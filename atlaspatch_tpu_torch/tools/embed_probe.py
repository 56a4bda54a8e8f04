"""Where the time of vit_l_16 embedding goes on the card: the engine's settings,
its stages, and the encoder's attention.

    python3 -m atlaspatch_tpu_torch.tools.embed_probe

Builds vit_l_16 in bfloat16 with random weights from the port's registry.

1. ``extract_batch`` over 512 random 256x256 uint8 patches at batch 32 (one
   warm and three timed passes, median patches/s, and the dispatch stage's
   wall and thread-CPU ms per forward) under the engine's settings: the
   default (dispatch depth 2, deferred fetches, 8 prep threads), depth 1,
   blocking fetches, and 1 and 4 prep threads.
2. One batch of 32 split into its parts: host preprocessing alone
   (patches/s on the 8 prep threads), the host time to enqueue one forward
   with the card idle, the forward's device time by CUDA events and its
   kernel launches by ``torch.profiler``.
3. The encoder's attention at vit_l_16's shape for a batch of 32 (B 32, T
   197, 16 heads, D 64, bfloat16): the model's own path (token-major einsums,
   float32 softmax), the same products on (B, H, T, D) tensors made
   contiguous first, the port's attention kernel (``ops/attention.py``), and
   ``F.scaled_dot_product_attention`` (timed only). Device time per call by
   ``torch.profiler`` and each one's max-abs difference to the model's path.

Every line carries the card's name and power limit. Needs a CUDA card (and
nvcc for the attention kernel).
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

PATCHES, BATCH, PASSES = 512, 32, 3
SETTINGS = {
    "default (depth 2, deferred, 8 prep threads)": ({}, 8),
    "dispatch depth 1": ({"ATLASPATCH_H2D_DEPTH": "1"}, 8),
    "blocking fetches": ({"ATLASPATCH_DEFERRED_FETCH": "0"}, 8),
    "1 prep thread": ({}, 1),
    "4 prep threads": ({}, 4),
}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 20) -> tuple[float, int]:
    """(device ms per call, kernel launches per call) by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in rows) / 1e3 / reps, sum(e.count for e in rows) // reps


def _extract_rates(ext, patches, card: str) -> None:
    from atlaspatch_tpu_torch.utils import perf

    os.environ["ATLASPATCH_PROFILE"] = "1"
    for label, (env, workers) in SETTINGS.items():
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        ext.prep_workers = workers
        try:
            ext.extract_batch(patches, batch_size=BATCH)
            perf.reset()
            times = []
            for _ in range(PASSES):
                t0 = time.perf_counter()
                ext.extract_batch(patches, batch_size=BATCH)
                times.append(time.perf_counter() - t0)
            d = perf.report()["embed_dispatch"]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print(f"extract_batch {label}: {len(patches) / statistics.median(times):.1f} patches/s (median of "
              f"{PASSES}); embed_dispatch {1e3 * d['total_s'] / d['count']:.2f} ms wall, "
              f"{1e3 * d['cpu_s'] / d['count']:.2f} ms thread CPU per forward [{card}]", flush=True)
    ext.prep_workers = 8


def _stages(ext, patches, card: str) -> None:
    from concurrent.futures import ThreadPoolExecutor

    chunk = patches[:BATCH]
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(ext.spec.apply_host, chunk))
        t0 = time.perf_counter()
        for _ in range(4):
            imgs = np.stack(list(pool.map(ext.spec.apply_host, patches)))
        prep_pps = 4 * len(patches) / (time.perf_counter() - t0)
    u8 = torch.from_numpy(imgs[:BATCH]).cuda()
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ext.forward_device(u8)
        enqueue.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        ext.forward_device(u8)
    end.record()
    end.synchronize()
    dev_ms, launches = _device_ms(lambda: ext.forward_device(u8), reps=5)
    print(f"stages of one batch of {BATCH}: host preprocessing {prep_pps:.0f} patches/s on 8 threads; "
          f"enqueue one forward (card idle) median {statistics.median(enqueue):.2f} ms host; forward "
          f"{start.elapsed_time(end) / 10:.2f} ms by CUDA events, device busy {dev_ms:.2f} ms by the "
          f"profiler, {launches} kernel launches [{card}]", flush=True)


def _attention(card: str) -> None:
    from atlaspatch_tpu_torch.models.encoders.vit import _softmax_attention
    from atlaspatch_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, D = BATCH, 197, 16, 64
    qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)  # token-major views, as the model has them

    def model_path():
        return _softmax_attention(q, k, v, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")

    def head_major():
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        s = torch.matmul(qh, kh.transpose(-1, -2)) * D**-0.5
        p = torch.softmax(s.float(), dim=-1).to(qh.dtype)
        return torch.matmul(p, vh).transpose(1, 2)

    def kernel():
        return A.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2)).transpose(1, 2)

    want = model_path().float()
    flops = 4.0 * B * H * T * T * D
    for label, fn in (("model path (token-major einsum, float32 softmax)", model_path),
                      ("(B, H, T, D) contiguous + matmul, float32 softmax", head_major),
                      (f"port kernel ({A.kernel_variant(torch.bfloat16, T, T, D)})", kernel),
                      ("SDPA (timed only)", sdpa)):
        err = (fn().float() - want).abs().max().item()
        ms, launches = _device_ms(fn)
        print(f"attention B={B} T={T} H={H} D={D} bf16, {label}: device {ms:.4f} ms per block "
              f"({launches} launches; x24 blocks = {24 * ms:.2f} ms per forward), {flops / ms / 1e9:.1f} "
              f"TFLOP/s, max-abs vs the model path {err:.3g} [{card}]", flush=True)


def main() -> None:
    from atlaspatch_tpu_torch.models.encoders import build_default_registry

    if not torch.cuda.is_available():
        raise SystemExit("embed_probe needs a CUDA card")
    os.environ.setdefault("ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "1")
    card = _card()
    ext = build_default_registry(device="cuda", dtype="bfloat16").create("vit_l_16")
    rng = np.random.default_rng(0)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(PATCHES)]
    _extract_rates(ext, patches, card)
    _stages(ext, patches, card)
    _attention(card)


if __name__ == "__main__":
    main()
