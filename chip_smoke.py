"""Drive the PyTorch port's segment-and-get-coords path on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):

  env     torch / CUDA versions, the card's name and power limit, and which of
          Pillow / h5py / OpenCV import (for information only)
  build   the attention kernel (nvcc, sm_90a) and the contour tracer (g++),
          both from the sources in atlaspatch_tpu_torch/csrc, built together
  kernel  the attention kernel against its plain PyTorch version at the shapes
          the main path hands it (every trunk block of the --fast preset and
          of the float32 default) plus ragged and q-pool checks; each line
          gives the kernel's, the plain version's and
          F.scaled_dot_product_attention's time and the bound
  seg     SAM2SegmentationService(device="cuda") at full Hiera-tiny width with
          random weights: (a) the --fast preset (bfloat16, input 768, batch 8)
          on 16 thumbnails of two shapes, (b) float32 at 1024, batch 1, on 2
          thumbnails. The kernel must have launched 12 times per forward.
          (b)'s logits are held against the same model on the CPU.
  profile one forward of (a) and of (b) under torch.profiler: device time by
          kernel, and the device's busy share of the forward
  coords  the masks of (a) → contours → patch coordinates on a 4096x3072
          synthetic slide (native containment checked against numpy)

Then one JSON line with the kernel record, the card's name and power limit,
and last the result line. Needs no network and no JAX.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Random weights are the point here, so no checkpoint is looked for outside
# the checkout; the default path (no env overrides); stage counters on.
os.environ["ATLASPATCH_ALLOW_RANDOM_WEIGHTS"] = "1"
os.environ["ATLASPATCH_PROFILE"] = "1"
os.environ["HF_HOME"] = str(Path(__file__).resolve().parent / "_no_hf_cache")
for _var in ("ATLASPATCH_SAM2_CHECKPOINT", "ATLASPATCH_WEIGHTS_DIR", "ATLASPATCH_HOST_RESIZE",
             "ATLASPATCH_DEVICE_MASK_RESIZE", "ATLASPATCH_THUMB_QUANT", "ATLASPATCH_GELU_TANH"):
    os.environ.pop(_var, None)

H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; FP32 CUDA cores
H100_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "atlaspatch_tpu_torch/csrc/flash_attn.cu"
KERNEL_REPLACES = "atlaspatch_tpu/ops/attention.py:23"  # _flash_kernel
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NO_SPILL = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_total_ms: float = 60.0, max_reps: int = 50) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(max_reps, max(3, min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(shape, dtype_name: str) -> tuple[float, float]:
    """(operation-bound ms, byte-bound ms) of one attention call: QK^T and PV
    flops over the dtype's peak; Q, K, V read and O written once over HBM."""
    n, h, tq, tk, d = shape
    flops = 4.0 * n * h * tq * tk * d
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * n * h * d * (2 * tq + 2 * tk)
    return 1e3 * flops / H100_PEAK_FLOPS[dtype_name], 1e3 * nbytes / H100_BYTES_PER_S


def phase_env(state):
    import torch

    state["card"] = card_line()
    libs = {}
    for mod in ("PIL", "h5py", "cv2"):
        try:
            __import__(mod)
            libs[mod] = True
        except ImportError:
            libs[mod] = False
    log(f"env torch={torch.__version__} cuda={torch.version.cuda} "
        f"device={torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"card=[{state['card']}] host_libs={libs}")


def phase_build(state):
    from atlaspatch_tpu_torch.build import build_log
    from atlaspatch_tpu_torch.io.native import load_contours_library
    from atlaspatch_tpu_torch.ops.attention import load_flash_library

    def timed(fn):
        t0 = time.perf_counter()
        lib = fn()
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        flash = pool.submit(timed, load_flash_library)
        contours = pool.submit(timed, load_contours_library)
        (flash_lib, flash_s), (_, contours_s) = flash.result(), contours.result()
    # ptxas -v: "Function properties for <name>", then its stack/spill line,
    # then "Used N registers"
    registers, spilled, name = [], [], ""
    for line in build_log(Path(flash_lib._name)).splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and not line.strip().startswith(NO_SPILL):
            spilled.append(f"{name}: {line.strip()}")
        elif "Used " in line:
            registers.append(int(line.split("Used ")[1].split()[0]))
    log(f"build ok flash_attn.so {flash_s:.1f}s (nvcc sm_90a), atlas_contours.so "
        f"{contours_s:.1f}s (g++), wall {time.perf_counter() - t0:.1f}s; ptxas: "
        f"{len(registers)} kernels, max registers {max(registers)}, "
        f"stack or spills: {'; '.join(spilled) if spilled else 'none'}")


def phase_kernel(state):
    import torch
    import torch.nn.functional as F

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
    from atlaspatch_tpu_torch.ops import attention as A

    cfg = SAM2Config.tiny()
    fast = trunk_attention_shapes(cfg, 768, 8)
    default = trunk_attention_shapes(cfg, 1024, 1)
    checks = [(s, "bfloat16", f"fast block {i}") for i, s in enumerate(fast)]
    checks += [(s, "float32", f"f32-1024 block {i}") for i, s in enumerate(default)]
    checks += [
        ((2, 1, 196, 196, 96), "float32", "ragged window"),
        ((1024, 8, 49, 196, 96), "float32", "q-pool 49/196"),
        ((9216, 2, 16, 64, 96), "float32", "q-pool 16/64"),
        ((8, 4, 2304, 2304, 96), "float32", "global 2304 in f32"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for shape, dtype_name, label in checks:
        n, h, tq, tk, d = shape
        dtype = getattr(torch, dtype_name)
        q = torch.randn(n, h, tq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(n, h, tk, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(n, h, tk, d, device="cuda", generator=gen).to(dtype)
        scale = d**-0.5
        got = A.flash_attention(q, k, v, scale)
        want = A.reference_attention(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        if not err <= TOL[dtype_name]:
            raise AssertionError(f"kernel disagrees at {label} {shape} {dtype_name}: {err}")
        worst = max(worst, err)
        del got, want
        ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: A.reference_attention(q, k, v, scale))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        op_ms, byte_ms = attention_bound(shape, dtype_name)
        row = dict(label=label, shape=shape, dtype=dtype_name, err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, op_ms=op_ms, byte_ms=byte_ms)
        rows.append(row)
        log(f"kernel {label:18s} (BH={n}x{h}, Tq={tq}, Tkv={tk}, D={d}) {dtype_name:8s} "
            f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"sdpa_ms={library_ms:.4f} bound_ms={max(op_ms, byte_ms):.4f} "
            f"({'operations' if op_ms >= byte_ms else 'bytes'}) [{state['card']}]")
        del q, k, v
    torch.cuda.empty_cache()

    # The record: one --fast forward's 12 trunk attention calls, summed; the
    # bound is the sum of each call's bound, named by the larger share of it.
    fast_rows = rows[: len(fast)]
    op = sum(r["op_ms"] for r in fast_rows if r["op_ms"] >= r["byte_ms"])
    byte = sum(r["byte_ms"] for r in fast_rows if r["op_ms"] < r["byte_ms"])
    state["kernel_record"] = {
        "name": "flash_attn",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in fast_rows),
        "plain_ms": sum(r["plain_ms"] for r in fast_rows),
        "bound_ms": op + byte,
        "bound_by": "operations" if op >= byte else "bytes",
        "library_ms": sum(r["library_ms"] for r in fast_rows),
    }
    log(f"kernel ok: {len(rows)} shapes, max_abs_err {worst:.3g} [{state['card']}]")
    for name, group in (("--fast", fast_rows), ("float32", rows[len(fast) : len(fast) + len(default)])):
        log(f"kernel one {name} forward's 12 calls: kernel {sum(r['ms'] for r in group):.3f} ms, "
            f"plain {sum(r['plain_ms'] for r in group):.3f} ms, sdpa "
            f"{sum(r['library_ms'] for r in group):.3f} ms, bound "
            f"{sum(max(r['op_ms'], r['byte_ms']) for r in group):.3f} ms [{state['card']}]")


def _thumbnails(shapes_wh, per_shape, seed0=0):
    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    thumbs, seed = [], seed0
    for w, h in shapes_wh:
        for _ in range(per_shape):
            thumbs.append(make_tissue_canvas(w, h, seed=seed))
            seed += 1
    return thumbs


def _run_service(svc, thumbs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = svc.segment_thumbnails_async(thumbs)()
    torch.cuda.synchronize()
    return masks, time.perf_counter() - t0


def phase_seg(state):
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.models.sam2.model import pil_nearest_index, thumbs_to_logits
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.utils import perf

    fast_thumbs = _thumbnails([(256, 192), (224, 160)], per_shape=8)
    f32_thumbs = _thumbnails([(256, 192), (224, 160)], per_shape=1, seed0=100)
    fast = SAM2SegmentationService(
        SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
    )
    f32 = SAM2SegmentationService(SegmentationConfig(device="cuda", precision="float32", batch_size=1))
    assert next(fast.predictor.model.parameters()).dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in fast.predictor.model.parameters())
    # warm-up (cuDNN plans, allocator): not part of the counted run
    _run_service(fast, fast_thumbs)
    _run_service(f32, f32_thumbs)

    perf.reset()
    A.flash_attention.launches = 0
    fast_masks, fast_s = _run_service(fast, fast_thumbs)
    f32_masks, f32_s = _run_service(f32, f32_thumbs)
    launches = A.flash_attention.launches
    forwards = 2 + 2  # (a): one batch of 8 per thumbnail shape; (b): one per thumbnail
    if launches != 12 * forwards:
        raise AssertionError(f"kernel launched {launches} times in {forwards} forwards, want 12 each")
    state["launches"] = launches
    stages = perf.report()

    for masks, thumbs in ((fast_masks, fast_thumbs), (f32_masks, f32_thumbs)):
        for m, t in zip(masks, thumbs):
            assert m.data.shape == t.shape[:2] and np.isin(m.data, (0.0, 1.0)).all()
    log(f"seg (a) --fast bf16 input 768 batch 8: {len(fast_thumbs)} thumbnails in {fast_s:.3f} s "
        f"= {len(fast_thumbs) / fast_s:.2f} thumbnails/s; tissue fraction "
        f"{np.mean([m.data.mean() for m in fast_masks]):.3f} [{state['card']}]")
    log(f"seg (b) f32 input 1024 batch 1: {len(f32_thumbs)} thumbnails in {f32_s:.3f} s "
        f"= {len(f32_thumbs) / f32_s:.2f} thumbnails/s [{state['card']}]")
    log(f"seg kernel launches {launches} in {forwards} forwards (12 per forward)")
    log("seg stages " + json.dumps(stages) + f" [{state['card']}]")

    # (b) on the card (every trunk attention is the kernel) vs the same
    # params on the CPU (every trunk attention is the plain version).
    model = f32.predictor.model
    cpu_model = copy.deepcopy(model).to("cpu")
    S = f32.predictor.input_size
    threshold = f32.cfg.mask_threshold
    for thumb, mask in zip(f32_thumbs, f32_masks):
        t = torch.from_numpy(thumb)[None]
        card_logits = thumbs_to_logits(model, t.cuda())[0].cpu()
        cpu_logits = thumbs_to_logits(cpu_model, t)[0]
        diff = (card_logits - cpu_logits).abs().max().item()
        scale = cpu_logits.abs().max().item()
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"card vs CPU logits differ by {diff} (max |logit| {scale})")
        h, w = thumb.shape[:2]
        small = cpu_logits.numpy()[pil_nearest_index(h, S)][:, pil_nearest_index(w, S)]
        differ = mask.data != (small > threshold)
        if (differ & (np.abs(small - threshold) >= diff)).any():
            raise AssertionError("card mask bits differ from CPU away from the threshold")
        log(f"seg (b) card vs CPU {h}x{w}: max |logit diff| {diff:.3g} "
            f"(<= 1e-3 x max|logit| {scale:.3g}); mask bits differing {int(differ.sum())}, "
            f"all within |logit - threshold| < {diff:.3g}")
    state["fast_masks"] = [m.data for m in fast_masks]
    state["services"] = {"--fast bf16 768 batch 8": (fast, fast_thumbs[:8]),
                         "f32 1024 batch 1": (f32, f32_thumbs[:1])}


def phase_profile(state):
    """One forward of each setting under torch.profiler: device time by
    kernel, and its share of the forward's host-clock time (the best of 3
    runs without the profiler, which slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for label, (svc, thumbs) in state.pop("services").items():
        wall_s = min(_run_service(svc, thumbs)[1] for _ in range(3))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _run_service(svc, thumbs)
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy_us = sum(e.self_device_time_total for e in rows)
        if busy_us == 0:
            raise AssertionError("the profiler recorded no device time")
        rows.sort(key=lambda e: -e.self_device_time_total)
        log(f"profile {label}: forward {1e3 * wall_s:.2f} ms host clock (thumbnails in, masks "
            f"out), device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall_s:.1f}%), "
            f"{sum(e.count for e in rows)} kernel launches [{state['card']}]")
        for e in rows[:12]:
            us = e.self_device_time_total
            log(f"profile   {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}% x{e.count:<4d} {e.key[:110]}")
        svc.close()


def phase_coords(state):
    import numpy as np

    from atlaspatch_tpu_torch.core.config import ExtractionConfig
    from atlaspatch_tpu_torch.io.synthetic_wsi import SyntheticWSI
    from atlaspatch_tpu_torch.ops import contours
    from atlaspatch_tpu_torch.ops.polygon import point_polygon_test, point_polygon_test_numpy
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService

    wsi = SyntheticWSI(size=(4096, 3072), mpp=0.5, seed=0)
    W, H = wsi.get_size(lv=0)  # opens the slide: magnification 20x from mpp 0.5
    svc = PatchExtractionService(ExtractionConfig(patch_size=256, target_magnification=20))
    level, _, psrc, step, _ = svc._prepare_geometry(wsi)
    counts, host_ms = [], []
    for mask in state["fast_masks"]:
        t0 = time.perf_counter()
        coords = svc.compute_coords(*svc._prepare_contours(mask, wsi), patch_size_src=psrc, step_src=step)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        assert coords.ndim == 2 and coords.shape[1] == 2
        assert (coords >= 0).all() and (coords[:, 0] < W).all() and (coords[:, 1] < H).all()
        counts.append(int(coords.shape[0]))
    # the native containment scan against its numpy oracle on the first mask
    tissue, holes = svc._prepare_contours(state["fast_masks"][0], wsi)
    native = svc.compute_coords(tissue, holes, patch_size_src=psrc, step_src=step)
    contours.point_polygon_test = point_polygon_test_numpy
    try:
        oracle = svc.compute_coords(tissue, holes, patch_size_src=psrc, step_src=step)
    finally:
        contours.point_polygon_test = point_polygon_test
    if native.tobytes() != oracle.tobytes():
        raise AssertionError("native containment disagrees with the numpy oracle")
    if sum(counts) == 0:
        raise AssertionError("no patch coordinates from any mask")
    log(f"coords ok: level {level}, patch {psrc}px step {step}px on {W}x{H}; per slide "
        f"{counts}; host ms per slide mean {np.mean(host_ms):.2f} max {np.max(host_ms):.2f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to drive", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state: dict = {}
    t_all = time.perf_counter()
    for name, phase in (("env", phase_env), ("build", phase_build), ("kernel", phase_kernel),
                        ("seg", phase_seg), ("profile", phase_profile), ("coords", phase_coords)):
        t0 = time.perf_counter()
        try:
            phase(state)
        except BaseException as e:  # noqa: BLE001 — report the phase, then fail
            print(f"phase {name} FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            raise
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    record = dict(state["kernel_record"], launches=state["launches"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}))
    print(state["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
