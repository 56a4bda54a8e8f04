"""Drive the PyTorch port's segment-and-get-coords path on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):

  env     torch / CUDA versions, the card's name and power limit, and which of
          Pillow / h5py / OpenCV import (for information only)
  build   the attention kernel's three libraries (nvcc, sm_90a: the wgmma +
          TMA bfloat16 body; the mma.sync bfloat16 body and two float32
          bodies, 3xTF32 on mma.sync and FMA; the float32 small-window body)
          and the contour tracer (g++), all from the sources in
          atlaspatch_tpu_torch/csrc, built in parallel; registers and spills
          per body (none allowed at D = 96 in the wgmma, tf32x3 and f32_win
          bodies), the tf32x3 and f32_win bodies' CTAs per SM, the wgmma
          body's SASS checked for HGMMA and UTMALDG, flash_attn.so's for TF32
          HMMA
  kernel  the attention kernel against its plain PyTorch version at the shapes
          the main path hands it (every trunk block of the --fast preset and
          of the float32 default) plus ragged, q-pool and FMA-body checks;
          each line gives the variant launched, the kernel's time by CUDA
          events and its device time per call by torch.profiler, the plain
          version's and F.scaled_dot_product_attention's time and the bound
          (float32 rows: the FP32-core and the 3xTF32 tensor-core bound); an
          float32 line whose shape both f32_win and another body take also
          times the other one, forced on the same inputs (for f32_win rows the
          body kernel_variant picked before f32_win). float32 is held to
          max-abs 1e-4 and, element by element, to attention.f32_error_limit,
          which a planted single TF32 pass on the global float32 block's
          inputs must exceed; bfloat16 to 2e-2 and, element by element, to
          attention.bf16_error_limit, which two planted faults emulated on the
          global block's inputs (P in fp8, one K/V tile skipped) must exceed
  seg     SAM2SegmentationService(device="cuda") at full Hiera-tiny width with
          random weights: (a) the --fast preset (bfloat16, input 768, batch 8)
          on 16 thumbnails of two shapes, (b) float32 at 1024, batch 1, on 2
          thumbnails. The kernel must have launched 12 times per forward, each
          variant as often as kernel_variant picks it at the trunk's shapes
          (the 3 global blocks of each forward of (a) on the wgmma body's
          192-row tile; 9 tf32x3 and 3 f32_win launches per forward of (b),
          none on the FMA body).
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
import re
import subprocess
import sys
import time
from collections import Counter
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

# dense bf16 tensor core; FP32 CUDA cores; dense TF32 tensor core (3xTF32 takes three passes)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
H100_BYTES_PER_S = 3.35e12
# The record covers the kernel's three libraries: 9 of a --fast forward's 12
# calls run the wgmma body, 3 the mma.sync body of flash_attn.cu; a float32
# forward runs flash_attn.cu's tf32x3 body and flash_attn_f32win.cu.
KERNEL_SOURCES = ["atlaspatch_tpu_torch/csrc/flash_attn_wgmma.cu", "atlaspatch_tpu_torch/csrc/flash_attn.cu",
                  "atlaspatch_tpu_torch/csrc/flash_attn_f32win.cu"]
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


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Mean device time in ms of the attention kernel that each fn() launches,
    by torch.profiler: the flash_fwd kernels' self device time over the
    launches it recorded of ``reps`` calls, after a warm-up (host time between
    launches is not counted). The profiler may drop some of a burst of
    launches, or now and then all of them: the mean is over those it kept,
    and a window that kept none is run again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "flash_fwd" in e.key]
        count = sum(e.count for e in events)
        if 0 < count <= reps:
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    raise AssertionError(f"the profiler saw {[(e.key, e.count) for e in events]} of {reps} launches "
                         f"in each of {tries} windows")


def other_float32_body(variant: str, tq: int, tk: int, d: int) -> str | None:
    """The body a float32 row is timed against: for f32_win, the one
    kernel_variant picked before f32_win took the windows; for tf32x3 at a
    window f32_win could take, f32_win; else None."""
    from atlaspatch_tpu_torch.ops.attention import F32WIN_MAX_T, TF32X3_HEAD_DIMS

    if variant == "f32_win":
        return "tf32x3" if d in TF32X3_HEAD_DIMS and tq > 16 else "f32"
    if variant == "tf32x3" and max(tq, tk) <= F32WIN_MAX_T:
        return "f32_win"
    return None


def attention_bound(shape, dtype_name: str) -> tuple[float, float]:
    """(operation-bound ms, byte-bound ms) of one attention call: QK^T and PV
    flops over the dtype's peak; Q, K, V read and O written once over HBM."""
    n, h, tq, tk, d = shape
    flops = 4.0 * n * h * tq * tk * d
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * n * h * d * (2 * tq + 2 * tk)
    return 1e3 * flops / H100_PEAK_FLOPS[dtype_name], 1e3 * nbytes / H100_BYTES_PER_S


def tf32x3_bound(shape) -> float:
    """ms of one float32 call on the tensor cores as 3xTF32: three TF32
    passes of its flops at the TF32 peak, or its bytes if they take longer."""
    n, h, tq, tk, d = shape
    return max(1e3 * 3 * 4.0 * n * h * tq * tk * d / H100_PEAK_FLOPS["tf32"],
               attention_bound(shape, "float32")[1])


def planted_faults(q, k, v, scale, want, limit) -> dict:
    """Max |fault - plain| / limit of two faults of a bfloat16 body, emulated
    in plain PyTorch on the same inputs: P rounded to fp8 (e4m3) in place of
    bfloat16, and the first 64-key K/V tile skipped."""
    import torch

    from atlaspatch_tpu_torch.ops.attention import reference_attention

    q, k, v = q.float(), k.float(), v.float()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q * scale, k), dim=-1)
    faults = {
        "p_fp8": torch.einsum("bhqk,bhkd->bhqd", p.to(torch.float8_e4m3fn).float(), v),
        "tile_skipped": reference_attention(q, k[:, :, 64:], v[:, :, 64:], scale),
    }
    return {name: ((out.to(torch.bfloat16).float() - want).abs() / limit).max().item()
            for name, out in faults.items()}


def planted_tf32_fault(q, k, v, scale, want, limit) -> dict:
    """Max |fault - plain| (max-abs) and max |fault - plain| / limit of a
    float32 body with one uncompensated TF32 pass, emulated in plain PyTorch:
    q * scale, k, v and P rounded to TF32 once (to nearest, by bit mask)."""
    import torch

    def tf32(x):
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", tf32(q * scale), tf32(k)), dim=-1)
    err = (torch.einsum("bhqk,bhkd->bhqd", tf32(p), tf32(v)) - want).abs()
    return {"max_abs": err.max().item(), "err/limit": (err / limit).max().item()}


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


def _ptxas_by_body(log: str) -> dict:
    """ptxas -v of a kernel library: per body (wgmma / mma / f32 / ...), the most
    registers and the instantiations (head dim first) with stack or spills."""
    bodies: dict = {}
    for name, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)", log, re.S):
        kind = re.search(r"flash_fwd_(wgmma|bf16|f32win|f32|tf32x3)_kernel", name).group(1)
        kind = {"bf16": "mma", "f32win": "f32_win"}.get(kind, kind)
        entry = bodies.setdefault(kind, {"kernels": 0, "max_registers": 0, "spilling": []})
        entry["kernels"] += 1
        registers = int(re.search(r"Used (\d+) registers", body).group(1))
        entry["max_registers"] = max(entry["max_registers"], registers)
        stack = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads)", body)
        if stack and stack.group(1) != NO_SPILL:
            d, second = re.search(r"kernelILi(\d+)E(?:Li(\d+)E)?", name).groups()
            entry["spilling"].append(f"D={d}{'' if second is None else f'/{second}'}: {stack.group(1)}")
    return bodies


def phase_build(state):
    from atlaspatch_tpu_torch.build import build_log, nvcc_path
    from atlaspatch_tpu_torch.io.native import load_contours_library
    from atlaspatch_tpu_torch.ops.attention import load_f32win_library, load_flash_library, load_wgmma_library

    def timed(fn):
        t0 = time.perf_counter()
        lib = fn()
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = [pool.submit(timed, fn) for fn in
                (load_wgmma_library, load_flash_library, load_f32win_library, load_contours_library)]
        (wgmma_lib, wgmma_s), (flash_lib, flash_s), (win_lib, win_s), (_, contours_s) = (
            j.result() for j in jobs)
    bodies = {**_ptxas_by_body(build_log(Path(wgmma_lib._name))),
              **_ptxas_by_body(build_log(Path(flash_lib._name))),
              **_ptxas_by_body(build_log(Path(win_lib._name)))}
    for body in ("wgmma", "tf32x3", "f32_win"):
        if body not in bodies or any(s.startswith("D=96") for s in bodies[body]["spilling"]):
            raise AssertionError(f"the {body} body is missing or spills at D = 96: {bodies.get(body)}")
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")

    def sass(lib):
        return subprocess.run([str(cuobjdump), "-sass", lib._name], capture_output=True, text=True,
                              check=True).stdout

    wgmma_sass, flash_sass = sass(wgmma_lib), sass(flash_lib)
    ops = {op: wgmma_sass.count(op) for op in ("HGMMA", "UTMALDG", "USETMAXREG")}
    if not ops["HGMMA"] or not ops["UTMALDG"]:
        raise AssertionError(f"the wgmma library's SASS lacks HGMMA or UTMALDG: {ops}")
    hmma = Counter(re.findall(r"HMMA\.[\w.]+", flash_sass))
    if not any("TF32" in op for op in hmma):
        raise AssertionError(f"flash_attn.so's SASS has no TF32 HMMA: {dict(hmma)}")
    ctas = flash_lib.atlas_flash_attn_tf32x3_ctas_per_sm()
    if ctas < 1:
        raise AssertionError(f"the tf32x3 body fits no CTA on an SM (cudaError {-ctas})")
    win_ctas = win_lib.atlas_flash_attn_f32win_ctas_per_sm()
    if win_ctas < 1:
        raise AssertionError(f"the f32_win body fits no CTA on an SM (cudaError {-win_ctas})")
    log(f"build ok flash_attn_wgmma.so {wgmma_s:.1f}s, flash_attn.so {flash_s:.1f}s and "
        f"flash_attn_f32win.so {win_s:.1f}s (nvcc sm_90a), atlas_contours.so {contours_s:.1f}s (g++), "
        f"wall {time.perf_counter() - t0:.1f}s")
    for kind, entry in bodies.items():
        log(f"build ptxas {kind}: {entry['kernels']} kernels, max registers {entry['max_registers']}, "
            f"stack or spills: {'; '.join(entry['spilling']) or 'none'}")
    log(f"build wgmma SASS: {ops}; flash_attn.so SASS: {dict(hmma)}; at D = 96: tf32x3 {ctas} CTAs "
        f"of 128 threads per SM, f32_win {win_ctas} CTAs of 384 threads (8 consumer, 4 producer warps) per SM")


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
        ((2, 1, 300, 300, 128), "float32", "FMA body D=128"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst, faults, tf32_fault = [], 0.0, None, None
    worst_ratio = {"bfloat16": 0.0, "float32": 0.0}
    for shape, dtype_name, label in checks:
        n, h, tq, tk, d = shape
        dtype = getattr(torch, dtype_name)
        q = torch.randn(n, h, tq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(n, h, tk, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(n, h, tk, d, device="cuda", generator=gen).to(dtype)
        scale = d**-0.5
        variant = A.kernel_variant(dtype, tq, tk, d)
        got = A.flash_attention(q, k, v, scale)
        error_limit = A.bf16_error_limit if dtype == torch.bfloat16 else A.f32_error_limit
        want, limit = error_limit(q, k, v, scale)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        ratio = ((got.float() - want).abs() / limit).max().item()
        if not (err <= TOL[dtype_name] and ratio <= 1.0):
            raise AssertionError(f"kernel disagrees at {label} {shape} {dtype_name}: max abs "
                                 f"{err}, max err/limit {ratio}")
        worst = max(worst, err)
        worst_ratio[dtype_name] = max(worst_ratio[dtype_name], ratio)
        if faults is None and dtype == torch.bfloat16 and tq == tk == 2304:
            faults = planted_faults(q, k, v, scale, want, limit)
            if not min(faults.values()) > 1.0:
                raise AssertionError(f"a planted fault passes the bfloat16 limit: {faults}")
        if tf32_fault is None and dtype == torch.float32 and tq == tk == 4096:
            tf32_fault = planted_tf32_fault(q, k, v, scale, want, limit)
            if not tf32_fault["err/limit"] > 1.0:
                raise AssertionError(f"a single TF32 pass passes the float32 limit: {tf32_fault}")
        del got, want, limit
        ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale))
        dev_ms = device_ms(lambda: A.flash_attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: A.reference_attention(q, k, v, scale))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        op_ms, byte_ms = attention_bound(shape, dtype_name)
        row = dict(label=label, shape=shape, dtype=dtype_name, variant=variant, err=err, ms=ms,
                   dev_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, op_ms=op_ms, byte_ms=byte_ms)
        other = other_float32_body(variant, tq, tk, d) if dtype == torch.float32 else None
        if other:
            row["other"] = other
            row["other_ms"] = cuda_ms(lambda: A._launch(other, q, k, v, scale))
            row["other_dev_ms"] = device_ms(lambda: A._launch(other, q, k, v, scale))
            other = (f" other={other} ms={row['other_ms']:.4f} dev_ms={row['other_dev_ms']:.4f} "
                     f"({'faster' if dev_ms < row['other_dev_ms'] else 'NOT faster'} by device time)")
        rows.append(row)
        log(f"kernel {label:18s} (BH={n}x{h}, Tq={tq}, Tkv={tk}, D={d}) {dtype_name:8s} "
            f"{variant:10s} max_abs_err={err:.3g} err/limit={ratio:.3g} ms={ms:.4f} dev_ms={dev_ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} bound_ms={max(op_ms, byte_ms):.4f} "
            f"({'operations' if op_ms >= byte_ms else 'bytes'})"
            + (f" tf32x3_bound_ms={tf32x3_bound(shape):.4f}" if dtype_name == "float32" else "")
            + (other or "") + f" [{state['card']}]")
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
        "source": KERNEL_SOURCES[0],
        "sources": KERNEL_SOURCES,
        "replaces": KERNEL_REPLACES,
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in fast_rows),
        "plain_ms": sum(r["plain_ms"] for r in fast_rows),
        "bound_ms": op + byte,
        "bound_by": "operations" if op >= byte else "bytes",
        "library_ms": sum(r["library_ms"] for r in fast_rows),
    }
    log(f"kernel ok: {len(rows)} shapes, max_abs_err {worst:.3g}; max err/limit bfloat16 "
        f"{worst_ratio['bfloat16']:.3g}, float32 {worst_ratio['float32']:.3g}; planted faults at "
        f"the global blocks: bfloat16 err/limit {({k_: round(v_, 3) for k_, v_ in faults.items()})}, "
        f"one TF32 pass in float32 max abs {tf32_fault['max_abs']:.3g} err/limit "
        f"{tf32_fault['err/limit']:.3g} [{state['card']}]")
    f32_rows = rows[len(fast) : len(fast) + len(default)]
    for name, group in (("--fast", fast_rows), ("float32", f32_rows)):
        log(f"kernel one {name} forward's 12 calls: kernel {sum(r['ms'] for r in group):.3f} ms "
            f"(device {sum(r['dev_ms'] for r in group):.3f}), "
            f"plain {sum(r['plain_ms'] for r in group):.3f} ms, sdpa "
            f"{sum(r['library_ms'] for r in group):.3f} ms, bound "
            f"{sum(max(r['op_ms'], r['byte_ms']) for r in group):.3f} ms"
            + (f" (3xTF32 bound {sum(tf32x3_bound(r['shape']) for r in group):.3f} ms)"
               if name == "float32" else "")
            + f" [{state['card']}]")
    win = [r for r in f32_rows if r["variant"] == "f32_win"]
    log(f"kernel the float32 forward's {len(win)} f32_win calls: {sum(r['ms'] for r in win):.4f} ms "
        f"(device {sum(r['dev_ms'] for r in win):.4f}); the bodies before, forced: "
        f"{sum(r['other_ms'] for r in win):.4f} ms (device {sum(r['other_dev_ms'] for r in win):.4f}); "
        f"sdpa {sum(r['library_ms'] for r in win):.4f} ms; bound "
        f"{sum(max(r['op_ms'], r['byte_ms']) for r in win):.4f} ms [{state['card']}]")
    if not any(r["variant"] == "f32" for r in rows):
        raise AssertionError("no kernel row ran on the FMA body")


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
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
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
    A.reset_launch_counts()
    fast_masks, fast_s = _run_service(fast, fast_thumbs)
    f32_masks, f32_s = _run_service(f32, f32_thumbs)
    launches = A.flash_attention.launches
    variants = dict(A.flash_attention.variant_launches)
    forwards = 2 + 2  # (a): one batch of 8 per thumbnail shape; (b): one per thumbnail
    if launches != 12 * forwards:
        raise AssertionError(f"kernel launched {launches} times in {forwards} forwards, want 12 each")
    cfg = fast.predictor.model.cfg
    want = Counter()
    for dtype, size, batch, n in ((torch.bfloat16, 768, 8, 2), (torch.float32, 1024, 1, 2)):
        for _, _, tq, tk, d in trunk_attention_shapes(cfg, size, batch):
            want[A.kernel_variant(dtype, tq, tk, d)] += n
    # (a): the global blocks on the 192-row wgmma tile; (b): 9 tf32x3 and 3
    # f32_win per forward, none on the FMA body
    if (variants != dict(want) or want["wgmma_m192"] != 3 * 2 or want["tf32x3"] != 9 * 2
            or want["f32_win"] != 3 * 2 or "f32" in want):
        raise AssertionError(f"kernel variants launched {variants}, want {dict(want)}")
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
    log(f"seg kernel launches {launches} in {forwards} forwards (12 per forward), by variant "
        f"{variants}")
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
    keys = ("name", "route", "source", "sources", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
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
