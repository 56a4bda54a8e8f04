"""Drive the PyTorch port's segment-and-get-coords and process paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):

  env     torch / CUDA versions, the card's name and power limit, and which of
          Pillow / h5py / OpenCV import (for information only)
  build   the attention kernel's three libraries (nvcc, sm_90a: the wgmma +
          TMA bfloat16 body; the mma.sync bfloat16 body and two float32
          bodies, 3xTF32 on mma.sync and FMA; the float32 small-window body),
          the contour tracer and the slide decoder (g++), all from the sources in
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
          version's and F.scaled_dot_product_attention's time (SDPA's device
          time too, which SDPA is only timed for) and the bound
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
  runner  segment-and-get-coords through the port's ProcessingRunner on
          bench.py's seg_coords_synthetic corpus: 28 SyntheticWSI slides of
          4096x3072 (3 levels, mpp 0.5; four make_tissue_canvas canvases,
          seeds 0-3, round-robin) behind empty .svs placeholders, the --fast
          service (bfloat16, input 768, batch 8; pend depth 3 and the
          remainder batch of 4 both run), patch 256 at 20x. Random-weight
          masks have no structure, so, as bench.py's BenchSegmentation does,
          the real device step runs and its masks are waited for, and then
          extraction gets the thumbnail thresholded at < 220. Checks: 12
          kernel launches per forward with kernel_variant's counts; 28 results
          and no failures; each H5 at patch_h5_path, read back by the port's
          read_h5: coords byte for byte the rows _iter_patch_entries yields
          for the mask handed to extraction, num_patches, passports that
          parse back to their coords, every file attr; no .lock or .stage-*
          file left; the H5 write not the stage with the most host time; a
          second run with skip_existing skips all 28 with no kernel launch
          and no file rewritten. Prints slides/s by host clock (a liveness
          figure), the stage counters and the H5 write's ms per slide
  tiff    segment-and-get-coords and process from slide files on disk,
          through DefaultWSILoader, the factory and the native decoder
          (atlas_tiff, g++ at build). Writes, on the card's host, with
          tests/tiff_builder.py and tests/container_builders.py: (f1)
          bench.py's real-TIFF corpus (28 JPEG SVS of 4096x3072, 3 levels,
          tile 256, AppMag 20, MPP 0.5; canvases seeds 100-103), (f2) one SVS
          of 16384x12288 (4 levels), (f3) an NDPI (single-strip restart JPEG
          with zeroed SOF dims), a MIRAX, a VMS, a VMU and a 2-level DICOM
          series with a label. Prints the decoder's build (g++, the libjpeg
          headers used, ldd, the libjpeg and libopenjp2 loaded) and holds it
          against Pillow's decode of the same bytes (a level-0 region, the
          --fast thumbnail of an (f1) slide by IDCT scaling, a 33003 J2K
          tile): max-abs 0, as tests/test_torch_native_tiff.py measures on
          the CPU. On the card both sides load Pillow's bundled libjpeg, so
          this holds the TIFF walk, tile assembly and J2K colour maths; the
          check across two libjpegs is the CPU test
          test_vendored_libjpeg_route_matches. Runs the runner's checks over (f1)+(f3) on the --fast
          thresholding service (12 launches per forward, every slide an H5,
          a skip pass), prints slides/s beside the runner phase's and the
          per-slide stage ms; then (f2) and two (f1) slides through the
          runner and embed_all (vit_l_16 bfloat16, batch 32): (f2)'s
          coordinates equal the CPU geometry over the same reader's
          thumbnail, 64 of its features match extract_batch on wsi.extract
          reads (per-row cosine > 0.999); prints (f2)'s thumbnail ms,
          patch_read ms per patch, patches/s and the device busy share
  embed   vit_l_16 from the port's registry at full width (dim 1024, depth
          24, 16 heads, 224 px, patch 16) with random weights, on the card.
          Checks: full width at depth 2 in float32 on the card (built with
          TF32 switched on, which the engine must switch off) against the
          same weights on the CPU, max-abs <= 1e-4; the full model in bfloat16
          against float32 on 16 patches, per-row cosine > 0.995; every param
          of the bfloat16 extractor bfloat16 on the card. Rates: bench.py's
          setting (512 random 256x256 uint8 patches through extract_batch at
          batch 32, one warm and 3 timed passes: median patches/s and the
          stage totals), the same at batch 256, the device-resident rate (the
          forward over a batch already on the card), the share of the bf16
          dense bound (the forward's FLOPs per patch over 989 TFLOP/s), the
          device busy share of one extract_batch by torch.profiler with its
          largest device operations, and the peak memory allocated
  process the runner phase's 28 slides through ProcessingRunner.run() and
          then PatchFeatureEmbeddingService.embed_all with vit_l_16 in
          bfloat16 (batch 32), as the JAX CLI's process composes them.
          Checks: every H5 holds features/vit_l_16 (num_patches x 1024
          float32, attrs name and embedding_dim) by read_h5, coords and file
          attrs unchanged by the append; one slide's features equal
          extract_batch on its patches read directly (per-row cosine >
          0.999); feature_sets == ["vit_l_16"]; no lock or stage file; a
          second embed_all runs no forward and rewrites no file; a
          configuration asking also for vit_b_16, through the runner with
          skip_existing, reuses every slide's coordinates (no segmentation
          launch) and embeds only vit_b_16. Prints patches/s and the stage
          totals (patch_read, embed_*, h5_append ms per slide)

Then one JSON line with the kernel record (``launches``: the seg phase's;
``runner_launches``: the runner phase's; ``tiff_launches``: the tiff phase's
(f1)+(f3) runner pass; ``process_launches``: the process phase's; the
encoder path holds no TPU kernel of its own), the card's name and power limit,
and last the result line. Needs no network, no JAX and no h5py: the H5 files
are written and read by the port's own HDF5 code.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
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


def device_ms(fn, reps: int = 20, tries: int = 3, kernel: str | None = "flash_fwd") -> float:
    """Mean device time in ms of one fn() call, by torch.profiler, after a
    warm-up (host time between launches is not counted).

    With ``kernel`` (the attention kernel's flash_fwd bodies): those kernels'
    self device time over the launches it recorded of ``reps`` calls. With
    ``kernel=None`` (a library call that may launch several kernels): every
    kernel's device time, over the launches of the most-launched one. The
    profiler may drop some of a burst of launches, or now and then all of
    them: the mean is over those it kept, and a window that kept none is run
    again, up to ``tries`` times."""
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
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                  and (kernel is None or kernel in e.key)]
        if kernel is None:
            count = max((e.count for e in events), default=0)
        else:
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
    from atlaspatch_tpu_torch.io.native import load_contours_library, load_tiff_library
    from atlaspatch_tpu_torch.ops.attention import load_f32win_library, load_flash_library, load_wgmma_library

    def timed(fn):
        t0 = time.perf_counter()
        lib = fn()
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        jobs = [pool.submit(timed, fn) for fn in (load_wgmma_library, load_flash_library, load_f32win_library,
                                                  load_contours_library, load_tiff_library)]
        (wgmma_lib, wgmma_s), (flash_lib, flash_s), (win_lib, win_s), (_, contours_s), (_, tiff_s) = (
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
        f"flash_attn_f32win.so {win_s:.1f}s (nvcc sm_90a), atlas_contours.so {contours_s:.1f}s and "
        f"atlas_tiff.so {tiff_s:.1f}s (g++), "
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
        # SDPA is timed only, never called by the port; by device time too,
        # since CUDA events read mostly host time for calls under ~0.05 ms
        sdpa_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), kernel=None)
        op_ms, byte_ms = attention_bound(shape, dtype_name)
        row = dict(label=label, shape=shape, dtype=dtype_name, variant=variant, err=err, ms=ms,
                   dev_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, sdpa_dev_ms=sdpa_dev_ms,
                   op_ms=op_ms, byte_ms=byte_ms)
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
            f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} sdpa_dev_ms={sdpa_dev_ms:.4f} "
            f"({'kernel faster' if dev_ms < sdpa_dev_ms else 'SDPA faster'} by device time) "
            f"bound_ms={max(op_ms, byte_ms):.4f} "
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
            f"{sum(r['library_ms'] for r in group):.3f} ms (device {sum(r['sdpa_dev_ms'] for r in group):.3f})"
            ", bound "
            f"{sum(max(r['op_ms'], r['byte_ms']) for r in group):.3f} ms"
            + (f" (3xTF32 bound {sum(tf32x3_bound(r['shape']) for r in group):.3f} ms)"
               if name == "float32" else "")
            + f" [{state['card']}]")
    win = [r for r in f32_rows if r["variant"] == "f32_win"]
    log(f"kernel the float32 forward's {len(win)} f32_win calls: {sum(r['ms'] for r in win):.4f} ms "
        f"(device {sum(r['dev_ms'] for r in win):.4f}); the bodies before, forced: "
        f"{sum(r['other_ms'] for r in win):.4f} ms (device {sum(r['other_dev_ms'] for r in win):.4f}); "
        f"sdpa {sum(r['library_ms'] for r in win):.4f} ms (device {sum(r['sdpa_dev_ms'] for r in win):.4f}); bound "
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


RUNNER_SLIDES, RUNNER_WH = 28, (4096, 3072)  # bench.py's seg_coords_synthetic corpus


def _runner_corpus():
    """bench.py's seg_coords_synthetic corpus: (stems, {stem: SyntheticWSI})."""
    from atlaspatch_tpu_torch.io.synthetic_wsi import SyntheticWSI, make_tissue_canvas

    canvases = [make_tissue_canvas(*RUNNER_WH, seed=s, n_blobs=3) for s in range(4)]
    stems = [f"slide{i:03d}" for i in range(RUNNER_SLIDES)]
    wsis = {stem: SyntheticWSI(path=f"/virtual/{stem}.svs", mpp=0.5, level0=canvases[i % 4], levels=3)
            for i, stem in enumerate(stems)}
    return stems, wsis


class _Loader:
    """The corpus's slides by stem, reopened fresh, timed as DefaultWSILoader times it."""

    def __init__(self, wsis):
        self.wsis = wsis

    def open(self, slide):
        from atlaspatch_tpu_torch.utils import perf

        with perf.stage("wsi_open"):
            wsi = self.wsis[slide.stem]
            wsi._loaded = False  # fresh open semantics
            return wsi


class _NullResolver:
    def resolve(self, slide):
        return None


def _thresholding_service(cfg):
    """The port's SAM2 service with bench.py's BenchSegmentation twist: the
    real device step runs and its masks are waited for, but extraction gets
    the thumbnail thresholded at < 220, since random-weight masks have no
    structure to extract patches from."""
    import numpy as np

    from atlaspatch_tpu_torch.core.models import Mask
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService

    class ThresholdingSegmentation(SAM2SegmentationService):
        def segment_thumbnails_async(self, thumbs):
            device_resolve = super().segment_thumbnails_async(thumbs)
            tissue = [(np.asarray(t.convert("L"), np.float32) < 220).astype(np.float32) for t in thumbs]

            def resolve():
                device_resolve()  # the real masks, fetched from the card
                return [Mask(data=m, source_shape=m.shape) for m in tissue]

            return resolve

    return ThresholdingSegmentation(cfg)


def phase_runner(state):
    """segment-and-get-coords through the port's ProcessingRunner: 28 synthetic
    slides in batches of 8 (pend depth 3 and the remainder batch both run) on
    the --fast preset, one atomic H5 per slide by the port's own writer, then
    a second run that must skip every slide."""
    import tempfile

    from atlaspatch_tpu_torch.core.config import SegmentationConfig

    stems, wsis = _runner_corpus()
    seg_cfg = SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
    seg = _thresholding_service(seg_cfg)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_runner_"))
    try:
        _drive_runner(state, seg, seg_cfg, stems, tmp, loader=_Loader(wsis), open_wsi=wsis.__getitem__,
                      what=f"{len(stems)} slides of {RUNNER_WH[0]}x{RUNNER_WH[1]}")
    finally:
        seg.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if state["runner_launches"] != 12 * state["runner_forwards"]:
        raise AssertionError(f"runner: {state['runner_launches']} kernel launches in "
                             f"{state['runner_forwards']} forwards, want 12 each")


def _drive_runner(state, seg, seg_cfg, stems, tmp, *, loader, open_wsi, what, in_dir=None, name="runner"):
    """One counted ProcessingRunner pass over ``stems`` (slides opened by
    ``loader``; ``open_wsi(stem)`` opens one again for the checks), its
    checks, and a skip pass. ``in_dir``: the slides' directory, else empty
    placeholders are written. Records ``<name>_launches``, ``_forwards``,
    ``_rate`` (slides/s) and ``_stages`` in ``state``."""
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.core.config import AppConfig, ExtractionConfig, OutputConfig, ProcessingConfig
    from atlaspatch_tpu_torch.core.paths import patch_h5_path
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.storage import H5PatchWriter
    from atlaspatch_tpu_torch.utils import perf
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    masks: dict = {}

    class RecordingExtraction(PatchExtractionService):
        def extract(self, wsi, mask, *, slide):
            masks[slide.stem] = mask
            return super().extract(wsi, mask, slide=slide)

    if in_dir is None:
        in_dir = tmp / "slides"
        in_dir.mkdir()
        for stem in stems:
            (in_dir / f"{stem}.svs").touch()  # discovery placeholders
    cfg = AppConfig(
        processing=ProcessingConfig(input_path=in_dir),
        segmentation=seg_cfg,
        extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
        output=OutputConfig(output_root=tmp / "out", skip_existing=True),
        device="cuda",
    )

    def runner():
        return ProcessingRunner(config=cfg, segmentation=seg,
                                extractor=RecordingExtraction(cfg.extraction, cfg.output),
                                visualizer=None, mpp_resolver=_NullResolver(), wsi_loader=loader)

    # warm-up outside the counted run: both batch sizes
    for n in (seg_cfg.batch_size, len(stems) % seg_cfg.batch_size):
        seg.segment_thumbnails_async(seg.prepare_thumbnails([open_wsi(s) for s in stems[:n]]))()
    torch.cuda.synchronize()

    order = [s.stem for s in runner().discover_slides()]  # the runner's batches, in order
    perf.reset()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    results, failures = runner().run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, variants = A.flash_attention.launches, dict(A.flash_attention.variant_launches)
    stages = perf.report()
    state.update({f"{name}_launches": launches, f"{name}_rate": len(stems) / wall_s, f"{name}_stages": stages})

    # the service runs one forward per thumbnail shape in each batch
    batch = seg_cfg.batch_size
    forwards = sum(len({masks[s].shape for s in order[i : i + batch] if s in masks})
                   for i in range(0, len(order), batch))
    shapes = trunk_attention_shapes(seg.predictor.model.cfg, seg_cfg.input_size, seg_cfg.batch_size)
    want = Counter()
    for _, _, tq, tk, d in shapes:
        want[A.kernel_variant(torch.bfloat16, tq, tk, d)] += forwards
    state[f"{name}_forwards"] = forwards
    if launches != len(shapes) * forwards or variants != dict(want):
        raise AssertionError(f"{name}: kernel launched {launches} times by variant {variants} in "
                             f"{forwards} forwards, want {len(shapes)} each: {dict(want)}")
    if failures or sorted(r.slide.stem for r in results) != sorted(stems):
        raise AssertionError(f"{name}: {len(results)} results, failures {failures}")

    extraction = PatchExtractionService(cfg.extraction, cfg.output)
    names = set(H5PatchWriter(chunk_rows=1, patch_size=1, patch_size_level0=1, level0_mag=1, target_mag=1,
                              level0_wh=(1, 1), overlap=0, slide_stem="x", wsi_path="x")._file_attrs())
    passport = re.compile(r"(.+)__x(\d+)_y(\d+)_rw(\d+)_rh(\d+)_lv(\d+)_mag(\w+)_tmag(\w+)_total(\d+)")
    counts, read_ms = [], []
    for res in results:
        stem, wsi = res.slide.stem, open_wsi(res.slide.stem)
        path = patch_h5_path(res.slide, cfg.output, cfg.extraction)
        if res.h5_path != path:
            raise AssertionError(f"{name}: {stem} written to {res.h5_path}, want {path}")
        t1 = time.perf_counter()
        datasets, attrs = read_h5(path)
        read_ms.append(1e3 * (time.perf_counter() - t1))
        entries = extraction._iter_patch_entries(wsi, *extraction._prepare_contours(masks[stem], wsi),
                                                 include_patch=False)
        want_coords = np.asarray([e[:5] for e in entries], dtype=np.int32).reshape(-1, 5)
        coords = datasets["coords"]
        n = coords.shape[0]
        if coords.dtype != np.int32 or coords.tobytes() != want_coords.tobytes():
            raise AssertionError(f"{name}: {stem} coords differ from its extraction's rows")
        if attrs["num_patches"] != n or res.num_patches != n:
            raise AssertionError(f"{name}: {stem} num_patches {attrs['num_patches']} for {n} rows")
        missing = (names | {"num_patches"}) - set(attrs)
        if missing:
            raise AssertionError(f"{name}: {stem} lacks file attrs {sorted(missing)}")
        for row, text in zip(coords, datasets["passports"]):
            m = passport.fullmatch(text.decode("ascii"))
            if not m or m.group(1) != stem or [int(g) for g in m.groups()[1:6]] != row.tolist() \
                    or int(m.group(9)) != n:
                raise AssertionError(f"{name}: {stem} passport {text!r} does not parse to {row}")
        counts.append(n)
    if not max(counts) > 0:
        raise AssertionError(f"{name}: no slide has a patch")
    leftovers = [p.name for p in (tmp / "out" / "patches").iterdir() if not p.name.endswith(".h5")]
    if leftovers or len(list((tmp / "out" / "patches").glob("*.h5"))) != len(stems):
        raise AssertionError(f"{name}: lock or stage files left behind: {leftovers}")

    # the skip pass: same output, skip_existing, nothing launched or rewritten
    mtimes = {p: p.stat().st_mtime_ns for p in (tmp / "out" / "patches").iterdir()}
    A.reset_launch_counts()
    results2, failures2 = runner().run()
    torch.cuda.synchronize()
    if results2 or failures2 or A.flash_attention.launches:
        raise AssertionError(f"{name}: the skip pass gave {len(results2)} results, {failures2}, "
                             f"{A.flash_attention.launches} kernel launches")
    if {p: p.stat().st_mtime_ns for p in (tmp / "out" / "patches").iterdir()} != mtimes:
        raise AssertionError(f"{name}: the skip pass rewrote files")

    h5 = stages.get("h5_write", {})
    slowest = max(stages, key=lambda k: stages[k]["total_s"])
    log(f"{name} {what} (--fast bf16 768 batch 8, "
        f"patch 256 at 20x): {wall_s:.3f} s = {len(stems) / wall_s:.2f} slides/s by host clock; "
        f"kernel launches {launches} in {forwards} forwards, by variant {variants}; patches per slide "
        f"{counts} [{state['card']}]")
    log(f"{name} h5 write {h5.get('mean_ms', float('nan')):.3f} ms per slide (cpu "
        f"{1e3 * h5.get('cpu_s', 0) / max(1, h5.get('count', 1)):.3f} ms), read_h5 back "
        f"{np.mean(read_ms):.3f} ms per slide; the stage that takes most host time: {slowest} "
        f"[{state['card']}]")
    log(f"{name} stages " + json.dumps(stages) + f" [{state['card']}]")
    if slowest == "h5_write":
        raise AssertionError(f"{name}: the H5 writer is the slowest stage: {stages}")
    log(f"{name} skip pass: 0 results, 0 failures, 0 kernel launches, no file rewritten")


# The tiff phase's corpus, written on the card's host by the repo's own
# writers (tests/tiff_builder.py, tests/container_builders.py):
# (f1) bench.py's write_tiff_corpus setting (bench.py:251-274), (f2) one
# slide of a 20x biopsy scan's size, (f3) one slide of each other container.
TIFF_SLIDES, TIFF_WH = 28, (4096, 3072)
BIG_WH, CONTAINER_WH = (16384, 12288), (2048, 1536)
APERIO_DESC = "Aperio Image Library v12\r\n{}x{} | AppMag = 20 | MPP = 0.5"
EMBED_CHECK_PATCHES = 64


def _builders():
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import container_builders
    import tiff_builder

    return tiff_builder, container_builders


def _write_svs(path: str, wh, seed: int, levels: int) -> str:
    """A JPEG-tiled Aperio pyramid (tile 256, compression 7) of a
    make_tissue_canvas canvas (runs in a worker process)."""
    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    tiff_builder, _ = _builders()
    tiff_builder.write_pyramid(path, make_tissue_canvas(*wh, seed=seed, n_blobs=3), levels=levels, tile=256,
                               compression=7, description=APERIO_DESC.format(*wh))
    return path


def _zero_sof_dims(jpeg: bytes) -> bytes:
    """Zero the JPEG SOF height and width, as NDPI writers do past 65,535 px."""
    data = bytearray(jpeg)
    i = data.find(b"\xff\xc0")
    data[i + 5 : i + 9] = b"\x00\x00\x00\x00"
    return bytes(data)


def _write_containers(d: str) -> dict:
    """(f3): an NDPI (a single-strip restart-marker JPEG of zeroed SOF
    dimensions at 20x, a 5x level), a 3-level MIRAX, a 2x2 Hamamatsu VMS, a
    VMU and a 2-level DICOM series with a label instance; {stem: path}."""
    import io

    from PIL import Image

    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    tiff_builder, cb = _builders()
    d = Path(d)
    w, h = CONTAINER_WH
    canvas = {k: make_tissue_canvas(w, h, seed=200 + i, n_blobs=3)
              for i, k in enumerate(("ndpi", "mirax", "vms", "vmu", "dicom"))}
    ndpi = [(65420, tiff_builder.TYPE_LONG, [1]), (65421, tiff_builder.TYPE_FLOAT, [20.0])]
    buf = io.BytesIO()
    Image.fromarray(canvas["ndpi"]).save(buf, "JPEG", quality=90, subsampling=0, restart_marker_rows=1)
    writer = tiff_builder.TiffWriter()
    writer.add_level_raw_strips([_zero_sof_dims(buf.getvalue())], width=w, height=h, rows_per_strip=h,
                                extra_tags=ndpi, resolution=(20000.0, 20000.0, 3))
    writer.add_level(canvas["ndpi"][::4, ::4].copy(),
                     extra_tags=[ndpi[0], (65421, tiff_builder.TYPE_FLOAT, [5.0])])
    writer.save(d / "ndpi.ndpi")
    cb.write_mirax(d / "mirax.mrxs", canvas["mirax"], tile_w=256, tile_h=192, n_levels=3, mpp=0.5, objective=20)
    cb.write_vms(d / "vms.vms", canvas["vms"], cols=2, rows=2, mpp=0.5, lens=20)
    cb.write_vmu(d / "vmu.vmu", canvas["vmu"], column_width=256, mpp=0.5, lens=20)
    base = cb.write_dicom_pyramid(d, canvas["dicom"], n_levels=2, tile=256, mpp=0.5)
    return {"ndpi": d / "ndpi.ndpi", "mirax": d / "mirax.mrxs", "vms": d / "vms.vms", "vmu": d / "vmu.vmu",
            base.stem: base}


def _write_j2k(path: str) -> str:
    """An Aperio 33003 (YCbCr J2K) level of 512x512, tile 256."""
    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    tiff_builder, _ = _builders()
    ycc = tiff_builder.rgb_to_full_range_ycbcr(make_tissue_canvas(512, 512, seed=300, n_blobs=2))
    tiff_builder.write_pyramid(path, ycc, levels=1, tile=256, compression=33003)
    return path


def _write_tiff_corpus(root: Path) -> dict:
    """Write the corpus with one spawned process per distinct file; the other
    24 (f1) slides are byte copies of the four canvases' files, as
    write_pyramid would write them again."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    f1, f3, big = root / "f1", root / "f3", root / "big"
    for d in (f1, f3, big):
        d.mkdir()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=7, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {
            "big": pool.submit(_write_svs, str(big / "big.svs"), BIG_WH, 400, 4),
            "f1": [pool.submit(_write_svs, str(f1 / f"tslide{s:03d}.svs"), TIFF_WH, 100 + s, 3) for s in range(4)],
            "f3": pool.submit(_write_containers, str(f3)),
            "j2k": pool.submit(_write_j2k, str(root / "j2k.svs")),
        }
        f3_paths = jobs["f3"].result()
        big_path = Path(jobs["big"].result())
        for job in jobs["f1"]:
            job.result()
        j2k = Path(jobs["j2k"].result())
    for i in range(4, TIFF_SLIDES):
        shutil.copyfile(f1 / f"tslide{i % 4:03d}.svs", f1 / f"tslide{i:03d}.svs")
    # one runner input: the (f1) slides and the (f3) containers side by side
    slides = root / "slides"
    slides.mkdir()
    paths = {}
    for src in sorted(f1.iterdir()) + sorted(f3.iterdir()):
        (slides / src.name).symlink_to(src)
    for stem, src in f3_paths.items():
        paths[stem] = slides / Path(src).name
    for i in range(TIFF_SLIDES):
        paths[f"tslide{i:03d}"] = slides / f"tslide{i:03d}.svs"
    size = j2k.stat().st_size + sum(p.stat().st_size for d in (f1, f3, big) for p in d.rglob("*") if p.is_file())
    return {"slides": slides, "paths": paths, "big": big_path, "j2k": j2k, "write_s": time.perf_counter() - t0,
            "bytes": size}


def _mapped(marker: str) -> list[str]:
    """The shared objects mapped into this process whose path contains ``marker``."""
    paths = {line.split()[-1] for line in Path("/proc/self/maps").read_text().splitlines()
             if marker in line and line.split()[-1].startswith("/")}
    return sorted(paths) or ["none"]


def _turbo_version(library: str) -> str:
    """The version string libjpeg-turbo embeds in its shared object."""
    try:
        m = re.search(rb"libjpeg-turbo version [0-9.]+", Path(library).read_bytes())
    except OSError:
        return "unreadable"
    return m.group(0).decode() if m else "not found"


def _tiff_probe(state, corpus):
    """How the decoder was built and what it loaded, then the decoder against
    Pillow's decode of the same bytes on this host."""
    import numpy as np

    from atlaspatch_tpu_torch.io import native
    from atlaspatch_tpu_torch.io.factory import WSIFactory
    from atlaspatch_tpu_torch.tools.pillow_check import j2k_ycbcr_tile, tiled_region

    info = native.tiff_library_info()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout.splitlines()[0]
    ldd = subprocess.run(["ldd", info["library"]], capture_output=True, text=True).stdout
    header_dir = info["jpeg_headers"]
    defines = (Path(header_dir) / "jconfig.h").read_text()
    header_version = re.search(r"#define LIBJPEG_TURBO_VERSION\s+(\S+)", defines)
    log(f"tiff probe: {gxx}; libjpeg headers {header_dir} (LIBJPEG_TURBO_VERSION "
        f"{header_version.group(1) if header_version else 'absent'}); linked {info['libjpeg']}; "
        f"libopenjp2 tried after the system sonames: {info['openjp2_fallback'] or 'none'}")
    log("tiff probe: ldd " + info["library"] + "\n" + "\n".join("  " + ln.strip() for ln in ldd.splitlines()))
    linked = re.search(r"libjpeg\S* => (\S+)", ldd)

    # decoder vs Pillow: a level-0 region and the thumbnail of an (f1) slide,
    # one 33003 J2K tile; the bar is tests/test_torch_native_tiff.py's: max-abs 0.
    # Both sides decode JPEG with the same libjpeg here (Pillow's bundled one).
    svs = corpus["paths"]["tslide000"]
    wsi = WSIFactory.load(str(svs))
    f = native.AtlasTiffFile(str(svs))
    checks = {
        "level-0 region 512x512 at (256, 256)": (f.read_region_level(0, 256, 256, 512, 512),
                                                 tiled_region(svs, 0, 256, 256, 512, 512)),
        "thumbnail at 1.25x, IDCT 1/4 (the --fast path)": (
            np.asarray(wsi.get_thumbnail_at_power(power=1.25, scaled_decode=True)),
            tiled_region(svs, 2, 0, 0, TIFF_WH[0] // 4, TIFF_WH[1] // 4, scale=4)),
        "33003 J2K tile 256x256": (native.AtlasTiffFile(str(corpus["j2k"])).read_region_level(0, 256, 0, 256, 256),
                                   j2k_ycbcr_tile(corpus["j2k"], 0, 1)),
    }
    f.close()
    wsi.cleanup()
    for label, (got, want) in checks.items():
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        log(f"tiff decoder vs Pillow, {label}: shape {got.shape}, max-abs {int(diff.max())}, "
            f"mean-abs {float(diff.mean()):.6f}")
        if got.shape != want.shape or diff.max() != 0:
            raise AssertionError(f"tiff: the native decoder differs from Pillow on the {label}")
    jpeg = linked.group(1) if linked else "unresolved"
    log(f"tiff probe: the decoder's libjpeg {jpeg} ({_turbo_version(jpeg)}); libjpeg mapped {_mapped('libjpeg')}; "
        f"libopenjp2 mapped after J2K decodes {_mapped('openjp2')} [{state['card']}]")


def phase_tiff(state):
    """segment-and-get-coords and process from slide files on disk, through
    DefaultWSILoader, the factory and the native decoders."""
    import tempfile

    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.core.models import Slide
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tiff_"))
    seg = None
    try:
        corpus = _write_tiff_corpus(tmp)
        log(f"tiff corpus: {TIFF_SLIDES} JPEG SVS of {TIFF_WH[0]}x{TIFF_WH[1]} (f1), one of "
            f"{BIG_WH[0]}x{BIG_WH[1]} (f2), NDPI, MIRAX, VMS, VMU and a DICOM series of "
            f"{CONTAINER_WH[0]}x{CONTAINER_WH[1]} (f3): {corpus['bytes'] / 2**20:.1f} MiB written in "
            f"{corpus['write_s']:.1f} s")
        _tiff_probe(state, corpus)
        seg_cfg = SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
        seg = _thresholding_service(seg_cfg)
        loader = DefaultWSILoader()
        paths = corpus["paths"]
        stems = sorted(paths)
        _drive_runner(state, seg, seg_cfg, stems, tmp / "runner", loader=loader,
                      open_wsi=lambda stem: loader.open(Slide(path=paths[stem])), in_dir=corpus["slides"],
                      what=f"{len(stems)} slide files (f1 + f3)", name="tiff")
        stages = state["tiff_stages"]
        per_slide = {k: stages[k]["mean_ms"] for k in ("wsi_open", "thumbnail", "contours", "grid_scan", "h5_write")
                     if k in stages}
        log(f"tiff runner: {state['tiff_rate']:.2f} slides/s from files vs {state['runner_rate']:.2f} "
            f"slides/s on the runner phase's in-memory slides; per-slide stage ms {json.dumps(per_slide)} "
            f"[{state['card']}]")
        _tiff_process(state, seg, seg_cfg, corpus, tmp)
    finally:
        if seg is not None:
            seg.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if state["tiff_launches"] != 12 * state["tiff_forwards"]:
        raise AssertionError(f"tiff: {state['tiff_launches']} kernel launches in {state['tiff_forwards']} forwards")


def _tiff_process(state, seg, seg_cfg, corpus, tmp):
    """(f2) and two (f1) slides through the runner and embed_all (vit_l_16,
    bfloat16, batch 32): patches read by the native decoder."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.core.config import (
        AppConfig, ExtractionConfig, FeatureExtractionConfig, OutputConfig, ProcessingConfig,
    )
    from atlaspatch_tpu_torch.core.models import Slide
    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader
    from atlaspatch_tpu_torch.utils import perf
    from atlaspatch_tpu_torch.utils.h5 import read_h5_tree

    in_dir = tmp / "process_slides"
    in_dir.mkdir()
    for src in (corpus["big"], corpus["paths"]["tslide000"], corpus["paths"]["tslide001"]):
        (in_dir / src.name).symlink_to(src)
    loader = DefaultWSILoader()
    big = Slide(path=in_dir / corpus["big"].name)

    # (f2)'s thumbnail on a fresh open, as the --fast service reads it
    t0 = time.perf_counter()
    fresh = loader.open(big)
    thumb = seg.prepare_thumbnails([fresh])[0]
    thumb_ms = 1e3 * (time.perf_counter() - t0)
    fresh.cleanup()

    def run(out):
        cfg = AppConfig(
            processing=ProcessingConfig(input_path=in_dir), segmentation=seg_cfg,
            extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
            output=OutputConfig(output_root=out, skip_existing=True),
            features=FeatureExtractionConfig(extractors=["vit_l_16"], batch_size=32, device="cuda",
                                             precision="bfloat16"),
            device="cuda",
        )
        runner = ProcessingRunner(config=cfg, segmentation=seg,
                                  extractor=PatchExtractionService(cfg.extraction, cfg.output),
                                  visualizer=None, mpp_resolver=_NullResolver(), wsi_loader=loader)
        results, failures = runner.run()
        if failures or len(results) != 3:
            raise AssertionError(f"tiff process: the runner gave {len(results)} results, {failures}")
        return cfg, sorted(results, key=lambda r: r.slide.stem)

    def embed(cfg, results):
        svc = PatchFeatureEmbeddingService(cfg.extraction, cfg.output, cfg.features)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fails = svc.embed_all(results, wsi_loader=loader)
        torch.cuda.synchronize()
        if fails:
            raise AssertionError(f"tiff process: embed_all failed: {fails}")
        return time.perf_counter() - t1

    cfg, results = run(tmp / "process_out")
    perf.reset()
    embed_s = embed(cfg, results)
    stages = perf.report()
    total = sum(r.num_patches for r in results)
    res_big = next(r for r in results if r.slide.stem == big.path.stem)
    tree = read_h5_tree(res_big.h5_path)
    coords, feats = tree.datasets["coords"], tree.datasets.get("features/vit_l_16")
    if feats is None or feats.shape != (res_big.num_patches, 1024) or not np.isfinite(feats).all():
        raise AssertionError(f"tiff process: (f2) features {None if feats is None else feats.shape}")

    # (f2)'s coordinates against the port's geometry on the CPU over the same
    # reader's thumbnail, thresholded on the host as the service's masks are
    wsi = loader.open(big)
    mask = (np.asarray(seg.prepare_thumbnails([wsi])[0].convert("L"), np.float32) < 220).astype(np.float32)
    extraction = PatchExtractionService(cfg.extraction, cfg.output)
    entries = extraction._iter_patch_entries(wsi, *extraction._prepare_contours(mask, wsi), include_patch=False)
    cpu_coords = np.asarray([e[:5] for e in entries], dtype=np.int32).reshape(-1, 5)
    if cpu_coords.tobytes() != coords.tobytes():
        raise AssertionError(f"tiff process: (f2) coordinates {coords.shape} differ from the CPU geometry's "
                             f"{cpu_coords.shape}")

    # 64 of (f2)'s features against extract_batch on the same patches read by wsi.extract
    pick = np.linspace(0, len(coords) - 1, EMBED_CHECK_PATCHES).astype(int)
    direct = [wsi.extract((int(x), int(y)), lv=int(lv), wh=(int(rw), int(rh)), mode="array")
              for x, y, rw, rh, lv in coords[pick]]
    ext = build_default_registry(device="cuda", dtype="bfloat16").create("vit_l_16")
    want = ext.extract_batch(direct, batch_size=32)
    ext.cleanup()
    cos = _cos_rows(feats[pick], want)
    if not cos.min() > 0.999:
        raise AssertionError(f"tiff process: (f2) features vs extract_batch per-row cosine {cos.min()}")
    wsi.cleanup()

    # the device's busy share over embed_all: the same work again, under the profiler
    cfg2, results2 = run(tmp / "process_out_profiled")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        embed(cfg2, results2)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    if busy_us == 0:
        raise AssertionError("tiff process: the profiler recorded no device time")
    read = stages.get("patch_read", {})
    log(f"tiff process (f2) {BIG_WH[0]}x{BIG_WH[1]}: thumbnail {thumb_ms:.1f} ms on a fresh open "
        f"({thumb.size[0]}x{thumb.size[1]}), {res_big.num_patches} patches; coordinates equal the CPU geometry's "
        f"over the same thumbnail; {EMBED_CHECK_PATCHES} features vs extract_batch on wsi.extract reads: "
        f"per-row cosine min {cos.min():.6f} [{state['card']}]")
    log(f"tiff process embed_all over (f2) + 2 (f1): {total} patches in {embed_s:.3f} s = {total / embed_s:.1f} "
        f"patches/s by host clock; patch_read {1e3 * read.get('total_s', 0) / max(1, total):.3f} ms per patch "
        f"({read.get('count', 0)} blocks); device busy {busy_us / 1e3:.1f} ms = "
        f"{100 * busy_us / 1e6 / embed_s:.1f}% of embed_all [{state['card']}]")
    log("tiff process stages " + json.dumps(stages))


EMBED_PATCHES, EMBED_PASSES = 512, 3  # bench.py's bench_embed_vitl setting


def vit_flops_per_patch(spec) -> float:
    """FLOPs of one ViT forward per image: the patch-embed convolution, and per
    block the qkv, projection and MLP products and QK^T and PV (2 per MAC)."""
    n = spec.tokens
    t = n + spec.prefix_tokens
    d, hidden = spec.dim, spec.hidden_dim
    block = t * (3 * d * d + d * d + 2 * d * hidden) + 2 * t * t * d
    return 2.0 * (n * 3 * spec.patch_size**2 * d + spec.depth * block)


def _cos_rows(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _timed_passes(ext, patches, batch, passes=EMBED_PASSES):
    """One warm pass, then ``passes`` timed ones: (median s, stage report of the timed ones)."""
    import statistics

    import torch

    from atlaspatch_tpu_torch.utils import perf

    ext.extract_batch(patches, batch_size=batch)
    torch.cuda.synchronize()
    perf.reset()
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        out = ext.extract_batch(patches, batch_size=batch)
        times.append(time.perf_counter() - t0)
    assert out.shape == (len(patches), ext.embedding_dim)
    return statistics.median(times), perf.report()


def phase_embed(state):
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor
    from atlaspatch_tpu_torch.models.encoders.vit import ViT, init_vit_
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES

    entry = ENTRIES["vit_l_16"]
    spec = entry.spec
    if (spec.dim, spec.depth, spec.heads, spec.img_size, spec.patch_size) != (1024, 24, 16, 224, 16):
        raise AssertionError(f"vit_l_16 is not at full width: {spec}")
    rng = np.random.default_rng(0)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(EMBED_PATCHES)]

    # float32 at full width, depth 2: the card (built with TF32 on, which the
    # engine must turn off) against the CPU on the same weights
    shallow = init_vit_(ViT(dataclasses.replace(spec, depth=2)), seed=0)
    cpu = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                model=copy.deepcopy(shallow), device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    card = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                 model=shallow, device="cuda")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the float32 extractor left TF32 on")
    f32_err = float(np.abs(card.extract_batch(patches[:4]) - cpu.extract_batch(patches[:4])).max())
    if not f32_err <= 1e-4:
        raise AssertionError(f"embed: float32 card vs CPU at depth 2 differ by {f32_err}")
    card.cleanup()
    del cpu, card, shallow

    # the full model from the registry, float32 and bfloat16 (same seed, same weights)
    t0 = time.perf_counter()
    f32 = build_default_registry(device="cuda", dtype="float32").create("vit_l_16")
    bf16 = build_default_registry(device="cuda", dtype="bfloat16").create("vit_l_16")
    build_s = time.perf_counter() - t0
    params = list(bf16.model.parameters())
    if not params or not all(p.dtype == torch.bfloat16 and p.is_cuda for p in params):
        raise AssertionError("embed: a param of the bfloat16 extractor is not bfloat16 on the card")
    w32, w16 = f32.model.blocks[0].attn.qkv.weight, bf16.model.blocks[0].attn.qkv.weight
    if not torch.equal(w32.to(torch.bfloat16), w16):
        raise AssertionError("embed: the float32 and bfloat16 extractors hold different weights")
    ref = f32.extract_batch(patches[:16])
    got = bf16.extract_batch(patches[:16])
    cos = _cos_rows(ref, got)
    if not (np.isfinite(got).all() and got.shape == (16, 1024) and cos.min() > 0.995):
        raise AssertionError(f"embed: bf16 vs float32 per-row cosine {cos.min()}")
    f32.cleanup()
    del f32
    log(f"embed vit_l_16 (dim 1024, depth 24, 16 heads, 224 px, patch 16; random weights, two "
        f"registry builds {build_s:.1f} s): float32 card vs CPU at depth 2 max-abs {f32_err:.3g} (<= 1e-4, "
        f"TF32 off); bf16 vs float32 on 16 patches per-row cosine min {cos.min():.6f} (> 0.995); "
        f"{len(params)} params all bfloat16 on the card")

    flops = vit_flops_per_patch(spec)
    bound_pps = H100_PEAK_FLOPS["bfloat16"] / flops
    torch.cuda.reset_peak_memory_stats()
    rates = {}
    for batch in (32, 256):
        med_s, stages = _timed_passes(bf16, patches, batch)
        rates[batch] = len(patches) / med_s
        log(f"embed extract_batch {len(patches)} patches at batch {batch}: median {med_s:.4f} s of "
            f"{EMBED_PASSES} = {rates[batch]:.1f} patches/s ({100 * rates[batch] / bound_pps:.1f}% of the "
            f"{bound_pps:.0f} patches/s bf16 bound) [{state['card']}]")
        log(f"embed stages at batch {batch} (3 passes) " + json.dumps(stages))
    for batch in (32, 256):
        u8 = torch.from_numpy(np.stack([entry.preprocess.apply_host(p) for p in patches[:batch]])).cuda()
        ms = cuda_ms(lambda: bf16.forward_device(u8), min_total_ms=300.0)
        rates[f"resident_{batch}"] = 1e3 * batch / ms
        log(f"embed resident forward at batch {batch}: {ms:.3f} ms = {rates[f'resident_{batch}']:.1f} "
            f"patches/s ({100 * rates[f'resident_{batch}'] / bound_pps:.1f}% of the bf16 bound; "
            f"{flops / 1e9:.2f} GFLOP per patch) [{state['card']}]")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    wall_s, _ = _timed_passes(bf16, patches, 32, passes=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bf16.extract_batch(patches, batch_size=32)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us == 0:
        raise AssertionError("embed: the profiler recorded no device time")
    rows.sort(key=lambda e: -e.self_device_time_total)
    log(f"embed profile: one extract_batch of {len(patches)} at batch 32, {1e3 * wall_s:.1f} ms host clock "
        f"(without the profiler), device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall_s:.1f}%); "
        f"peak memory allocated {peak_gib:.2f} GiB [{state['card']}]")
    for e in rows[:10]:
        us = e.self_device_time_total
        log(f"embed profile   {us / 1e3:8.2f} ms {100 * us / busy_us:5.1f}% x{e.count:<5d} {e.key[:100]}")
    bf16.cleanup()
    state["embed"] = dict(rates, bound_pps=bound_pps, busy=busy_us / 1e6 / wall_s)


def phase_process(state):
    """process below the CLI: the runner phase's slides through
    ProcessingRunner.run() and then embed_all with vit_l_16 in bfloat16, as the
    JAX CLI composes them (atlaspatch_tpu/cli.py:313-347)."""
    import tempfile

    from atlaspatch_tpu_torch.core.config import SegmentationConfig

    stems, wsis = _runner_corpus()
    seg_cfg = SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
    seg = _thresholding_service(seg_cfg)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_process_"))
    try:
        _drive_process(state, seg, seg_cfg, wsis, stems, tmp)
    finally:
        seg.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _drive_process(state, seg, seg_cfg, wsis, stems, tmp):
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.core.config import (
        AppConfig, ExtractionConfig, FeatureExtractionConfig, OutputConfig, ProcessingConfig,
    )
    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
    from atlaspatch_tpu_torch.utils import perf
    from atlaspatch_tpu_torch.utils.h5 import read_h5, read_h5_tree

    in_dir = tmp / "slides"
    in_dir.mkdir()
    for stem in stems:
        (in_dir / f"{stem}.svs").touch()
    out = tmp / "out"

    def config(extractors):
        return AppConfig(
            processing=ProcessingConfig(input_path=in_dir),
            segmentation=seg_cfg,
            extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
            output=OutputConfig(output_root=out, skip_existing=True),
            features=FeatureExtractionConfig(extractors=extractors, batch_size=32, device="cuda",
                                             precision="bfloat16"),
            device="cuda",
        )

    def run_process(cfg):
        runner = ProcessingRunner(config=cfg, segmentation=seg,
                                  extractor=PatchExtractionService(cfg.extraction, cfg.output),
                                  visualizer=None, mpp_resolver=_NullResolver(), wsi_loader=_Loader(wsis))
        results, failures = runner.run()
        torch.cuda.synchronize()
        if failures or len(results) != len(stems):
            raise AssertionError(f"process: the runner gave {len(results)} results, {failures}")
        before = {r.slide.stem: read_h5(r.h5_path) for r in results}
        svc = PatchFeatureEmbeddingService(cfg.extraction, cfg.output, cfg.features)
        perf.reset()
        t0 = time.perf_counter()
        fails = svc.embed_all(results, wsi_loader=_Loader(wsis))
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        if fails:
            raise AssertionError(f"process: embed_all failed: {fails}")
        return sorted(results, key=lambda r: r.slide.stem), before, embed_s, perf.report()

    def features_of(results, name):
        got = {}
        for res in results:
            tree = read_h5_tree(res.h5_path)
            feats = tree.datasets.get(f"features/{name}")
            if feats is None or feats.shape != (res.num_patches, 1024 if name == "vit_l_16" else 768) \
                    or feats.dtype != np.float32 or not np.isfinite(feats).all():
                raise AssertionError(f"process: {res.slide.stem} features/{name} is "
                                     f"{None if feats is None else (feats.shape, feats.dtype)}")
            if tree.dataset_attrs.get(f"features/{name}") != {"name": name,
                                                              "embedding_dim": feats.shape[1]}:
                raise AssertionError(f"process: {res.slide.stem} features/{name} attrs "
                                     f"{tree.dataset_attrs.get(f'features/{name}')}")
            got[res.slide.stem] = (tree, feats)
        return got

    def unchanged(results, before, trees):
        for res in results:
            (old_data, old_attrs), tree = before[res.slide.stem], trees[res.slide.stem][0]
            for key, arr in old_data.items():
                if tree.datasets[key].tobytes() != arr.tobytes() or tree.datasets[key].dtype != arr.dtype:
                    raise AssertionError(f"process: {res.slide.stem} {key} changed by the append")
            if set(tree.attrs) != set(old_attrs) or any(
                    type(tree.attrs[k]) is not type(v) or tree.attrs[k] != v for k, v in old_attrs.items()):
                raise AssertionError(f"process: {res.slide.stem} file attrs changed by the append")

    patches_dir = out / "patches"
    A.reset_launch_counts()
    t0 = time.perf_counter()
    results, before, embed_s, stages = run_process(config(["vit_l_16"]))
    wall_s = time.perf_counter() - t0
    launches = A.flash_attention.launches
    state["process_launches"] = launches
    forwards = -(-len(stems) // seg_cfg.batch_size)
    if launches != 12 * forwards:
        raise AssertionError(f"process: {launches} kernel launches in {forwards} segmentation forwards")
    trees = features_of(results, "vit_l_16")
    unchanged(results, before, trees)
    if any(r.metadata.get("feature_sets") != ["vit_l_16"] for r in results):
        raise AssertionError(f"process: feature_sets {[r.metadata.get('feature_sets') for r in results]}")
    leftovers = [p.name for p in patches_dir.iterdir() if not p.name.endswith(".h5")]
    if leftovers:
        raise AssertionError(f"process: lock or stage files left behind: {leftovers}")
    total = sum(r.num_patches for r in results)
    if not total:
        raise AssertionError("process: no patch to embed")

    # one slide's features against extract_batch on its patches read directly
    probe = max(results, key=lambda r: r.num_patches)
    wsi = wsis[probe.slide.stem]
    coords = trees[probe.slide.stem][0].datasets["coords"]
    direct = [wsi.extract((int(x), int(y)), lv=int(lv), wh=(int(rw), int(rh)), mode="array")
              for x, y, rw, rh, lv in coords]
    if any(p.shape[:2] != (256, 256) for p in direct):
        import cv2

        direct = [p if p.shape[:2] == (256, 256) else cv2.resize(p, (256, 256)) for p in direct]
    ext = build_default_registry(device="cuda", dtype="bfloat16").create("vit_l_16")
    want = ext.extract_batch(direct, batch_size=32)
    ext.cleanup()
    got = trees[probe.slide.stem][1]
    cos = _cos_rows(got, want)
    if not cos.min() > 0.999:
        raise AssertionError(f"process: {probe.slide.stem} features vs extract_batch per-row cosine {cos.min()}")
    probe_err = float(np.abs(got - want).max())

    # a second embed_all: nothing to do, no file rewritten
    mtimes = {p: p.stat().st_mtime_ns for p in patches_dir.iterdir()}
    cfg = config(["vit_l_16"])
    perf.reset()
    svc = PatchFeatureEmbeddingService(cfg.extraction, cfg.output, cfg.features)
    if svc.embed_all(results, wsi_loader=_Loader(wsis)):
        raise AssertionError("process: the second embed_all failed")
    again = perf.report()
    if any(k.startswith("embed_") or k == "h5_append" for k in again):
        raise AssertionError(f"process: the second embed_all ran {again}")
    if {p: p.stat().st_mtime_ns for p in patches_dir.iterdir()} != mtimes:
        raise AssertionError("process: the second embed_all rewrote files")

    # one more encoder: the runner reuses every slide's coordinates, only vit_b_16 is embedded
    A.reset_launch_counts()
    results2, before2, _, stages2 = run_process(config(["vit_l_16", "vit_b_16"]))
    if A.flash_attention.launches:
        raise AssertionError(f"process: the reuse pass segmented ({A.flash_attention.launches} launches)")
    trees2 = features_of(results2, "vit_b_16")
    unchanged(results2, before2, trees2)
    for res in results2:
        if trees2[res.slide.stem][0].datasets["features/vit_l_16"].tobytes() != trees[res.slide.stem][1].tobytes():
            raise AssertionError(f"process: {res.slide.stem} vit_l_16 re-embedded")
        if res.metadata.get("feature_sets") != ["vit_b_16", "vit_l_16"]:
            raise AssertionError(f"process: feature_sets {res.metadata.get('feature_sets')}")
    if stages2.get("h5_append", {}).get("count") != len(stems):
        raise AssertionError(f"process: the reuse pass appended {stages2.get('h5_append')}")

    append = stages.get("h5_append", {})
    log(f"process {len(stems)} slides, {total} patches: runner + embed_all {wall_s:.3f} s, embed_all "
        f"{embed_s:.3f} s = {total / embed_s:.1f} patches/s (vit_l_16 bf16 batch 32) by host clock; "
        f"{launches} attention kernel launches in {forwards} segmentation forwards [{state['card']}]")
    log(f"process h5 append {append.get('mean_ms', float('nan')):.3f} ms per slide (cpu "
        f"{1e3 * append.get('cpu_s', 0) / max(1, append.get('count', 1)):.3f} ms); {probe.slide.stem} "
        f"({probe.num_patches} patches) vs extract_batch read directly: per-row cosine min {cos.min():.6f}, "
        f"max-abs {probe_err:.3g} [{state['card']}]")
    log("process stages " + json.dumps(stages) + f" [{state['card']}]")
    log("process second embed_all: no forward, no file rewritten; reuse pass with vit_b_16: 0 "
        f"segmentation launches, {len(stems)} appends of vit_b_16 only; stages " + json.dumps(stages2))


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
                        ("seg", phase_seg), ("profile", phase_profile), ("coords", phase_coords),
                        ("runner", phase_runner), ("tiff", phase_tiff), ("embed", phase_embed),
                        ("process", phase_process)):
        t0 = time.perf_counter()
        try:
            phase(state)
        except BaseException as e:  # noqa: BLE001 — report the phase, then fail
            print(f"phase {name} FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            raise
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    record = dict(state["kernel_record"], launches=state["launches"], runner_launches=state["runner_launches"],
                  tiff_launches=state["tiff_launches"], process_launches=state["process_launches"])
    keys = ("name", "route", "source", "sources", "replaces", "launches", "runner_launches", "tiff_launches",
            "process_launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}))
    print(state["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
