"""Time the 3xTF32 attention body against variants that undo one design choice each.

    python3 -m atlaspatch_tpu_torch.tools.tf32x3_variants

Builds ``csrc/flash_attn.cu`` (head dim 96 only) once per entry of VARIANTS,
each the committed source with a few lines replaced, all in parallel. Each
build is launched as the ``tf32x3`` body at the float32 default's shapes (the
global block, the stage-2, stage-0 and stage-3 windows) and timed by CUDA
events in two rounds, forward and reverse order, beside the FMA body and
``F.scaled_dot_product_attention``. Each line gives the build's registers and
spills at D = 96, the count in its SASS of TF32 HMMA and of the compares and
selects that cvt.rna.tf32.f32 turns into, its times, and its max err /
``f32_error_limit`` at the global block for scale D^-1/2 and -0.125 (the two
ceilings compute something else and read far over). Needs an NVIDIA Hopper
card and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from atlaspatch_tpu_torch.build import BUILD_DIR, CSRC, build_log, build_shared_library, nvcc_path
from atlaspatch_tpu_torch.ops import attention as A

_SPLIT = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_GROUPS = "constexpr int kTf32PvGroups = 2;"
# variant -> (text of the committed source, its replacement) pairs
VARIANTS = {
    "committed": [],
    "split by cvt.rna.tf32.f32": [
        (_SPLIT, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;'),
    ],
    "PV chained into the running accumulator": [
        ("        float c[4] = {0.f, 0.f, 0.f, 0.f};", "        float (&c)[4] = acc[n];"),
        ("#pragma unroll\n        for (int i = 0; i < 4; ++i) acc[n][i] += c[i];\n", ""),
    ],
    "fresh PV accumulator per 1 key group": [(_GROUPS, _GROUPS.replace("= 2", "= 1"))],
    "fresh PV accumulator per 4 key groups": [(_GROUPS, _GROUPS.replace("= 2", "= 4"))],
    "fresh PV accumulator per 8 key groups": [(_GROUPS, _GROUPS.replace("= 2", "= 8"))],
    "no branch per key group": [("      if (j0 * 8 >= kv_rows) continue;\n", "")],
    "K as 32-bit loads, rows of D + 4": [
        ("  static constexpr int kStrideK = D + 8;", "  static constexpr int kStrideK = D + 4;"),
        ("(warp * 16 + g) * S::kStrideK + 2 * t;", "(warp * 16 + g) * S::kStrideK + t;"),
        ("qr[kk * 8 + 1],\n                          qr[8 * S::kStrideK + kk * 8 + 1]}",
         "qr[kk * 8 + 4],\n                          qr[8 * S::kStrideK + kk * 8 + 4]}"),
        ("    const float* kr = kt + g * S::kStrideK + 2 * t;", "    const float* kr = kt + g * S::kStrideK + t;"),
        ("        const float2 kj = *reinterpret_cast<const float2*>(kr + j * 8 * S::kStrideK + kk * 8);\n"
         "        mma_3xtf32(s[j], q_big[kk], q_small[kk], kj.x, kj.y);",
         "        const float* kj = kr + j * 8 * S::kStrideK + kk * 8;\n"
         "        mma_3xtf32(s[j], q_big[kk], q_small[kk], kj[0], kj[4]);"),
    ],
    "ceiling: operands not split": [(_SPLIT, "  return __float_as_uint(x);")],
    "ceiling: no mma": [
        ('      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
         '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"',
         '      "// %0 %1 %2 %3 %4 %5 %6 %7 %8 %9"'),
    ],
}
# (B*H, T_q, T_kv, D=96) of the float32 default: global block, stage-2, stage-0, stage-3 windows
SHAPES = [(4, 4096, 4096), (100, 196, 196), (1024, 64, 64), (200, 49, 49)]


def _source(patches) -> str:
    src = (CSRC / "flash_attn.cu").read_text()
    src = re.sub(r"ATLAS_CASE\((\d+)\)", lambda m: m.group(0) if m.group(1) == "96" else "", src)
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"the source no longer holds one copy of {old!r}")
        src = src.replace(old, new)
    return src


def _build(item):
    i, (name, patches) = item
    cu = BUILD_DIR / "tf32x3_variants" / f"variant{i}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(_source(patches))
    path = build_shared_library(f"atlas_flash_attn_variant{i}", [cu], [nvcc_path(), *A._NVCC_FLAGS])
    fn = ctypes.CDLL(str(path)).atlas_flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + A._SOURCES["atlas_flash_attn"][2]
    ptxas = re.search(r"tf32x3_kernelILi96E.*?(\d+ bytes spill stores).*?Used (\d+) registers",
                      build_log(path), re.S)
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    (body,) = [f for f in sass.split("Function : ") if "tf32x3_kernelILi96E" in f.splitlines()[0]]
    ops = {op: len(re.findall(rf"\b{re.escape(op)}\b", body)) for op in ("HMMA.1688.F32.TF32", "FSETP", "SEL")}
    return name, fn, f"{ptxas.group(2)} registers, {ptxas.group(1)}, SASS {ops}"


def _launch(fn, q, k, v, scale) -> torch.Tensor:
    B, H, Tq, D = q.shape
    out = torch.empty(B, Tq, H, D, device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*A._strides(q), *A._strides(k), *A._strides(v), *A._strides(out))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Tq, k.shape[2], D,
             strides, A._BODIES["tf32x3"], scale, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(_build, enumerate(VARIANTS.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [tuple(torch.randn(bh, 1, t, 96, device="cuda", generator=gen) for t in (tq, tk, tk))
              for bh, tq, tk in SHAPES]
    scales = (96**-0.5, -0.125)
    q, k, v = inputs[0]
    limits = [A.f32_error_limit(q, k, v, s) for s in scales]
    times: dict = {name: [] for name in VARIANTS}
    for order in (built, built[::-1]):
        for name, fn, _ in order:
            times[name].append([_ms(lambda: _launch(fn, *x, scales[0])) for x in inputs])
    for name, fn, ptxas in built:
        ratios = []
        for s, (want, limit) in zip(scales, limits):
            got = _launch(fn, q, k, v, s)
            ratios.append(((got - want).abs() / limit).max().item())
        rows = " | ".join(f"{tq}x{tk} {r0:.4f} / {r1:.4f}" for (_, tq, tk), r0, r1 in
                          zip(SHAPES, *times[name]))
        print(f"{name:42s} {ptxas}; ms {rows}; global err/limit {ratios[0]:.3g} / {ratios[1]:.3g} [{card}]")
    for label, fn in (("FMA body (f32)", lambda x: A._launch("f32", *x, scales[0])),
                      ("SDPA", lambda x: F.scaled_dot_product_attention(*x, scale=scales[0]))):
        print(f"{label:42s} ms " + " | ".join(f"{tq}x{tk} {_ms(lambda: fn(x)):.4f}"
                                              for (_, tq, tk), x in zip(SHAPES, inputs)) + f" [{card}]")


if __name__ == "__main__":
    main()
