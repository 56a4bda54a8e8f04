"""Time the float32 small-window attention body against variants that undo one design choice each.

    python3 -m atlaspatch_tpu_torch.tools.f32win_variants

Builds ``csrc/flash_attn_f32win.cu`` (head dim 96 only) once per entry of
VARIANTS, each the committed source with a few lines replaced, all in
parallel, and times each build at the float32 default's five window shapes
(B*H, T_q, T_kv, D = 96): its device time per launch by torch.profiler, in two
rounds (forward and reverse order). The ceilings compute something else (no
loads, no compute, no Q or P reads from shared memory) and say which part of
the body takes the time. Each line gives the build's registers and spills
at D = 96, the count in its SASS of FFMA and of 128-bit and other
shared-memory loads, and its times; the FMA and 3xTF32 bodies and
``F.scaled_dot_product_attention`` follow for scale. Needs an NVIDIA Hopper
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
from torch.profiler import ProfilerActivity, profile

from atlaspatch_tpu_torch.build import BUILD_DIR, CSRC, build_log, build_shared_library, nvcc_path
from atlaspatch_tpu_torch.ops import attention as A

_QLOAD = "      const float4 qv = *reinterpret_cast<const float4*>(qs + qoff[r] + d);"
_PLOAD = "    for (int r = 0; r < R; ++r) p4[r] = *reinterpret_cast<const float4*>(ps + r * kMaxT + j);"
# variant -> (text of the committed source, its replacement) pairs
_ITEM_ROWS = "  const int item_rows = tq <= kItemRows / 2 || few ? kItemRows / 2 : kItemRows;"
VARIANTS = {
    "committed": [],
    "three stages": [("constexpr int kTargetStages = 4;", "constexpr int kTargetStages = 3;")],
    "one producer warp": [("constexpr int kProducers = 32 * 4;", "constexpr int kProducers = 32;")],
    "two producer warps": [("constexpr int kProducers = 32 * 4;", "constexpr int kProducers = 32 * 2;")],
    "items of 8 rows always": [(_ITEM_ROWS, "  const int item_rows = kItemRows;")],
    "items of 4 rows always": [(_ITEM_ROWS, "  const int item_rows = kItemRows / 2;")],
    "4 consumer warps": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "ceiling: loads only, no compute": [
        ("      if (item_rows == kItemRows)\n", "      if (item_rows < 0)\n"),
        ("      else\n        attend_rows<D, kItemRows / 2>", "      else if (item_rows < 0)\n        attend_rows<D, kItemRows / 2>"),
    ],
    "ceiling: compute only, no loads": [("      for (int u = 0; u < units; ++u) {\n        const int bh = bh0 + u;\n        const uint32_t dst",
                                         "      for (int u = 0; u < 0; ++u) {\n        const int bh = bh0 + u;\n        const uint32_t dst")],
    "ceiling: Q K^T without Q reads": [
        ("  int qoff[R];\n",
         "  int qoff[R];\n  float4 qreg[R];\n#pragma unroll\n  for (int r = 0; r < R; ++r) "
         "qreg[r] = *reinterpret_cast<const float4*>(qs + min(r, rows - 1) * kStride);\n"),
        (_QLOAD, "      const float4 qv = qreg[r];"),
    ],
    "ceiling: P V without P reads": [
        ("  int j = 0;\n#pragma unroll 2\n",
         "  float4 preg[R];\n#pragma unroll\n  for (int r = 0; r < R; ++r) "
         "preg[r] = *reinterpret_cast<const float4*>(ps + r * kMaxT);\n  int j = 0;\n#pragma unroll 2\n"),
        (_PLOAD, "    for (int r = 0; r < R; ++r) p4[r] = preg[r];"),
    ],
}
# (B*H, T_q, T_kv) at D = 96: the float32 default's stage-0, 16/64 q-pool,
# stage-1, 4/16 q-pool and stage-3 windows
SHAPES = [(1024, 64, 64), (2048, 16, 64), (2048, 16, 16), (4096, 4, 16), (200, 49, 49)]


def _source(patches) -> str:
    src = (CSRC / "flash_attn_f32win.cu").read_text()
    src = re.sub(r"ATLAS_CASE\((\d+)\)", lambda m: m.group(0) if m.group(1) == "96" else "", src)
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"the source no longer holds one copy of {old!r}")
        src = src.replace(old, new)
    return src


def _build(item):
    i, (name, patches) = item
    cu = BUILD_DIR / "f32win_variants" / f"variant{i}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(_source(patches))
    path = build_shared_library(f"atlas_flash_attn_f32win_variant{i}", [cu], [nvcc_path(), *A._NVCC_FLAGS])
    fn = ctypes.CDLL(str(path)).atlas_flash_attn_f32win_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + A._SOURCES["atlas_flash_attn_f32win"][2]
    ptxas = re.search(r"f32win_kernelILi96E.*?(\d+ bytes spill stores).*?Used (\d+) registers",
                      build_log(path), re.S)
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    ops = {"FFMA": len(re.findall(r"\bFFMA\b", sass)), "LDS.128": len(re.findall(r"\bLDS\.128\b", sass)),
           "LDS other": len(re.findall(r"\bLDS(?!\.128)[.\w]*\b", sass))}
    return name, fn, f"{ptxas.group(2)} registers, {ptxas.group(1)}, SASS {ops}"


def _launch(fn, q, k, v, scale) -> torch.Tensor:
    B, H, Tq, D = q.shape
    out = torch.empty(B, Tq, H, D, device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*A._strides(q), *A._strides(k), *A._strides(v), *A._strides(out))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Tq, k.shape[2], D,
             strides, scale, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def _device_ms(fn, reps: int = 20) -> float:
    """Mean device time per launch of the kernels fn() launches, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in events) / 1e3 / max(1, sum(e.count for e in events))


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(_build, enumerate(VARIANTS.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [tuple(torch.randn(bh, 1, t, 96, device="cuda", generator=gen) for t in (tq, tk, tk))
              for bh, tq, tk in SHAPES]
    scale = 96**-0.5
    times: dict = {name: [] for name in VARIANTS}
    for order in (built, built[::-1]):
        for name, fn, _ in order:
            times[name].append([_device_ms(lambda: _launch(fn, *x, scale)) for x in inputs])
    for name, fn, ptxas in built:
        q, k, v = inputs[-1]
        want, limit = A.f32_error_limit(q, k, v, scale)
        ratio = ((_launch(fn, q, k, v, scale) - want).abs() / limit).max().item()
        rows = " | ".join(f"{tq}/{tk} {r0:.4f} / {r1:.4f}" for (_, tq, tk), r0, r1 in zip(SHAPES, *times[name]))
        print(f"{name:44s} {ptxas}; device ms {rows}; err/limit at 49/49 {ratio:.3g} [{card}]")
    for label, fn in (("FMA body (f32)", lambda x: A._launch("f32", *x, scale)),
                      ("3xTF32 body (tf32x3, T_q > 16)", lambda x: A._launch("tf32x3", *x, scale)),
                      ("SDPA", lambda x: F.scaled_dot_product_attention(*x, scale=scale))):
        print(f"{label:44s} device ms " + " | ".join(
            f"{tq}/{tk} {_device_ms(lambda: fn(x)):.4f}" if label[0] != "3" or tq > 16 else f"{tq}/{tk} -"
            for (_, tq, tk), x in zip(SHAPES, inputs)) + f" [{card}]")


if __name__ == "__main__":
    main()
