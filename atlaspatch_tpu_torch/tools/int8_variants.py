"""Time the int8 serving mode's kernels at its shapes: int8_linear_s8's two bodies and the wgmma body's two tile widths, and quantize_rows_s8's prologues against the unfused chain they replace.

    python3 -m atlaspatch_tpu_torch.tools.int8_variants [linear|quantize|host_times]

Builds the ``atlas_int8_linear`` library (``csrc/int8_linear.cu`` and
``csrc/int8_linear_wgmma.cu``) and prints, per kernel instantiation, its
registers and stack or spills by ``ptxas -v`` and the library's SASS counts
of IMMA (mma.sync), IGMMA (wgmma s8) and UTMALDG (TMA loads). Then, at
vit_l_16's four block linears at batch 32 and 256 (M = 6,304 and 50,432)
and medsiglip's MLP (hidden 4,304) at M = 8,192 and 5, it forces each body
the shape admits: ``mma``, ``wgmma`` in 128-column tiles and in 256-column
tiles, each held against the plain version at max-abs 0, and times each by
its device time per launch (torch.profiler), in two rounds (forward and
reverse order), beside the tile width ``wgmma_block_n`` picks, the bound,
``torch._int_mm`` alone (cuBLASLt's int8 product, M > 16 only; the kernels
it ran are printed) and bf16 ``F.linear``, which are timed only. Then the
sums over one vit_l_16 forward (96 linears) per batch, and the host time of
one call: the routed ``int8_linear``, the wgmma body's C entry alone
(through ctypes), ``torch._int_mm`` and ``F.linear``. Last, builds the wgmma
body again once per entry of VARIANTS, each the committed source with a few
lines replaced, all in parallel, and times each build's two tile widths at
vit_l_16's shapes (the median of three profiler windows), each build's
output equal to the committed body's.

``quantize`` times ``quantize_rows_s8``'s prologues at vit_l_16's rows at
batch 32 and 256 (layernorm at K 1,024, tanh GELU at 4,096, the attention's
output at 1,024) beside what they replace, timed on the same inputs: the
``F.layer_norm`` and ``F.gelu`` kernels, the reshape copy of the attention's
output, and the earlier two-read body (``OLD_QUANTIZE_SOURCE``, kept here only,
built as its own library), with the sums over one forward (96 quantizers)
and the bound; then builds of ``csrc/int8_linear.cu`` that undo one design
choice each (``QUANT_VARIANTS``). ``host_times`` times one call's host time
of each wrapper. With no argument it runs all three. Needs an NVIDIA Hopper
card and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from atlaspatch_tpu_torch.build import BUILD_DIR, CSRC, build_log, build_shared_library, nvcc_path
from atlaspatch_tpu_torch.ops import int8 as I

VITL = {"qkv": (1024, 3072), "proj": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
MEDSIGLIP = {"fc1": (1152, 4304), "fc2": (4304, 1152)}
INT8_OPS, BYTES_PER_S = 1979e12, 3.35e12  # H100 SXM: dense int8 tensor cores, HBM3
BODIES = {"mma": ("mma", None), "wgmma/128": ("wgmma", 128), "wgmma/256": ("wgmma", 256)}
_STORE = "        sts32(out_tile + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ g) << 4) + 4 * t, pack_bf16(y[0], y[1]));"
# variant -> (text of the committed int8_linear_wgmma.cu, its replacement) pairs
VARIANTS = {
    "committed": [],
    "a plain store to shared memory, which the compiler may move": [(_STORE, (
        "        *reinterpret_cast<uint32_t*>(smem_raw + (out_tile - smem_u32(smem_raw)) + (j >> 3) * 8192 + "
        "r * 128 + (((j & 7) ^ g) << 4) + 4 * t) = pack_bf16(y[0], y[1]);"))],
    "at most 4 stages": [("constexpr int kMaxStages = 6;", "constexpr int kMaxStages = 4;")],
}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 20, kernel: str | None = None, seen: dict | None = None) -> float:
    """Mean device time of one fn() call: the self device time of the kernels
    whose name holds ``kernel`` (every kernel for None) over the launches the
    profiler kept of the one that took the most of it (the call's product
    kernel: a library call may launch a helper more often, and the profiler
    may drop some launches of a burst). With ``seen``, fills it with the
    kernels' names and launches in the window."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                  and (kernel is None or kernel in e.key)]
        count = max(events, key=lambda e: e.self_device_time_total).count if events else 0
        if 0 < count <= reps:
            if seen is not None:
                seen.update((e.key, e.count) for e in events)
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    raise RuntimeError(f"the profiler kept none of {reps} launches in 3 windows")


def bound_ms(m: int, n: int, k: int) -> tuple[float, str]:
    """The least time of one (M, K) x (N, K) product to bfloat16: 2 M N K
    int8 operations at the tensor-core peak, or xq, W, both scales, the bias
    and the output over HBM once, whichever is longer."""
    ops = 1e3 * 2.0 * m * n * k / INT8_OPS
    nbytes = 1e3 * (m * k + n * k + 4 * m + 6 * n + 2 * m * n) / BYTES_PER_S
    return (ops, "operations") if ops >= nbytes else (nbytes, "bytes")


def build_report() -> None:
    lib = I.load_int8_library()
    log = build_log(Path(lib._name))
    for name, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)", log, re.S):
        regs = re.search(r"Used (\d+) registers", body).group(1)
        stack = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads)", body)
        print(f"ptxas {name}: {regs} registers, {stack.group(1) if stack else 'no stack line'}")
    for line in log.splitlines():
        if "warning" in line.lower():
            print(f"ptxas {line.strip()}")
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    ops = Counter(re.findall(r"\b(IMMA\.[\w.]+|IGMMA\.[\w.]+|\w*GMMA\.[\w.]+|UTMALDG[\w.]*)", sass))
    print(f"SASS {dict(ops)}")


def _source(patches, name: str = "int8_linear_wgmma.cu") -> str:
    src = (CSRC / name).read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"the source no longer holds one copy of {old!r}")
        src = src.replace(old, new)
    return src


def _build_variant(item):
    """(name, the variant's atlas_int8_linear_s8_wgmma, its ptxas summary)."""
    i, (name, patches) = item
    cu = BUILD_DIR / "int8_variants" / f"variant{i}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(_source(patches))
    path = build_shared_library(f"atlas_int8_wgmma_variant{i}", [cu], [nvcc_path(), *I._NVCC_FLAGS])
    fn = ctypes.CDLL(str(path)).atlas_int8_linear_s8_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    found = re.findall(r"(\d+ bytes spill stores).*?Used (\d+) registers", build_log(path), re.S)
    return name, fn, "; ".join(f"{regs} registers, {spill}" for spill, regs in sorted(set(found)))


def _launch_variant(fn, xq, s_x, w, qscale, bias, block_n: int) -> torch.Tensor:
    m, k = xq.shape
    n = w.shape[0]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=xq.device)
    err = fn(xq.data_ptr(), w.data_ptr(), s_x.data_ptr(), qscale.data_ptr(), bias.data_ptr(), 1, out.data_ptr(),
             m, n, k, block_n, I._sm_count(0), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def variants(card: str) -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(_build_variant, enumerate(VARIANTS.items())))
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(b * 197, k, n) for b in (32, 256) for k, n in VITL.values()]
    for name, fn, ptxas in built:
        sums, cells = Counter(), []
        for m, k, n in shapes:
            _, xq, s_x, w, qscale, bias = _operands(m, n, k, gen)
            for bn in (128, 256):
                want = I._launch_linear("wgmma", xq, s_x, w, qscale, bias, torch.bfloat16, bn)
                if not torch.equal(_launch_variant(fn, xq, s_x, w, qscale, bias, bn), want):
                    raise AssertionError(f"variant {name!r} differs from the committed body at {(m, k, n, bn)}")
                ms = sorted(_device_ms(lambda: _launch_variant(fn, xq, s_x, w, qscale, bias, bn),
                                       kernel="int8_linear") for _ in range(3))[1]
                sums[f"b{m // 197}/{bn}"] += 24 * ms
                cells.append(f"{m}x{k}x{n}/{bn} {ms:.4f}")
            del xq, s_x, w, qscale, bias
        print(f"variant {name}: {ptxas}; forward sums (ms) {dict((k, round(v, 3)) for k, v in sums.items())}; "
              f"per launch {' '.join(cells)} [{card}]")


# The earlier quantize_rows_s8 (one warp a row, the row read twice, an IEEE division per element), the
# "before" of the fused quantizer: kept here only, built as its own library.
OLD_QUANTIZE_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kQuantWarps = 8;
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Vec { T v[VEC]; };
template <int VEC> struct alignas(VEC) Bytes { int8_t v[VEC]; };

template <typename T, int VEC>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_two_reads_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ scale,
                               int rows, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantWarps + warp;
  if (row >= rows) return;
  const Vec<T, VEC>* src = reinterpret_cast<const Vec<T, VEC>*>(x + (int64_t)row * cols);
  Bytes<VEC>* dst = reinterpret_cast<Bytes<VEC>*>(xq + (int64_t)row * cols);
  const int n = cols / VEC;
  float amax = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const Vec<T, VEC> p = src[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(to_float(p.v[j])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  for (int i = lane; i < n; i += 32) {
    const Vec<T, VEC> p = src[i];
    Bytes<VEC> q;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(to_float(p.v[j]), s)), -127.0f), 127.0f);
      q.v[j] = (int8_t)__float2int_rn(r);
    }
    dst[i] = q;
  }
  if (lane == 0) scale[row] = s;
}
}  // namespace

extern "C" int atlas_quantize_rows_two_reads(const void* x, int x_is_bf16, void* xq, void* scale, int rows, int cols,
                                             void* stream) {
  const dim3 grid((rows + kQuantWarps - 1) / kQuantWarps), block(kQuantWarps * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16 && cols % 8 == 0)
    quantize_rows_two_reads_kernel<__nv_bfloat16, 8><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(scale), rows, cols);
  else if (!x_is_bf16 && cols % 4 == 0)
    quantize_rows_two_reads_kernel<float, 4><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(scale), rows, cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""
_OLD: list = []


def load_old_quantizer() -> ctypes.CDLL:
    """Build (once) and load OLD_QUANTIZE_SOURCE as ``atlas_quantize_rows_two_reads``."""
    if not _OLD:
        cu = BUILD_DIR / "int8_variants" / "quantize_two_reads.cu"
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(OLD_QUANTIZE_SOURCE)
        lib = ctypes.CDLL(str(build_shared_library("atlas_quantize_rows_two_reads", [cu],
                                                   [nvcc_path(), *I._NVCC_FLAGS])))
        lib.atlas_quantize_rows_two_reads.restype = ctypes.c_int
        lib.atlas_quantize_rows_two_reads.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        _OLD.append(lib)
    return _OLD[0]


def old_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The earlier quantize_rows_s8 on a contiguous (M, K) CUDA tensor (K a multiple of 16 bytes): (xq, s_x).
    Not counted in ``quantize_rows.launches``."""
    m, k = x.shape
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
    s_x = torch.empty(m, dtype=torch.float32, device=x.device)
    err = load_old_quantizer().atlas_quantize_rows_two_reads(
        x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(), s_x.data_ptr(), m, k,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the two-read quantizer failed: cudaError {err}")
    return xq, s_x


def quantize_bound_ms(m: int, k: int, elem: int = 2) -> float:
    """The least time of one quantizer over (M, K) rows: ``elem`` bytes in and one out per value,
    the float32 scale out per row, over HBM once."""
    return 1e3 * ((elem + 1) * m * k + 4 * m) / BYTES_PER_S


def quantize_chain(m: int, gen: torch.Generator) -> dict:
    """The inputs of one vit_l_16 block's four quantizers at M rows, bfloat16: the residual stream
    with norm1's weights (layernorm, K 1,024, twice a block), fc1's output (tanh GELU, K 4,096) and
    the attention's (B, T, H, D) einsum output (K 1,024)."""
    x = (torch.randn(m, 1024, device="cuda", generator=gen) * 2 + 0.3).to(torch.bfloat16)
    w = (1 + 0.5 * torch.randn(1024, device="cuda", generator=gen)).to(torch.bfloat16)
    b = (0.5 * torch.randn(1024, device="cuda", generator=gen)).to(torch.bfloat16)
    h = (torch.randn(m, 4096, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    batch = m // 197
    attn = torch.softmax(torch.randn(batch, 16, 197, 197, device="cuda", generator=gen), dim=-1).to(torch.bfloat16)
    v = torch.randn(batch, 197, 16, 64, device="cuda", generator=gen).to(torch.bfloat16)
    return dict(x=x, w=w, b=b, h=h, heads=torch.einsum("bhqk,bkhd->bqhd", attn, v))


# Per vit_l_16 block: the fused quantizers and the unfused chain they replace, as (name, count a
# block, call on quantize_chain's inputs, profiler kernel filter, bound (M -> ms)).
def chain_calls(c: dict) -> dict:
    return {
        "layernorm": (2, lambda: I.layernorm_quantize_rows(c["x"], c["w"], c["b"], 1e-6), "quantize_rows_s8"),
        "gelu_tanh": (1, lambda: I.act_quantize_rows(c["h"], "gelu_tanh"), "quantize_rows_s8"),
        "identity": (1, lambda: I.quantize_heads(c["heads"]), "quantize_rows_s8"),
        "F.layer_norm": (2, lambda: F.layer_norm(c["x"], (1024,), c["w"], c["b"], 1e-6), None),
        "F.gelu": (1, lambda: F.gelu(c["h"], approximate="tanh"), None),
        "proj copy": (1, lambda: c["heads"].reshape(c["heads"].shape[0], 197, 1024), None),
        "two-read 1,024": (3, lambda: old_quantize_rows(c["x"]), "two_reads"),
        "two-read 4,096": (1, lambda: old_quantize_rows(c["h"]), "two_reads"),
    }


# variant -> (text of the committed int8_linear.cu, its replacement) pairs
QUANT_VARIANTS = {
    "committed": [],
    "an IEEE division per value (div_rn) in place of the multiply and the tie test": [(
        "  const float q = fminf(fmaxf(__fmul_rn(x, r), -127.0f), 127.0f);\n  float f = __fadd_rn(q, kMagic);\n"
        "  if (fabsf(",
        "  const float q = fminf(fmaxf(div_rn(x, s), -127.0f), 127.0f);\n  float f = __fadd_rn(q, kMagic);\n"
        "  if (false && fabsf(")],
    "no clamp to [-127, 127] (the same bytes for finite rows)": [(
        "  const float q = fminf(fmaxf(__fmul_rn(x, r), -127.0f), 127.0f);\n",
        "  const float q = __fmul_rn(x, r);\n")],
    "no register cap (1 CTA an SM)": [("constexpr int kQuantCtas[7] = {4, 3, 3, 3, 3, 3, 3};",
                                       "constexpr int kQuantCtas[7] = {1, 1, 1, 1, 1, 1, 1};")],
}


def quantize_times(card: str) -> None:
    """The fused quantizers and the chain they replace at vit_l_16's rows (batch 32, 256): device
    ms per call (the median of three profiler windows) and per forward (24 blocks), beside the
    bound; then each QUANT_VARIANTS build's fused quantizers on the same inputs, equal to the
    committed ones."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    with ThreadPoolExecutor(len(QUANT_VARIANTS)) as pool:
        built = list(pool.map(_build_quant_variant, enumerate(QUANT_VARIANTS.items())))
    for batch in (32, 256):
        m = batch * 197
        c = quantize_chain(m, gen)
        sums = Counter()
        for name, (count, fn, kernel) in chain_calls(c).items():
            ms = sorted(_device_ms(fn, kernel=kernel) for _ in range(3))[1]
            sums["fused" if kernel == "quantize_rows_s8" else "chain"] += 24 * count * ms
            print(f"quantize b{batch} {name:16s} x{count} a block: {ms:.4f} ms a call, {24 * count * ms:.3f} a forward "
                  f"[{card}]")
        bound = 24 * (3 * quantize_bound_ms(m, 1024) + quantize_bound_ms(m, 4096))
        print(f"quantize b{batch} per forward (96 quantizers): fused {sums['fused']:.3f} ms, the unfused chain "
              f"{sums['chain']:.3f}, bound {bound:.3f} ({100 * bound / sums['fused']:.1f}% reached) [{card}]")
        for name, fn, ptxas in built:
            total, parts = 0.0, []
            for prologue, count, args in (("layernorm", 2, (c["x"], c["w"], c["b"], 1e-6)),
                                          ("gelu_tanh", 1, (c["h"],)), ("identity", 1, (c["heads"],))):
                def call(fn=fn, prologue=prologue, args=args):
                    return _launch_quant_variant(fn, prologue, *args)
                want = {"layernorm": lambda: I.layernorm_quantize_rows(*args),
                        "gelu_tanh": lambda: I.act_quantize_rows(args[0], "gelu_tanh"),
                        "identity": lambda: I.quantize_heads(args[0])}[prologue]()
                got = call()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"quantizer variant {name!r} differs from the committed one ({prologue})")
                ms = sorted(_device_ms(call, kernel="quantize_rows_s8") for _ in range(3))[1]
                total += 24 * count * ms
                parts.append(f"{prologue} {ms:.4f}")
            print(f"quantize variant {name}: b{batch} per forward {total:.3f} ms ({', '.join(parts)} a call); {ptxas} "
                  f"[{card}]")
        del c
        torch.cuda.empty_cache()


def _build_quant_variant(item):
    i, (name, patches) = item
    cu = BUILD_DIR / "int8_variants" / f"quant_variant{i}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(_source(patches, "int8_linear.cu"))
    path = build_shared_library(f"atlas_int8_quant_variant{i}", [cu], [nvcc_path(), *I._NVCC_FLAGS])
    fn = ctypes.CDLL(str(path)).atlas_quantize_rows_s8
    fn.restype = ctypes.c_int
    fn.argtypes = I.load_int8_library().atlas_quantize_rows_s8.argtypes
    found = re.findall(r"Compiling entry function '\w*quantize_rows_s8_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)E\w*'"
                       r".*?(\d+) bytes spill stores.*?Used (\d+) registers", build_log(path), re.S)
    cells = [(("bf16" if "bfloat" in ty else "f32"), int(e), int(u), I.PROLOGUES[int(p)], int(spill), int(regs))
             for ty, e, u, p, spill, regs in found]
    main = " ".join(f"{ty}/{p} {regs}" for ty, e, u, p, spill, regs in cells if e == 16 and u == 2)
    spilling = [f"{ty}/{e}/{u}/{p} {spill} B" for ty, e, u, p, spill, regs in cells if spill]
    return name, fn, (f"{len(cells)} quantizer instantiations; registers of the 16 x 2 ones: {main}; spilling: "
                      f"{spilling or 'none'}")


def _launch_quant_variant(fn, prologue, x, *ln):
    """One call of a variant build's atlas_quantize_rows_s8, as ops/int8.py launches the committed one."""
    if prologue == "identity":
        b, t, h, d = x.shape
        rows, cols, layout = b * t, h * d, (x.stride(0), x.stride(1), t, x.stride(2), d)
    else:
        rows, cols = x.shape
        layout = (0, x.stride(0), rows, 0, cols)
    xq = torch.empty(rows, cols, dtype=torch.int8, device=x.device)
    s_x = torch.empty(rows, dtype=torch.float32, device=x.device)
    gamma, beta, eps = ln if ln else (None, None, 0.0)
    err = fn(I.PROLOGUES.index(prologue), 1, rows, cols, x.data_ptr(), *layout, None, 0,
             None if gamma is None else gamma.data_ptr(), None if beta is None else beta.data_ptr(), eps,
             xq.data_ptr(), s_x.data_ptr(), None, None, 0, None, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return xq, s_x


def _operands(m: int, n: int, k: int, gen: torch.Generator):
    x = (torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    xq, s_x = I.quantize_rows(x)
    w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)
    qscale = (torch.rand(n, device="cuda", generator=gen) + 0.5) / 127.0
    bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    return x, xq, s_x, w, qscale, bias


def main(argv: list[str] | None = None) -> None:
    parts = (sys.argv[1:] if argv is None else argv) or ["linear", "quantize", "host_times"]
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_report()
    if "linear" in parts:
        linear_times(card)
    if "quantize" in parts:
        quantize_times(card)
    if "host_times" in parts:
        host_times(card)


def linear_times(card: str) -> None:
    """int8_linear_s8's bodies and tile widths at every shape, then the wgmma VARIANTS builds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(b * 197, k, n, f"vit_l_16 {name} b{b}") for b in (32, 256) for name, (k, n) in VITL.items()]
    cases += [(m, k, n, f"medsiglip {name} M={m}") for m in (8192, 5) for name, (k, n) in MEDSIGLIP.items()]
    sums: dict = {}
    for m, k, n, label in cases:
        x, xq, s_x, w, qscale, bias = _operands(m, n, k, gen)
        want = I.int8_linear_plain(xq, s_x, w, qscale, bias, torch.bfloat16)
        bodies = {name: (lambda v=v, bn=bn: I._launch_linear(v, xq, s_x, w, qscale, bias, torch.bfloat16, bn))
                  for name, (v, bn) in BODIES.items()}
        for name, fn in bodies.items():
            err = (fn().float() - want.float()).abs().max().item()
            if err != 0:
                raise AssertionError(f"{label}: {name} max-abs {err} against the plain version (must be 0)")
        del want
        times: dict = {name: [] for name in bodies}
        for order in (list(bodies), list(reversed(bodies))):
            for name in order:
                times[name].append(_device_ms(bodies[name], kernel="int8_linear_s8"))
        w16 = w.to(torch.bfloat16)
        int_mm_kernels: dict = {}
        int_mm = _device_ms(lambda: torch._int_mm(xq, w.t()), seen=int_mm_kernels) if m > 16 else None
        bf16 = _device_ms(lambda: F.linear(x, w16, bias))
        bound, by = bound_ms(m, n, k)
        picked = I.wgmma_block_n(m, n, I._sm_count(0))
        body_s = " ".join(f"{name} {min(t):.4f}/{max(t):.4f}" for name, t in times.items())
        print(f"{label:22s} M={m:6d} K={k:5d} N={n:5d}: {body_s}; picked wgmma/{picked}; bound {bound:.4f} ({by}); "
              f"_int_mm {'null' if int_mm is None else f'{int_mm:.4f}'}; bf16 F.linear {bf16:.4f} "
              f"(device ms per launch, min/max of 2 rounds) [{card}]")
        if int_mm_kernels:
            print(f"{label:22s} _int_mm ran (kernel: launches in 20 calls) {int_mm_kernels}")
        if label.startswith("vit_l_16"):
            b = label.rsplit(" ", 1)[1]
            row = sums.setdefault(b, Counter())
            for name, t in times.items():
                row[name] += 24 * min(t)
            row["picked"] += 24 * min(times[f"wgmma/{picked}"])
            row["bound"] += 24 * bound
            row["_int_mm"] += 24 * int_mm
            row["bf16"] += 24 * bf16
        del x, xq, s_x, w, w16, qscale, bias
        torch.cuda.empty_cache()
    for b, row in sums.items():
        print(f"vit_l_16 forward {b} (96 linears), ms: " + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
              + f" [{card}]")
    variants(card)


def _host_us(fn, reps: int = 200) -> float:
    """Host microseconds per fn() call, the least of three bursts of ``reps``
    calls that the card queues without waiting (the host clock stops before
    the synchronisation)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def host_times(card: str) -> None:
    """The host time of one call at vit_l_16's qkv at batch 32 and medsiglip's
    fc2 at M = 5: the routed int8_linear (Python checks, the output's
    allocation, ctypes, three tensor-map encodes and the launch), the wgmma
    body's C entry alone through ctypes (encodes and launch), each quantizer
    wrapper on the same (M, K) rows, and the library calls, each after a
    warm call."""
    lib = I.load_int8_library()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in ((32 * 197, 1024, 3072), (5, 4304, 1152)):
        x, xq, s_x, w, qscale, bias = _operands(m, n, k, gen)
        ln_w = torch.ones(k, dtype=torch.bfloat16, device="cuda")
        ln_b = torch.zeros(k, dtype=torch.bfloat16, device="cuda")
        heads = x.view(m, 1, k // 16, 16)
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        args = (xq.data_ptr(), w.data_ptr(), s_x.data_ptr(), qscale.data_ptr(), bias.data_ptr(), 1, out.data_ptr(),
                m, n, k, I.wgmma_block_n(m, n, I._sm_count(0)), I._sm_count(0),
                torch.cuda.current_stream().cuda_stream)
        w16 = w.to(torch.bfloat16)
        calls = {"int8_linear (routed)": lambda: I.int8_linear(xq, s_x, w, qscale, bias, torch.bfloat16),
                 "atlas_int8_linear_s8_wgmma (C entry)": lambda: lib.atlas_int8_linear_s8_wgmma(*args),
                 "quantize_rows": lambda: I.quantize_rows(x),
                 "quantize_heads": lambda: I.quantize_heads(heads),
                 "layernorm_quantize_rows": lambda: I.layernorm_quantize_rows(x, ln_w, ln_b, 1e-6),
                 "act_quantize_rows": lambda: I.act_quantize_rows(x, "gelu_tanh"),
                 "torch._int_mm": (lambda: torch._int_mm(xq, w.t())) if m > 16 else None,
                 "bf16 F.linear": lambda: F.linear(x, w16, bias)}
        times = {name: _host_us(fn) for name, fn in calls.items() if fn is not None}
        print(f"host us per call at M={m} K={k} N={n}: "
              + ", ".join(f"{name} {us:.2f}" for name, us in times.items()) + f" [{card}]")
        del x, xq, s_x, w, w16, qscale, bias, out


if __name__ == "__main__":
    main()
