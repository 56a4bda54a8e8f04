"""Time the int8 serving mode's kernels at its shapes: int8_linear_s8's two bodies and the wgmma body's tile widths, in bfloat16 and int32, quantize_rows_s8's prologues against the unfused chain they replace, and its tensor-parallel modes' streamed bodies against the template's modes.

    python3 -m atlaspatch_tpu_torch.tools.int8_variants [linear|int32|ragged|quantize|tp|host_times]

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

``int32`` times int8_linear_s8's int32 output (``int8_linear_s32``, a
row-parallel shard's partial under tensor-parallel int8) at the (1, 2)
mesh's shard shapes of vit_l_16 and dinov3_vit7b16 at batch 32 and 256 and
two rows that show the tile grid's last wave (``SHARDS``): the ``mma`` body
and the ``wgmma`` body at both tile widths (128 staged whole, 256 staged in
two halves), forced, the width ``wgmma_block_n`` routes to named, beside
``torch._int_mm`` and the bound, and builds of the wgmma body that store
the int32 tile otherwise (``S32_VARIANTS``: from registers), each equal to
the plain product; then the sums over one vit_l_16 TP forward.

``ragged`` times the products whose K is no multiple of 16 (``RAGGED``:
virchow's fc2, K 3,416, in bfloat16 at batch 32 and 256, and the int32
partials of medsiglip's and virchow_v2's TP (1, 2) fc2 shards, K 2,152 and
1,708, at batch 32) over xq and weights at the 16-byte row pitch (pad
bytes 0x7f) as the port hands them over: ``wgmma`` at both tile widths (the
width ``wgmma_block_n`` routes to named), the ``mma`` body over the pitched
rows and over packed ones (the route before the pitch), each equal to the
plain version, beside ``torch._int_mm`` (packed rows, K a multiple of 8
only), bf16 ``F.linear`` and the bound, in two rounds (forward and reverse
order).

``quantize`` times ``quantize_rows_s8``'s prologues at vit_l_16's rows at
batch 32 and 256 (layernorm at K 1,024, tanh GELU at 4,096, the attention's
output at 1,024) beside what they replace, timed on the same inputs: the
``F.layer_norm`` and ``F.gelu`` kernels, the reshape copy of the attention's
output, and the earlier two-read body (``OLD_QUANTIZE_SOURCE``, kept here only,
built as its own library), with the sums over one forward (96 quantizers)
and the bound; then builds of ``csrc/int8_linear.cu`` that undo one design
choice each (``QUANT_VARIANTS``). ``tp`` times quantize_rows_s8's amax-only
and given-amax modes at the (1, 2) mesh's shard rows of vit_l_16 and
dinov3_vit7b16 at batch 32 and 256 (``TP_QUANT``), each call after an L2
flush: as the forward routes them (the streamed bodies; an activation's
amax-only stores its values and given-amax quantizes them by the identity
prologue), the template's modes (forced; their body before),
torch.linalg.vector_norm for the identity amax-only, and the byte bounds of
the function replaced, each equal to the template's output (max-abs 0), with
the sums over one vit_l_16 TP forward; the SASS instructions per element of
the template and the streamed bodies (``cuobjdump -sass``, static counts);
and builds of the streamed bodies that undo one choice each
(``STREAM_VARIANTS``). ``host_times`` times one
call's host time of each wrapper. With no argument it runs all six. Needs
an NVIDIA Hopper card and nvcc.
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
_STORE = "          sts32(out_tile + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ g) << 4) + 4 * t, pack_bf16(y[0], y[1]));"
# variant -> (text of the committed int8_linear_wgmma.cu, its replacement) pairs
VARIANTS = {
    "committed": [],
    "a plain store to shared memory, which the compiler may move": [(_STORE, (
        "          *reinterpret_cast<uint32_t*>(smem_raw + (out_tile - smem_u32(smem_raw)) + (j >> 3) * 8192 + "
        "r * 128 + (((j & 7) ^ g) << 4) + 4 * t) = pack_bf16(y[0], y[1]);"))],
    "at most 4 stages": [("constexpr int kMaxStages = 6;", "constexpr int kMaxStages = 4;")],
}
# TP (1, 2) int8's row-parallel shard products, (M, K, N): batch 32, vit_l_16 (197 tokens) and
# dinov3_vit7b16 (201); proj's half of the heads and fc2's half of the hidden units. At M 6,304 and
# N 1,024 a 128 x 128 tile grid is 400 tiles, 3.03 waves over 132 SMs: the "tail" rows cut M to
# 6,144 (384 tiles, 2.91 waves), so that the time of the fourth wave's 4 tiles shows
SHARDS = {"vit_l_16 proj": (32 * 197, 512, 1024), "vit_l_16 fc2": (32 * 197, 2048, 1024),
          "dinov3_vit7b16 proj": (32 * 201, 2048, 4096), "dinov3_vit7b16 fc2": (32 * 201, 4096, 4096),
          "tail: proj at M 6,144": (6144, 512, 1024), "tail: fc2 at M 6,144": (6144, 2048, 1024),
          "b256 vit_l_16 proj": (256 * 197, 512, 1024), "b256 vit_l_16 fc2": (256 * 197, 2048, 1024),
          "b256 dinov3_vit7b16 proj": (256 * 201, 2048, 4096), "b256 dinov3_vit7b16 fc2": (256 * 201, 4096, 4096)}
_S32_STAGE = """      stage_s32<BN, 0, T::kParts>(acc, out_tile, wq * 16 + g, g, t);
      if constexpr (T::kParts == 2) {"""
_TILE_STORE = "    if (wq == 0 && lane == 0) store_panels<T>("
# int32 variant -> (text of the committed int8_linear_wgmma.cu, its replacement) pairs, and the tile width
S32_VARIANTS = {
    "stores from registers (st.global.v2), no staging": ([
        ("                            int M, int N, int K) {\n  using T = Tile<BN, OutT>;",
         "                            int M, int N, int K, int32_t* __restrict__ out_s32) {\n"
         "  using T = Tile<BN, OutT>;"),
        ("      N, K);", "      N, K, static_cast<int32_t*>(out));"),
        (_S32_STAGE, r"""      const int row0 = m0 + cw * 64 + wq * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row0 + 8 * h < M)
            asm volatile("st.global.v2.b32 [%0], {%1, %2};\n" ::"l"(out_s32 + (int64_t)(row0 + 8 * h) * N + n),
                         "r"(acc[4 * j + 2 * h]), "r"(acc[4 * j + 2 * h + 1]) : "memory");
      }
      if constexpr (false) {"""),
        (_TILE_STORE, "    if (!kS32 && wq == 0 && lane == 0) store_panels<T>("),
    ], 128),
}
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


_L2_FLUSH: list = []


def _l2_flush() -> None:
    """Overwrite a 256 MB buffer (five times the H100's 50 MB L2), so that the next call reads from HBM."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.float32, device="cuda"))
    _L2_FLUSH[0].zero_()


def _device_ms(fn, reps: int = 20, kernel: str | None = None, seen: dict | None = None, cold: bool = False) -> float:
    """Mean device time of one fn() call: the self device time of the kernels
    whose name holds ``kernel`` (every kernel for None) over the launches the
    profiler kept of the one that took the most of it (the call's product
    kernel: a library call may launch a helper more often, and the profiler
    may drop some launches of a burst). With ``seen``, fills it with the
    kernels' names and launches in the window. With ``cold``, every call
    follows an L2 flush, whose fill kernel is not counted."""
    if cold:
        def fn(call=fn):
            _l2_flush()
            return call()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                  and (kernel is None or kernel in e.key) and not (cold and "FillFunctor" in e.key)]
        count = max(events, key=lambda e: e.self_device_time_total).count if events else 0
        if 0 < count <= reps:
            if seen is not None:
                seen.update((e.key, e.count) for e in events)
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    raise RuntimeError(f"the profiler kept none of {reps} launches in 3 windows")


def bound_ms(m: int, n: int, k: int, s32: bool = False) -> tuple[float, str]:
    """The least time of one (M, K) x (N, K) product to bfloat16: 2 M N K
    int8 operations at the tensor-core peak, or xq, W, both scales, the bias
    and the output over HBM once, whichever is longer. With ``s32``, of the
    int32 product: xq, W and 4 bytes a value out."""
    ops = 1e3 * 2.0 * m * n * k / INT8_OPS
    moved = m * k + n * k + (4 * m * n if s32 else 4 * m + 6 * n + 2 * m * n)
    nbytes = 1e3 * moved / BYTES_PER_S
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


def _build_variant(item, prefix: str = "variant"):
    """(name, the variant's atlas_int8_linear_s8_wgmma, its ptxas summary)."""
    i, (name, patches) = item
    cu = BUILD_DIR / "int8_variants" / f"{prefix}{i}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(_source(patches))
    path = build_shared_library(f"atlas_int8_wgmma_{prefix}{i}", [cu], [nvcc_path(), *I._NVCC_FLAGS])
    fn = ctypes.CDLL(str(path)).atlas_int8_linear_s8_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = _WGMMA_ARGTYPES
    found = re.findall(r"(\d+ bytes spill stores).*?Used (\d+) registers", build_log(path), re.S)
    return name, fn, "; ".join(f"{regs} registers, {spill}" for spill, regs in sorted(set(found)))


def _launch_variant(fn, xq, s_x, w, qscale, bias, block_n: int) -> torch.Tensor:
    m, k = xq.shape
    n = w.shape[0]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=xq.device)
    err = fn(xq.data_ptr(), w.data_ptr(), s_x.data_ptr(), qscale.data_ptr(), bias.data_ptr(), 1, out.data_ptr(),
             1, m, n, k, I._pitch(xq), I._pitch(w), block_n, I._sm_count(0), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def _launch_s32_variant(fn, xq, w, block_n: int) -> torch.Tensor:
    """One int32 product of a variant build's C entry (code 2)."""
    m, k = xq.shape
    n = w.shape[0]
    out = torch.empty(m, n, dtype=torch.int32, device=xq.device)
    err = fn(xq.data_ptr(), w.data_ptr(), None, None, None, 0, out.data_ptr(), 2, m, n, k, I._pitch(xq), I._pitch(w),
             block_n, I._sm_count(0), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def linear_s32_times(card: str) -> None:
    """int8_linear_s8's int32 output at each SHARDS shape: the mma body and the wgmma body in both
    tile widths (forced; the routed body and width named), each S32_VARIANTS build, every one equal
    to the plain product (max-abs 0), and torch._int_mm, by device time per launch (the median of
    three profiler windows), beside the bound; then the sums over one vit_l_16 TP (1, 2) forward at
    batch 32 (24 blocks, 2 shards: 48 products each of proj and fc2)."""
    with ThreadPoolExecutor(len(S32_VARIANTS)) as pool:
        built = list(pool.map(lambda item: _build_variant((item[0], (item[1][0], item[1][1][0])), "s32_variant"),
                              enumerate(S32_VARIANTS.items())))
    for name, _, ptxas in built:
        print(f"int32 variant {name}: {ptxas}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    sums: dict = {}
    for label, (m, k, n) in SHARDS.items():
        xq, w = (torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)
                 for shape in ((m, k), (n, k)))
        want = I.int8_linear_s32_plain(xq, w)
        routed = I.linear_variant(m, n, k, torch.int32, xq.data_ptr(), w.data_ptr())
        if routed == "wgmma":
            routed += f"/{I.wgmma_block_n(m, n, I._sm_count(0), torch.int32, k)}"
        calls = {"mma": lambda: I._launch_linear("mma", xq, None, w, None, None, torch.int32),
                 **{f"wgmma/{bn}": (lambda bn=bn: I._launch_linear("wgmma", xq, None, w, None, None, torch.int32, bn))
                    for bn in I.WGMMA_BLOCK_NS}}
        for name, fn, _ in built:
            calls[name] = lambda fn=fn, bn=S32_VARIANTS[name][1]: _launch_s32_variant(fn, xq, w, bn)
        for name, fn in calls.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{label}: int32 {name} differs from the plain product")
        del want
        times = {name: sorted(_device_ms(fn, kernel="int8_linear_s8") for _ in range(3))[1]
                 for name, fn in calls.items()}
        times["_int_mm"] = sorted(_device_ms(lambda: torch._int_mm(xq, w.t())) for _ in range(3))[1]
        bound, by = bound_ms(m, n, k, s32=True)
        print(f"int32 {label:20s} M={m} K={k} N={n} (routed {routed}): "
              + "; ".join(f"{name} {ms:.4f} ({100 * bound / ms:.1f}% of bound)" for name, ms in times.items())
              + f"; bound {bound:.4f} ({by}) (device ms per launch, median of 3 windows) [{card}]")
        if label.startswith("vit_l_16"):
            for name, ms in {**times, "routed": times[routed], "bound": bound}.items():
                sums[name] = sums.get(name, 0.0) + 48 * ms
        del xq, w
        torch.cuda.empty_cache()
    print("int32 per vit_l_16 TP (1, 2) forward (48 proj + 48 fc2 shard products), ms: "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in sums.items()) + f" [{card}]")


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
             xq.data_ptr(), cols, s_x.data_ptr(), None, None, 0, None, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return xq, s_x


# TP (1, 2) int8's row-parallel quantizer rows, a shard's half: (label, tokens, whole K, prologue,
# operand): vit_l_16's proj (8 of 16 heads of 64) and fc2 (tanh GELU), dinov3_vit7b16's proj (16 of 32
# heads of 128) and fc2 (tanh GELU or SiLU of fc_gate, times fc_up)
TP_QUANT = [("vit_l_16 proj", 197, 1024, "identity", "heads"), ("vit_l_16 fc2", 197, 4096, "gelu_tanh", None),
            ("7B proj", 201, 4096, "identity", "heads"), ("7B fc2", 201, 8192, "gelu_tanh", "gated"),
            ("7B fc2 silu", 201, 8192, "silu", "gated")]
_S_LANE = """    const float s = div_rn(fmaxf(row_amax[j], 1e-8f), 127.0f);
    const float r0 = __fdividef(1.0f, s);
    const float r = __fmaf_rn(__fmaf_rn(-s, r0, 1.0f), r0, r0);
    if (u == 0) scale[row] = s;"""
_LOOP = """#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int row = m0 + j * kWarps;"""
# variant -> (text of the committed int8_linear.cu, its replacement) pairs: the streamed bodies' choices undone
STREAM_VARIANTS = {
    "given 4 rows a warp": [("constexpr int kGivenRows = 2;", "constexpr int kGivenRows = 4;")],
    "given: s and 1 / s once a row, in shared memory behind a barrier": [
        (_LOOP, """  __shared__ float s_tile[kWarps * kAhead], r_tile[kWarps * kAhead];
  if (lane == 0)
    for (int j = 0; j < kAhead; ++j)
      if (m0 + j * kWarps < rows) {
        const float s = div_rn(fmaxf(row_amax[j], 1e-8f), 127.0f), r0 = __fdividef(1.0f, s);
        s_tile[warp + j * kWarps] = s;
        r_tile[warp + j * kWarps] = __fmaf_rn(__fmaf_rn(-s, r0, 1.0f), r0, r0);
      }
  __syncthreads();
""" + _LOOP),
        (_S_LANE, """    const float s = s_tile[warp + j * kWarps], r = r_tile[warp + j * kWarps];
    if (u == 0) scale[row] = s;""")],
    "16-byte units where 32 fit": [("  if (bytes == 32) return launch_stream<T, 32 / sizeof(T), P>(c, stream);",
                                    "  if (bytes == 32) return launch_stream<T, 16 / sizeof(T), P>(c, stream);")],
    "amax 4 units ahead (identity), 2 (activations)": [("constexpr int kAmaxAhead[7] = {2, 0, 1, 1, 1, 1, 1};",
                                                        "constexpr int kAmaxAhead[7] = {4, 0, 2, 2, 2, 2, 2};")],
    "3 CTAs an SM": [("constexpr int kStreamCtas = 4;", "constexpr int kStreamCtas = 3;")],
}


def _tp_operands(tokens: int, k: int, operand, gen: torch.Generator, batch: int):
    """A shard's operands: the half of the attention's (B, T, H, D) output (stored (B, H, T, D)) a
    shard holds, or fc1's half rows (a, and b for a gated MLP), bfloat16."""
    m, kk = batch * tokens, k // 2
    if operand == "heads":
        d = 64 if k == 1024 else 128
        whole = torch.randn(batch, k // d, tokens, d, device="cuda", generator=gen).to(torch.bfloat16)
        return (whole.transpose(1, 2)[:, :, : k // d // 2],)
    a = (torch.randn(m, kk, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    return a, (torch.randn(m, kk, device="cuda", generator=gen) * 2).to(torch.bfloat16) if operand else None


def _tp_call(prologue: str, ops, mode: str, body: str | None, amax=None, fn=None):
    """One quantizer call on a shard's operands (the heads, (a, b), or stored values (v, None) with the
    identity prologue) through _launch_quantize, or through a variant build's
    atlas_quantize_rows_s8_stream (``fn``: the routed unit, no counting). An activation's amax-only
    on the streamed body returns (amax, values)."""
    if ops[0].ndim == 4:
        x, layout, rows, cols = I._heads_layout("tp", ops[0])
        b = None
    else:
        (x, b), rows, cols = ops, ops[0].shape[0], ops[0].shape[1]
        layout = (0, x.stride(0), rows, 0, cols)
    if fn is None:
        return I._launch_quantize(prologue, x, layout, rows=rows, cols=cols, b=b, mode=mode, amax=amax, body=body)
    _, unit = I.quant_variant(mode, prologue, layout[4], x.element_size(), 16)
    store = mode == "amax_only" and prologue != "identity"
    out = torch.empty(rows, dtype=torch.float32, device=x.device) if mode == "amax_only" else None
    xq = None if mode == "amax_only" else torch.empty(rows, cols, dtype=torch.int8, device=x.device)
    s_x = None if mode == "amax_only" else torch.empty(rows, dtype=torch.float32, device=x.device)
    values = torch.empty(rows, cols, dtype=x.dtype, device=x.device) if store else None
    err = fn(I.PROLOGUES.index(prologue), 1, rows, cols, x.data_ptr(), *layout, None if b is None else b.data_ptr(),
             0 if b is None else b.stride(0), unit, None if xq is None else xq.data_ptr(), cols,
             None if s_x is None else s_x.data_ptr(), I.QUANT_MODES.index(mode),
             (out if amax is None else amax).data_ptr(), None if values is None else values.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    if mode == "amax_only":
        return (out, values) if store else out
    return xq, s_x


def _sass_per_element(lib) -> dict:
    """Static SASS instructions (and MUFU among them) per element of bfloat16 kernels of the
    quantizer, identity and tanh GELU: each kernel's instructions over the values a thread holds at
    once (the template: 2 units of 16; the streamed bodies' 32-byte units of 16: given-amax 2 rows',
    the identity only, amax-only an iteration's 2 (identity) or 1 (tanh GELU, storing)). Static
    counts include the rare paths (quantize_one's near-tie residual, tanhf's two ranges)."""
    sass = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    functions = re.split(r"\n\s*Function : ", sass)
    out = {}
    for label, pattern, values in (
            ("template", r"quantize_rows_s8_kernelI13__nv_bfloat16Li16ELi2ELi{p}E", {"identity": 32, "gelu_tanh": 32}),
            ("stream amax-only", r"quantize_stream_amax_kernelI13__nv_bfloat16Li16ELi{p}E",
             {"identity": 32, "gelu_tanh": 16}),
            ("stream given-amax", r"quantize_stream_given_kernelI13__nv_bfloat16Li16EE", {"identity": 32})):
        for prologue, n in values.items():
            code = next((f for f in functions if re.match(r"\S*" + pattern.format(p=I.PROLOGUES.index(prologue)), f)),
                        "")
            instrs = re.findall(r"/\*[0-9a-f]{4}\*/\s+([A-Z][\w.]*)", code)
            if not instrs:
                raise AssertionError(f"no SASS of {label} {prologue} in {lib._name}")
            out[f"{label} {prologue}"] = (len(instrs) / n, sum(op.startswith("MUFU") for op in instrs) / n)
    return out


def tp_quantize_times(card: str) -> None:
    """The tensor-parallel modes at each TP_QUANT shard at batch 32 and 256, each call after an L2
    flush: as the forward routes them (the streamed bodies; an activation's amax-only storing its
    values, given-amax quantizing them by the identity prologue), the template's modes (forced; the
    activation computed in both) and vector_norm (identity amax-only), each equal to the template's
    output, by device time per launch (the median of three profiler windows) beside the byte bounds
    (amax-only: the function it replaces, the shard read once and 4 bytes a row; given-amax: what it
    reads on the route, the heads or the stored values, once, xq and the scales written; the pair:
    the function both replace, the shard read twice and xq written once) and the bytes the routed
    pair moves;
    the sums over one vit_l_16 TP forward (48 calls each of proj and fc2); the static SASS
    instructions per element; then STREAM_VARIANTS builds."""
    lib = I.load_int8_library()
    for name, (per_elem, mufu) in _sass_per_element(lib).items():
        print(f"tp SASS {name} (bfloat16): {per_elem:.2f} instructions per element, {mufu:.3f} MUFU (static) [{card}]")
    with ThreadPoolExecutor(len(STREAM_VARIANTS)) as pool:
        built = list(pool.map(_build_stream_variant, enumerate(STREAM_VARIANTS.items())))
    gen = torch.Generator(device="cuda").manual_seed(5)

    def median(fn, kernel):
        return sorted(_device_ms(fn, kernel=kernel, cold=True) for _ in range(3))[1]

    for batch in (32, 256):
        sums = Counter()
        for label, tokens, k, prologue, operand in TP_QUANT:
            ops = _tp_operands(tokens, k, operand, gen, batch)
            m, kk = batch * tokens, k // 2
            act = prologue != "identity"
            amax = _tp_call(prologue, ops, "amax_only", "template")
            want = _tp_call(prologue, ops, "given_amax", "template", amax)
            # what given-amax quantizes on the route: the heads, or the activation's stored values
            src = (_tp_call(prologue, ops, "amax_only", None)[1], None) if act else ops
            given_p = "identity"
            calls = {"amax-only": (lambda: _tp_call(prologue, ops, "amax_only", None), "quantize_stream_amax"),
                     "amax-only template": (lambda: _tp_call(prologue, ops, "amax_only", "template"),
                                            "quantize_rows_s8"),
                     "given-amax": (lambda: _tp_call(given_p, src, "given_amax", None, amax), "quantize_stream_given"),
                     "given-amax template": (lambda: _tp_call(prologue, ops, "given_amax", "template", amax),
                                             "quantize_rows_s8")}
            if not act:
                calls["vector_norm"] = (lambda: torch.linalg.vector_norm(ops[0], float("inf"), dim=(-2, -1),
                                                                         dtype=torch.float32), None)
            for name, fn in built:
                calls[f"amax-only {name}"] = (lambda fn=fn: _tp_call(prologue, ops, "amax_only", None, fn=fn),
                                              "quantize_stream_amax")
                calls[f"given-amax {name}"] = (lambda fn=fn: _tp_call(given_p, src, "given_amax", None, amax, fn=fn),
                                               "quantize_stream_given")
            for name, (fn, _) in calls.items():
                got = fn()
                if name == "vector_norm":
                    same = torch.equal(got.reshape(-1), amax)
                elif name.startswith("amax") and act and "template" not in name:
                    same = torch.equal(got[0], amax) and torch.equal(got[1], src[0])
                elif name.startswith("amax"):
                    same = torch.equal(got, amax)
                else:
                    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                if not same:
                    raise AssertionError(f"{label} b{batch}: {name} differs from the template's mode")
            times = {name: median(fn, kernel) for name, (fn, kernel) in calls.items()}
            n_in = 2 if operand == "gated" else 1
            again = 4 if act else 2 * n_in  # the pair's second pass: the stored values written and read
            bounds = {"amax-only": 2 * n_in * m * kk + 4 * m, "given-amax": 3 * m * kk + 8 * m}
            bounds = {name: 1e3 * n / BYTES_PER_S for name, n in bounds.items()}
            pair, pair_t = times["amax-only"] + times["given-amax"], (times["amax-only template"]
                                                                    + times["given-amax template"])
            pair_bound = 1e3 * ((4 * n_in + 1) * m * kk + 12 * m) / BYTES_PER_S
            moved = 1e3 * ((2 * n_in + again + 1) * m * kk + 12 * m) / BYTES_PER_S
            gated = " * b" if operand == "gated" else ""
            print(f"tp b{batch} {label:12s} {prologue}{gated} M={m} K={kk} (a shard, L2 cold): "
                  + "; ".join(f"{name} {ms:.4f}" + (f" ({100 * bounds[name] / ms:.1f}% of bound {bounds[name]:.4f})"
                                                    if name in bounds else "") for name, ms in times.items())
                  + f"; the pair {pair:.4f} ({100 * pair_bound / pair:.1f}% of bound {pair_bound:.4f}; it moves "
                  f"{moved:.4f} of bytes, {100 * moved / pair:.1f}%), template {pair_t:.4f} "
                  f"({100 * pair_bound / pair_t:.1f}%)"
                  f" (device ms per launch, median of 3 windows) [{card}]")
            if label.startswith("vit_l_16"):
                for mode in ("amax-only", "given-amax"):
                    sums[f"{mode} routed"] += 48 * times[mode]
                    sums[f"{mode} template"] += 48 * times[f"{mode} template"]
                    sums[f"{mode} bound"] += 48 * bounds[mode]
                sums["pair bound"] += 48 * pair_bound
                sums["pair bytes moved"] += 48 * moved
            del ops, amax, want, src
            torch.cuda.empty_cache()
        print(f"tp b{batch} per vit_l_16 TP (1, 2) forward (48 proj + 48 fc2 shard calls a mode), ms: "
              + ", ".join(f"{name} {ms:.3f}" for name, ms in sums.items()) + f" [{card}]")


def _build_stream_variant(item):
    """(name, the build's atlas_quantize_rows_s8_stream) of a STREAM_VARIANTS entry."""
    i, (name, patches) = item
    cu = BUILD_DIR / "int8_variants" / f"stream_variant{i}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(_source(patches, "int8_linear.cu"))
    path = build_shared_library(f"atlas_int8_stream_variant{i}", [cu], [nvcc_path(), *I._NVCC_FLAGS])
    fn = ctypes.CDLL(str(path)).atlas_quantize_rows_s8_stream
    fn.restype = ctypes.c_int
    fn.argtypes = I.load_int8_library().atlas_quantize_rows_s8_stream.argtypes
    return name, fn


def _operands(m: int, n: int, k: int, gen: torch.Generator):
    x = (torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    xq, s_x = I.quantize_rows(x)
    w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)
    qscale = (torch.rand(n, device="cuda", generator=gen) + 0.5) / 127.0
    bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    return x, xq, s_x, w, qscale, bias


# products whose K is no multiple of 16, (M, K, N, output): virchow's fc2 (v1 257 tokens, v2 261) at
# batch 32 and 256 in bfloat16; the TP (1, 2) fc2 shards of medsiglip (1,024 tokens) and virchow_v2 at
# batch 32 in int32
RAGGED = {"virchow_v1 fc2 b32": (32 * 257, 3416, 1280, torch.bfloat16),
          "virchow_v2 fc2 b32": (32 * 261, 3416, 1280, torch.bfloat16),
          "virchow_v1 fc2 b256": (256 * 257, 3416, 1280, torch.bfloat16),
          "virchow_v2 fc2 b256": (256 * 261, 3416, 1280, torch.bfloat16),
          "medsiglip fc2 shard b32": (32 * 1024, 2152, 1152, torch.int32),
          "virchow_v2 fc2 shard b32": (32 * 261, 1708, 1280, torch.int32)}


def _fill_pad(t: torch.Tensor) -> None:
    rows, k = t.shape
    t.as_strided((rows, I.pitch16(k)), (I.pitch16(k), 1))[:, k:].fill_(0x7F)


def ragged_times(card: str) -> None:
    """int8_linear_s8 at every RAGGED shape over pitched and over packed rows, each body equal to the plain
    version, by device time per launch (min and max of two rounds), beside the library calls and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, (m, k, n, out_dtype) in RAGGED.items():
        x, xq, s_x, w, qscale, bias = _operands(m, n, k, gen)
        w = I.pitched(w)
        _fill_pad(xq)
        _fill_pad(w)
        xq_p, w_p = xq.contiguous(), w.contiguous()
        s32 = out_dtype == torch.int32
        args = (None, None, None) if s32 else (s_x, qscale, bias)

        def body(variant, a, b, bn=None):
            return lambda: I._launch_linear(variant, a, args[0], b, args[1], args[2], out_dtype, bn)

        bodies = {**{f"wgmma/{bn}": body("wgmma", xq, w, bn) for bn in I.WGMMA_BLOCK_NS},
                  "mma pitched": body("mma", xq, w), "mma packed": body("mma", xq_p, w_p)}
        want = I.int8_linear_s32_plain(xq_p, w_p) if s32 else I.int8_linear_plain(xq_p, s_x, w_p, qscale, bias,
                                                                                    out_dtype)
        for name, fn in bodies.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{label}: {name} differs from the plain version")
        del want
        times: dict = {name: [] for name in bodies}
        for order in (list(bodies), list(reversed(bodies))):
            for name in order:
                times[name].append(_device_ms(bodies[name], kernel="int8_linear_s8"))
        routed = I.linear_variant(m, n, k, out_dtype, xq.data_ptr(), w.data_ptr(), xq.stride(0), w.stride(0))
        picked = I.wgmma_block_n(m, n, I._sm_count(0), out_dtype, k)
        int_mm = _device_ms(lambda: torch._int_mm(xq_p, w_p.t())) if k % 8 == 0 else None
        bf16 = None if s32 else _device_ms(lambda w16=w_p.to(torch.bfloat16): F.linear(x, w16, bias))
        bound, by = bound_ms(m, n, k, s32=s32)
        print(f"ragged {label:26s} M={m:6d} K={k:5d} N={n:5d} {str(out_dtype).removeprefix('torch.')}: "
              + " ".join(f"{name} {min(t):.4f}/{max(t):.4f}" for name, t in times.items())
              + f"; routed {routed}/{picked}; bound {bound:.4f} ({by}); _int_mm "
              f"{'none (K no multiple of 8)' if int_mm is None else f'{int_mm:.4f}'}; bf16 F.linear "
              f"{'-' if bf16 is None else f'{bf16:.4f}'} (device ms per launch, min/max of 2 rounds) [{card}]")
        del x, xq, s_x, w, qscale, bias, xq_p, w_p
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> None:
    parts = (sys.argv[1:] if argv is None else argv) or ["linear", "int32", "ragged", "quantize", "tp", "host_times"]
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_report()
    if "linear" in parts:
        linear_times(card)
    if "int32" in parts:
        linear_s32_times(card)
    if "ragged" in parts:
        ragged_times(card)
    if "quantize" in parts:
        quantize_times(card)
    if "tp" in parts:
        tp_quantize_times(card)
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
        args = (xq.data_ptr(), w.data_ptr(), s_x.data_ptr(), qscale.data_ptr(), bias.data_ptr(), 1, out.data_ptr(), 1,
                m, n, k, I._pitch(xq), I._pitch(w), I.wgmma_block_n(m, n, I._sm_count(0)), I._sm_count(0),
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
