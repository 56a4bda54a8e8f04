// W8A8 linear for Hopper (sm_90a): the row quantizer and the int8 x int8 ->
// int32 tensor-core product with its dequantizing epilogue, the two halves of
// the int8 serving mode's block linears.
//
// Replaces atlaspatch_tpu/models/encoders/vit.py::Int8Dense (:124-157), which
// XLA fuses into one program on the TPU: a per-row abs-max quantizer (the
// JAX _q8_dyn along the last axis, inlined at :143-145), an int8 dot_general
// accumulating in int32 (:146-151), and the dequantization
// acc * (s_x * qscale) + bias, cast to the activations' dtype (:152-156).
// Eager PyTorch would run these as a dozen passes over device memory; here
// they are two kernels, each of which reads its inputs once and writes its
// outputs once.
//
// quantize_rows_s8: one template with a prologue that computes the row's
// values from what lies in memory, then the abs-max quantizer in the same pass
// (the XLA fusion of Int8Dense's quantizer with the op before it on the TPU):
//   identity    x, read where it lies: a (M, K) matrix of any row stride, or
//               the attention's (B, T, H, D) output rows of H D;
//   layernorm   F.layer_norm(x, weight, bias, eps), before qkv and fc1;
//   activations act(a) or act(a) * b (SwiGLU and the gated MLP: a and b two
//               row-strided operands), before fc2.
// Each computes the function the port's unfused chain computes, rounded to
// the input's dtype where that chain stores: F.layer_norm once, GELU and SiLU
// once, QuickGELU's x * sigmoid(1.702 x) three times, act(a) * b twice. Then
// s = max(amax, 1e-8) / 127 (IEEE) and q = clamp(rint(x / s), -127, 127),
// rint half-to-even as jnp.round rounds. The row is read from device memory
// once, by loads all issued before the first use, and held in registers (32
// or 128 values a thread); xq is written as 16-byte stores, its rows `ldq`
// bytes apart (the port passes round_up(K, 16), the row pitch the wgmma
// product's TMA maps take; the pad bytes are not written). Bound on an H100
// SXM: bytes (2 or 4 in, 1 out per element; per row 4 out). The design:
//   * a row is one warp (K = 1,024: 32 bfloat16 a lane) or a group of 2, 4 or
//     8 warps (K = 4,096: 4 warps, 32 a thread); 8 warps a CTA, and at least
//     3 or 4 CTAs an SM (a register cap, kQuantCtas), so rows in flight cover
//     the memory's latency;
//   * x / s without a division per element: q = x * (1 / s) lies within
//     2^-15 of the IEEE quotient, so where q is further than 2^-13 from a
//     half-integer both round alike; nearer (about 1 value in 10^4), the
//     exact residual x - h s of the half-integer h decides, which keeps
//     exact .5 ties; the rounding itself is an add of 1.5 * 2^23, whose low
//     byte is the int8 value. No division in the kernel calls IEEE
//     division's subroutine (div_rn), whose call convention spills;
//   * layernorm's mean and variance are ATen's vectorized_layer_norm_kernel's
//     (aten/src/ATen/native/cuda/layer_norm_kernel.cu): its 128 threads'
//     Welford sums over 4-element vectors, combined in its shuffle and
//     shared-memory order, with the multiply-adds its build contracts
//     written as fma (this library is built with -fmad=false). Equal
//     statistics give an equal normalized row, so the quantizer sees the
//     values F.layer_norm stores; a differing one would move a value by a
//     bfloat16 ulp now and then, and the row's scale with it where that
//     value is the row's largest.
// identity equals the plain version bit for bit; layernorm and the
// activations meet it where the arithmetic above equals ATen's.
// Three modes (tensor-parallel int8, where a row-parallel linear's shards
// each hold a slice of the row, and the JAX program takes the row's abs-max
// across them): one-pass (the above), amax-only (the prologue and the
// reduction, writing the row's abs-max and no xq) and given-amax (the
// prologue, then s from an abs-max read per row instead of reduced). The max
// is exact in any order, so a row split over shards, its slices' amaxes
// maxed and handed back, quantizes each slice to the bytes and the scale of
// the whole row's one pass. The two tensor-parallel modes run on bodies of
// their own (quantize_stream_*, atlas_quantize_rows_s8_stream), which need
// neither the held row nor the group reduction one-pass needs: amax-only a
// warp per row keeping a running max over units loaded ahead, and for an
// activation also storing its values (rows, cols) in the input dtype;
// given-amax (the identity prologue only) an elementwise pass over 32-, 16-
// or 8-byte units, the row's scale read first. Under the TP plan given-amax
// quantizes the attention's heads and those stored values, so fc2's
// activation runs once, not in both modes (measured faster at every shard,
// PERF.md); an activation's given-amax stays on the template. Both reuse the
// template's prologue functions and quantize_one, so their values and bytes
// are the template modes' bit for bit (which stay, forced only by tests and
// tools/int8_variants.py). Bound: bytes; the function they replace (the
// row's abs-max of the shard, then its quantization with the maxed abs-max)
// reads the shard twice (2 bytes an element a read, 4 with the gated b
// operand) and writes 1 byte an element; storing the activation's values
// (2 bytes written, 2 read again, in place of the second read) adds 2 bytes
// an element ungated and none gated. The activations' tanhf and expf make
// fc2's amax-only partly issue-bound.
//
// int8_linear_s8: Y (M, N) = dequant(Xq (M, K) . Wq (N, K)^T). Bound on an
// H100 SXM: operations at ViT widths (2 M N K over 1,979 TOPS int8 against
// M K + N K + 2 M N bytes over 3.35 TB/s; vit_l_16's fc1 at batch 256 has
// M = 50,432, K = 1,024, N = 4,096: 0.214 ms of products, 0.139 ms of
// bytes). This first version is the simple correct one: 128 x 128 CTA tiles
// over K steps of 64 bytes, a 3-stage cp.async ring in shared memory, eight
// warps each holding a 64 x 32 int32 accumulator and issuing
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (A row-major; W stored
// (N, K) row-major is the column-major B the instruction takes). Fragments
// are 32-bit shared loads from rows padded to 80 bytes, which puts the eight
// rows a load touches in distinct banks. Tails: rows past M and columns past
// N are zero-filled by the copy (src-size 0) and masked in the epilogue; K
// need not be a multiple of 64 (medsiglip's MLP 4,304, virchow's 3,416):
// the copy zero-fills past K (a copy that straddles K reads K - k bytes and
// fills the rest), and its width (16, 8, 4 or 1 bytes) is the largest that
// divides both operands' row pitches (ldx, ldw: K where they are
// contiguous, round_up(K, 16) where the port pitched them) and bases. The
// epilogue is the dequantization, element by element in the plain version's
// order: y = float(acc) * (s_x[m] *
// qscale[n]), then + bias[n] (read in its stored dtype), then the cast
// (bfloat16 round-to-nearest-even or float32), all through the _rn
// intrinsics, which the compiler never contracts into an FMA (and the
// library is built with -fmad=false besides): a fused multiply-add rounds
// once and would not equal the plain version. The int32 sum is exact, so the
// result equals the plain version bit for bit. int8_linear_wgmma.cu's body
// (wgmma s8 fed by TMA) is faster; this one takes what it does not, and writes
// the int32 accumulator itself (no dequantization) for tensor-parallel int8's
// row-parallel partials.
//
// dequant_sum_s32: Y (M, N) = dequant(P_0 + ... + P_{n-1}), n int32 partials
// (M, N) of one K split over shards: the int32 sum, then int8_linear_s8's
// epilogue arithmetic unchanged, so the result equals int8_linear_s8 on the
// whole K bit for bit (the int32 sum is exact; the row's scale is the whole
// row's, given-amax). Elementwise; bound by bytes on an H100 SXM (4 n in and
// 2 or 4 out per element over 3.35 TB/s): 4 consecutive columns a thread,
// 16-byte loads of each partial where the rows allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------- quantizer

// The prologue codes of atlas_quantize_rows_s8, in ops/int8.py::PROLOGUES's order.
enum Prologue : int { kIdentity, kLayerNorm, kGelu, kGeluTanh, kQuickGelu, kSilu, kRelu };
// The quantizer's modes, in ops/int8.py::QUANT_MODES's order.
enum Mode : int { kOnePass, kAmaxOnly, kGivenAmax };

constexpr int kQuantThreads = 256;   // a CTA: 256 / group rows of `group` threads
constexpr int kQuantMaxCols = 8192;  // 256 threads x 32 values
// By prologue, the CTAs an SM that a bfloat16 2-unit instantiation's registers must allow: more rows
// in flight (at most 64 registers a thread for identity, 80 for the others, where none spills;
// float32's spill there). tools/int8_variants.py QUANT_VARIANTS measures the choice.
constexpr int kQuantCtas[7] = {4, 3, 3, 3, 3, 3, 3};

// 1 / n, n = 1..32, rounded to nearest: ATen's Welford weights 1.f / count
// (its vectors' counts run 1, 2, 3, ... in every thread, so they are constants).
__constant__ float kInvCount[33] = {
    0.0f,      1.0f / 1,  1.0f / 2,  1.0f / 3,  1.0f / 4,  1.0f / 5,  1.0f / 6,  1.0f / 7,  1.0f / 8,
    1.0f / 9,  1.0f / 10, 1.0f / 11, 1.0f / 12, 1.0f / 13, 1.0f / 14, 1.0f / 15, 1.0f / 16, 1.0f / 17,
    1.0f / 18, 1.0f / 19, 1.0f / 20, 1.0f / 21, 1.0f / 22, 1.0f / 23, 1.0f / 24, 1.0f / 25, 1.0f / 26,
    1.0f / 27, 1.0f / 28, 1.0f / 29, 1.0f / 30, 1.0f / 31, 1.0f / 32};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v as a store to T leaves it.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// E consecutive elements of a row: 16-byte loads where E * sizeof(T) >= 16.
template <typename T, int E>
struct alignas(E * sizeof(T) >= 16 ? 16 : E * sizeof(T)) Unit {
  T v[E];
};

// Where an operand's element (m, k) lies, in elements from p: the row at
// (m / t) sb + (m % t) st, the column at (k / d) sh + k % d (k where sh == 0).
struct Rows {
  const void* p;
  long long sb, st, sh;
  int t, d;
};

template <typename T>
__device__ __forceinline__ const T* row_start(const Rows& r, int m) {
  return static_cast<const T*>(r.p) + (long long)(m / r.t) * r.sb + (long long)(m % r.t) * r.st;
}

__device__ __forceinline__ long long column(const Rows& r, int k) {
  return r.sh == 0 ? (long long)k : (long long)(k / r.d) * r.sh + k % r.d;
}

// a / b rounded to nearest even, as IEEE division (div.rn.f32) gives it, without the subroutine that
// instruction calls for extreme operands (a call's convention costs registers, and spills). r ~ 1 / b
// by MUFU.RCP and a Newton step, q = a r within 2 ulps; of q and its two neighbours the one with the
// least residual |a - b q| (one fma, exact for the correctly rounded one) is the quotient, the even
// one on a tie. Quotients outside the normal range (a row's tail of a saturated sigmoid or SiLU,
// which quantizes to 0) come back as q.
__device__ __forceinline__ float div_rn(float a, float b) {
  float r = __fdividef(1.0f, b);
  r = __fmaf_rn(__fmaf_rn(-b, r, 1.0f), r, r);
  const float q = __fmul_rn(a, r);
  if (!(fabsf(q) >= 0x1p-125f && fabsf(q) < 0x1p+127f)) return q;
  const float lo = __uint_as_float(__float_as_uint(q) - 1u), hi = __uint_as_float(__float_as_uint(q) + 1u);
  const float dq = fabsf(__fmaf_rn(-b, q, a)), dlo = fabsf(__fmaf_rn(-b, lo, a)), dhi = fabsf(__fmaf_rn(-b, hi, a));
  const float best = dlo < dhi ? lo : hi, dbest = fminf(dlo, dhi);
  if (dq < dbest || (dq == dbest && !(__float_as_uint(q) & 1u))) return q;
  if (dlo == dhi) return (__float_as_uint(lo) & 1u) ? hi : lo;
  return best;
}

// The activations as ATen's CUDA kernels compute them in float (GeluCUDAKernelImpl, silu_kernel,
// sigmoid_kernel_cuda and the scalar multiply of x * torch.sigmoid(1.702 * x)); QuickGELU's two
// inner stores are rounded here, its last one and every other result by the caller.
template <int P, typename T>
__device__ __forceinline__ float activation(float x) {
  if constexpr (P == kGelu) {
    return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(x, 0.70710678118654752440f))));
  } else if constexpr (P == kGeluTanh) {
    constexpr float kBeta = (float)(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
    const float inner = __fmul_rn(kBeta, __fmaf_rn(0.044715f, __fmul_rn(__fmul_rn(x, x), x), x));
    return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
  } else if constexpr (P == kQuickGelu) {
    const float z = rnd<T>(__fmul_rn(x, 1.702f));
    return __fmul_rn(x, rnd<T>(div_rn(1.0f, __fadd_rn(1.0f, expf(-z)))));
  } else if constexpr (P == kSilu) {
    return div_rn(x, __fadd_rn(1.0f, expf(-x)));
  } else {
    return fmaxf(x, 0.0f);
  }
}

struct Welford {
  float mean, m2, count;
};

// ATen's cuWelfordOnlineSum, with the weight 1 / (count + 1) given.
__device__ __forceinline__ void welford_add(Welford& w, float x, float weight) {
  const float delta = __fsub_rn(x, w.mean);
  w.count = __fadd_rn(w.count, 1.0f);
  w.mean = __fmaf_rn(delta, weight, w.mean);
  w.m2 = __fmaf_rn(delta, __fsub_rn(x, w.mean), w.m2);
}

// ATen's cuWelfordCombine(dataB = b, dataA = a), with its count-only terms given: count = a.count +
// b.count, coef = 1 / count, na = a.count coef, nb = b.count coef (one set serves every slot of a
// lane, whose slots hold equal counts).
struct Weights {
  float count, na, nb;
};

__device__ __forceinline__ Weights combine_weights(float b_count, float a_count) {
  const float count = __fadd_rn(a_count, b_count);
  const float coef = div_rn(1.0f, count);
  return {count, __fmul_rn(a_count, coef), __fmul_rn(b_count, coef)};
}

__device__ __forceinline__ Welford welford_combine(const Welford& b, const Welford& a, const Weights& k) {
  if (!(k.count > 0.0f)) return {0.0f, 0.0f, 0.0f};
  const float delta = __fsub_rn(b.mean, a.mean);
  return {__fmaf_rn(k.na, a.mean, __fmul_rn(k.nb, b.mean)),
          __fmaf_rn(__fmul_rn(__fmul_rn(delta, delta), a.count), k.nb, __fadd_rn(a.m2, b.m2)), k.count};
}

__device__ __forceinline__ Welford shfl_down(const Welford& w, int offset) {
  return {__shfl_down_sync(0xffffffffu, w.mean, offset), __shfl_down_sync(0xffffffffu, w.m2, offset),
          __shfl_down_sync(0xffffffffu, w.count, offset)};
}

// The row's mean and 1 / sqrt(var + eps) as ATen's vectorized layer norm computes them, for a row held
// by one warp in 16-element units (unit l + 32 j in lane l). ATen's 128 threads (4 warps) each sum
// 4-element vectors v, v + 128, v + 256, ...: its thread 4 l + i is slot i here, whose j-th vector is
// unit l + 32 j's i-th quarter. Its shuffle offsets 16, 8, 4 are lane offsets 4, 2, 1 here, its
// offsets 2 and 1 slots i + 2 and i + 1, and its warp w's result lands in lane 8 w.
template <int U>
__device__ __forceinline__ void aten_row_stats(const float (&v)[U][16], int lane, int units, int cols, float eps,
                                               float& mean, float& rstd) {
  Welford w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < U; ++j) {
    if (lane + 32 * j < units) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) welford_add(w[i], v[j][4 * i + e], kInvCount[4 * j + e + 1]);
    }
  }
#pragma unroll
  for (int offset = 4; offset > 0; offset >>= 1) {
    Welford other[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) other[i] = shfl_down(w[i], offset);
    const Weights k = combine_weights(w[0].count, other[0].count);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = welford_combine(w[i], other[i], k);
  }
  const Weights k = combine_weights(w[0].count, w[2].count);
  w[0] = welford_combine(w[0], w[2], k);
  w[1] = welford_combine(w[1], w[3], k);
  w[0] = welford_combine(w[0], w[1], combine_weights(w[0].count, w[1].count));
#pragma unroll
  for (int offset = 16; offset >= 8; offset >>= 1) {  // ATen's warps 0, 1 take 2, 3, then 0 takes 1
    const Welford other = shfl_down(w[0], offset);
    w[0] = welford_combine(w[0], other, combine_weights(w[0].count, other.count));
  }
  mean = __shfl_sync(0xffffffffu, w[0].mean, 0);
  const float var = div_rn(__shfl_sync(0xffffffffu, w[0].m2, 0), (float)cols);
  rstd = rsqrtf(__fadd_rn(var, eps));
}

// Sum or max over a row's group of threads (a power of two, 32 to 256), in one fixed order.
template <bool kMax>
__device__ __forceinline__ float group_reduce(float x, int group, float* red) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, offset);
    x = kMax ? fmaxf(x, y) : __fadd_rn(x, y);
  }
  if (group > 32) {
    const int warp = threadIdx.x >> 5, first = warp & ~(group / 32 - 1);
    __syncthreads();  // the last reduction's reads are done
    if ((threadIdx.x & 31) == 0) red[warp] = x;
    __syncthreads();
    x = red[first];
    for (int w = 1; w < group / 32; ++w) x = kMax ? fmaxf(x, red[first + w]) : __fadd_rn(x, red[first + w]);
  }
  return x;
}

// rint(fl(x / s)) clamped to [-127, 127], in the low byte. q = x r (r ~ 1 / s within 2 ulps) lies
// within 2^-15 of fl(x / s) (|x / s| <= 127); where it lies further than 2^-13 from a half-integer
// both round to the same integer. Adding 1.5 * 2^23 rounds half-to-even and leaves the integer in
// the low bits. Nearer a half-integer h (about 1 value in 10^4), the exact residual d = x - h s (one
// fma: |d| < 2^-12 s is a multiple of s's ulp / 4) decides: fl(x / s) is h itself where
// |d| <= s ulp(h) / 2 (then rint takes the even neighbour), else it lies on d's side of h.
__device__ __forceinline__ uint32_t quantize_one(float x, float s, float r) {
  constexpr float kMagic = 12582912.0f;
  const float q = fminf(fmaxf(__fmul_rn(x, r), -127.0f), 127.0f);
  float f = __fadd_rn(q, kMagic);
  if (fabsf(__fsub_rn(q, __fsub_rn(f, kMagic))) > 0.5f - 0x1p-13f) {
    const float h = __fadd_rn(floorf(q), 0.5f);
    const float d = __fmaf_rn(-h, s, x);
    const float half_ulp = __fmul_rn(s, __fmul_rn(__uint_as_float(__float_as_uint(h) & 0x7f800000u), 0x1p-24f));
    const float n = fabsf(d) <= half_ulp ? rintf(h) : (d > 0.0f ? __fadd_rn(h, 0.5f) : __fsub_rn(h, 0.5f));
    f = __fadd_rn(n, kMagic);
  }
  return __float_as_uint(f);
}

// One row per group of `group` threads; thread t holds units t + j group (E elements each, j < U)
// in registers. Groups past the last row read it and write nothing. `mode` (Mode) is the same for
// every thread: amax-only writes amax[row] and returns before the quantizer, given-amax reads it.
template <typename T, int E, int U, int P>
__global__ void __launch_bounds__(kQuantThreads, sizeof(T) == 2 && E == 16 && U == 2 ? kQuantCtas[P] : 1)
quantize_rows_s8_kernel(const Rows a, const T* __restrict__ b, const long long ldb, const T* __restrict__ gamma,
                        const T* __restrict__ beta, const float eps, int8_t* __restrict__ xq, const long long ldq,
                        float* __restrict__ scale, float* __restrict__ mean_out, float* __restrict__ rstd_out,
                        const int mode, float* __restrict__ amax_io, const int rows, const int cols,
                        const int group) {
  __shared__ float red[kQuantThreads / 32];
  const int t = threadIdx.x & (group - 1);
  const int row = blockIdx.x * (kQuantThreads / group) + threadIdx.x / group;
  const int m = min(row, rows - 1);
  const int units = cols / E;
  const T* arow = row_start<T>(a, m);
  const T* brow = b == nullptr ? nullptr : b + (long long)m * ldb;

  Unit<T, E> ua[U], ub[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = t + j * group;
    if (u < units) {
      ua[j] = *reinterpret_cast<const Unit<T, E>*>(arow + column(a, u * E));
      if constexpr (P >= kGelu)
        if (b != nullptr) ub[j] = *reinterpret_cast<const Unit<T, E>*>(brow + u * E);
    }
  }
  float v[U][E];
#pragma unroll
  for (int j = 0; j < U; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) v[j][e] = t + j * group < units ? to_float(ua[j].v[e]) : 0.0f;

  if constexpr (P == kLayerNorm) {
    float mean, rstd;
    if constexpr (E == 16) {
      aten_row_stats<U>(v, t, units, cols, eps, mean, rstd);
    } else {  // rows no multiple of 16 (ATen's other kernel): two passes over the registers
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < U; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, v[j][e]);
      mean = div_rn(group_reduce<false>(sum, group, red), (float)cols);
      float dev = 0.0f;
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (t + j * group < units)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float d = __fsub_rn(v[j][e], mean);
            dev = __fmaf_rn(d, d, dev);
          }
      rstd = rsqrtf(__fadd_rn(div_rn(group_reduce<false>(dev, group, red), (float)cols), eps));
    }
    if (t == 0 && row < rows && mean_out != nullptr) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int u = t + j * group;
      if (u < units) {
        const Unit<T, E> g = *reinterpret_cast<const Unit<T, E>*>(gamma + u * E);
        const Unit<T, E> h = *reinterpret_cast<const Unit<T, E>*>(beta + u * E);
#pragma unroll
        for (int e = 0; e < E; ++e)  // ATen: gamma * (rstd * (x - mean)) + beta
          v[j][e] = rnd<T>(__fmaf_rn(to_float(g.v[e]), __fmul_rn(rstd, __fsub_rn(v[j][e], mean)),
                                     to_float(h.v[e])));
      }
    }
  } else if constexpr (P >= kGelu) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (t + j * group < units) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float h = rnd<T>(activation<P, T>(v[j][e]));
          if (b != nullptr) h = rnd<T>(__fmul_rn(h, to_float(ub[j].v[e])));
          v[j][e] = h;
        }
      }
    }
  }

  float amax = 0.0f;
  if (mode == kGivenAmax) {
    amax = amax_io[m];
  } else {
#pragma unroll
    for (int j = 0; j < U; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
    amax = group_reduce<true>(amax, group, red);
    if (mode == kAmaxOnly) {
      if (t == 0 && row < rows) amax_io[row] = amax;
      return;
    }
  }
  const float s = div_rn(fmaxf(amax, 1e-8f), 127.0f);
  const float r0 = __fdividef(1.0f, s);
  const float r = __fmaf_rn(__fmaf_rn(-s, r0, 1.0f), r0, r0);
  if (row >= rows) return;
  int8_t* out = xq + (long long)row * ldq;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = t + j * group;
    if (u < units) {
      uint32_t f[E];
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = quantize_one(v[j][e], s, r);
      if constexpr (E == 1) {
        out[u] = (int8_t)(f[0] & 0xffu);
      } else {
        uint32_t w[E / 4];
#pragma unroll
        for (int i = 0; i < E / 4; ++i)
          w[i] = __byte_perm(__byte_perm(f[4 * i], f[4 * i + 1], 0x0040), __byte_perm(f[4 * i + 2], f[4 * i + 3], 0x0040),
                             0x5410);
        if constexpr (E == 16) *reinterpret_cast<uint4*>(out + u * E) = make_uint4(w[0], w[1], w[2], w[3]);
        if constexpr (E == 8) *reinterpret_cast<uint2*>(out + u * E) = make_uint2(w[0], w[1]);
        if constexpr (E == 4) *reinterpret_cast<uint32_t*>(out + u * E) = w[0];
      }
    }
  }
  if (t == 0) scale[row] = s;
}

struct QuantCall {
  Rows a;
  const void* b;
  long long ldb;
  const void *gamma, *beta;
  float eps;
  void* xq;
  long long ldq;  // xq's row pitch in bytes
  void *scale, *mean, *rstd;
  int mode;
  void* amax;
  int rows, cols;
  void* act;  // the streamed amax-only body's stored prologue values, or null
};

template <typename T, int E, int U, int P>
cudaError_t launch_quantize(const QuantCall& c, int group, cudaStream_t stream) {
  const int per_cta = kQuantThreads / group;
  quantize_rows_s8_kernel<T, E, U, P><<<(c.rows + per_cta - 1) / per_cta, kQuantThreads, 0, stream>>>(
      c.a, static_cast<const T*>(c.b), c.ldb, static_cast<const T*>(c.gamma), static_cast<const T*>(c.beta), c.eps,
      static_cast<int8_t*>(c.xq), c.ldq, static_cast<float*>(c.scale), static_cast<float*>(c.mean),
      static_cast<float*>(c.rstd), c.mode, static_cast<float*>(c.amax), c.rows, c.cols, group);
  return cudaGetLastError();
}

bool on16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Units of 16 elements where every one starts on 16 bytes (K a multiple of 16, 16-byte bases and
// strides, xq's pitch), else of one 16-byte vector (8 bfloat16 or 4 float32: virchow's K = 3,416; not for
// layernorm, whose units of 16 follow ATen's threads), else single elements. A layernorm row of
// 16-element units is one warp (ATen's statistics), the other rows the fewest threads that hold them:
// 32 values a thread (64 or 128 for a layernorm row of 1,025 to 2,048 or 2,049 to 4,096).
template <typename T, int P>
cudaError_t dispatch_quantize(const QuantCall& c, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = on16(c.a.p) && c.a.sb % kVec == 0 && c.a.st % kVec == 0 &&
                       (c.b == nullptr || (on16(c.b) && c.ldb % kVec == 0)) &&
                       (c.gamma == nullptr || (on16(c.gamma) && on16(c.beta))) && (c.xq == nullptr || on16(c.xq));
  const bool heads16 = c.a.sh == 0 || (c.a.sh % kVec == 0 && c.a.d % 16 == 0);
  if (aligned && heads16 && c.cols % 16 == 0 && (c.xq == nullptr || c.ldq % 16 == 0)) {
    const int units = c.cols / 16;
    if constexpr (P == kLayerNorm) {
      if (units <= 64) return launch_quantize<T, 16, 2, P>(c, 32, stream);
      if (units <= 128) return launch_quantize<T, 16, 4, P>(c, 32, stream);
      if (units <= 256) return launch_quantize<T, 16, 8, P>(c, 32, stream);
    } else {
      int group = 32;
      while (units > 2 * group) group *= 2;
      return launch_quantize<T, 16, 2, P>(c, group, stream);
    }
  }
  if constexpr (P != kLayerNorm) {
    if (aligned && (c.a.sh == 0 || (c.a.sh % kVec == 0 && c.a.d % kVec == 0)) && c.cols % kVec == 0 &&
        (c.xq == nullptr || c.ldq % kVec == 0)) {
      const int units = c.cols / kVec;
      int group = 32;
      while (units * kVec > 32 * group) group *= 2;
      return launch_quantize<T, kVec, 32 / kVec, P>(c, group, stream);
    }
  }
  int group = 32;
  while (c.cols > 32 * group) group *= 2;
  return launch_quantize<T, 1, 32, P>(c, group, stream);
}

template <typename T>
cudaError_t dispatch_prologue(int prologue, const QuantCall& c, cudaStream_t stream) {
  switch (prologue) {
    case kIdentity: return dispatch_quantize<T, kIdentity>(c, stream);
    case kLayerNorm: return dispatch_quantize<T, kLayerNorm>(c, stream);
    case kGelu: return dispatch_quantize<T, kGelu>(c, stream);
    case kGeluTanh: return dispatch_quantize<T, kGeluTanh>(c, stream);
    case kQuickGelu: return dispatch_quantize<T, kQuickGelu>(c, stream);
    case kSilu: return dispatch_quantize<T, kSilu>(c, stream);
    default: return dispatch_quantize<T, kRelu>(c, stream);
  }
}

// --------------------------------------------------------- quantizer, streamed

// The tensor-parallel modes without the template's held row: given-amax knows each row's scale before
// it reads a value, and amax-only writes 4 bytes a row (and, for an activation, the values), so neither
// waits for a whole row in registers or reduces across a group through shared memory. Units are E
// elements of one row (32, 16 or 8 bytes, or one element), as stream_unit_fits admits them.
// tools/int8_variants.py STREAM_VARIANTS measures the choices: the rows a given-amax warp loads before
// it uses the first, the units an amax-only lane loads before it uses the first, by prologue (the
// activations' tanhf, erff and expf are the work there, and more values in flight only cost
// registers), and the CTAs an SM the registers must allow (4: 64 a thread, none spilling).
constexpr int kStreamThreads = 256;
constexpr int kGivenRows = 2;
constexpr int kAmaxAhead[7] = {2, 0, 1, 1, 1, 1, 1};
constexpr int kStreamCtas = 4;

// A unit's column offset in an operand's row: unit u holds elements u E ..; heads of `hu` units (d / E)
// lie sh apart (sh == 0: one run). The head's index by a shift where hu is a power of two.
struct UnitColumns {
  long long sh;
  int hu, log2_hu;  // log2_hu < 0: hu is no power of two
  __device__ __forceinline__ UnitColumns(const Rows& r, int e) : sh(r.sh), hu(r.d / e), log2_hu(-1) {
    if (sh != 0 && (hu & (hu - 1)) == 0) log2_hu = __ffs(hu) - 1;
  }
  template <int E>
  __device__ __forceinline__ long long at(int u) const {
    if (sh == 0) return (long long)u * E;
    const int h = log2_hu >= 0 ? u >> log2_hu : u / hu;
    return h * sh + (long long)(u - h * hu) * E;
  }
};

// The prologue's value of one element: x, act(x), or act(x) * y, each op rounded to T as the template rounds it.
template <typename T, int P>
__device__ __forceinline__ float prologue_value(T x, T y, bool gated) {
  float v = to_float(x);
  if constexpr (P >= kGelu) {
    v = rnd<T>(activation<P, T>(v));
    if (gated) v = rnd<T>(__fmul_rn(v, to_float(y)));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(v);
  else return v;
}

// given-amax, the identity prologue: an elementwise pass over the rows x units (units = cols / E) in
// tiles of 8 kGivenRows rows x 32 units, a CTA a tile, the tiles of a row block consecutive (CTAs in
// flight read whole rows, not a column of pieces of many): warp w takes rows w + 8 j (j < kGivenRows)
// of it, lane l unit l, so a warp reads 32 consecutive units of a row and a lane's column offset is
// computed once. Every load is issued first, the rows' amax with the values; then per row s and 1 / s
// (the template's arithmetic: div_rn, then the refined reciprocal: a warp's lanes compute their row's
// alike, which measured faster than a table in shared memory behind a barrier), the first column of
// tiles writing the rows' scales, and quantize_one per element, E bytes stored a unit.
template <typename T, int E>
__global__ void __launch_bounds__(kStreamThreads, kStreamCtas)
quantize_stream_given_kernel(const Rows a, const float* __restrict__ amax, int8_t* __restrict__ xq,
                             const long long ldq, float* __restrict__ scale, const int rows, const int cols) {
  constexpr int kAhead = kGivenRows;
  constexpr int kWarps = kStreamThreads / 32;
  const int units = cols / E;
  const int chunks = (units + 31) / 32;  // a row block's tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = (blockIdx.x % chunks) * 32 + lane;
  const int m0 = (blockIdx.x / chunks) * kWarps * kAhead + warp;  // the warp's first row
  const bool in_row = u < units;
  const long long col = UnitColumns(a, E).at<E>(u);

  Unit<T, E> ua[kAhead];
  float row_amax[kAhead];
  int m = m0, mb = m / a.t, mt = m - mb * a.t;  // the row's place in the (B, T) layout
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (m < rows) {
      row_amax[j] = amax[m];
      if (in_row)
        ua[j] = *reinterpret_cast<const Unit<T, E>*>(static_cast<const T*>(a.p) + mb * a.sb + mt * a.st + col);
    }
    m += kWarps;
    mt += kWarps;
    while (mt >= a.t) {
      mt -= a.t;
      ++mb;
    }
  }
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int row = m0 + j * kWarps;
    if (row >= rows) continue;
    const float s = div_rn(fmaxf(row_amax[j], 1e-8f), 127.0f);
    const float r0 = __fdividef(1.0f, s);
    const float r = __fmaf_rn(__fmaf_rn(-s, r0, 1.0f), r0, r0);
    if (u == 0) scale[row] = s;
    if (!in_row) continue;
    uint32_t f[E];
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = quantize_one(to_float(ua[j].v[e]), s, r);
    int8_t* out = xq + (long long)row * ldq + (long long)u * E;
    if constexpr (E == 1) {
      *out = (int8_t)(f[0] & 0xffu);
    } else if constexpr (E == 2) {
      *reinterpret_cast<uint16_t*>(out) = (uint16_t)__byte_perm(f[0], f[1], 0x0040);
    } else {
      uint32_t w[E / 4];
#pragma unroll
      for (int i = 0; i < E / 4; ++i)
        w[i] = __byte_perm(__byte_perm(f[4 * i], f[4 * i + 1], 0x0040), __byte_perm(f[4 * i + 2], f[4 * i + 3], 0x0040),
                           0x5410);
      if constexpr (E == 16) *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
      if constexpr (E == 8) *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
      if constexpr (E == 4) *reinterpret_cast<uint32_t*>(out) = w[0];
    }
  }
}

// amax-only: a row per warp, 8 a CTA. Lane l keeps a running max over the row's units l + 32 i, loading
// A = kAmaxAhead[P] of them before it uses the first; one shuffle reduction a row, and lane 0 writes its
// amax. An activation's values are also stored to `act`, (rows, cols) in T: the one-pass chain's values,
// which given-amax's identity prologue then quantizes.
template <typename T, int E, int P>
__global__ void __launch_bounds__(kStreamThreads, kStreamCtas)
quantize_stream_amax_kernel(const Rows a, const T* __restrict__ b, const long long ldb, float* __restrict__ amax,
                            T* __restrict__ act, const int rows, const int cols) {
  constexpr int kAhead = kAmaxAhead[P];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kStreamThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int units = cols / E;
  const UnitColumns columns(a, E);
  const T* arow = row_start<T>(a, row);
  const T* brow = b == nullptr ? nullptr : b + (long long)row * ldb;
  T* out = nullptr;  // an activation's stored values
  if constexpr (P >= kGelu) out = act + (long long)row * cols;
  float mx = 0.0f;
  for (int u0 = lane; u0 < units; u0 += 32 * kAhead) {
    Unit<T, E> ua[kAhead], ub[kAhead] = {};
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int u = u0 + 32 * j;
      if (u < units) {
        ua[j] = *reinterpret_cast<const Unit<T, E>*>(arow + columns.at<E>(u));
        if constexpr (P >= kGelu)
          if (brow != nullptr) ub[j] = *reinterpret_cast<const Unit<T, E>*>(brow + u * E);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int u = u0 + 32 * j;
      if (u >= units) continue;
      Unit<T, E> h;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = prologue_value<T, P>(ua[j].v[e], ub[j].v[e], brow != nullptr);
        mx = fmaxf(mx, fabsf(v));
        h.v[e] = from_float<T>(v);
      }
      if constexpr (P >= kGelu) *reinterpret_cast<Unit<T, E>*>(out + u * E) = h;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, offset));
  if (lane == 0) amax[row] = mx;
}

// Whether units of `bytes` (32, 16 or 8, or one element) tile the row (and each head) and start on their
// loads' width (at most 16 bytes) in every operand: a's base and strides (and its heads' stride), b's,
// the stored values' and xq's (its base and row pitch on the unit's bytes).
template <typename T>
bool stream_unit_fits(const QuantCall& c, int bytes) {
  if (bytes != 32 && bytes != 16 && bytes != 8 && bytes != (int)sizeof(T)) return false;
  const int e = bytes / (int)sizeof(T), load = bytes < 16 ? bytes : 16, ea = load / (int)sizeof(T);
  const bool heads_ok = c.a.sh == 0 || (c.a.sh % ea == 0 && c.a.d % e == 0);
  return (uintptr_t)c.a.p % load == 0 && c.a.sb % ea == 0 && c.a.st % ea == 0 && heads_ok && c.cols % e == 0 &&
         (c.b == nullptr || ((uintptr_t)c.b % load == 0 && c.ldb % ea == 0)) &&
         (c.act == nullptr || (uintptr_t)c.act % load == 0) &&
         (c.xq == nullptr || ((uintptr_t)c.xq % (e < 16 ? e : 16) == 0 && c.ldq % (e < 16 ? e : 16) == 0));
}

template <typename T, int E, int P>
cudaError_t launch_stream(const QuantCall& c, cudaStream_t stream) {
  if constexpr (P == kIdentity) {
    if (c.mode == kGivenAmax) {
      constexpr int per_cta = kStreamThreads / 32 * kGivenRows;
      const long long ctas = (long long)((c.rows + per_cta - 1) / per_cta) * ((c.cols / E + 31) / 32);
      if (ctas >= (1LL << 31)) return cudaErrorInvalidValue;
      quantize_stream_given_kernel<T, E><<<(unsigned)ctas, kStreamThreads, 0, stream>>>(
          c.a, static_cast<const float*>(c.amax), static_cast<int8_t*>(c.xq), c.ldq, static_cast<float*>(c.scale),
          c.rows, c.cols);
      return cudaGetLastError();
    }
  }
  constexpr int per_cta = kStreamThreads / 32;
  quantize_stream_amax_kernel<T, E, P><<<(c.rows + per_cta - 1) / per_cta, kStreamThreads, 0, stream>>>(
      c.a, static_cast<const T*>(c.b), c.ldb, static_cast<float*>(c.amax), static_cast<T*>(c.act), c.rows, c.cols);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_stream_unit(const QuantCall& c, int bytes, cudaStream_t stream) {
  if (bytes == 32) return launch_stream<T, 32 / sizeof(T), P>(c, stream);
  if (bytes == 16) return launch_stream<T, 16 / sizeof(T), P>(c, stream);
  if (bytes == 8) return launch_stream<T, 8 / sizeof(T), P>(c, stream);
  return launch_stream<T, 1, P>(c, stream);
}

template <typename T>
cudaError_t dispatch_stream(int prologue, const QuantCall& c, int bytes, cudaStream_t stream) {
  if (!stream_unit_fits<T>(c, bytes)) return cudaErrorInvalidValue;
  switch (prologue) {
    case kIdentity: return dispatch_stream_unit<T, kIdentity>(c, bytes, stream);
    case kGelu: return dispatch_stream_unit<T, kGelu>(c, bytes, stream);
    case kGeluTanh: return dispatch_stream_unit<T, kGeluTanh>(c, bytes, stream);
    case kQuickGelu: return dispatch_stream_unit<T, kQuickGelu>(c, bytes, stream);
    case kSilu: return dispatch_stream_unit<T, kSilu>(c, bytes, stream);
    default: return dispatch_stream_unit<T, kRelu>(c, bytes, stream);
  }
}

// ------------------------------------------------------------------ product

constexpr int kBM = 128, kBN = 128, kBK = 64;  // CTA tile; K step in bytes (= int8 elements)
constexpr int kRow = kBK + 16;                 // shared row pitch in bytes: 8 rows on distinct banks
constexpr int kStages = 3;
constexpr int kThreads = 256;                  // 8 warps: 2 along M (64 rows) x 4 along N (32 columns)
constexpr int kTileBytes = kBM * kRow;         // one operand's tile in one stage (kBM == kBN)
constexpr int kSmemBytes = kStages * 2 * kTileBytes;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int src_bytes, int width) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [row0, row0 + kBM) x bytes [k0, k0 + kBK) of a (rows, K) int8
// matrix whose rows lie `ld` bytes apart into a tile of pitch kRow; zeros
// past `rows` and past K (a copy across K reads K - k bytes: never the bytes
// between K and the pitch). WIDTH bytes per copy (a divisor of ld and of the
// base's alignment); WIDTH 1 copies by plain loads and stores.
template <int WIDTH>
__device__ __forceinline__ void load_tile(int8_t* tile, const int8_t* __restrict__ g, int rows, int K,
                                          long long ld, int row0, int k0) {
  constexpr int kPerRow = kBK / WIDTH;
  constexpr int kChunks = kBM * kPerRow;
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kPerRow, kb = (c % kPerRow) * WIDTH;
    const int gr = row0 + r, gk = k0 + kb;
    const bool ok = gr < rows && gk < K;
    int8_t* dst = tile + r * kRow + kb;
    if constexpr (WIDTH == 1) {
      *dst = ok ? g[(int64_t)gr * ld + gk] : (int8_t)0;
    } else {
      const int8_t* src = ok ? g + (int64_t)gr * ld + gk : g;
      cp_async(dst, src, ok ? min(WIDTH, K - gk) : 0, WIDTH);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_one(float* p, float y) { *p = y; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float y) { *p = __float2bfloat16_rn(y); }
__device__ __forceinline__ void store_two(float* p, float y0, float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}
__device__ __forceinline__ void store_two(__nv_bfloat16* p, float y0, float y1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(y0);
  v.y = __float2bfloat16_rn(y1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// int8_linear_s8's dequantization of one element, in the plain version's order: float(acc) * (s_x[m] *
// qscale[n]), then + bias[n] read in its stored dtype; the caller's store casts. dequant_sum_s32 runs it too.
__device__ __forceinline__ float dequant(int acc, float sx, float qs, const void* bias, int bias_is_bf16, int col) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, qs));
  if (bias != nullptr) {
    const float bv = bias_is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                                  : static_cast<const float*>(bias)[col];
    y = __fadd_rn(y, bv);
  }
  return y;
}

template <typename OutT, int WIDTH>
__global__ void __launch_bounds__(kThreads)
int8_linear_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                      const float* __restrict__ s_x, const float* __restrict__ qscale,
                      const void* __restrict__ bias, int bias_is_bf16, OutT* __restrict__ out,
                      int M, int N, int K, long long ldx, long long ldw) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and thread-in-group
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = (K + kBK - 1) / kBK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto stage_a = [&](int s) { return smem + s * 2 * kTileBytes; };
  auto stage_b = [&](int s) { return smem + s * 2 * kTileBytes + kTileBytes; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_tile<WIDTH>(stage_a(s), xq, M, K, ldx, m0, s * kBK);
      load_tile<WIDTH>(stage_b(s), w, N, K, ldw, n0, s * kBK);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed for every thread; the stage read at kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      load_tile<WIDTH>(stage_a(next % kStages), xq, M, K, ldx, m0, next * kBK);
      load_tile<WIDTH>(stage_b(next % kStages), w, N, K, ldw, n0, next * kBK);
    }
    cp_async_commit();

    const int8_t* As = stage_a(kt % kStages);
    const int8_t* Bs = stage_b(kt % kStages);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * kRow + kk + t * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kRow);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn + j * 8 + g) * kRow + kk + t * 4;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator (i, j, r) holds row wm + 16 i + g (+ 8 for r >= 2),
  // column wn + 8 j + 2 t (+ 1 for odd r). An int32 output is the accumulator as it is.
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      if constexpr (std::is_same<OutT, int32_t>::value) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn + j * 8 + 2 * t;
          int32_t* o = out + (int64_t)m * N + n;
          if (pairs && n + 1 < N) {
            *reinterpret_cast<int2*>(o) = make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
            if (n < N) o[0] = acc[i][j][2 * h];
            if (n + 1 < N) o[1] = acc[i][j][2 * h + 1];
          }
        }
      } else {
        const float sx = s_x[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn + j * 8 + 2 * t;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n + e;
            y[e] = col < N ? dequant(acc[i][j][2 * h + e], sx, qscale[col], bias, bias_is_bf16, col) : 0.0f;
          }
          OutT* o = out + (int64_t)m * N + n;
          if (pairs && n + 1 < N) {
            store_two(o, y[0], y[1]);
          } else {
            if (n < N) store_one(o, y[0]);
            if (n + 1 < N) store_one(o + 1, y[1]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ dequant_sum_s32

constexpr int kMaxPartials = 8;  // shards of one row-parallel linear
constexpr int kSumThreads = 256;

struct Partials {
  const int32_t* p[kMaxPartials];
};

// V consecutive elements of one row a thread (V divides N): the partials' int32 sum (wrapping, as
// the whole product's own sum would: the total fits), then int8_linear_s8's epilogue.
template <typename OutT, int V>
__global__ void __launch_bounds__(kSumThreads)
dequant_sum_s32_kernel(const Partials parts, const int n_parts, const float* __restrict__ s_x,
                       const float* __restrict__ qscale, const void* __restrict__ bias, const int bias_is_bf16,
                       OutT* __restrict__ out, const int M, const int N) {
  const long long i = ((long long)blockIdx.x * kSumThreads + threadIdx.x) * V;
  if (i >= (long long)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  uint32_t acc[V];
  if constexpr (V == 4) {
    const int4 v = *reinterpret_cast<const int4*>(parts.p[0] + i);
    acc[0] = v.x, acc[1] = v.y, acc[2] = v.z, acc[3] = v.w;
#pragma unroll
    for (int s = 1; s < kMaxPartials; ++s) {  // constant indices: the pointers stay in the parameter bank
      if (s < n_parts) {
        const int4 w = *reinterpret_cast<const int4*>(parts.p[s] + i);
        acc[0] += (uint32_t)w.x, acc[1] += (uint32_t)w.y, acc[2] += (uint32_t)w.z, acc[3] += (uint32_t)w.w;
      }
    }
  } else {
    acc[0] = (uint32_t)parts.p[0][i];
#pragma unroll
    for (int s = 1; s < kMaxPartials; ++s)
      if (s < n_parts) acc[0] += (uint32_t)parts.p[s][i];
  }
  const float sx = s_x[m];
  float y[V];
#pragma unroll
  for (int e = 0; e < V; ++e) y[e] = dequant((int)acc[e], sx, qscale[n + e], bias, bias_is_bf16, n + e);
  OutT* o = out + i;
  if constexpr (V == 4) {
    store_two(o, y[0], y[1]);
    store_two(o + 2, y[2], y[3]);
  } else {
    store_one(o, y[0]);
  }
}

template <typename OutT, int V>
cudaError_t launch_dequant_sum(const Partials& parts, int n_parts, const void* s_x, const void* qscale,
                               const void* bias, int bias_is_bf16, void* out, int M, int N, cudaStream_t stream) {
  const long long threads = ((long long)M * N + V - 1) / V;
  dequant_sum_s32_kernel<OutT, V><<<(unsigned)((threads + kSumThreads - 1) / kSumThreads), kSumThreads, 0, stream>>>(
      parts, n_parts, static_cast<const float*>(s_x), static_cast<const float*>(qscale), bias, bias_is_bf16,
      static_cast<OutT*>(out), M, N);
  return cudaGetLastError();
}

// 4 columns a thread where N allows and every partial starts on 16 bytes (the output then on 8).
template <typename OutT>
cudaError_t dispatch_dequant_sum(const Partials& parts, int n_parts, const void* s_x, const void* qscale,
                                 const void* bias, int bias_is_bf16, void* out, int M, int N, cudaStream_t stream) {
  bool wide = N % 4 == 0 && (uintptr_t)out % (4 * sizeof(OutT)) == 0;
  for (int s = 0; s < n_parts; ++s) wide = wide && on16(parts.p[s]);
  return wide ? launch_dequant_sum<OutT, 4>(parts, n_parts, s_x, qscale, bias, bias_is_bf16, out, M, N, stream)
              : launch_dequant_sum<OutT, 1>(parts, n_parts, s_x, qscale, bias, bias_is_bf16, out, M, N, stream);
}

template <typename OutT, int WIDTH>
cudaError_t launch_linear_width(const void* xq, const void* w, const void* s_x, const void* qscale,
                                const void* bias, int bias_is_bf16, void* out, int M, int N, int K,
                                long long ldx, long long ldw, cudaStream_t stream) {
  auto kernel = int8_linear_s8_kernel<OutT, WIDTH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN), block(kThreads);
  kernel<<<grid, block, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), static_cast<const float*>(s_x),
      static_cast<const float*>(qscale), bias, bias_is_bf16, static_cast<OutT*>(out), M, N, K, ldx, ldw);
  return cudaGetLastError();
}

// The widest copy that keeps both operands' rows aligned: it divides both
// pitches and both bases (K need not be a multiple: the copy across K is cut
// short).
int copy_width(const void* xq, const void* w, long long ldx, long long ldw) {
  int width = 16;
  while (width > 1 && (ldx % width || ldw % width || (uintptr_t)xq % width || (uintptr_t)w % width))
    width = width == 4 ? 1 : width / 2;
  return width;
}

template <typename OutT>
cudaError_t launch_linear(const void* xq, const void* w, const void* s_x, const void* qscale,
                          const void* bias, int bias_is_bf16, void* out, int M, int N, int K,
                          long long ldx, long long ldw, cudaStream_t stream) {
  switch (copy_width(xq, w, ldx, ldw)) {
    case 16:
      return launch_linear_width<OutT, 16>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, stream);
    case 8:
      return launch_linear_width<OutT, 8>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, stream);
    case 4:
      return launch_linear_width<OutT, 4>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, stream);
    default:
      return launch_linear_width<OutT, 1>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, stream);
  }
}

}  // namespace

// The quantizer of `prologue` (Prologue) over rows x cols values of float32 or
// bfloat16 operands -> xq (rows, cols) int8, its rows ldq >= cols bytes apart,
// and scale (rows,) float32.
// a's element (m, k) lies at a + (m / a_t) a_sb + (m % a_t) a_st + (k / a_d) a_sh
// + k % a_d elements (a_sh = 0: + k); b (the activations' second operand, or
// null) at b + m ldb + k; gamma, beta (cols,) and eps are layernorm's, which
// also writes its mean and 1 / sqrt(var + eps) per row where mean and rstd are
// not null. `mode` (Mode): one-pass; amax-only, which writes each row's abs-max
// to amax (rows,) float32 and neither xq nor scale (both may be null); given-amax,
// which reads it from amax. Returns the launch's cudaError.
extern "C" int atlas_quantize_rows_s8(int prologue, int x_is_bf16, int rows, int cols, const void* a, long long a_sb,
                                      long long a_st, int a_t, long long a_sh, int a_d, const void* b, long long ldb,
                                      const void* gamma, const void* beta, float eps, void* xq, long long ldq,
                                      void* scale, void* mean, void* rstd, int mode, void* amax, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kQuantMaxCols || a_t <= 0 || a_d <= 0 || prologue < kIdentity ||
      prologue > kRelu || (prologue == kLayerNorm && (gamma == nullptr || beta == nullptr)) ||
      ((mean == nullptr) != (rstd == nullptr)) || mode < kOnePass || mode > kGivenAmax ||
      ((mode == kOnePass) != (amax == nullptr)) ||
      (mode != kAmaxOnly && (xq == nullptr || scale == nullptr || ldq < cols)))
    return (int)cudaErrorInvalidValue;
  const QuantCall c{{a, a_sb, a_st, a_sh, a_t, a_d}, b, ldb, gamma, beta, eps, xq, ldq, scale, mean, rstd, mode,
                    amax, rows, cols};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16 ? dispatch_prologue<__nv_bfloat16>(prologue, c, s) : dispatch_prologue<float>(prologue, c, s));
}

// The tensor-parallel modes on their streamed bodies: atlas_quantize_rows_s8's operands, prologue (not
// layernorm) and mode, in units of `unit_bytes` (32, 16 or 8, or one element's size) that must fit every
// operand (stream_unit_fits). Amax-only writes amax (rows,) and, for an activation, its values to act
// (rows, cols) contiguous in x's dtype (act is required there and refused for the identity); given-amax
// takes the identity prologue only, reads amax and writes xq (rows ldq >= cols bytes apart) and scale.
// Returns the launch's cudaError.
extern "C" int atlas_quantize_rows_s8_stream(int prologue, int x_is_bf16, int rows, int cols, const void* a,
                                             long long a_sb, long long a_st, int a_t, long long a_sh, int a_d,
                                             const void* b, long long ldb, int unit_bytes, void* xq, long long ldq,
                                             void* scale, int mode, void* amax, void* act, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kQuantMaxCols || a_t <= 0 || a_d <= 0 || prologue < kIdentity ||
      prologue > kRelu || prologue == kLayerNorm || amax == nullptr ||
      (mode != kAmaxOnly && mode != kGivenAmax) ||
      (mode == kGivenAmax && (prologue != kIdentity || xq == nullptr || scale == nullptr || ldq < cols)) ||
      (prologue == kIdentity ? (b != nullptr || act != nullptr) : act == nullptr))
    return (int)cudaErrorInvalidValue;
  QuantCall c{{a, a_sb, a_st, a_sh, a_t, a_d}, b, ldb, nullptr, nullptr, 0.0f, xq, ldq, scale, nullptr, nullptr, mode,
              amax, rows, cols, act};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16 ? dispatch_stream<__nv_bfloat16>(prologue, c, unit_bytes, s)
                         : dispatch_stream<float>(prologue, c, unit_bytes, s));
}

// The out types of atlas_int8_linear_s8, in ops/int8.py::_OUT_CODES's order.
enum OutType : int { kOutF32, kOutBF16, kOutS32 };

// xq (M, K) int8 and w (N, K) int8 with rows ldx and ldw >= K bytes apart,
// s_x (M,) and qscale (N,) float32, bias (N,) float32 or bfloat16 or null,
// contiguous -> out (M, N), contiguous, of `out_type`
// (OutType): float32 or bfloat16, dequantized, or int32, the accumulator as it
// is (s_x, qscale and bias unread, and may be null). Returns the launch's
// cudaError.
extern "C" int atlas_int8_linear_s8(const void* xq, const void* w, const void* s_x, const void* qscale,
                                    const void* bias, int bias_is_bf16, void* out, int out_type, int M,
                                    int N, int K, long long ldx, long long ldw, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < K || (N + kBN - 1) / kBN > 65535 || out_type < kOutF32 ||
      out_type > kOutS32 || (out_type != kOutS32 && (s_x == nullptr || qscale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_type) {
    case kOutBF16:
      return (int)launch_linear<__nv_bfloat16>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, s);
    case kOutS32:
      return (int)launch_linear<int32_t>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, s);
    default:
      return (int)launch_linear<float>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, s);
  }
}

// partials: a host array of n_parts (1 to kMaxPartials) pointers to (M, N) int32,
// contiguous, on one card; s_x (M,), qscale (N,) float32, bias (N,) float32 or
// bfloat16 or null -> out (M, N) float32 or bfloat16. Returns the launch's cudaError.
extern "C" int atlas_dequant_sum_s32(const void* const* partials, int n_parts, const void* s_x, const void* qscale,
                                     const void* bias, int bias_is_bf16, void* out, int out_is_bf16, int M, int N,
                                     void* stream) {
  if (M <= 0 || N <= 0 || n_parts < 1 || n_parts > kMaxPartials || (long long)M * N >= (1LL << 38))
    return (int)cudaErrorInvalidValue;
  Partials parts{};
  for (int i = 0; i < n_parts; ++i) parts.p[i] = static_cast<const int32_t*>(partials[i]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_is_bf16
                   ? dispatch_dequant_sum<__nv_bfloat16>(parts, n_parts, s_x, qscale, bias, bias_is_bf16, out, M, N, s)
                   : dispatch_dequant_sum<float>(parts, n_parts, s_x, qscale, bias, bias_is_bf16, out, M, N, s));
}
