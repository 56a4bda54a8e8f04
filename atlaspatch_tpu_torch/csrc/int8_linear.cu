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
// quantize_rows_s8: one warp per row. It reads the row (bfloat16 or float32)
// as 16-byte vectors, takes its abs-max in float32 (a butterfly over the
// warp), then reads it again (from L1) and writes q = clamp(rint(x / s),
// -127, 127) as int8 with s = max(amax, 1e-8) / 127, both divisions IEEE
// round-to-nearest (__fdiv_rn) and rint half-to-even, as jnp.round rounds.
// Bound on an H100 SXM: bytes (2 or 4 bytes in, 1 out per element, a few
// operations each).
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
// the copy zero-fills past K, and its width (16, 8, 4 or 1 bytes) is the
// largest that divides K. The epilogue is the dequantization, element by
// element in the plain version's order: y = float(acc) * (s_x[m] *
// qscale[n]), then + bias[n] (read in its stored dtype), then the cast
// (bfloat16 round-to-nearest-even or float32), all through the _rn
// intrinsics, which the compiler never contracts into an FMA (and the
// library is built with -fmad=false besides): a fused multiply-add rounds
// once and would not equal the plain version. The int32 sum is exact, so the
// result equals the plain version bit for bit. wgmma s8 fed by TMA is the
// later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// ---------------------------------------------------------------- quantizer

constexpr int kQuantWarps = 8;  // rows per CTA, one warp each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <int VEC>
struct alignas(VEC) Bytes {
  int8_t v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_s8_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ scale,
                        int rows, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantWarps + warp;
  if (row >= rows) return;
  const Vec<T, VEC>* src = reinterpret_cast<const Vec<T, VEC>*>(x + (int64_t)row * cols);
  Bytes<VEC>* dst = reinterpret_cast<Bytes<VEC>*>(xq + (int64_t)row * cols);
  const int n = cols / VEC;  // VEC divides cols
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

template <typename T>
cudaError_t launch_quantize(const void* x, void* xq, void* scale, int rows, int cols, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((rows + kQuantWarps - 1) / kQuantWarps), block(kQuantWarps * 32);
  const bool vec = cols % kVec == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)xq % kVec == 0;
  if (vec)
    quantize_rows_s8_kernel<T, kVec><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(scale), rows, cols);
  else
    quantize_rows_s8_kernel<T, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(scale), rows, cols);
  return cudaGetLastError();
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
// matrix into a tile of pitch kRow; zeros past `rows` and past K. WIDTH bytes
// per copy (a divisor of K); WIDTH 1 copies by plain loads and stores.
template <int WIDTH>
__device__ __forceinline__ void load_tile(int8_t* tile, const int8_t* __restrict__ g, int rows, int K,
                                          int row0, int k0) {
  constexpr int kPerRow = kBK / WIDTH;
  constexpr int kChunks = kBM * kPerRow;
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kPerRow, kb = (c % kPerRow) * WIDTH;
    const int gr = row0 + r, gk = k0 + kb;
    const bool ok = gr < rows && gk < K;
    int8_t* dst = tile + r * kRow + kb;
    if constexpr (WIDTH == 1) {
      *dst = ok ? g[(int64_t)gr * K + gk] : (int8_t)0;
    } else {
      const int8_t* src = ok ? g + (int64_t)gr * K + gk : g;
      cp_async(dst, src, ok ? WIDTH : 0, WIDTH);
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

template <typename OutT, int WIDTH>
__global__ void __launch_bounds__(kThreads)
int8_linear_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                      const float* __restrict__ s_x, const float* __restrict__ qscale,
                      const void* __restrict__ bias, int bias_is_bf16, OutT* __restrict__ out,
                      int M, int N, int K) {
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
      load_tile<WIDTH>(stage_a(s), xq, M, K, m0, s * kBK);
      load_tile<WIDTH>(stage_b(s), w, N, K, n0, s * kBK);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed for every thread; the stage read at kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      load_tile<WIDTH>(stage_a(next % kStages), xq, M, K, m0, next * kBK);
      load_tile<WIDTH>(stage_b(next % kStages), w, N, K, n0, next * kBK);
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
  // column wn + 8 j + 2 t (+ 1 for odd r).
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float sx = s_x[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n + e;
          y[e] = 0.0f;
          if (col >= N) continue;
          y[e] = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), __fmul_rn(sx, qscale[col]));
          if (bias != nullptr) {
            const float bv = bias_is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                                          : static_cast<const float*>(bias)[col];
            y[e] = __fadd_rn(y[e], bv);
          }
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

template <typename OutT, int WIDTH>
cudaError_t launch_linear_width(const void* xq, const void* w, const void* s_x, const void* qscale,
                                const void* bias, int bias_is_bf16, void* out, int M, int N, int K,
                                cudaStream_t stream) {
  auto kernel = int8_linear_s8_kernel<OutT, WIDTH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN), block(kThreads);
  kernel<<<grid, block, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), static_cast<const float*>(s_x),
      static_cast<const float*>(qscale), bias, bias_is_bf16, static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

// The widest copy that divides K and keeps both operands' rows aligned.
int copy_width(const void* xq, const void* w, int K) {
  int width = 16;
  while (width > 1 && (K % width || (uintptr_t)xq % width || (uintptr_t)w % width)) width = width == 4 ? 1 : width / 2;
  return width;
}

template <typename OutT>
cudaError_t launch_linear(const void* xq, const void* w, const void* s_x, const void* qscale,
                          const void* bias, int bias_is_bf16, void* out, int M, int N, int K,
                          cudaStream_t stream) {
  switch (copy_width(xq, w, K)) {
    case 16:
      return launch_linear_width<OutT, 16>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, stream);
    case 8:
      return launch_linear_width<OutT, 8>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, stream);
    case 4:
      return launch_linear_width<OutT, 4>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, stream);
    default:
      return launch_linear_width<OutT, 1>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, stream);
  }
}

}  // namespace

// x (rows, cols) float32 or bfloat16, contiguous -> xq (rows, cols) int8 and
// scale (rows,) float32. Returns the launch's cudaError.
extern "C" int atlas_quantize_rows_s8(const void* x, int x_is_bf16, void* xq, void* scale, int rows, int cols,
                                      void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16 ? launch_quantize<__nv_bfloat16>(x, xq, scale, rows, cols, s)
                         : launch_quantize<float>(x, xq, scale, rows, cols, s));
}

// xq (M, K) int8, w (N, K) int8, s_x (M,) and qscale (N,) float32, bias (N,)
// float32 or bfloat16 or null, all contiguous -> out (M, N) float32 or
// bfloat16. Returns the launch's cudaError.
extern "C" int atlas_int8_linear_s8(const void* xq, const void* w, const void* s_x, const void* qscale,
                                    const void* bias, int bias_is_bf16, void* out, int out_is_bf16, int M,
                                    int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (N + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_is_bf16
                   ? launch_linear<__nv_bfloat16>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, s)
                   : launch_linear<float>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, s));
}
