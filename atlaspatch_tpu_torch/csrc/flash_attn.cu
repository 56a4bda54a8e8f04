// Flash attention forward for Hopper (sm_90a): non-causal, unmasked
// softmax(Q K^T * scale) V over (B*H, T, D) with T_q != T_kv allowed.
//
// Replaces the TPU kernel atlaspatch_tpu/ops/attention.py::_flash_kernel
// (Pallas, launched by flash_attention). It computes the same function: the
// online-softmax recurrence over K/V tiles with float32 running max, sum and
// accumulator, so the (T_q, T_kv) score matrix never reaches device memory.
// The TPU blocking is not carried over: no 512-row VMEM blocks and no zero
// pad of D=96 to 128. K/V are walked in 64-row tiles; the ragged last tile of
// T_q and T_kv is masked, since the Hiera shapes (T = 4, 16, 49, 196) are not
// multiples of 64. Q, K, V and O are (B, H, T, D) with D contiguous and any
// other strides, so the trunk hands over its fused qkv projection and takes
// back a (B, T, H, D) output without a transposing copy either way.
//
// Bound on an H100 SXM: the work is 4*T_q*T_kv*D flop against
// 2*(T_q+T_kv)*D*bytes of traffic. At the global blocks it is bound by
// operations (T=2304, D=96, B*H=32 in bfloat16: 65.2 GFLOP vs 56.6 MB, 66 us
// at the 989 TFLOP/s bf16 tensor-core peak vs 17 us at 3.35 TB/s); the
// windowed blocks (T <= 196) are bound by bytes. Three bodies, by input type
// and shape:
//
// bfloat16 (the --fast path): QK^T and PV run on the tensor cores as
// mma.sync m16n8k16 (bf16 in, float32 accumulate). A CTA of W warps owns a
// (b*h, 16*W-row Q tile); each warp keeps its 16 Q rows as A fragments in
// registers for the whole K/V walk, and its 16 x 64 score tile and 16 x D
// output accumulator in registers, so scores never touch shared memory: the
// score accumulator is re-packed to bf16 in place as the A fragment of PV
// (the rounding of p to bf16 that the plain version makes too). Q, K and V
// reach shared memory by cp.async, row-major with padded rows, and the
// fragments come out by ldmatrix (V's transposed) without bank conflicts.
// Where T_kv spans several tiles and W = 4, the K/V tiles are
// double-buffered: tile i+1 loads while tile i is multiplied. W is 1 when
// T_q <= 16 (the q-pool blocks hand it T_q = 4 and 16), so small Q tiles do
// not leave three warps idle. mma.sync reaches only part of the tensor-core
// peak: bfloat16 with D in {64, 96, 128} and T_q > 16 goes to the wgmma + TMA
// body in flash_attn_wgmma.cu instead (ops/attention.py::kernel_variant).
//
// float32 with T_q > 16 and D in {64, 96} (tf32x3, the reference-exact
// default's global and windowed blocks): the same mma.sync structure on
// m16n8k8 TF32, error-compensated: each operand x is split into big =
// tf32(x) and small = tf32(x - big), and each product is small*big +
// big*small + big*big, which keeps float32 accuracy (ops/attention.py::
// f32_error_limit). Its bound is those 3 x 4*T_q*T_kv*D flop at the 495
// TFLOP/s TF32 rate: 0.156 ms at the global block (B*H=4, 4096, 4096, 96),
// where the FMA body's 67 TFLOP/s FP32 rate allows 0.385 ms. SDPA's float32
// route runs the same scheme (PyTorch's memory-efficient attention on
// OpMultiplyAddFastF32). 4 warps own a 64-row Q tile, held as big and small
// A fragments in registers; K/V arrive in 64-key tiles by cp.async, double-
// buffered, and their B fragments come out of shared memory without bank
// conflicts (K as 8-byte loads) to be split in registers. P needs no
// shuffle: the keys of each 8-key group are relabelled so that the score
// accumulator is P's A fragment as it stands. Choices measured on an H100
// (tools/tf32x3_variants.py, PERF.md): the split is an integer add and mask
// (cvt.rna.tf32.f32 compiles to a compare-and-select sequence, about 1.3x
// slower overall); PV's products go into a fresh accumulator per two key
// groups, since the tensor cores truncate the sums they accumulate and,
// chained over T_kv, that drift left f32_error_limit; 255 registers at
// D = 96 allow 2 CTAs per SM, and D = 128 spills, so it stays on the FMA
// body.
//
// float32 otherwise (T_q <= 16: the q-pool and stage-1 blocks; other D):
// float32 FMA on the CUDA cores (no TF32), 256 threads per 64-row Q tile,
// each thread a 4x4 block of scores and a 4-row block of the output, fed by
// 16-byte shared-memory loads. Its bound is the 67 TFLOP/s FP32 rate it uses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 64;  // key rows per K/V tile (every body)

// Element strides of one (B, H, T, D) operand; D is contiguous.
struct Strides {
  int64_t b, h, t;
};

struct Layout {
  Strides q, k, v, o;
  int heads;
};

// Offset of head `bh` (= b * heads + h) of an operand.
__device__ __forceinline__ int64_t head_offset(const Strides& s, int64_t bh, int heads) {
  return (bh / heads) * s.b + (bh % heads) * s.h;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA
// ---------------------------------------------------------------------------
//
// A CTA of 256 threads owns a (b*h, 64-row Q tile); thread (tx, ty),
// tx, ty < 16, holds the scores of rows 4ty..4ty+3 and keys 4tx..4tx+3 of each
// 64-key tile, and the output of those rows at columns 2tx + 32c + {0, 1}.
// Q and K sit transposed in shared memory, so each step of QK^T is two
// 16-byte loads (4 rows of Q, 4 keys of K) for 16 FMAs; P goes through
// shared memory row-major and V row-major, so PV reads 4 keys of P per
// 16-byte load and V in 8-byte pairs that a half-warp takes from 32
// consecutive banks.

constexpr int kF32BlockM = 64;            // query rows per CTA
constexpr int kF32Threads = 256;          // 16 x 16
constexpr int kF32TStride = kBlockN + 4;  // row stride (floats) of Q^T, K^T and P:
                                          // 16-byte rows

template <int D>
constexpr size_t f32_smem_bytes() {
  // Q^T [D][kF32TStride], K^T [D][kF32TStride], V [kBlockN][D], P [kF32BlockM][kF32TStride]
  return sizeof(float) *
         (size_t)(2 * D * kF32TStride + kBlockN * D + kF32BlockM * kF32TStride);
}

// 64 x D tile of a row-major source (rows `row_stride` apart) into
// shared memory transposed, dst[d * kF32TStride + r], times `mul` and zero
// beyond `valid` rows. Consecutive threads take consecutive rows, so the
// 4-byte stores of a warp land in distinct banks.
template <int D>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int64_t row_stride,
                                                int valid, float mul, int tid) {
  constexpr int rows = 64;  // kF32BlockM == kBlockN
  for (int e = tid; e < rows * (D / 4); e += kF32Threads) {
    const int r = e % rows;
    const int d = (e / rows) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * row_stride + d);
    dst[(d + 0) * kF32TStride + r] = x.x * mul;
    dst[(d + 1) * kF32TStride + r] = x.y * mul;
    dst[(d + 2) * kF32TStride + r] = x.z * mul;
    dst[(d + 3) * kF32TStride + r] = x.w * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Layout L, int tq,
                     int tk, float scale) {
  constexpr int kPairs = (D + 31) / 32;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;                // Q^T, pre-scaled
  float* ks = qs + D * kF32TStride;    // K^T
  float* vs = ks + D * kF32TStride;    // V
  float* ps = vs + kBlockN * D;        // P

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // keys 4tx..4tx+3; output columns 2tx + 32c + {0, 1}
  const int ty = tid >> 4;  // rows 4ty..4ty+3
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kF32BlockM;
  const int q_rows = min(kF32BlockM, tq - q0);
  const float* kb = k + head_offset(L.k, bh, L.heads);
  const float* vb = v + head_offset(L.v, bh, L.heads);

  load_transposed<D>(qs, q + head_offset(L.q, bh, L.heads) + q0 * L.q.t, L.q.t, q_rows, scale,
                     tid);

  float m[4], l[4], acc[4][2 * kPairs];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * kPairs; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < tk; kv0 += kBlockN) {
    const int kv_rows = min(kBlockN, tk - kv0);
    __syncthreads();  // the previous tile's readers are done (and Q^T is written)
    load_transposed<D>(ks, kb + kv0 * L.k.t, L.k.t, kv_rows, 1.f, tid);
    for (int e = tid; e < kBlockN * (D / 4); e += kF32Threads) {
      const int r = e / (D / 4);
      const int c = (e - r * (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < kv_rows) x = *reinterpret_cast<const float4*>(vb + (kv0 + r) * L.v.t + c);
      *reinterpret_cast<float4*>(vs + r * D + c) = x;
    }
    __syncthreads();

    // S = (Q * scale) K^T for rows 4ty+i, keys 4tx+j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(qs + d * kF32TStride + 4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(ks + d * kF32TStride + 4 * tx);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // Online softmax update; the 16 threads of a row are 16 consecutive lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * tx + j >= kv_rows) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: key 0 of every tile is valid
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * kF32TStride + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * kPairs; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V, 4 keys at a time (V rows past the ragged end are zero).
    for (int n4 = 0; n4 < kv_rows; n4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kF32TStride + n4);
        p[i][0] = x.x;
        p[i][1] = x.y;
        p[i][2] = x.z;
        p[i][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (n4 + jj) * D + 2 * tx;
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          if (D % 32 == 0 || 2 * tx + 32 * c < D) {
            const float2 w = *reinterpret_cast<const float2*>(vrow + 32 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][2 * c] = fmaf(p[i][jj], w.x, acc[i][2 * c]);
              acc[i][2 * c + 1] = fmaf(p[i][jj], w.y, acc[i][2 * c + 1]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= q_rows) continue;
    float* orow = o + head_offset(L.o, bh, L.heads) + (q0 + r) * L.o.t + 2 * tx;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kPairs; ++c)
      if (D % 32 == 0 || 2 * tx + 32 * c < D)
        *reinterpret_cast<float2*>(orow + 32 * c) =
            make_float2(acc[i][2 * c] * inv, acc[i][2 * c + 1] * inv);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, const Layout& L,
                       int bh, int tq, int tk, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + kF32BlockM - 1) / kF32BlockM);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), L, tq, tk, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4*g + t:
//   A (16x16, row-major): {a0,a1} = A[g][2t..2t+1],   {a2,a3} = A[g+8][2t..2t+1],
//                         {a4,a5} = A[g][2t+8..+9],   {a6,a7} = A[g+8][2t+8..+9]
//   B (16x8, "col"):      {b0,b1} = B[2t..2t+1][g],   {b2,b3} = B[2t+8..+9][g]
//   C (16x8, float32):    c0,c1 = C[g][2t..2t+1],     c2,c3 = C[g+8][2t..2t+1]
// Each pair of bf16 is one 32-bit register, the lower index in the low half.
// ldmatrix.x4 loads four 8x8 b16 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i; lane 4g+t receives row g, columns 2t..2t+1 of each
// (with .trans: rows 2t..2t+1, column g). So the A fragment of a 16x16
// row-major tile is one ldmatrix.x4, the B fragments of two k-steps of
// K^T (K row-major: rows are keys) one ldmatrix.x4, and the B fragments of
// two n-tiles of V (row-major: rows are keys) one ldmatrix.x4.trans.

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without passing through registers; copies
// nothing and writes zeros when !valid (`src` must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int W, int kStages_>
struct MmaShape {
  static constexpr int kThreads = 32 * W;
  static constexpr int kBlockM = 16 * W;
  static constexpr int kStages = kStages_;         // K/V buffers: 2 overlap the next
                                                   // tile's load with this one's math
  static constexpr int kDPad = (D + 31) / 32 * 32; // smem columns: whole pairs of
                                                   // 16-wide k-steps and 8-wide n-tiles
  static constexpr int kStride = kDPad + 8;        // smem row (bf16): 16-byte aligned,
                                                   // rows 8 apart in distinct banks
  static constexpr int kTile = kBlockN * kStride;  // one K or V buffer (bf16)
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * (size_t)(kBlockM * kStride + 2 * kStages * kTile);
};

// `rows` x kDPad tile from a source of rows `row_stride` elements apart into
// smem rows of kStride, zero beyond `valid` rows and beyond column D; cp.async
// of 16 bytes per thread and step, not waited for here.
template <int D, int W>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int64_t row_stride, int rows, int valid,
                                                int tid) {
  using S = MmaShape<D, W, 1>;
  constexpr int kVecs = S::kDPad / 8;
  for (int e = tid; e < rows * kVecs; e += S::kThreads) {
    const int r = e / kVecs;
    const int c = (e - r * kVecs) * 8;
    const bool ok = r < valid && c < D;
    cp_async_16(dst + r * S::kStride + c, ok ? src + r * row_stride + c : src, ok);
  }
}

template <int D, int W, int kStages>
__global__ void __launch_bounds__(32 * W)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      Layout L, int tq, int tk, float scale_log2) {
  using S = MmaShape<D, W, kStages>;
  constexpr int kKSteps = S::kDPad / 16;  // QK^T k-steps (even)
  constexpr int kNTiles = S::kDPad / 8;   // PV n-tiles over the head dim (even; those
                                          // past D read zero columns, store nothing)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBlockM][kStride]
  __nv_bfloat16* ks = qs + S::kBlockM * S::kStride;                // [kStages][kBlockN][kStride]
  __nv_bfloat16* vs = ks + S::kStages * S::kTile;                  // [kStages][kBlockN][kStride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * S::kBlockM;
  const int q_rows = min(S::kBlockM, tq - q0);
  const __nv_bfloat16* kb = k + head_offset(L.k, bh, L.heads);
  const __nv_bfloat16* vb = v + head_offset(L.v, bh, L.heads);
  const int n_tiles = (tk + kBlockN - 1) / kBlockN;

  // Rows read of a K/V tile: whole 16-key chunks. Rows past the ragged end
  // are zero, so P (0 there) times V stays 0.
  auto load_kv = [&](int tile, int stage) {
    const int kv0 = tile * kBlockN;
    const int valid = min(kBlockN, tk - kv0);
    const int rows = min(kBlockN, (valid + 15) / 16 * 16);
    load_tile_async<D, W>(ks + stage * S::kTile, kb + kv0 * L.k.t, L.k.t, rows, valid, tid);
    load_tile_async<D, W>(vs + stage * S::kTile, vb + kv0 * L.v.t, L.v.t, rows, valid, tid);
    cp_async_commit();
  };

  load_tile_async<D, W>(qs, q + head_offset(L.q, bh, L.heads) + q0 * L.q.t, L.q.t, S::kBlockM,
                        q_rows, tid);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_wait<1>();  // Q has landed (tile 0 may still be in flight)
  __syncthreads();

  // This warp's 16 Q rows as A fragments, kept in registers.
  uint32_t qf[kKSteps][4];
  {
    const __nv_bfloat16* qa =
        qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kStride + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
  }

  // Rows g and g+8 of this warp's 16: running max (log2 units) and this
  // lane's partial row sum (its 2 columns of each 8-column tile).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv_rows = min(kBlockN, tk - it * kBlockN);
    if constexpr (S::kStages == 2) {
      if (it + 1 < n_tiles) {
        load_kv(it + 1, (it + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (it > 0) load_kv(it, 0);
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp
    const __nv_bfloat16* kt = ks + (S::kStages == 2 ? it & 1 : 0) * S::kTile;
    const __nv_bfloat16* vt = vs + (S::kStages == 2 ? it & 1 : 0) * S::kTile;

    // S = Q K^T: 8 n-tiles of 8 keys; tiles wholly past the ragged end are
    // skipped (the branch is uniform across the warp).
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if (j * 8 < kv_rows) {
        const __nv_bfloat16* kr = kt + (j * 8 + (lane & 7)) * S::kStride + (lane >> 3) * 8;
#pragma unroll
        for (int kk = 0; kk < kKSteps; kk += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kr + kk * 16);
          mma_bf16(s[j], qf[kk], b[0], b[1]);
          mma_bf16(s[j], qf[kk + 1], b[2], b[3]);
        }
      }
    }

    // Online softmax in log2 units; the 4 lanes of a row are lanes 4g..4g+3.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j * 8 + 2 * t + e < kv_rows;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);  // finite: key 0 of every tile is valid
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += P V: the score tiles 2c and 2c+1, rounded to bf16, are the A
    // fragment of key chunk c; one ldmatrix.trans gives the B fragments of
    // n-tiles n and n+1.
#pragma unroll
    for (int c = 0; c < kBlockN / 16; ++c) {
      if (c * 16 < kv_rows) {
        const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                               pack_bf16(s[2 * c][2], s[2 * c][3]),
                               pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                               pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
        const __nv_bfloat16* vr =
            vt + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kStride + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < kNTiles; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vr + n * 8);
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = warp * 16 + g;
  __nv_bfloat16* ob0 = o + head_offset(L.o, bh, L.heads) + (q0 + r0) * L.o.t + 2 * t;
  __nv_bfloat16* ob1 = ob0 + 8 * L.o.t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < q_rows)
      *reinterpret_cast<uint32_t*>(ob0 + n * 8) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r0 + 8 < q_rows)
      *reinterpret_cast<uint32_t*>(ob1 + n * 8) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D, int W, int kStages>
cudaError_t launch_bf16_warps(const void* q, const void* k, const void* v, void* o,
                              const Layout& L, int bh, int tq, int tk, float scale,
                              cudaStream_t stream) {
  constexpr size_t smem = MmaShape<D, W, kStages>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D, W, kStages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + 16 * W - 1) / (16 * W));
  flash_fwd_bf16_kernel<D, W, kStages><<<grid, 32 * W, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), L, tq, tk,
      scale * 1.4426950408889634f);  // exp(x) = exp2(x * log2(e))
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const Layout& L,
                        int bh, int tq, int tk, float scale, cudaStream_t stream) {
  // One warp for Q tiles of up to 16 rows; a second K/V buffer only where
  // there is a second tile to load (it costs occupancy otherwise).
  if (tq <= 16) return launch_bf16_warps<D, 1, 1>(q, k, v, o, L, bh, tq, tk, scale, stream);
  if (tk <= kBlockN) return launch_bf16_warps<D, 4, 1>(q, k, v, o, L, bh, tq, tk, scale, stream);
  return launch_bf16_warps<D, 4, 2>(q, k, v, o, L, bh, tq, tk, scale, stream);
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32), lane = 4*g + t:
//   A (16x8, row-major): a0 = A[g][t],  a1 = A[g+8][t],  a2 = A[g][t+4],  a3 = A[g+8][t+4]
//   B (8x8, "col"):      b0 = B[t][g],  b1 = B[t+4][g]
//   C (16x8, float32):   c0,c1 = C[g][2t..2t+1],  c2,c3 = C[g+8][2t..2t+1]
// The k index of an mma is only a label that A and B share. QK^T: in k-step
// kk, k-column t is d = 8kk + 2t and t+4 is d = 8kk + 2t + 1, so K's B
// fragment b0/b1 = K[key g][8kk + 2t, +1] is one 8-byte load; K rows of D + 8
// floats are 8 banks apart, so a half-warp's loads cover banks 8g + 2t (+1)
// once each. PV: within each 8-key group k-column t is key 2t and t+4 is key
// 2t+1. The score accumulator of that group, {c0, c2, c1, c3}, is then P's A
// fragment as it stands, and b0/b1 = V[key 2t / 2t+1][column g]; V rows of
// D + 4 floats are 4 banks apart, so those loads hit banks 8t + g (+4): 32
// distinct banks, no conflict.

constexpr int kTf32Warps = 4;
constexpr int kTf32Threads = 32 * kTf32Warps;
constexpr int kTf32BlockM = 16 * kTf32Warps;  // query rows per CTA
constexpr int kTf32PvGroups = 2;               // 8-key groups per fresh PV accumulator
static_assert(kTf32BlockM == kBlockN, "the Q tile passes through a K buffer");

template <int D>
struct Tf32Shape {
  // smem rows (floats), 16-byte aligned: K's 8 banks apart (its fragments
  // are 8-byte loads), V's 4 banks apart (32-bit loads from two rows).
  static constexpr int kStrideK = D + 8;
  static constexpr int kStrideV = D + 4;
  static constexpr int kTileK = kBlockN * kStrideK;  // one Q or K buffer (floats)
  static constexpr int kTileV = kBlockN * kStrideV;  // one V buffer
  // K and V, two stages each; Q passes through the second K buffer first.
  static constexpr size_t kSmemBytes = sizeof(float) * 2 * (size_t)(kTileK + kTileV);
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
// as cvt.rna.tf32.f32 rounds; an integer add and mask, since cvt.rna.tf32.f32
// compiles to a longer compare-and-select sequence.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to within 2^-22 |x|; both TF32, rounded to nearest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));  // exact in float32
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as small*big + big*small + big*big (CUTLASS's OpMultiplyAddFastF32
// order: the small terms first, so they are not lost below the big one).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split_tf32(b0, b0_big, b0_small);
  split_tf32(b1, b1_big, b1_small);
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// 64 x D rows of a float32 source (rows `row_stride` apart) into smem rows of
// kStride floats, zero beyond `valid` rows; cp.async, not waited for here.
template <int D, int kStride>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int64_t row_stride,
                                              int valid, int tid) {
  constexpr int kVecs = D / 4;
  for (int e = tid; e < kBlockN * kVecs; e += kTf32Threads) {
    const int r = e / kVecs;
    const int c = (e - r * kVecs) * 4;
    const bool ok = r < valid;
    cp_async_16(dst + r * kStride + c, ok ? src + r * row_stride + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kTf32Threads, 2)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, Layout L, int tq,
                        int tk, float scale_log2) {
  using S = Tf32Shape<D>;
  constexpr int kSteps = D / 8;  // QK^T k-steps, and PV n-tiles over the head dim
  extern __shared__ __align__(16) float smem_tf32[];
  float* ks = smem_tf32;           // [2][kBlockN][kStrideK]
  float* vs = ks + 2 * S::kTileK;  // [2][kBlockN][kStrideV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTf32BlockM;
  const int q_rows = min(kTf32BlockM, tq - q0);
  const float* kb = k + head_offset(L.k, bh, L.heads);
  const float* vb = v + head_offset(L.v, bh, L.heads);
  const int n_tiles = (tk + kBlockN - 1) / kBlockN;

  // Every K/V tile is 64 whole rows, zero past T_kv: QK^T runs on all of
  // them (their scores are masked) and P (0 there) times V stays 0.
  auto load_kv = [&](int tile, int stage) {
    const int kv0 = tile * kBlockN;
    const int valid = min(kBlockN, tk - kv0);
    load_rows_f32<D, S::kStrideK>(ks + stage * S::kTileK, kb + kv0 * L.k.t, L.k.t, valid, tid);
    load_rows_f32<D, S::kStrideV>(vs + stage * S::kTileV, vb + kv0 * L.v.t, L.v.t, valid, tid);
    cp_async_commit();
  };

  load_rows_f32<D, S::kStrideK>(ks + S::kTileK, q + head_offset(L.q, bh, L.heads) + q0 * L.q.t,
                                L.q.t, q_rows, tid);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_wait<1>();  // Q has landed (tile 0 may still be in flight)
  __syncthreads();

  // This warp's 16 Q rows, times scale * log2(e) (scores come out in log2
  // units), as big and small A fragments kept in registers. In k-step kk,
  // k-column t is d = 8kk + 2t and t+4 is 8kk + 2t + 1 (K's B fragment
  // takes the same labels, so it is one 8-byte load).
  uint32_t q_big[kSteps][4], q_small[kSteps][4];
  {
    const float* qr = ks + S::kTileK + (warp * 16 + g) * S::kStrideK + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const float x[4] = {qr[kk * 8], qr[8 * S::kStrideK + kk * 8], qr[kk * 8 + 1],
                          qr[8 * S::kStrideK + kk * 8 + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i] * scale_log2, q_big[kk][i], q_small[kk][i]);
    }
  }
  __syncthreads();  // every warp holds its Q before tile 1 overwrites the buffer

  // Rows g and g+8 of this warp's 16: running max (log2 units) and this
  // lane's partial row sum (its 2 columns of each 8-column tile).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv_rows = min(kBlockN, tk - it * kBlockN);
    if (it + 1 < n_tiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp
    const float* kt = ks + (it & 1) * S::kTileK;
    const float* vt = vs + (it & 1) * S::kTileV;

    // S = Q K^T over the 8 key groups, k-steps outer so that the 8
    // accumulators are independent chains of mma.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const float* kr = kt + g * S::kStrideK + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const float2 kj = *reinterpret_cast<const float2*>(kr + j * 8 * S::kStrideK + kk * 8);
        mma_3xtf32(s[j], q_big[kk], q_small[kk], kj.x, kj.y);  // K[key g][8kk + 2t, +1]
      }
    }

    // Online softmax in log2 units; the 4 lanes of a row are lanes 4g..4g+3.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (j * 8 + 2 * t + e >= kv_rows) s[j][e] = s[j][2 + e] = -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);  // finite: key 0 of every tile is valid
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += P V. P's A fragment of key group j is its score accumulator
    // {c0, c2, c1, c3} (keys relabelled: k-column t is key 2t, t+4 is 2t+1).
    // The tensor cores truncate each sum they accumulate, and chained over
    // all of T_kv (1536 products at T_kv = 4096) that drift exceeds
    // f32_error_limit. So the products of kTf32PvGroups key groups go into a
    // fresh accumulator, added to the running one in float32 (rounded to
    // nearest). Groups past the ragged end are skipped: a uniform branch,
    // which also keeps ptxas from hoisting the next groups' loads into spills.
    const float* vr = vt + 2 * t * S::kStrideV + g;
#pragma unroll
    for (int j0 = 0; j0 < kBlockN / 8; j0 += kTf32PvGroups) {
      if (j0 * 8 >= kv_rows) continue;
      uint32_t p_big[kTf32PvGroups][4], p_small[kTf32PvGroups][4];
#pragma unroll
      for (int jj = 0; jj < kTf32PvGroups; ++jj) {
        const float* c = s[j0 + jj];
        split_tf32(c[0], p_big[jj][0], p_small[jj][0]);  // P[g][key 2t]
        split_tf32(c[2], p_big[jj][1], p_small[jj][1]);  // P[g+8][key 2t]
        split_tf32(c[1], p_big[jj][2], p_small[jj][2]);  // P[g][key 2t+1]
        split_tf32(c[3], p_big[jj][3], p_small[jj][3]);  // P[g+8][key 2t+1]
      }
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < kTf32PvGroups; ++jj) {
          const float* vj = vr + (j0 + jj) * 8 * S::kStrideV + n * 8;
          mma_3xtf32(c, p_big[jj], p_small[jj], vj[0], vj[S::kStrideV]);  // V[key 2t / 2t+1][8n + g]
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += c[i];
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = warp * 16 + g;
  float* ob0 = o + head_offset(L.o, bh, L.heads) + (q0 + r0) * L.o.t + 2 * t;
  float* ob1 = ob0 + 8 * L.o.t;
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
    if (r0 < q_rows)
      *reinterpret_cast<float2*>(ob0 + n * 8) = make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r0 + 8 < q_rows)
      *reinterpret_cast<float2*>(ob1 + n * 8) = make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// Dynamic shared memory, and the largest carveout: only under it do two
// CTAs (2 x 104 KB at D = 96) share an SM.
template <int D>
cudaError_t configure_tf32x3() {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tf32Shape<D>::kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o, const Layout& L,
                          int bh, int tq, int tk, float scale, cudaStream_t stream) {
  constexpr size_t smem = Tf32Shape<D>::kSmemBytes;
  cudaError_t err = configure_tf32x3<D>();
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + kTf32BlockM - 1) / kTf32BlockM);
  flash_fwd_tf32x3_kernel<D><<<grid, kTf32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), L, tq, tk, scale * 1.4426950408889634f);  // exp(x) = exp2(x log2 e)
  return cudaGetLastError();
}

// Body codes of atlas_flash_attn_fwd (ops/attention.py::_BODIES).
enum Body { kBodyF32 = 0, kBodyMma = 1, kBodyTf32x3 = 2 };

// Head dims the tf32x3 body is built for (ops/attention.py::TF32X3_HEAD_DIMS).
template <int D>
constexpr bool kTf32x3Dim = D == 64 || D == 96;

template <int D>
cudaError_t launch_body(int body, const void* q, const void* k, const void* v, void* o,
                        const Layout& L, int bh, int tq, int tk, float scale,
                        cudaStream_t stream) {
  switch (body) {
    case kBodyF32:
      return launch_f32<D>(q, k, v, o, L, bh, tq, tk, scale, stream);
    case kBodyMma:
      return launch_bf16<D>(q, k, v, o, L, bh, tq, tk, scale, stream);
    case kBodyTf32x3:
      if constexpr (kTf32x3Dim<D>) return launch_tf32x3<D>(q, k, v, o, L, bh, tq, tk, scale, stream);
      else return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const Layout& L,
                     int bh, int tq, int tk, int d, int body, float scale, cudaStream_t stream) {
  switch (d) {
#define ATLAS_CASE(DV) \
  case DV:             \
    return launch_body<DV>(body, q, k, v, o, L, bh, tq, tk, scale, stream);
    ATLAS_CASE(8) ATLAS_CASE(16) ATLAS_CASE(24) ATLAS_CASE(32)
    ATLAS_CASE(40) ATLAS_CASE(48) ATLAS_CASE(56) ATLAS_CASE(64)
    ATLAS_CASE(72) ATLAS_CASE(80) ATLAS_CASE(88) ATLAS_CASE(96)
    ATLAS_CASE(104) ATLAS_CASE(112) ATLAS_CASE(120) ATLAS_CASE(128)
#undef ATLAS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (batch, heads, t, d) device buffers of the dtype `body` takes
// (0 = f32: float32 FMA; 1 = mma: bfloat16; 2 = tf32x3: float32 3xTF32, for
// d in 64/96) with d contiguous; `strides` holds the (batch, heads, t)
// element strides of q, k, v and o in that order (12 values). Every row
// must start on 16 bytes (the bodies move 16-byte vectors). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for an unknown body or a head dim it is
// not built for).
extern "C" int atlas_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    int batch, int heads, int tq, int tk, int d,
                                    const int64_t* strides, int body, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const int64_t* t = strides;
  const Layout L{{t[0], t[1], t[2]}, {t[3], t[4], t[5]}, {t[6], t[7], t[8]}, {t[9], t[10], t[11]},
                 heads};
  return (int)dispatch(q, k, v, o, L, batch * heads, tq, tk, d, body, scale,
                       static_cast<cudaStream_t>(stream));
}

// CTAs of the tf32x3 body that fit on one SM at head dim 96, as the launch
// configures it (registers, dynamic shared memory, carveout); negative: the
// cudaError of the query.
extern "C" int atlas_flash_attn_tf32x3_ctas_per_sm() {
  cudaError_t err = configure_tf32x3<96>();
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, flash_fwd_tf32x3_kernel<96>,
                                                        kTf32Threads, Tf32Shape<96>::kSmemBytes);
  return err == cudaSuccess ? ctas : -(int)err;
}
