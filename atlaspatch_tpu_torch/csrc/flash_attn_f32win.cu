// Flash attention forward for Hopper (sm_90a), float32 small windows:
// non-causal, unmasked softmax(Q K^T * scale) V over (B*H, T, D) for
// T_q <= 64 and T_kv <= 64, in exact float32 on the CUDA cores (FMA, no TF32).
//
// Replaces the TPU kernel atlaspatch_tpu/ops/attention.py::_flash_kernel
// (Pallas, launched by flash_attention) for the small float32 windows that the
// 3xTF32 body of flash_attn.cu does not take (ops/attention.py::kernel_variant):
// T_q <= 16, which in the float32 default are the q-pool blocks (16/64 and
// 4/16) and the stage-1 window (16/16), and any window of up to 64 query and
// key rows at a head dim other than 64 and 96. It computes the same function.
// A whole window fits on chip, so the TPU kernel's online-softmax recurrence
// over K/V blocks reduces to one pass: scores, row max, exp2, row sum, P V,
// one division.
//
// Bound on an H100 SXM: bytes. Each (window, head) moves 4 (2 T_q + 2 T_kv) D
// bytes for 4 T_q T_kv D flop, at most 32 flop per byte (T = 64) and at most
// 6.4 at T_q <= 16, against the FP32 cores' 67 TFLOP/s over 3.35 TB/s = 20.
// So the design moves the bytes well and keeps the FMA pipe fed from shared
// memory. (At T_q > 16 with D 64 or 96, the 64/64 and 49/49 windows, the
// tensor-core body is faster on the card: PERF.md.)
//
// - The unit of work is one (window, head): its Q, K and V, T_q + 2 T_kv rows
//   of D floats, copied whole into one stage of a ring in shared memory.
//   Nothing is padded to 64 rows. The ring is the shared memory left after
//   the mbarriers and the P scratch (539 rows at D = 96), cut at launch into stages of `group`
//   units so that about four stages fit: at D = 96, one 144-row unit at
//   16/64 (three stages), 2 units at 16/16, 3 at 4/16.
// - Persistent CTAs (SMs x CTAs per SM, from the occupancy query) walk the
//   groups. Four producer warps, one on each partition of the SM, keep the
//   ring full by cp.async (16 bytes per thread and instruction), each
//   thread's copies completing on the stage's full mbarrier
//   (cp.async.mbarrier.arrive.noinc); the consumers free a stage through its
//   empty mbarrier. So the warps that compute issue no loads and wait on no
//   CTA barrier, and up to three stages of rows are in flight while one is
//   computed. (TMA bulk copies of single rows, 384 bytes at D = 96, moved the
//   rows at half the rate, and one producer warp, sharing a partition's issue
//   slots with two consumers, fell behind them: PERF.md.)
// - Operands are read in place: q, k and v are strided views of the fused qkv
//   projection (rows 3 H D floats apart, each on 16 bytes); the output is
//   written in the caller's (B, T_q, H, D) layout.
// - Eight consumer warps take items of R query rows of one unit (R = 8, or 4
//   where 8-row items would leave warps idle or T_q <= 4), dealt in turn
//   across the stages, so a warp with nothing in this stage starts on the
//   next. For Q K^T a warp's lanes split the keys (key `lane` and
//   `lane + 32`), reading K rows as 16-byte vectors (rows of D + 4 floats:
//   8 consecutive rows start in 8 distinct bank groups) and Q rows as
//   broadcasts. For P V they split the columns of D (column `lane + 32 m`),
//   reading P rows of the warp's own scratch as broadcasts and V rows as
//   128-byte runs. Each row's max and sum are one butterfly over the warp:
//   no rescaling, since every key is on chip.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kMaxT = 64;              // the most T_q and T_kv this body takes
constexpr int kWarps = 8;              // consumer warps
constexpr int kProducers = 32 * 4;     // producer threads: one warp on each SM partition
constexpr int kThreads = 32 * kWarps + kProducers;
constexpr int kUnitRows = 3 * kMaxT;   // rows of the largest unit: Q, K and V of 64 rows
constexpr int kTargetStages = 4;       // ring stages aimed for: three load while one computes
constexpr int kMaxStages = 4;
constexpr int kItemRows = 8;           // the most query rows of a warp's item (8 or 4, per launch)
constexpr int kBarBytes = 128;         // full and empty mbarriers of kMaxStages stages
constexpr int kSmemMax = 232448;       // shared memory a CTA may use (227 KB)
constexpr int kMaxDevices = 64;

// Element strides of one (B, H, T, D) operand; D is contiguous.
struct Strides {
  int64_t b, h, t;
};

struct Layout {
  Strides q, k, v, o;
  int heads;
};

// Shared memory of one instantiation: the mbarriers, each consumer warp's P
// scratch (kItemRows rows of kMaxT probabilities), and the ring: as many rows
// as the rest holds, cut into stages of `group` units at launch.
template <int D>
struct WinShape {
  static constexpr int kStride = D + 4;             // floats per row: 16-byte rows; D/4 + 1 is
                                                    // odd, so 8 consecutive rows start in 8
                                                    // distinct 16-byte bank groups
  static constexpr int kCols = (D + 31) / 32;       // output columns per lane: lane + 32 m
  static constexpr int kScratch = kItemRows * kMaxT;  // floats of P per warp
  static constexpr int kRingRows =
      ((kSmemMax - kBarBytes) / (int)sizeof(float) - kWarps * kScratch) / kStride;
  static constexpr size_t kSmemBytes =
      kBarBytes + sizeof(float) * ((size_t)kWarps * kScratch + (size_t)kRingRows * kStride);
  static_assert(D % 8 == 0 && D >= 8 && D <= 128, "head dims are multiples of 8 up to 128");
  static_assert(kRingRows >= 2 * kUnitRows, "the ring holds two stages of the largest unit");
  static_assert(kSmemBytes <= kSmemMax, "a CTA may use at most 227 KB of shared memory");
  static_assert(2 * kMaxStages * 8 <= kBarBytes, "room for the mbarriers");
};

__device__ __forceinline__ int64_t head_offset(const Strides& s, int bh, int heads) {
  return (int64_t)(bh / heads) * s.b + (int64_t)(bh % heads) * s.h;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of this parity has completed. A wait of
// 2^26 polls (far beyond any stage's load) traps, so a fault in the ring is a
// launch error rather than a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// `rows` rows of D floats, `row_stride` apart, to shared rows of kStride
// floats at `dst`: 16-byte chunk e by producer thread e mod kProducers.
template <int D>
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* src, int64_t row_stride,
                                          int rows, int ptid) {
  constexpr int kVecs = D / 4;
  for (int e = ptid; e < rows * kVecs; e += kProducers) {
    const int r = e / kVecs;
    const int c = (e - r * kVecs) * 4;
    cp_async_16(dst + (uint32_t)((r * WinShape<D>::kStride + c) * sizeof(float)),
                src + r * row_stride + c);
  }
}

// s[r][c] = Q[row r] . K[key lane + 32 c] over D, summed in order by FMA. Lanes
// past T_kv read the last key (their scores are masked by the caller), rows
// past `rows` the last row (their results are not stored).
template <int D, int R, int KPL>
__device__ __forceinline__ void scores(float (&s)[R][2], const float* qs, const float* ks, int rows,
                                       int tk, int lane) {
  constexpr int kStride = WinShape<D>::kStride;
  const float* kr[KPL];
#pragma unroll
  for (int c = 0; c < KPL; ++c) kr[c] = ks + min(lane + 32 * c, tk - 1) * kStride;
  int qoff[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qoff[r] = min(r, rows - 1) * kStride;
    s[r][0] = s[r][1] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 kv[KPL];
#pragma unroll
    for (int c = 0; c < KPL; ++c) kv[c] = *reinterpret_cast<const float4*>(kr[c] + d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + qoff[r] + d);
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
        s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
        s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
        s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
      }
    }
  }
}

// One warp's item: R query rows (`rows` of them valid) of one unit, whose
// Q rows start at qs and whose K and V rows start at ks and vs; the output
// rows go to `out`, `out_stride` floats apart.
template <int D, int R>
__device__ __forceinline__ void attend_rows(const float* qs, const float* ks, const float* vs,
                                            int rows, int tk, float scale_log2, float* ps,
                                            float* out, int64_t out_stride, int lane) {
  using S = WinShape<D>;
  float s[R][2];
  if (tk > 32)
    scores<D, R, 2>(s, qs, ks, rows, tk, lane);
  else
    scores<D, R, 1>(s, qs, ks, rows, tk, lane);

  // Softmax in log2 units, one pass: the scale is applied to the score, the
  // keys past T_kv masked after it (a negative scale must not unmask them).
  float l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) s[r][c] = lane + 32 * c < tk ? s[r][c] * scale_log2 : -INFINITY;
    float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float p0 = exp2f(s[r][0] - mx);  // mx is finite: key 0 is valid
    const float p1 = exp2f(s[r][1] - mx);
    float sum = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[r] = sum;
    ps[r * kMaxT + lane] = p0;
    ps[r * kMaxT + lane + 32] = p1;
  }
  __syncwarp();

  // acc = P V over the T_kv valid keys: 4 keys of each P row per broadcast,
  // then the ragged rest one by one (V rows past T_kv are not this unit's).
  float acc[R][S::kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < S::kCols; ++m) acc[r][m] = 0.f;
  const float* vl = vs + lane;
  int j = 0;
#pragma unroll 2
  for (; j + 4 <= tk; j += 4) {
    float4 p4[R];
#pragma unroll
    for (int r = 0; r < R; ++r) p4[r] = *reinterpret_cast<const float4*>(ps + r * kMaxT + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int m = 0; m < S::kCols; ++m) {
        if (D % 32 == 0 || lane + 32 * m < D) {
          const float w = vl[(j + jj) * S::kStride + 32 * m];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
            acc[r][m] = fmaf(p, w, acc[r][m]);
          }
        }
      }
    }
  }
  for (; j < tk; ++j) {
#pragma unroll
    for (int m = 0; m < S::kCols; ++m) {
      if (D % 32 == 0 || lane + 32 * m < D) {
        const float w = vl[j * S::kStride + 32 * m];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][m] = fmaf(ps[r * kMaxT + j], w, acc[r][m]);
      }
    }
  }
  __syncwarp();  // every lane has read P before the warp's next item writes it

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int m = 0; m < S::kCols; ++m)
      if (D % 32 == 0 || lane + 32 * m < D) out[r * out_stride + lane + 32 * m] = acc[r][m] / l[r];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32win_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, Layout L, int bh_total,
                        int tq, int tk, int group, int stages, int item_rows, float scale_log2) {
  using S = WinShape<D>;
  extern __shared__ __align__(128) unsigned char smem_win[];
  const uint32_t bars = smem_u32(smem_win);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kMaxStages + s); };
  float* scratch = reinterpret_cast<float*>(smem_win + kBarBytes);
  float* ring = scratch + kWarps * S::kScratch;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int unit_rows = tq + 2 * tk;
  const int stage_floats = group * unit_rows * S::kStride;
  const int n_groups = (bh_total + group - 1) / group;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), kProducers);  // one arrival per producer thread, by cp.async
      mbar_init(empty(s), kWarps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWarps) {
    // Producers: group i of this CTA into stage i % stages, once the
    // consumers have freed it (the first use of each stage passes at once);
    // each thread arrives on the stage's full barrier when its copies have
    // landed.
    const int ptid = tid - 32 * kWarps;
    for (int i = 0, g = blockIdx.x; g < n_groups; ++i, g += gridDim.x) {
      const int s = i % stages;
      const int bh0 = g * group;
      const int units = min(group, bh_total - bh0);
      mbar_wait(empty(s), ((i / stages) & 1) ^ 1);
      for (int u = 0; u < units; ++u) {
        const int bh = bh0 + u;
        const uint32_t dst = smem_u32(ring + s * stage_floats + u * unit_rows * S::kStride);
        constexpr uint32_t kRowBytes = S::kStride * sizeof(float);
        copy_rows<D>(dst, q + head_offset(L.q, bh, L.heads), L.q.t, tq, ptid);
        copy_rows<D>(dst + tq * kRowBytes, k + head_offset(L.k, bh, L.heads), L.k.t, tk, ptid);
        copy_rows<D>(dst + (tq + tk) * kRowBytes, v + head_offset(L.v, bh, L.heads), L.v.t, tk,
                     ptid);
      }
      cp_async_arrive(full(s));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumers: the items of group i (units x row blocks) are numbered on from
  // the last group's, and warp w takes those numbered w mod kWarps.
  float* ps = scratch + warp * S::kScratch;
  const int blocks = (tq + item_rows - 1) / item_rows;
  int first = 0;  // number of this group's first item
  for (int i = 0, g = blockIdx.x; g < n_groups; ++i, g += gridDim.x) {
    const int s = i % stages;
    const int bh0 = g * group;
    const int items = min(group, bh_total - bh0) * blocks;
    const float* stage = ring + s * stage_floats;
    mbar_wait(full(s), (i / stages) & 1);
    for (int item = (warp - first % kWarps + kWarps) % kWarps; item < items; item += kWarps) {
      const int u = item / blocks;
      const int r0 = (item - u * blocks) * item_rows;
      const float* qs = stage + (u * unit_rows + r0) * S::kStride;
      const float* ks = stage + (u * unit_rows + tq) * S::kStride;
      float* out = o + head_offset(L.o, bh0 + u, L.heads) + r0 * L.o.t;
      const int rows = min(item_rows, tq - r0);
      if (item_rows == kItemRows)
        attend_rows<D, kItemRows>(qs, ks, ks + tk * S::kStride, rows, tk, scale_log2, ps, out,
                                  L.o.t, lane);
      else
        attend_rows<D, kItemRows / 2>(qs, ks, ks + tk * S::kStride, rows, tk, scale_log2, ps, out,
                                      L.o.t, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
    first += items;
  }
}

// Dynamic shared memory and the largest carveout for one instantiation, then
// its CTAs per SM and the device's SMs; done once per device and cached.
template <int D>
cudaError_t occupancy(int& ctas, int& sms) {
  static std::atomic<int> cached[kMaxDevices];  // ctas << 16 | sms, 0 until configured
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int hit = dev < kMaxDevices ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (hit) {
    ctas = hit >> 16;
    sms = hit & 0xffff;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(flash_fwd_f32win_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WinShape<D>::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_f32win_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, flash_fwd_f32win_kernel<D>, kThreads,
                                                        WinShape<D>::kSmemBytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) cached[dev].store(ctas << 16 | sms, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_f32win(const void* q, const void* k, const void* v, void* o, const Layout& L,
                          int bh, int tq, int tk, float scale, cudaStream_t stream) {
  int ctas = 0, sms = 0;
  cudaError_t err = occupancy<D>(ctas, sms);
  if (err != cudaSuccess) return err;
  // Units per stage: as many as leave kTargetStages stages in the ring, but
  // no fewer groups than CTAs where the heads allow it; then as many stages
  // as the ring holds, up to kMaxStages (at least two: a unit is at most
  // kUnitRows rows).
  const int slots = ctas * sms;
  const int unit_rows = tq + 2 * tk;
  const int group = std::max(
      1, std::min(WinShape<D>::kRingRows / (kTargetStages * unit_rows), (bh + slots - 1) / slots));
  const int stages = std::min(kMaxStages, WinShape<D>::kRingRows / (group * unit_rows));
  const int n_groups = (bh + group - 1) / group;
  // Query rows per item: 8, unless T_q <= 4 (half of each item would be
  // rows past T_q) or the landed stages, all but the one loading, would
  // hold fewer 8-row items than there are warps.
  const bool few = (stages - 1) * group * ((tq + kItemRows - 1) / kItemRows) < kWarps;
  const int item_rows = tq <= kItemRows / 2 || few ? kItemRows / 2 : kItemRows;
  flash_fwd_f32win_kernel<D><<<std::min(n_groups, slots), kThreads, WinShape<D>::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), L, bh, tq, tk, group, stages, item_rows,
      scale * 1.4426950408889634f);  // exp(x) = exp2(x log2 e)
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const Layout& L, int bh,
                     int tq, int tk, int d, float scale, cudaStream_t stream) {
  switch (d) {
#define ATLAS_CASE(DV) \
  case DV:             \
    return launch_f32win<DV>(q, k, v, o, L, bh, tq, tk, scale, stream);
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

// q, k, v, o: (batch, heads, t, d) float32 device buffers with d contiguous,
// t_q and t_kv at most 64 and d a multiple of 8 up to 128; `strides` holds the
// (batch, heads, t) element strides of q, k, v and o in that order (12
// values). Every row must start on 16 bytes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int atlas_flash_attn_f32win_fwd(const void* q, const void* k, const void* v, void* o,
                                           int batch, int heads, int tq, int tk, int d,
                                           const int64_t* strides, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0 || tq > kMaxT || tk > kMaxT)
    return (int)cudaErrorInvalidValue;
  const int64_t* t = strides;
  const Layout L{{t[0], t[1], t[2]}, {t[3], t[4], t[5]}, {t[6], t[7], t[8]}, {t[9], t[10], t[11]},
                 heads};
  return (int)dispatch(q, k, v, o, L, batch * heads, tq, tk, d, scale,
                       static_cast<cudaStream_t>(stream));
}

// CTAs of the body that fit on one SM at head dim 96, as the launch configures
// it; negative: the cudaError of the query.
extern "C" int atlas_flash_attn_f32win_ctas_per_sm() {
  int ctas = 0, sms = 0;
  const cudaError_t err = occupancy<96>(ctas, sms);
  return err == cudaSuccess ? ctas : -(int)err;
}
