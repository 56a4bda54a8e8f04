// int8_linear_s8 for Hopper (sm_90a) on wgmma s8 fed by TMA: the second,
// faster body of the W8A8 linear Y (M, N) = dequant(Xq (M, K) . Wq (N, K)^T),
// the same function as the mma.sync body in int8_linear.cu, bit for bit; and
// its int32 output, Xq . Wq^T not dequantized: a row-parallel shard's partial
// under tensor-parallel int8, which int8_linear.cu's dequant_sum_s32 sums.
//
// Replaces, with int8_linear.cu's quantizer, atlaspatch_tpu/models/encoders/
// vit.py::Int8Dense (:124-157): the int8 dot_general accumulating in int32
// (:146-151; split over K by the TP plan, whose int32 partials XLA sums) and
// the dequantization acc * (s_x * qscale) + bias, cast to the activations'
// dtype (:152-156), which XLA fuses on the TPU. The dispatch between the two
// bodies is ops/int8.py::linear_variant: this one takes operands whose row
// pitch is a multiple of 16 bytes and whose bases lie on 16 bytes (a TMA
// map's row stride and base; K itself may be anything: the port's quantizer
// writes xq, and the model pitches its int8 weights, at round_up(K, 16)
// bytes a row, so virchow's fc2, K = 3,416, and the TP shards of K 1,708 and
// 2,152 come here) and writes bfloat16 with N a multiple of 8 or int32 with N
// a multiple of 4 (output rows of a multiple of 16 bytes, a TMA map's row
// stride); int8_linear.cu the rest (float32 output; other N; contiguous
// operands whose K is no multiple of 16).
//
// Bound on an H100 SXM: operations at ViT widths (2 M N K over 1,979 TOPS
// int8 against M K + N K + 2 M N bytes over 3.35 TB/s: vit_l_16's fc1 at
// batch 256, M = 50,432, K = 1,024, N = 4,096, is 0.214 ms of products and
// 0.139 ms of bytes); bytes at M up to a few hundred, where the weights'
// N K bytes are the work. Short of that, what holds it back on the card is
// the L2 traffic of the operand tiles (a 128 x 256 tile reads 48 KB per
// 128-byte K step, which at the int8 rate would be ~11 TB/s over 132 SMs)
// and the epilogue between tiles. The int32 output writes 4 bytes a value,
// so its bytes weigh more: at vit_l_16's proj shard under TP (1, 2), M =
// 6,304, K = 512, N = 1,024, they are 6,304 x 512 + 1,024 x 512 + 4 x 6,304
// x 1,024 = 29.5 MB, 0.0088 ms, against 0.0033 ms of products; at its fc2
// shard (K = 2,048) the products bind, 2 x 6,304 x 1,024 x 2,048 over 1,979
// TOPS = 0.0134 ms, against 0.0122 ms of bytes. The design (each choice
// measured against the alternative by tools/int8_variants.py; numbers in
// PERF.md):
//
// - A CTA is one producer warpgroup and two consumer warpgroups; a CTA tile
//   is 128 rows (64 per consumer) by BN = 128 or 256 columns (a template
//   parameter beside the output type, picked per shape by
//   ops/int8.py::wgmma_block_n: for bfloat16 256 unless its tiles are fewer
//   than the SMs; for int32 see below). setmaxnreg hands the producer's
//   registers to the consumers (40 and 232): a 64 x 256 int32 accumulator
//   is 128 registers a thread.
// - One producer thread issues TMA loads of 128-byte K blocks of Xq (128
//   rows) and Wq (BN rows) under CU_TENSOR_MAP_SWIZZLE_128B into a ring of
//   stages (as many as fit beside the output tile, at most 6: 3 of 48 KB
//   for BN = 256, 6 of 32 KB for BN = 128, 5 beside a 128-wide int32 tile),
//   with full mbarriers carrying the byte counts and empty mbarriers,
//   arrived at by each consumer warp, handing stages back. TMA zero-fills rows past M and
//   N and bytes past K, and a zero int8 adds nothing to an int32 sum, so
//   medsiglip's K = 4,304 (33.6 blocks) needs no tail code. The maps' K
//   extent is K and their row stride the operand's pitch, so the last box
//   of a row-pitched operand (K = 3,416: bytes 3,328 to 3,455 of a 3,424-byte
//   row) is zero-filled past K and never reads the pad bytes.
// - Each consumer issues, per stage, four wgmma.mma_async m64nBNk32
//   s32.s8.s8 with both operands in shared memory: wgmma takes 8-bit
//   operands K-major only, which is the row-major (M, K) activations and
//   (N, K) weights as they lie. One group stays in flight: a stage goes
//   back to the producer when the group after it has been issued and its
//   own has completed.
// - CTAs are persistent: as many as the card has SMs walk the output tiles
//   row of tiles by row of tiles (n fastest), so the CTAs in flight share a
//   few 128-row panels of Xq and the whole of Wq (at most 16 MB) in L2, and
//   the producer runs ahead into the next tile's K blocks while the
//   consumers run the epilogue.
// - The epilogue is int8_linear.cu's, unchanged in arithmetic: y =
//   __fmul_rn(__int2float_rn(acc), __fmul_rn(s_x[m], qscale[n])), then
//   __fadd_rn of the bias read in its stored dtype, then the cast (the
//   accumulator of thread 32w + 4g + t holds rows 16w + g and + 8, columns
//   8j + 2t and + 1: mma.sync's C layout repeated along N). The library is
//   built with -fmad=false. The int32 sum is exact in any order the tensor
//   cores take it, so this body equals the plain version, and the mma.sync
//   body, bit for bit. It writes bfloat16 with N a multiple of 8 (every ViT
//   shape in the int8 engine, which runs bfloat16): each consumer writes its
//   64 x BN slice to shared memory as swizzled panels of 64 rows by 128
//   bytes (64 columns) and one thread stores them with TMA, which drains
//   while the consumers go on to the next tile.
// - The int32 output stores the accumulator as it is, with no s_x, qscale
//   or bias: the int32 sum is exact in any order, so it equals the plain
//   product bit for bit, and dequant_sum_s32 of a row's partials equals
//   this body's bfloat16 output on the whole K. Each consumer stages its
//   slice as panels of 32 columns (128-byte rows, SWIZZLE_128B) with 8-byte
//   stores, the threads with t >= 2 storing column group j ^ 2 where the
//   others store j, so that a half-warp's 16 stores fill the 8 16-byte
//   chunks of its rows once each (no bank conflict); the panels leave by
//   TMA under the bfloat16 tile's bulk_wait_read handshake. At 4 bytes a
//   value a 128 x 256 tile is 128 KB and would leave 2 stages, so a 128-wide
//   int32 tile (64 KB, beside 5 stages) is staged whole, and a 256-wide one
//   in two halves through one 64 KB buffer (beside 3 stages), its second
//   half staged once the first half's store has read the buffer.
//   wgmma_block_n takes 256 only for long products (128 or more K blocks an
//   SM in 256-wide tiles: dinov3_vit7b16's fc2 shard), where reading Xq half
//   as often repays the wait between the halves; vit_l_16's shards run 128.
//   At M = 6,304, N = 1,024 that is 400 tiles, 3.03 waves over 132 SMs: the
//   fourth wave's 4 tiles cost ~15% of a call (M = 6,144, 2.91 waves, runs
//   12-15% faster).
// - Left out, measured slower (PERF.md): stores from registers (bfloat16
//   1.4x per forward; int32 1.1-1.3x a call, 2.200 against 1.962 ms per TP
//   forward), clusters of two CTAs sharing the weight tile by TMA multicast
//   (1.7-1.9x), 64-byte K blocks with more stages.

// Shared-memory layout under SWIZZLE_128B (TMA writes it, wgmma reads it):
// row r of a tile is 128 bytes at r * 128 from a 1024-byte-aligned base, its
// 16-byte chunk c stored at chunk c ^ (r % 8). wgmma descriptors (PTX ISA,
// "matrix descriptor"): start address >> 4 in bits 0-13, leading byte offset
// >> 4 in 16-29 (unused for K-major swizzled operands), stride byte offset
// >> 4 in 32-45 = 1024 (8 rows of 128 bytes), layout 1 (SWIZZLE_128B) in
// 62-63; the k32 step s of a stage starts at base + 32 s.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBM = 128;                  // CTA tile rows: two consumer warpgroups of 64
constexpr int kBK = 128;                  // K bytes per stage: one 128-byte swizzle row
constexpr int kMaxStages = 6;
constexpr int kThreads = 384;             // producer warpgroup + two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;        // 128 * 40 + 256 * 232 <= 65,536
constexpr int kEncodeFailed = 1000000;    // + CUresult of cuTensorMapEncodeTiled
constexpr int kNoDriverEntry = 2000000;   // + cudaError of cudaGetDriverEntryPoint

// The ring, and the output tile the TMA store reads: per consumer, its 64 x
// BN slice (or half of it) as panels of 64 rows x 128 bytes (SWIZZLE_128B),
// 64 bfloat16 or 32 int32 columns each. Stages: as many as fit in 227 KB, at
// most 6. The shared memory fits one CTA on an SM.
template <int BN, typename OutT>
struct Tile {
  static_assert(BN == 128 || BN == 256, "the tile is 128 or 256 columns wide");
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPanelCols = 128 / (int)sizeof(OutT);  // columns of a panel
  static constexpr int kPanels = BN / kPanelCols;             // output panels per consumer
  // a 256-wide int32 slice is staged in two halves through one buffer (a whole tile, 128 KB,
  // would leave 2 stages)
  static constexpr int kParts = sizeof(OutT) == 4 && BN == 256 ? 2 : 1;
  static constexpr int kPartPanels = kPanels / kParts;        // panels a consumer stages at once
  static constexpr int kOutBytes = kBM * BN * (int)sizeof(OutT) / kParts;
  static constexpr int kFree = 232448 - 1024 - kOutBytes;  // less the base's alignment slack
  static constexpr int S = kFree / (kStageBytes + 16) < kMaxStages ? kFree / (kStageBytes + 16) : kMaxStages;
  static constexpr int kOutOff = S * kStageBytes;
  static constexpr int kBarOff = kOutOff + kOutBytes;
  // then full and empty per stage, and 1024 bytes of slack to align the base
  static constexpr int kSmemBytes = kBarOff + 8 * 2 * S + 1024;
  static_assert(S >= 3 && kSmemBytes <= 232448, "the ring does not fit in shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of this parity has completed. A wait of
// 2^26 polls (far beyond any stage's load) traps, so a fault in the ring is
// a launch error rather than a hang.
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// One panel of the output tile from shared memory to global, past the ends
// of the (N, M) map clipped.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Waits until the committed bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until the committed bulk stores have completed.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Makes this thread's generic-proxy writes to shared memory visible to TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Synchronises the 128 threads of one consumer warpgroup (named barrier
// `id`, 1 or 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of accumulator registers above the
// wait for the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// K-major SWIZZLE_128B matrix descriptor (see the header comment).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma m64nNk32, int32 += s8 x s8, A and B from shared memory, both
// K-major; accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// A store to shared memory the compiler keeps in place (measured faster
// here than a plain store it may move: tools/int8_variants.py).
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts64(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(lo), "r"(hi) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(lo);
  v.y = __float2bfloat16_rn(hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One thread's int32 accumulators of part PART of PARTS of its consumer's
// slice (rows r and r + 8, r % 8 == g; column groups PART BN / 8 / PARTS on)
// into that part's panels of 32 columns: columns 8i + 2t and + 1 of the part
// are 8 bytes at 8 (t % 2) in chunk 2 (i % 4) + t / 2 of panel i / 4, stored
// at chunk ^ g. Threads with t >= 2 store group i ^ 2 (the same panel) where
// the others store i: a half-warp (g < 4 or g >= 4) then writes chunks
// 2 (i % 4) ^ 5 (t / 2) ^ g, all 8 of them, each once.
template <int BN, int PART, int PARTS>
__device__ __forceinline__ void stage_s32(const int (&acc)[BN / 2], uint32_t slice, int r, int g, int t) {
  constexpr int kGroups = BN / 8 / PARTS;
  const bool flip = t & 2;
  const uint32_t row = slice + r * 128 + 8 * (t & 1);
  const uint32_t chunk = (uint32_t)((flip ? 4 : 0) ^ (t >> 1) ^ g) << 4;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int j = PART * kGroups + i, jf = PART * kGroups + (i ^ 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sts64(row + (i >> 2) * 8192 + h * 8 * 128 + ((32u * (i & 3)) ^ chunk),
            flip ? acc[4 * jf + 2 * h] : acc[4 * j + 2 * h], flip ? acc[4 * jf + 2 * h + 1] : acc[4 * j + 2 * h + 1]);
  }
}

// One thread's TMA stores of a consumer's staged panels, part `part` of its
// slice; columns past N are clipped, and panels wholly past N are not sent.
template <typename T>
__device__ __forceinline__ void store_panels(const CUtensorMap* map, uint32_t slice, int part, int n0, int row,
                                             int N) {
#pragma unroll
  for (int p = 0; p < T::kPartPanels; ++p) {
    const int col = n0 + (part * T::kPartPanels + p) * T::kPanelCols;
    if (col < N) tma_store_2d(map, slice + p * 8192, col, row);
  }
  bulk_commit();
}

// Each consumer writes its 64 x BN slice of the output tile (bfloat16,
// dequantized, or the int32 accumulator) to shared memory and one of its
// threads stores it with TMA, asynchronously, so the consumers go on to the
// next tile's products while the store drains.
template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
int8_linear_s8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                            const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ s_x,
                            const float* __restrict__ qscale, const void* __restrict__ bias, int bias_is_bf16,
                            int M, int N, int K) {
  using T = Tile<BN, OutT>;
  constexpr bool kS32 = std::is_same<OutT, int32_t>::value;
  constexpr int S = T::S;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + T::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int k_blocks = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // Producer: one thread keeps the ring full, running ahead across tiles.
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      int it = 0;  // K blocks issued by this CTA
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(empty(s), ((it / S) & 1) ^ 1);  // the first use of a stage passes
          const uint32_t dst = base + s * T::kStageBytes;
          mbar_expect_tx(full(s), T::kStageBytes);
          tma_load_2d(dst, &tm_x, full(s), kb * kBK, m0);
          tma_load_2d(dst + T::kABytes, &tm_w, full(s), kb * kBK, n0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup cw: rows 64 cw .. 64 cw + 63 of each tile; this
  // warp's 16 are rows g and g + 8 of its slice in the accumulator layout.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = (warp >> 2) - 1;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  int acc[BN / 2];
  int it = 0;  // K blocks consumed by this CTA
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
    int s_prev = 0;
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(full(s), (it / S) & 1);
      const uint32_t a_tile = base + s * T::kStageBytes + cw * 64 * kBK;
      const uint32_t b_tile = base + s * T::kStageBytes + T::kABytes;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k)
        wgmma_s8<BN>(acc, sw128_desc(a_tile + 32 * k), sw128_desc(b_tile + 32 * k), kb | k);
      wgmma_commit();
      if (kb > 0) {
        wgmma_wait<1>();  // the previous stage's group is done: hand its stage back
        if (lane == 0) mbar_arrive(empty(s_prev));
      }
      s_prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(s_prev));

    // Epilogue: bfloat16, the dequantization in the plain version's order;
    // int32, the accumulator as it is.
    const int r0 = m0 + cw * 64 + wq * 16 + g;
    float sx0 = 0.0f, sx1 = 0.0f;
    if (!kS32) {
      sx0 = r0 < M ? s_x[r0] : 0.0f;
      sx1 = r0 + 8 < M ? s_x[r0 + 8] : 0.0f;
    }
    // this consumer's output panels; row r of a panel at r * 128, its 16-byte
    // chunk c at chunk c ^ (r % 8), and r % 8 == g for this thread's rows
    const uint32_t out_tile = base + T::kOutOff + cw * T::kPartPanels * 8192;
    if (wq == 0 && lane == 0) bulk_wait_read();  // the last tile's store has read the panels
    warpgroup_sync(1 + cw);
    if constexpr (kS32) {  // rows and columns past the ends: the store clips them
      stage_s32<BN, 0, T::kParts>(acc, out_tile, wq * 16 + g, g, t);
      if constexpr (T::kParts == 2) {  // send the first half, and stage the second once it has been read
        fence_async_shared();
        warpgroup_sync(1 + cw);
        if (wq == 0 && lane == 0) {
          store_panels<T>(&tm_out, out_tile, 0, n0, m0 + cw * 64, N);
          bulk_wait_read();
        }
        warpgroup_sync(1 + cw);
        stage_s32<BN, 1, 2>(acc, out_tile, wq * 16 + g, g, t);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n0 + 8 * j >= N) continue;  // N % 8 == 0: all 8 columns of the group or none
        const float qs[2] = {qscale[n], qscale[n + 1]};
        float bv[2] = {0.0f, 0.0f};
        if (bias != nullptr) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bv[e] = bias_is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n + e])
                                 : static_cast<const float*>(bias)[n + e];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows past M: the TMA store clips them
          const float sx = h ? sx1 : sx0;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            y[e] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), __fmul_rn(sx, qs[e]));
            if (bias != nullptr) y[e] = __fadd_rn(y[e], bv[e]);
          }
          const int r = wq * 16 + g + 8 * h;
          sts32(out_tile + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ g) << 4) + 4 * t, pack_bf16(y[0], y[1]));
        }
      }
    }
    fence_async_shared();
    warpgroup_sync(1 + cw);
    if (wq == 0 && lane == 0) store_panels<T>(&tm_out, out_tile, T::kParts - 1, n0, m0 + cw * 64, N);
  }
  if (wq == 0 && lane == 0) bulk_wait();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links nothing beyond cudart.
cudaError_t encoder(EncodeTiled* fn) {
  static cudaError_t err = cudaSuccess;
  static const EncodeTiled found = [] {
    void* p = nullptr;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  *fn = found;
  return found ? cudaSuccess : (err != cudaSuccess ? err : cudaErrorSymbolNotFound);
}

// A 2-d map (K, rows) over a row-major (rows, K) int8 operand whose rows lie
// `pitch` bytes apart (a multiple of 16, at least K), read in boxes of 128
// bytes of K by `box_rows` rows under SWIZZLE_128B; rows and bytes past the
// ends (past K, not past the pitch) read as zeros.
CUresult encode_operand(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int K, long long pitch,
                        int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A 2-d map (N, M) over the row-major (M, N) bfloat16 or int32 output,
// written in panels of 128 bytes (64 or 32 columns) by 64 rows under
// SWIZZLE_128B.
template <typename OutT>
CUresult encode_output(EncodeTiled encode, CUtensorMap* map, void* ptr, int M, int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(OutT)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(OutT)), 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type =
      std::is_same<OutT, int32_t>::value ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, ptr, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Raises the kernel's shared-memory allowance on the current device, once
// per device, so that a launch does not pay for the call.
template <int BN, typename OutT>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};  // bit d: set on device d
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(int8_linear_s8_wgmma_kernel<BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<BN, OutT>::kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int BN, typename OutT>
int launch_wgmma(const void* xq, const void* w, const void* s_x, const void* qscale, const void* bias,
                 int bias_is_bf16, void* out, int M, int N, int K, long long ldx, long long ldw, int ctas,
                 cudaStream_t stream) {
  EncodeTiled encode = nullptr;
  const cudaError_t found = encoder(&encode);
  if (found != cudaSuccess) return kNoDriverEntry + (int)found;
  CUtensorMap tm_x, tm_w, tm_out;
  CUresult res = encode_operand(encode, &tm_x, xq, M, K, ldx, kBM);
  if (res == CUDA_SUCCESS) res = encode_operand(encode, &tm_w, w, N, K, ldw, BN);
  if (res == CUDA_SUCCESS) res = encode_output<OutT>(encode, &tm_out, out, M, N);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  const cudaError_t err = allow_smem<BN, OutT>();
  if (err != cudaSuccess) return (int)err;
  // Persistent CTAs, one an SM: as many as there are tiles, at most `ctas`.
  const int64_t tiles = (int64_t)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < ctas ? tiles : ctas);
  int8_linear_s8_wgmma_kernel<BN, OutT><<<grid, kThreads, Tile<BN, OutT>::kSmemBytes, stream>>>(
      tm_x, tm_w, tm_out, static_cast<const float*>(s_x), static_cast<const float*>(qscale), bias, bias_is_bf16, M,
      N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (M, K) int8 with rows ldx bytes apart, w (N, K) int8 with rows ldw
// bytes apart (each pitch a multiple of 16 and at least K; the bytes between
// K and the pitch are never read), xq, w and out on 16 bytes, out contiguous
// -> out (M, N): out_code 1, bfloat16 dequantized by s_x
// (M,) and qscale (N,) float32 and bias (N,) float32 or bfloat16 or null, N a
// multiple of 8; out_code 2, the int32 product (s_x, qscale and bias
// unused), N a multiple of 4. In CTA tiles of 128 x block_n (128 or 256), at
// most `ctas` CTAs (the card's SM count). Launches on `stream` and
// does not synchronise. Returns 0, a cudaError (cudaErrorInvalidValue for a
// shape, output, block_n or ctas it does not take), 1000000 + the CUresult of
// a tensor map that would not encode, or 2000000 + the cudaError of a driver
// without cuTensorMapEncodeTiled.
extern "C" int atlas_int8_linear_s8_wgmma(const void* xq, const void* w, const void* s_x, const void* qscale,
                                          const void* bias, int bias_is_bf16, void* out, int out_code, int M, int N,
                                          int K, long long ldx, long long ldw, int block_n, int ctas,
                                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldx % 16 || ldw < K || ldw % 16 || ctas <= 0 ||
      (uintptr_t)xq % 16 || (uintptr_t)w % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_code == 2 && N % 4 == 0) {
    if (block_n == 256)
      return launch_wgmma<256, int32_t>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, ctas, s);
    if (block_n == 128)
      return launch_wgmma<128, int32_t>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, ctas, s);
  }
  if (out_code != 1 || N % 8) return (int)cudaErrorInvalidValue;
  if (block_n == 256)
    return launch_wgmma<256, __nv_bfloat16>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, ctas, s);
  if (block_n == 128)
    return launch_wgmma<128, __nv_bfloat16>(xq, w, s_x, qscale, bias, bias_is_bf16, out, M, N, K, ldx, ldw, ctas, s);
  return (int)cudaErrorInvalidValue;
}
