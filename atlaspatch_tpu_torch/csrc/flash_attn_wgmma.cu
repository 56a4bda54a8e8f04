// Flash attention forward for Hopper (sm_90a), bfloat16, on wgmma fed by TMA:
// non-causal, unmasked softmax(Q K^T * scale) V over (B*H, T, D), T_q != T_kv
// allowed, D in {64, 96, 128}.
//
// Replaces the TPU kernel atlaspatch_tpu/ops/attention.py::_flash_kernel
// (Pallas, launched by flash_attention) for bfloat16 inputs with T_q > 16; the
// mma.sync body in flash_attn.cu keeps T_q <= 16, other head dims and float32.
// The dispatch between them is ops/attention.py::kernel_variant. Same
// function as the TPU kernel: the online-softmax recurrence over K/V tiles
// with float32 running max, sum and accumulator; the score matrix never
// reaches device memory. Q, K, V are (B, H, T, D) with D contiguous and any
// other strides (the trunk's fused qkv projection is read in place); O is
// written through its (B, H, T) strides, a (B, T, H, D) tensor in the trunk.
//
// Bound on an H100 SXM: 4*T_q*T_kv*D flop against 2*(T_q+T_kv)*D*2 bytes.
// The global blocks (B*H=32, T=2304, D=96: 65.2 GFLOP, 66 us at the 989
// TFLOP/s bf16 tensor-core peak) are bound by operations; the windows (T <=
// 196) by bytes. The design aims at the tensor cores' own instructions:
//
// - A CTA is one producer warpgroup and C consumer warpgroups, each consumer
//   owning 64 rows of a Q tile: C = 1 for T_q <= 64 (two CTAs per SM), C = 3
//   (192 rows, built for D <= 96) where it pads T_q no more than C = 2 does,
//   else C = 2. The global blocks take C = 3: their 2304 rows split into
//   whole tiles, and 384 of them fill 132 SMs in 2.9 waves where 576 128-row
//   tiles take 4.4. setmaxnreg hands the producer's registers to the
//   consumers (24 for the producer; 232, 240 and 160 for C = 1, 2, 3).
// - CTAs are persistent: as many as fit on the card, each walking work items
//   (b*h, Q tile). One thread of the producer issues TMA loads: an item's Q
//   into one of two Q buffers, then its K and V tiles (64 keys for C = 1 and
//   3, 128 for C = 2) into a ring of stages (2, 3 and 4 for C = 1, 2, 3; 2
//   for C = 2 at D = 128, where 3 do not fit), running ahead into the next item while the
//   consumers finish this one. Full mbarriers (K and V apart, so Q K^T starts
//   before V has landed) carry the byte counts; empty mbarriers, arrived at by
//   each consumer warp, hand buffers back. No __syncthreads() after set-up.
// - S = Q K^T is wgmma m64nNk16 with both operands in shared memory
//   (K-major). The masked online softmax runs on the accumulator in
//   registers, one FFMA and one ex2 per score; P is rounded to bf16 in place
//   (where the plain version rounds it, ops/attention.py) as the register A
//   operand of the PV wgmma, whose B operand is V, keys x D row-major, read
//   MN-major (the transpose bit 16-bit types allow). Each warpgroup issues
//   Q K_j^T and P_{j-1} V_{j-1} together, so the softmax of tile j runs while
//   the tensor cores do the PV product of tile j-1; a deeper ring lets the
//   consumer warpgroups drift apart, so one's softmax overlaps another's
//   products.
// - TMA zero-fills rows past T (the ragged windows of T = 49 and 196) with
//   no copy; the scores of those keys are set to -inf, since a zero K row
//   scores 0, and their zero V rows add nothing.
//
// D = 96 (192-byte rows, wider than the 128-byte swizzle span): every tile is
// kept as D/32 column panels of 32 bf16 (64-byte rows) under SWIZZLE_64B, one
// TMA box per panel. Q K^T takes two k16 steps per panel, each with its
// panel's descriptor; PV is one wgmma m64n(D)k16 per 16 keys whose B
// descriptor spans the panels through its leading byte offset (the panel
// stride). Cost: no padding (the TPU kernel's zero pad of D to 128 would add
// 33% tensor-core work on an operation-bound shape), D/32 TMA boxes per tile
// instead of one or two, and 64-byte instead of 128-byte swizzle rows, which
// wgmma reads without bank conflicts all the same (8 rows of a core matrix
// land in 8 distinct 16-byte bank groups). The same layout serves D = 64 and
// 128.
//
// Shared-memory layout under SWIZZLE_64B (TMA writes it, wgmma reads it): the
// element (row r, column c) of a panel sits at byte
//   r * 64 + (((c / 8) ^ ((r / 2) % 4)) * 16) + (c % 8) * 2
// from the panel's 512-byte-aligned base. wgmma descriptors (PTX ISA,
// "matrix descriptor"): start address >> 4 in bits 0-13, leading byte offset
// >> 4 in 16-29, stride byte offset >> 4 in 32-45, base offset 0 (every start
// is 512-aligned up to the in-row k offset), layout 2 (SWIZZLE_64B) in 62-63.
//   K-major Q and K: start = panel base + rows + k16 step * 32 bytes, SBO =
//     512 (8 rows of 64 bytes), LBO unused.
//   MN-major V: start = panel-0 base + key * 64, LBO = panel bytes (the next
//     32 columns of D), SBO = 512 (the next 8 keys).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPanelCols = 32;   // bf16 columns of one panel
constexpr int kPanelRow = 64;    // bytes of one panel row
constexpr int kAtom = 512;       // bytes of 8 panel rows: the swizzle pattern's period
constexpr int kEncodeFailed = 1000000;     // + CUresult of cuTensorMapEncodeTiled
constexpr int kNoDriverEntry = 2000000;    // + cudaError of cudaGetDriverEntryPoint

// Shared memory one CTA may take: 227 KB, or half of the SM's 228 KB less the
// 1 KB each CTA reserves where two CTAs share an SM.
constexpr int smem_limit(int ctas_per_sm) {
  return ctas_per_sm == 1 ? 232448 : 233472 / 2 - 1024;
}

// The tile of C consumer warpgroups at head dim D: K/V rows per ring stage
// and ring stages, as measured on an H100 (PERF.md): 64 keys in 2 stages for
// 64 Q rows, 128 keys in 3 stages for 128 Q rows (2 at D = 128, where 3 do
// not fit), 64 keys in 4 stages for 192 Q rows (128 keys spill there).
template <int D, int C>
struct WgmmaShape {
  static_assert(D % kPanelCols == 0 && D <= 128, "D is a multiple of 32 up to 128");
  static_assert(C >= 1 && C <= 3, "one to three consumer warpgroups");
  static constexpr int BN = C == 2 ? 128 : 64;
  static constexpr int S = C == 1 ? 2 : C == 3 ? 4 : D == 128 ? 2 : 3;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kBlockM = 64 * C;
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kQPanel = kBlockM * kPanelRow;  // bytes of one Q panel
  static constexpr int kKVPanel = BN * kPanelRow;      // bytes of one K or V panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKVPanel;  // one K or V tile
  static constexpr int kKOff = 2 * kQBytes;  // two Q buffers
  static constexpr int kVOff = kKOff + S * kKVBytes;
  static constexpr int kBarOff = kVOff + S * kKVBytes;
  // then Q full and empty per Q buffer, per stage K full, V full and K/V
  // empty, and 1024 bytes of slack to align the base
  static constexpr int kSmemBytes = kBarOff + 8 * (4 + 3 * S) + 1024;
  static constexpr int kCtasPerSm = C == 1 ? 2 : 1;  // as __launch_bounds__ asks
  static_assert(kSmemBytes <= smem_limit(kCtasPerSm), "the ring does not fit in shared memory");
  // Registers per thread after setmaxnreg: the producer's 24, the rest of
  // the CTA's launch-time share (65536 / kCtasPerSm) split among the consumers.
  static constexpr int kProducerRegs = 24;
  static constexpr int kLaunchRegs = 65536 / kCtasPerSm / kThreads / 8 * 8;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * C) / 8 * 8;
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
// 2^26 polls (far beyond any tile's load) traps, so a fault in the ring is a
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int t, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(t), "r"(h), "r"(b)
      : "memory");
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

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// SWIZZLE_64B matrix descriptor (see the header comment).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, float32 += bf16 x bf16. Accumulator of thread 32w + 4g + t
// (warp w of the group): d[4j + e] = (row 16w + g, column 8j + 2t + e) and
// d[4j + 2 + e] = (row 16w + g + 8, same column), e in {0, 1}. The register A
// operand of one warp is the mma.m16n8k16 A fragment of its 16 rows.
// ss: A and B from shared memory, both K-major. rs: A from registers, B
// MN-major (transposed).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on the S accumulator, in log2 units: masks
// keys past `valid`, updates the running max and sum of rows g and g + 8,
// leaves p = exp2(s * scale - max) in `sc` (one FFMA and one MUFU.EX2 per
// score) and returns the factors that rescale the output accumulator. The 4
// lanes of a row are lanes 4g..4g+3.
template <int BN>
__device__ __forceinline__ void softmax_step(float (&sc)[BN / 2], int valid, int t, float scale_log2,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  float k = scale_log2;
  if (k < 0.f) {  // a negative scale reverses the order of the scores: apply it first
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] *= k;
    k = 1.f;
  }
  if (valid < BN) {  // the ragged last tile only: uniform across the warpgroup
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * t + e >= valid) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx0 = fmaxf(mx0, sc[4 * j + e]);
      mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * k);  // finite: key 0 of every tile is valid
  const float mn1 = fmaxf(m1, mx1 * k);
  alpha0 = fast_exp2(m0 - mn0);  // 0 on the first tile (m = -inf)
  alpha1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j + 0] = fast_exp2(fmaf(sc[4 * j + 0], k, -mn0));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], k, -mn0));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], k, -mn1));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], k, -mn1));
    sum0 += sc[4 * j + 0] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
}

// P in bf16 as wgmma A fragments: keys 16c..16c+15 are accumulator columns
// 8(2c)..8(2c+1)+7, the mma.m16n8k16 A fragment of each warp's 16 rows.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) {
    pa[c][0] = pack_bf16(sc[8 * c + 0], sc[8 * c + 1]);
    pa[c][1] = pack_bf16(sc[8 * c + 2], sc[8 * c + 3]);
    pa[c][2] = pack_bf16(sc[8 * c + 4], sc[8 * c + 5]);
    pa[c][3] = pack_bf16(sc[8 * c + 6], sc[8 * c + 7]);
  }
}

template <int BN>
__device__ __forceinline__ void fence_p(uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[c][i])::"memory");
}

// A CTA walks work items (b*h, Q tile) blockIdx.x, + gridDim.x, ...: the
// producer runs ahead into the next item (its Q into the other of two Q
// buffers, its K/V into the ring) while the consumers finish this one.
template <int D, int C>
__global__ void __launch_bounds__(128 * (C + 1), C == 1 ? 2 : 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       int64_t o_sb, int64_t o_sh, int64_t o_st, int bh_total, int heads, int tq,
                       int tk, float scale_log2) {
  using G = WgmmaShape<D, C>;
  constexpr int BN = G::BN, S = G::S;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + G::kBarOff;
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto q_empty = [&](int i) { return bars + 8u * (2 + i); };
  auto k_full = [&](int s) { return bars + 8u * (4 + s); };
  auto v_full = [&](int s) { return bars + 8u * (4 + S + s); };
  auto kv_empty = [&](int s) { return bars + 8u * (4 + 2 * S + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = warp >> 2;
  const int q_tiles = (tq + G::kBlockM - 1) / G::kBlockM;
  const int n_items = bh_total * q_tiles;
  const int n_tiles = (tk + BN - 1) / BN;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * C);  // one arrival per consumer warp
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), 4 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    // Producer: one thread keeps the Q buffers and the K/V ring full.
    setmaxnreg_dec<G::kProducerRegs>();
    if (warp == 0 && lane == 0) {
      int n = 0, tile = 0;  // items and K/V tiles issued by this CTA
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const int bh = item / q_tiles;
        const int b = bh / heads, h = bh % heads;
        const int qb = n & 1;
        mbar_wait(q_empty(qb), ((n >> 1) & 1) ^ 1);  // the first use passes
        mbar_expect_tx(q_full(qb), G::kQBytes);
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p)
          tma_load(base + qb * G::kQBytes + p * G::kQPanel, &tm_q, q_full(qb), p * kPanelCols,
                   (item % q_tiles) * G::kBlockM, h, b);
        for (int it = 0; it < n_tiles; ++it, ++tile) {
          const int s = tile % S;
          mbar_wait(kv_empty(s), ((tile / S) & 1) ^ 1);
          const uint32_t k_dst = base + G::kKOff + s * G::kKVBytes;
          const uint32_t v_dst = base + G::kVOff + s * G::kKVBytes;
          mbar_expect_tx(k_full(s), G::kKVBytes);
#pragma unroll
          for (int p = 0; p < G::kPanels; ++p)
            tma_load(k_dst + p * G::kKVPanel, &tm_k, k_full(s), p * kPanelCols, it * BN, h, b);
          mbar_expect_tx(v_full(s), G::kKVBytes);
#pragma unroll
          for (int p = 0; p < G::kPanels; ++p)
            tma_load(v_dst + p * G::kKVPanel, &tm_v, v_full(s), p * kPanelCols, it * BN, h, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup `group - 1`: 64 Q rows of each item; this warp's 16
  // are rows g and g + 8 of its 16-row slice in the accumulator layout.
  setmaxnreg_inc<G::kConsumerRegs>();
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cw = group - 1;
  const uint32_t q_rows = cw * 64 * kPanelRow;  // within each Q panel

  // S = Q K^T of the tile in stage s: two k16 steps per panel.
  auto issue_qk = [&](float (&sc)[BN / 2], uint32_t q_buf, int s) {
    const uint32_t k_tile = base + G::kKOff + s * G::kKVBytes;
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss<BN>(sc, sw64_desc(q_buf + q_rows + p * G::kQPanel + kk * 32, 16, kAtom),
                     sw64_desc(k_tile + p * G::kKVPanel + kk * 32, 16, kAtom));
  };
  // acc += P V of the tile in stage s: one wgmma per 16 keys; chunks wholly
  // past the ragged end are skipped (uniform across the warpgroup).
  auto issue_pv = [&](float (&acc)[D / 2], const uint32_t (&pa)[BN / 16][4], int s, int valid) {
    const uint32_t v_tile = base + G::kVOff + s * G::kKVBytes;
#pragma unroll
    for (int c = 0; c < BN / 16; ++c)
      if (c * 16 < valid)
        wgmma_rs<D>(acc, pa[c], sw64_desc(v_tile + c * 16 * kPanelRow, G::kKVPanel, kAtom));
  };

  int n = 0, tile = 0;  // items and K/V tiles consumed by this CTA
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const int bh = item / q_tiles;
    const int q0 = (item % q_tiles) * G::kBlockM;
    const int qb = n & 1;
    const uint32_t q_buf = base + qb * G::kQBytes;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, alpha0, alpha1;
    float acc[D / 2], sc[BN / 2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // Tile 0: S, softmax, P.
    mbar_wait(q_full(qb), (n >> 1) & 1);
    int s_prev = tile % S, valid_prev = min(BN, tk);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full(s_prev), (tile / S) & 1);
    fence_regs(sc);
    wgmma_fence();
    issue_qk(sc, q_buf, s_prev);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_step<BN>(sc, valid_prev, t, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    pack_p<BN>(pa, sc);

    // Tile it: S_it = Q K_it^T and acc += P_{it-1} V_{it-1} in flight
    // together; the softmax of tile it runs while the PV product does.
    for (int it = 1; it < n_tiles; ++it) {
      const int s = (tile + it) % S;
      const int valid = min(BN, tk - it * BN);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      mbar_wait(k_full(s), ((tile + it) / S) & 1);
      fence_regs(sc);
      fence_regs(acc);
      wgmma_fence();
      issue_qk(sc, q_buf, s);
      wgmma_commit();
      mbar_wait(v_full(s_prev), ((tile + it - 1) / S) & 1);
      issue_pv(acc, pa, s_prev, valid_prev);
      wgmma_commit();
      wgmma_wait<1>();  // S_it is done; the PV product may still run
      fence_regs(sc);
      softmax_step<BN>(sc, valid, t, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p<BN>(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty(s_prev));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      pack_p<BN>(pa, sc);
      s_prev = s;
      valid_prev = valid;
    }

    // The last PV product; then Q and the last stage go back to the producer.
    mbar_wait(v_full(s_prev), ((tile + n_tiles - 1) / S) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(acc, pa, s_prev, valid_prev);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_p<BN>(pa);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(kv_empty(s_prev));
      mbar_arrive(q_empty(qb));
    }
    tile += n_tiles;

    float r0s = l0, r1s = l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r0s += __shfl_xor_sync(0xffffffffu, r0s, off);
      r1s += __shfl_xor_sync(0xffffffffu, r1s, off);
    }
    const float inv0 = 1.f / r0s, inv1 = 1.f / r1s;
    const int r0 = q0 + (group - 1) * 64 + wq * 16 + g;
    __nv_bfloat16* ob0 = o + (bh / heads) * o_sb + (bh % heads) * o_sh + r0 * o_st + 2 * t;
    __nv_bfloat16* ob1 = ob0 + 8 * o_st;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < tq)
        *reinterpret_cast<uint32_t*>(ob0 + 8 * j) =
            pack_bf16(acc[4 * j + 0] * inv0, acc[4 * j + 1] * inv0);
      if (r0 + 8 < tq)
        *reinterpret_cast<uint32_t*>(ob1 + 8 * j) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
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

// A 4-d map (D, T, H, B) over one (B, H, T, D) operand with element strides
// st = (b, h, t), read as D/32 panels of `rows` x 32 under SWIZZLE_64B; rows
// past T read as zeros.
CUresult encode_operand(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int t,
                        int heads, int batch, const int64_t* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, int C>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                 int tq, int tk, const int64_t* st, float scale, cudaStream_t stream) {
  using G = WgmmaShape<D, C>;
  EncodeTiled encode = nullptr;
  const cudaError_t found = encoder(&encode);
  if (found != cudaSuccess) return kNoDriverEntry + (int)found;
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = encode_operand(encode, &tm_q, q, D, tq, heads, batch, st + 0, G::kBlockM);
  if (res == CUDA_SUCCESS) res = encode_operand(encode, &tm_k, k, D, tk, heads, batch, st + 3, G::BN);
  if (res == CUDA_SUCCESS) res = encode_operand(encode, &tm_v, v, D, tk, heads, batch, st + 6, G::BN);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  auto kernel = flash_fwd_wgmma_kernel<D, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmemBytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // Persistent CTAs: as many as fit on the card at once, each walking items.
  const int64_t items = (int64_t)batch * heads * ((tq + G::kBlockM - 1) / G::kBlockM);
  const int grid = (int)(items < (int64_t)sms * G::kCtasPerSm ? items : (int64_t)sms * G::kCtasPerSm);
  kernel<<<grid, G::kThreads, G::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], batch * heads,
      heads, tq, tk, scale * 1.4426950408889634f);  // exp(x) = exp2(x * log2(e))
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (batch, heads, t, d) bfloat16 device buffers with d contiguous,
// d in {64, 96, 128}; `strides` holds the (batch, heads, t) element strides of
// q, k, v and o in that order (12 values): those of q, k and v non-zero
// multiples of 8 (a tensor map's), every base on 16 bytes. `block_m` (64, 128,
// or 192 for d <= 96) picks the Q tile: one, two or three consumer
// warpgroups. Launches on `stream`
// and does not synchronise. Returns 0, a cudaError (cudaErrorInvalidValue for
// an unsupported d or block_m), 1000000 + the CUresult of a tensor map that
// would not encode, or 2000000 + the cudaError of a driver without
// cuTensorMapEncodeTiled.
extern "C" int atlas_flash_attn_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                          int batch, int heads, int tq, int tk, int d,
                                          const int64_t* strides, int block_m, float scale,
                                          void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#define ATLAS_TILE(DV, C) \
  if (d == DV && block_m == 64 * C) \
    return launch_wgmma<DV, C>(q, k, v, o, batch, heads, tq, tk, strides, scale, s);
  ATLAS_TILE(64, 1) ATLAS_TILE(96, 1) ATLAS_TILE(128, 1)
  ATLAS_TILE(64, 2) ATLAS_TILE(96, 2) ATLAS_TILE(128, 2)
  ATLAS_TILE(64, 3) ATLAS_TILE(96, 3)
#undef ATLAS_TILE
  return (int)cudaErrorInvalidValue;
}
