// Flash-attention forward (GQA), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (body _flash_fwd_kernel): softmax(q k^T * hd^-0.5) v
// per (batch, query head) with an online softmax (m, l in float32), the kv
// head read as h / G, keys past Skv and queries past Sq masked, causal
// (top-left aligned, q_pos >= k_pos) tiles above the diagonal skipped, the
// isfinite guards that make a fully masked row 0 and never NaN, and the
// output acc / max(l, 1e-30) in q's dtype.
//
// Layouts are those of the port's model code, so no transpose is needed:
// q and out (B, Sq, KV, G, hd), k and v (B, Skv, KV, hd), all contiguous.
//
// bfloat16: flash_fwd_wgmma. What bounds it on this card: at the serving
// path's shape (B 4, S 512, KV 1, G 8, hd 256, causal) the function moves
// ~19 MB (5.6 us at 3.35 TB/s) and, with P split in two below, does ~6.4e9
// tensor-core operations (~6.5 us at 989 TFLOP/s). What the design does:
//   - both products on the bf16 tensor cores with wgmma, float32
//     accumulators in registers: S = Q K^T with Q and K from shared memory,
//     O += P V with P from registers and V from shared memory (MN-major);
//   - P keeps float32 accuracy, as the Pallas kernel multiplies float32 p by
//     float32 v: P = P_hi + P_lo with P_hi = bf16(P), P_lo = bf16(P - P_hi),
//     two wgmma into the same accumulator (V is exact in bf16; ~16 bits of
//     P kept). Q K^T needs no split: bf16 x bf16 products are exact in
//     float32. l is summed from the float32 P;
//   - K/V tiles of 64 keys arrive by TMA (128-byte swizzle, 64-byte at hd
//     32) into a ring of 2 (hd 256) or 3 shared-memory stages with mbarrier
//     completion. One thread issues the loads, each as soon as its stage is
//     released, so STAGES - 1 tiles are in flight while the two warpgroups
//     compute. There is no producer warpgroup: its 128 threads would cap
//     every thread at 168 registers, and the hd-256 warpgroup needs ~250
//     (ptxas spilled with one, setmaxnreg notwithstanding). Rows
//     past Skv are zero-filled by TMA; the mask decides which keys are live;
//   - MQA/GQA heads packed per tile: for a fixed (b, position, kv head) the
//     G query heads are G*hd contiguous elements, so a 64-row tile holds
//     64/G positions x G heads (row r: position p0 + r / G, head r % G) and
//     the block stages each K/V tile once for all G heads. Where G does not
//     divide 64, a tile holds 64 positions of one head;
//   - causal balance: each block's two warpgroups take the q tiles t and
//     last - t, so every block does about the same work; a warpgroup whose
//     tile ends before a K/V tile skips it (and still releases the stage);
//   - the CUDA-core work between the products kept small, since nothing
//     overlaps it inside a warpgroup: the mask only on tiles that cross the
//     diagonal, Skv or Sq, and the output divided by l through one IEEE
//     reciprocal per row and a correctly rounded FMA step per element.
//
// float32: flash_fwd_tf32. What bounds it on this card: at the serving
// shape the products are 4.29e9 operations and float32 accuracy on the tensor
// cores costs three TF32 products each (below), 0.026 ms at 495/3 TFLOP/s
// beside ~0.0003 ms of softmax at the float32 rate and 0.011 ms of bytes.
// What the design does:
//   - both products on the tensor cores, mma.sync m16n8k8 TF32 with float32
//     accumulators, in error-compensated TF32: each operand a is split as
//     hi = tf32(a), lo = tf32(a - hi) (rounded to nearest, ties away: the
//     value of cvt.rna), and lo·hi, hi·lo, then hi·hi go into one
//     accumulator. One TF32 product keeps ~3 digits and misses the 2e-5 bar
//     by 38-55x; three stay within it (tests/test_torch_flash_attention.py
//     emulates both on the CPU). S = Q K^T takes its k-steps into two
//     accumulators in turn (summed once per tile), so that more independent
//     products are in flight;
//   - P stays in registers: the m16n8 accumulator of S holds keys 2t and
//     2t + 1 of the thread's rows where an A operand wants t and t + 4, so
//     P V runs over a permuted k (logical t -> key 2t, t + 4 -> 2t + 1) and
//     reads the V rows in the same order. The softmax (max, expf, rescale,
//     l summed from the float32 P) runs on the CUDA cores in float32;
//   - MQA/GQA heads packed per tile as in the bf16 kernel (row r: position
//     p0 + r / G, head r % G; one head a tile where G does not divide 64),
//     so each K/V tile is staged once for all G heads;
//   - causal balance by splitting the keys: one 64-row q tile a block, its 8
//     warps in two groups of 4 warps x 16 rows, group g on the K/V tiles kt
//     with kt % 2 == g; at the end group 1 hands its (m, l, acc) to group 0
//     through shared memory, which merges the two online softmaxes. So both
//     groups stay busy and a block's time is half its tile's keys. The
//     blocks go heaviest tile first, so the light ones fill the SMs as the
//     heavy ones end. A warp skips the K/V tiles above its rows' diagonal
//     and masks only tiles that cross the diagonal, Skv or Sq;
//   - K/V tiles of 32 keys (16 at hd 256, where Q and two stages of two
//     32-key K/V pairs would pass the 227 KB of shared memory) double-
//     buffered with 16-byte cp.async, the next step's two tiles in flight
//     while the current ones compute; rows past Skv are zero-filled by the
//     copy. Q is staged once and its fragments are split as they load.
//     Shared-memory rows are padded by 4 floats, so every fragment load hits
//     32 banks;
//   - the output is acc / max(l, 1e-30) by IEEE division, as the plain
//     version.
// On the card the same design with register-tiled fmaf products was 1.58x
// slower, and pairing q tiles t and last - t in a block (the bf16 kernel's
// balance) 1.13x slower (PERF.md §6).
//
// Raw PTX (wgmma.mma_async, cp.async.bulk.tensor, mbarrier), no CUTLASS or
// CuTe headers, so the file builds in seconds; the TMA maps are encoded on
// the host through cudaGetDriverEntryPoint (no -lcuda). Built
// without fast math (accurate expf, IEEE division) by kernels/build.py.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace wg {

constexpr int ROWS = 64;                  // q rows per warpgroup (one wgmma M)
constexpr int CONSUMERS = 2;              // warpgroups per block, 64 q rows each
constexpr int THREADS = 128 * CONSUMERS;
constexpr int BK = 64;                    // keys per K/V tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of ``bar`` with this parity has completed. A wait
// that has not completed after 2^24 polls (far longer than any tile takes)
// traps, so a fault in the pipeline ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// Hides a value from loop-invariant code motion: the wgmma descriptors derived
// from it are then formed next to their use instead of being hoisted out of
// the K/V loop, where 20-odd 64-bit descriptors would take the registers the
// accumulators need.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (issued ... waited).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// x / d rounded to nearest, from inv = RN(1 / d): q = RN(x * inv) is within
// an ulp of x / d, the FMA gives its exact remainder, and one correction
// step rounds correctly (Markstein) for normal operands and results, as here
// (d >= 1e-30, |x| <= d * max |v|). Cheaper than an IEEE division per element.
__device__ __forceinline__ float div_rn(float x, float d, float inv) {
  const float q = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q, d, x), inv, q);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D (64 x 32) = A (64 x 16, K-major smem) * B (32 x 16, K-major smem) [+ D]
  __device__ __forceinline__ static void ss(
      float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // D (64 x 32) += A (64 x 16, registers) * B (16 x 32, MN-major smem)
  __device__ __forceinline__ static void rs(
      float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // D (64 x 64) = A (64 x 16, K-major smem) * B (64 x 16, K-major smem) [+ D]
  __device__ __forceinline__ static void ss(
      float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // D (64 x 64) += A (64 x 16, registers) * B (16 x 64, MN-major smem)
  __device__ __forceinline__ static void rs(
      float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D (64 x 128) += A (64 x 16, registers) * B (16 x 128, MN-major smem)
  __device__ __forceinline__ static void rs(
      float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        "%58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // D (64 x 256) += A (64 x 16, registers) * B (16 x 256, MN-major smem)
  __device__ __forceinline__ static void rs(
      float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
        "%122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
          "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
          "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <int HD>
struct Cfg {
  static constexpr int CW = HD < 64 ? HD : 64;     // columns per swizzle chunk
  static constexpr int NC = HD / CW;               // chunks per row
  static constexpr int SW = 2 * CW;                // bytes per shared row = swizzle span
  static constexpr uint64_t SWIZZLE = SW == 128 ? 1 : 2;  // descriptor code: 128 or 64 bytes
  static constexpr int STAGES = HD == 256 ? 2 : 3;  // K/V ring depth
  static constexpr int Q_BYTES = ROWS * HD * 2;    // one warpgroup's Q tile
  static constexpr int KV_BYTES = BK * HD * 2;     // one K or V tile
  static constexpr int SMEM = 1024 + CONSUMERS * Q_BYTES + 2 * STAGES * KV_BYTES +
                              8 * (1 + 2 * STAGES);  // + alignment slack and mbarriers
};

// The q tile (of 64 rows) that warpgroup ``w`` of block ``blk`` takes, or -1:
// tile blk and tile last - blk, so that every block does about the same
// causal work (the middle tile of an odd count goes to warpgroup 0 alone).
__device__ __forceinline__ int tile_of(int w, int blk, int n_tiles) {
  const int t = w == 0 ? blk : n_tiles - 1 - blk;
  return (t < n_tiles && !(w > 0 && t == blk)) ? t : -1;
}

// K/V tiles that q tile ``t`` needs: all, or up to its last live position
// (moved by the causal offset ``off``) when causal (tiles above the diagonal
// are skipped); 0 for no tile.
__device__ __forceinline__ int tiles_needed(int t, int PT, int Sq, int n_kv, int causal,
                                            int off) {
  if (t < 0) return 0;
  const int last = min((t + 1) * PT, Sq) - 1;
  return causal ? min(n_kv, (last + off) / BK + 1) : n_kv;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int Sq,
                int Skv, int KV, int G, int GP, int n_tiles, float scale, int causal,
                int off) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // swizzle atoms
  uint8_t* sk = sq + CONSUMERS * C::Q_BYTES;
  uint8_t* sv = sk + C::STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + C::STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;           // K/V stage loaded
  uint64_t* empty = full + C::STAGES;    // K/V stage released by both warpgroups

  const int HG = G / GP;                 // head groups per kv head: 1 when packed
  const int kv = blockIdx.y / HG, hg = blockIdx.y % HG;
  const int b = blockIdx.z;
  const int PT = ROWS / GP;              // positions per q tile
  const int n_kv = (Skv + BK - 1) / BK;
  int n_kt = 0;                          // K/V tiles this block streams
#pragma unroll
  for (int c = 0; c < CONSUMERS; ++c)
    n_kt = max(n_kt, tiles_needed(tile_of(c, blockIdx.x, n_tiles), PT, Sq, n_kv, causal, off));

  // K/V tile kt into its stage (one thread)
  auto load_kv = [&](int kt) {
    const int s = kt % C::STAGES;
    mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
    for (int j = 0; j < C::NC; ++j) {
      tma_load_4d(sk + s * C::KV_BYTES + j * BK * C::SW, &tk, &full[s], j * C::CW, kv, kt * BK, b);
      tma_load_4d(sv + s * C::KV_BYTES + j * BK * C::SW, &tv, &full[s], j * C::CW, kv, kt * BK, b);
    }
  };

  // Thread 0 issues every TMA load: both Q tiles and the first STAGES K/V
  // tiles now, each later K/V tile as soon as both warpgroups have released
  // its stage (below). A separate producer warpgroup would cap every thread
  // at 168 registers (65536 / 384): ptxas spilled at hd 256 there,
  // setmaxnreg or not, while this kernel takes ~250 and spills none.
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    uint32_t q_bytes = 0;
#pragma unroll
    for (int c = 0; c < CONSUMERS; ++c)
      if (tile_of(c, blockIdx.x, n_tiles) >= 0) q_bytes += C::Q_BYTES;
    mbar_expect_tx(q_full, q_bytes);
#pragma unroll
    for (int c = 0; c < CONSUMERS; ++c) {
      const int t = tile_of(c, blockIdx.x, n_tiles);
      if (t < 0) continue;
#pragma unroll
      for (int j = 0; j < C::NC; ++j)
        tma_load_5d(sq + c * C::Q_BYTES + j * ROWS * C::SW, &tq, q_full, j * C::CW, hg * GP, kv,
                    t * PT, b);
    }
    for (int kt = 0; kt < min(n_kt, C::STAGES); ++kt) load_kv(kt);
  }
  __syncthreads();

  // warpgroup w: 64 q rows
  const int w = threadIdx.x / 128;
  const int t = tile_of(w, blockIdx.x, n_tiles);
  const int need = tiles_needed(t, PT, Sq, n_kv, causal, off);
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;   // this thread's rows: r0 and r0 + 8
  const int p0 = t * PT;
  const int qpos0 = p0 + r0 / GP, qpos1 = p0 + (r0 + 8) / GP;
  const uint8_t* qs = sq + w * C::Q_BYTES;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if (need > 0) mbar_wait(q_full, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % C::STAGES;
    const uint32_t parity = (kt / C::STAGES) & 1;
    mbar_wait(&full[s], parity);
    if (kt < need) {
      // S = Q K^T (64 x BK), float32 accumulators; descriptor + byte
      // offset / 16 moves the start address
      const uint64_t qd = opaque(smem_desc(qs, 16, 8 * C::SW, C::SWIZZLE));
      const uint64_t kd = opaque(smem_desc(sk + s * C::KV_BYTES, 16, 8 * C::SW, C::SWIZZLE));
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < C::NC; ++j) {
#pragma unroll
        for (int kk = 0; kk < C::CW / 16; ++kk)
          Wgmma<BK>::ss(sc, qd + ((j * ROWS * C::SW + kk * 32) >> 4),
                        kd + ((j * BK * C::SW + kk * 32) >> 4), (j | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask, online softmax; element i: row r0 + 8 * ((i >> 1) & 1),
      // key kt * BK + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1). Only a tile
      // on the diagonal, past Skv or with rows past Sq needs the mask.
      const bool masked = (kt + 1) * BK > Skv || (causal && (kt + 1) * BK - 1 > p0 + off) ||
                          p0 + PT > Sq;
      if (masked) {
        const int k0 = kt * BK + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          const bool live = kpos < Skv && qpos < Sq && (!causal || qpos + off >= kpos);
          sc[i] = live ? sc[i] * scale : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = isfinite(mn0) ? mn0 : 0.f, ms1 = isfinite(mn1) ? mn1 : 0.f;
      const float corr0 = isfinite(m0) ? expf(m0 - ms0) : 0.f;
      const float corr1 = isfinite(m1) ? expf(m1 - ms1) : 0.f;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float e = expf(sc[i] - ((i & 2) ? ms1 : ms0));
        const float p = isfinite(sc[i]) ? e : 0.f;
        sc[i] = p;
        if (i & 2) sum1 += p; else sum0 += p;
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? corr1 : corr0;

      // P = P_hi + P_lo as wgmma A fragments (the accumulator layout of S is
      // the A layout: k16 chunk kk holds elements 8kk .. 8kk + 7)
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[8 * kk + 2 * e], y = sc[8 * kk + 2 * e + 1];
          const float xh = __bfloat162float(__float2bfloat16_rn(x));
          const float yh = __bfloat162float(__float2bfloat16_rn(y));
          ph[kk][e] = pack_bf16(xh, yh);
          pl[kk][e] = pack_bf16(x - xh, y - yh);
        }
      }

      // O += P_hi V + P_lo V (V MN-major: hd contiguous, chunks of CW columns)
      const uint64_t vd =
          opaque(smem_desc(sv + s * C::KV_BYTES, BK * C::SW, 8 * C::SW, C::SWIZZLE));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        Wgmma<HD>::rs(acc, ph[kk], vd + ((kk * 16 * C::SW) >> 4));
        Wgmma<HD>::rs(acc, pl[kk], vd + ((kk * 16 * C::SW) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && kt + C::STAGES < n_kt) {  // refill the stage
      mbar_wait(&empty[s], parity);
      load_kv(kt + C::STAGES);
    }
  }

  if (need > 0) {
    const size_t q_row = size_t(KV) * G * HD;  // stride of one position in q / out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const int qpos = h ? qpos1 : qpos0;
      if (qpos >= Sq) continue;
      const float denom = fmaxf(h ? l1 : l0, 1e-30f);
      const float inv = 1.f / denom;  // correctly rounded (IEEE division)
      const int g = hg * GP + row % GP;
      __nv_bfloat16* orow =
          out + (size_t(b) * Sq + qpos) * q_row + (size_t(kv) * G + g) * HD + 2 * (lane % 4);
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const float x = div_rn(acc[4 * n8 + 2 * h], denom, inv);
        const float y = div_rn(acc[4 * n8 + 2 * h + 1], denom, inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n8) = __floats2bfloat162_rn(x, y);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded (no -lcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA map of a contiguous bf16 tensor: ``dims`` and ``box`` innermost first.
bool encode(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
            const uint32_t* box, int swizzle_bytes) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim, gstride,
            bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int TENSOR_MAP_FAILED = -1;  // launcher status: a TMA map could not be encoded

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int KV,
           int G, float scale, int causal, int off, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int GP = ROWS % G == 0 ? G : 1;  // heads packed per 64-row tile
  const int PT = ROWS / GP;
  const int n_tiles = (Sq + PT - 1) / PT;
  const uint64_t qdims[5] = {uint64_t(HD), uint64_t(G), uint64_t(KV), uint64_t(Sq), uint64_t(B)};
  const uint32_t qbox[5] = {uint32_t(C::CW), uint32_t(GP), 1, uint32_t(PT), 1};
  const uint64_t kdims[4] = {uint64_t(HD), uint64_t(KV), uint64_t(Skv), uint64_t(B)};
  const uint32_t kbox[4] = {uint32_t(C::CW), 1, uint32_t(BK), 1};
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, 5, qdims, qbox, C::SW) || !encode(&tk, k, 4, kdims, kbox, C::SW) ||
      !encode(&tv, v, 4, kdims, kbox, C::SW))
    return TENSOR_MAP_FAILED;
  auto kernel = flash_fwd_wgmma<HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n_tiles + CONSUMERS - 1) / CONSUMERS, KV * (G / GP), B);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv,
                                             KV, G, GP, n_tiles, scale, causal, off);
  return int(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync
// ---------------------------------------------------------------------------
namespace f32 {

using namespace tf32x3;

constexpr int ROWS = 64;                  // q rows per tile, 16 a warp
constexpr int TILE_WARPS = ROWS / 16;
constexpr int SPLITS = 2;                 // warp groups of a block, on every other K/V tile
constexpr int THREADS = 32 * TILE_WARPS * SPLITS;
constexpr int GROUP_THREADS = 32 * TILE_WARPS;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 16 : 32;  // keys per K/V tile
  static constexpr int NJ = BK / 8;               // n-tiles of S = k-steps of P V
  static constexpr int NO = HD / 8;               // n-tiles of O
  static constexpr int NB = NO < 8 ? NO : 8;      // O n-tiles per batch of products
  static constexpr int RS = HD + 4;               // row stride of Q, K and V in shared memory
  static constexpr int Q_FLOATS = ROWS * RS;
  static constexpr int KV_FLOATS = BK * RS;       // one K or V tile
  static constexpr int STAGE_FLOATS = SPLITS * 2 * KV_FLOATS;  // a K and a V tile a group
  static constexpr int MERGE_FLOATS = (4 + 4 * NO) * GROUP_THREADS;  // a group's m, l, acc
  static constexpr size_t SMEM = sizeof(float) * (size_t(Q_FLOATS) + 2 * size_t(STAGE_FLOATS));
  static_assert(MERGE_FLOATS <= 2 * STAGE_FLOATS, "the merge reuses the K/V stages");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// acc[j] += a b[j], j < N, in error-compensated TF32: lo·hi and hi·lo over
// all columns first, then hi·hi, so the tensor cores get independent
// products back to back.
template <int N>
__device__ __forceinline__ void mma3(float (*acc)[4], const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[j], a.hi, b[j].hi);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int B, int Sq, int Skv,
               int KV, int G, int GP, int n_tiles, float scale, int causal, int off) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, NJ = C::NJ, NO = C::NO, NB = C::NB, RS = C::RS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // (ROWS, RS): the block's q tile
  float* kvs = qs + C::Q_FLOATS;   // 2 stages x SPLITS x (K tile, V tile), (BK, RS) each

  // one q tile a block; blockIdx.x runs over (head group, batch, tile) with
  // the tile slowest and the last (causal: the heaviest) first
  const int HG = G / GP;           // head groups per kv head: 1 when packed
  const int heads = KV * HG;
  const int kv = blockIdx.x % heads / HG, hg = blockIdx.x % heads % HG;
  const int b = blockIdx.x / heads % B;
  const int t = n_tiles - 1 - blockIdx.x / heads / B;
  const int PT = ROWS / GP;        // positions per q tile
  const int p0 = t * PT;
  const int n_kv = (Skv + BK - 1) / BK;
  const int n_kt = causal ? min(n_kv, (min(p0 + PT, Sq) - 1 + off) / BK + 1) : n_kv;
  const int n_it = (n_kt + SPLITS - 1) / SPLITS;  // K/V tiles a group takes
  const size_t q_row = size_t(KV) * G * HD;  // stride of one position in q / out
  const size_t k_row = size_t(KV) * HD;      // stride of one position in k / v
  const size_t q_off = size_t(b) * Sq * q_row + (size_t(kv) * G + size_t(hg) * GP) * HD;
  const size_t k_off = size_t(b) * Skv * k_row + size_t(kv) * HD;
  const float* qb = q + q_off;
  const float* kb = k + k_off;
  const float* vb = v + k_off;

  // Q once, and in step it the K/V tiles it * SPLITS + g of the groups g
  // into stage it % 2; rows past Sq / Skv and tiles past n_kt zero-filled
  constexpr int C4 = HD / 4;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, c4 = i % C4;
    const int pos = p0 + r / GP;
    const bool valid = pos < Sq;
    cp_async16(qs + r * RS + 4 * c4,
               valid ? qb + size_t(pos) * q_row + (r % GP) * HD + 4 * c4 : qb, valid);
  }
  auto stage = [&](int it) {
    float* st = kvs + (it & 1) * C::STAGE_FLOATS;
    for (int i = threadIdx.x; i < SPLITS * BK * C4; i += THREADS) {
      const int g = i / (BK * C4), r = i / C4 % BK, c4 = i % C4;
      const int kt = it * SPLITS + g, key = kt * BK + r;
      const bool valid = kt < n_kt && key < Skv;
      const size_t off = valid ? size_t(key) * k_row + 4 * c4 : 0;
      float* ks = st + g * 2 * C::KV_FLOATS;
      cp_async16(ks + r * RS + 4 * c4, kb + off, valid);
      cp_async16(ks + C::KV_FLOATS + r * RS + 4 * c4, vb + off, valid);
    }
    cp_async_commit();
  };
  stage(0);  // with Q in the same group

  // warp w of group g: rows r0 .. r0 + 15 of the tile, the K/V tiles kt
  // with kt % SPLITS == g; this thread's rows r0 + gq and r0 + gq + 8
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment row and column in the quad
  const int grp = warp / TILE_WARPS;
  const int r0 = (warp % TILE_WARPS) * 16;
  const int first = p0 + r0 / GP, last = p0 + (r0 + 15) / GP;  // the warp's positions
  const int qpos0 = p0 + (r0 + gq) / GP, qpos1 = p0 + (r0 + gq + 8) / GP;
  int need = 0;  // K/V tiles the warp's rows need
  if (first < Sq) need = causal ? min(n_kv, (min(last, Sq - 1) + off) / BK + 1) : n_kv;
  const float* qw = qs + (r0 + gq) * RS + tq;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // step it is in shared memory; step it - 1 is consumed
    if (it + 1 < n_it) stage(it + 1);
    const int kt = it * SPLITS + grp;
    if (kt >= need) continue;
    const float* ks = kvs + (it & 1) * C::STAGE_FLOATS + grp * 2 * C::KV_FLOATS;
    const float* vs = ks + C::KV_FLOATS;
    // S = Q K^T, 16 rows x BK keys; k-steps alternate between two sums
    float sc[NJ][4], sc2[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sc2[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < HD; kk += 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = kk + 8 * h;
        FragA a;
        a.set(qw[k0], qw[8 * RS + k0], qw[k0 + 4], qw[8 * RS + k0 + 4]);
        FragB bf[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* kr = ks + (8 * j + gq) * RS + k0 + tq;
          bf[j].set(kr[0], kr[4]);
        }
        mma3<NJ>(h ? sc2 : sc, a, bf);
      }
    }

    // scale, mask, online softmax; element (j, e): row gq + 8 * (e >> 1),
    // key kt * BK + 8 * j + 2 * tq + (e & 1). Only a tile on the diagonal,
    // past Skv or with rows past Sq needs the mask.
    const bool masked =
        (kt + 1) * BK > Skv || (causal && (kt + 1) * BK - 1 > first + off) || last >= Sq;
    const int key0 = kt * BK + 2 * tq;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (sc[j][e] + sc2[j][e]) * scale;
        if (masked) {
          const int kpos = key0 + 8 * j + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          if (!(kpos < Skv && qpos < Sq && (!causal || qpos + off >= kpos))) x = -INFINITY;
        }
        sc[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = isfinite(mn0) ? mn0 : 0.f, ms1 = isfinite(mn1) ? mn1 : 0.f;
    const float corr0 = isfinite(m0) ? expf(m0 - ms0) : 0.f;
    const float corr1 = isfinite(m1) ? expf(m1 - ms1) : 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e];
        const float p = isfinite(x) ? expf(x - (e < 2 ? ms0 : ms1)) : 0.f;
        sc[j][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 += __shfl_xor_sync(FULL, sum0, o);
      sum1 += __shfl_xor_sync(FULL, sum1, o);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V over the permuted k: A (j) = P's keys 8j + 2t, 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      FragA a;
      a.set(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
      const float* vr = vs + (8 * j + 2 * tq) * RS + gq;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NB) {
        FragB bf[NB];
#pragma unroll
        for (int n = 0; n < NB; ++n) bf[n].set(vr[8 * (n0 + n)], vr[RS + 8 * (n0 + n)]);
        mma3<NB>(acc + n0, a, bf);
      }
    }
  }

  // the groups hold the online softmax of the same rows over two halves of
  // the keys: group 1 hands (m, l, acc) to group 0 through shared memory
  // (the K/V stages, free now) and group 0 merges them and writes the rows
  float* mg = kvs + threadIdx.x % GROUP_THREADS;  // value e at mg[e * GROUP_THREADS]
  __syncthreads();
  if (grp == 1) {
    mg[0] = m0;
    mg[GROUP_THREADS] = m1;
    mg[2 * GROUP_THREADS] = l0;
    mg[3 * GROUP_THREADS] = l1;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mg[(4 + 4 * n + e) * GROUP_THREADS] = acc[n][e];
  }
  __syncthreads();
  if (grp == 0 && need > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = h ? qpos1 : qpos0;
      if (pos >= Sq) continue;
      const float m_own = h ? m1 : m0, m_other = mg[h * GROUP_THREADS];
      const float mn = fmaxf(m_own, m_other);
      const float ms = isfinite(mn) ? mn : 0.f;
      const float c_own = isfinite(m_own) ? expf(m_own - ms) : 0.f;
      const float c_other = isfinite(m_other) ? expf(m_other - ms) : 0.f;
      const float l = (h ? l1 : l0) * c_own + mg[(2 + h) * GROUP_THREADS] * c_other;
      const float denom = fmaxf(l, 1e-30f);
      float* orow = out + q_off + size_t(pos) * q_row + ((r0 + gq + 8 * h) % GP) * HD + 2 * tq;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float x = acc[n][2 * h] * c_own + mg[(4 + 4 * n + 2 * h) * GROUP_THREADS] * c_other;
        const float y =
            acc[n][2 * h + 1] * c_own + mg[(5 + 4 * n + 2 * h) * GROUP_THREADS] * c_other;
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x / denom, y / denom);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int KV,
           int G, float scale, int causal, int off, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int GP = ROWS % G == 0 ? G : 1;  // heads packed per 64-row tile
  const int PT = ROWS / GP;
  const int n_tiles = (Sq + PT - 1) / PT;
  auto kernel = flash_fwd_tf32<HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  const unsigned blocks = unsigned(n_tiles) * unsigned(B) * unsigned(KV * (G / GP));
  kernel<<<blocks, THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), B, Sq, Skv, KV, G, GP, n_tiles, scale, causal, off);
  return int(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// causal_offset: with causal, query row i sees the keys <= causal_offset + i
// (0: top-left; a block of a sequence-sharded query starts at its first row).
// dtype: 0 float32 (3xTF32 mma.sync kernel), 1 bfloat16 (wgmma kernel). Returns
// the CUDA status of the launch (0 on success, -1 where a TMA map could not
// be encoded); the wrapper raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int KV, int G, int hd,
                                      float scale, int causal, int causal_offset, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || G <= 0 || causal_offset < 0)
    return int(cudaErrorInvalidValue);
  const int off = causal_offset;
  if (dtype == 0) {
    switch (hd) {
      case 32: return f32::launch<32>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
      case 64: return f32::launch<64>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
      case 128: return f32::launch<128>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
      case 256: return f32::launch<256>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
      default: return int(cudaErrorInvalidValue);
    }
  }
  if (dtype != 1) return int(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return wg::launch<32>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
    case 64: return wg::launch<64>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
    case 128: return wg::launch<128>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
    case 256: return wg::launch<256>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, off, st);
    default: return int(cudaErrorInvalidValue);
  }
}
