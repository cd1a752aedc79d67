// Helpers of the float32 kernels that run their products on the tensor cores
// in error-compensated TF32 (csrc/ssd.cu, csrc/flash_attention.cu's f32
// route): an operand a is split into hi = tf32(a) and lo = tf32(a - hi), and
// a·b is taken as lo·hi + hi·lo + hi·hi by mma.sync m16n8k8 with float32
// accumulators; K/V and other tiles are staged by 16-byte cp.async copies.
// kernels/ref.py::tf32_rna is the plain version of the rounding.
// kernels/build.py hashes this header with every source, so an edit here
// rebuilds both kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// cvt.rna.tf32.f32 of a finite float: round the magnitude to 10 mantissa
// bits, ties away from zero (add half of the dropped 13 bits, clear them).
// The same value as the PTX instruction, in two integer operations; ptxas
// expands the instruction itself into a longer sequence on sm_90, and the
// split runs for every operand the products load.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t hi[4], lo[4];
  __device__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// A 16-byte global-to-shared copy; valid false zero-fills the 16 bytes.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

}  // namespace tf32x3
