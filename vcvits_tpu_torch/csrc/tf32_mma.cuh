// 3xTF32 products on Hopper's tensor cores with mma.sync, and cp.async
// copies: the helpers that csrc/flow_coupling.cu uses (csrc/mrf.cu carries
// its own copy of the same helpers).
//
// fp32 operands are split as a = hi + lo with hi = cvt.rna.tf32(a). A weight's
// lo is rounded to tf32 too; an activation's lo is passed as fp32 and the
// tensor cores drop its low 13 bits. A product is taken as
// lo*hi + hi*lo + hi*hi: about 2^-21 relative, where one TF32 product is off
// by 2^-11. The tensor cores' fp32 adds truncate, so a caller sums one weight
// tile's products into a fresh partial sum (mma_tf32_zero for the first) and
// adds that to its accumulator in fp32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a . b, one m16n8k8 tf32 product, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c = a . b
__device__ __forceinline__ void mma_tf32_zero(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// The m16n8k8 fragments of a thread (lane = 4 g + q):
//   A (16 x 8, row-major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, [k][n]):     b0 (q, g), b1 (q + 4, g)
//   C (16 x 8):            c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// A's fragment from a row-major fp32 tile `p` (at row g, column q) with row
// stride `stride`, split into hi and lo.
__device__ __forceinline__ void load_a_split(const float* p, int stride, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const float v[4] = {p[0], p[8 * stride], p[4], p[8 * stride + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // lo left in fp32: the tensor cores drop its low 13 bits
    hi[i] = tf32(v[i]);
    lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
  }
}

// B's fragment from a row-major [k][n] fp32 tile `p` (at row q, column g).
__device__ __forceinline__ void load_b_split(const float* p, int stride, uint32_t (&hi)[2],
                                             uint32_t (&lo)[2]) {
  split(p[0], hi[0], lo[0]);
  split(p[4 * stride], hi[1], lo[1]);
}

// part (+)= a . b in 3xTF32; `first` starts a fresh partial sum.
__device__ __forceinline__ void mma_3xtf32(float* part, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2], bool first) {
  if (first)
    mma_tf32_zero(part, al, bh);
  else
    mma_tf32(part, al, bh);
  mma_tf32(part, ah, bl);
  mma_tf32(part, ah, bh);
}

}  // namespace tc
