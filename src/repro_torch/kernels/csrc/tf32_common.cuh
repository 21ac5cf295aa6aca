// Shared device code of the fp32 kernels on the tensor cores: the
// attention kernels (attention_tf32.cuh) and the SSD scan kernels
// (ssd_tf32.cuh).
//
// 3xTF32. Every fp32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna.tf32.f32: round to nearest, ties away from zero,
// low 13 mantissa bits zeroed), and each product a b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms first, accumulated in
// fp32 by mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (SASS
// HMMA.1688.F32.TF32): CUTLASS's OpMultiplyAddFastF32. hi + lo holds x to
// 2^-22 relative, and the dropped lo_a lo_b term is of that size, so the
// products keep fp32 accuracy to a few ulps. kernels/flash_attention.py::
// _split_tf32 models the split in plain PyTorch.
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4 g + t): A (16 x 8, row)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// col) b0 (k t, n g), b1 (k t + 4, n g); C (16 x 8) c0 (g, 2t), c1 (g,
// 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1). The sum over a product's
// 8 k values may run in any order, as long as A and B agree on it. Two
// orders are used. Natural: k index t is column t (frag_a, frag_b_rows).
// Permuted: k index t is column 2t and t + 4 is 2t + 1 (frag_a_perm,
// frag_a_trans, frag_b_cols). An accumulator tile that comes out of one
// product as C feeds the next as A in the permuted order without a
// shuffle (split_scores: a = c0, c2, c1, c3).
//
// Planes. An operand tile lies row-major in shared memory as a hi plane
// and a lo plane of tf32 bits with a row stride LD = columns + 4 words
// (= 4 mod 16). Then the natural row reads (frag_a, frag_b_rows: 8 rows
// x 4 columns) and the permuted column reads (frag_a_trans,
// frag_b_cols: rows 2t, 2t + 1 x 8 columns) are free of bank conflicts;
// frag_a_perm (the row-major A of a product whose B is read by
// columns) has two-way conflicts.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pam {
namespace tf32 {

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// The same split of the bits of an fp32 x by integer rounding: add half a
// TF32 ulp to the magnitude and clear the 13 low bits, which is what
// cvt.rna.tf32.f32 gives for every finite x (kernels/flash_attention.py::
// _tf32 is this form), at the integer pipe's rate. For fragments split in
// registers as they are loaded.
__device__ __forceinline__ void split_bits(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) +
        0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 8) of a plane,
// natural order.
template <int LD>
__device__ __forceinline__ void frag_a(const uint32_t* p, int r0, int k0,
                                       uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* x = p + (r0 + g) * LD + k0 + t;
  a[0] = x[0];
  a[1] = x[8 * LD];
  a[2] = x[4];
  a[3] = x[8 * LD + 4];
}

// The same rows and columns in the permuted order.
template <int LD>
__device__ __forceinline__ void frag_a_perm(const uint32_t* p, int r0,
                                            int k0, uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint2 x0 = *reinterpret_cast<const uint2*>(p + (r0 + g) * LD + k0 +
                                                   2 * t);
  const uint2 x1 = *reinterpret_cast<const uint2*>(p + (r0 + g + 8) * LD +
                                                   k0 + 2 * t);
  a[0] = x0.x;
  a[1] = x1.x;
  a[2] = x0.y;
  a[3] = x1.y;
}

// A fragment of the transpose of a plane, A[m][k] = plane[k][m], m in
// [m0, m0 + 16), k in [k0, k0 + 8), permuted order.
template <int LD>
__device__ __forceinline__ void frag_a_trans(const uint32_t* p, int m0,
                                             int k0, uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* x = p + (k0 + 2 * t) * LD + m0 + g;
  a[0] = x[0];
  a[1] = x[8];
  a[2] = x[LD];
  a[3] = x[LD + 8];
}

// B fragment with the plane's rows as n: B[k][n] = plane[n0 + n][k0 + k]
// (the K of S = Q K^T), natural order.
template <int LD>
__device__ __forceinline__ void frag_b_rows(const uint32_t* p, int n0,
                                            int k0, uint32_t (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* x = p + (n0 + g) * LD + k0 + t;
  b[0] = x[0];
  b[1] = x[4];
}

// B fragment with the plane's rows as k, permuted order: B[t][n] =
// plane[k0 + 2t][n0 + n], B[t + 4][n] = plane[k0 + 2t + 1][n0 + n] (the V
// of O = P V).
template <int LD>
__device__ __forceinline__ void frag_b_cols(const uint32_t* p, int k0,
                                            int n0, uint32_t (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* x = p + (k0 + 2 * t) * LD + n0 + g;
  b[0] = x[0];
  b[1] = x[LD];
}

// An accumulator n-tile as the hi / lo A fragments of the next product,
// permuted order.
__device__ __forceinline__ void split_scores(const float (&c)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Max / sum over the 4 lanes of a quad (the owners of one accumulator
// row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tf32
}  // namespace pam
