// Shared device code of the fp32 full-sequence attention kernels on the
// tensor cores (flash_attention_tf32x3.cu: forward;
// flash_attention_bwd_tf32x3.cu: backward).
//
// 3xTF32. Every fp32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna.tf32.f32: round to nearest, ties away from zero,
// low 13 mantissa bits zeroed), and each product a b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms first, accumulated in
// fp32 by mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (SASS
// HMMA.1688.F32.TF32): CUTLASS's OpMultiplyAddFastF32. hi + lo holds x to
// 2^-22 relative, and the dropped lo_a lo_b term is of that size, so the
// products keep fp32 accuracy to a few ulps. kernels/flash_attention.py::
// _split_tf32 and _fwd_tf32x3 / _bwd_tf32x3 model the split in plain
// PyTorch.
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4 g + t): A (16 x 8, row)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// col) b0 (k t, n g), b1 (k t + 4, n g); C (16 x 8) c0 (g, 2t), c1 (g,
// 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1). A score tile that comes
// out of one product as C feeds the next as A without a shuffle: the sum
// over the 8 columns of an n-tile may run in any order, so k index t
// stands for column 2t and t + 4 for column 2t + 1 (a = c0, c2, c1, c3),
// and the B operand of that product reads its rows 2t and 2t + 1.
//
// Tiles. Every operand tile is row-major in shared memory with a row
// stride of D + 4 words, as a hi plane and a lo plane of tf32 bits. With
// the stride = 4 (mod 16) all three fragment reads are free of bank
// conflicts: A and the "row" B read (8 rows) x (4 columns), the "column"
// B (rows 2t, 2t + 1) x (8 columns). A CTA holds a stationary tile of 64
// rows (16 a warp) for its life and walks moving tiles, double-buffered:
// the copy of tile j + 1 (cp.async, 16 bytes a thread, rows past the end
// zero-filled) runs while the warps multiply tile j. A thread splits
// exactly the chunks it copied, in place (raw fp32 into the hi plane,
// then hi and lo written), so a tile needs one barrier: after its split,
// which also frees the other buffer for the next copy.
#pragma once

#include <cstdint>

#include "attention_common.cuh"

namespace pam {
namespace tf32 {

template <int D>
__host__ __device__ constexpr int ld() {
  return D + 4;
}

// Rows of a moving tile: 32, or 16 at head dims 112 and 128, where a
// backward CTA's two stationary tiles (256 hi / lo rows of D + 4 words)
// and two double-buffered moving ones must fit in 227 KB.
template <int D>
__host__ __device__ constexpr int move_rows() {
  return D >= 112 ? 16 : 32;
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
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

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 8) of a plane.
template <int D>
__device__ __forceinline__ void load_a(const uint32_t* p, int r0, int k0,
                                       uint32_t (&a)[4]) {
  constexpr int LD = ld<D>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* x = p + (r0 + g) * LD + k0 + t;
  a[0] = x[0];
  a[1] = x[8 * LD];
  a[2] = x[4];
  a[3] = x[8 * LD + 4];
}

// B fragment with the tile's rows as n: B[k][n] = tile[n0 + n][k0 + k]
// (the K of S = Q K^T).
template <int D>
__device__ __forceinline__ void load_b_rows(const uint32_t* p, int n0,
                                            int k0, uint32_t (&b)[2]) {
  constexpr int LD = ld<D>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* x = p + (n0 + g) * LD + k0 + t;
  b[0] = x[0];
  b[1] = x[4];
}

// B fragment with the tile's rows as k, in the score tiles' column order:
// B[t][n] = tile[k0 + 2t][n0 + n], B[t + 4][n] = tile[k0 + 2t + 1][n0 + n]
// (the V of O = P V).
template <int D>
__device__ __forceinline__ void load_b_cols(const uint32_t* p, int k0,
                                            int n0, uint32_t (&b)[2]) {
  constexpr int LD = ld<D>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint32_t* x = p + (k0 + 2 * t) * LD + n0 + g;
  b[0] = x[0];
  b[1] = x[LD];
}

// An accumulator n-tile (a score tile's 8 columns) as the hi / lo A
// fragments of the next product (see the column order above).
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

// Copies rows [r0, r0 + R) of a row-major (n, D) fp32 matrix into the hi
// plane dst; rows at or past n are zero-filled. Chunk c (16 bytes) of
// the tile goes to thread c % T (the CTA's threads), the mapping
// split_rows uses.
template <int D, int R, int T>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int r0, int n, uint32_t* dst) {
  constexpr int LD = ld<D>();
  constexpr int C = D / 4;
  for (int c = threadIdx.x; c < R * C; c += T) {
    const int r = c / C;
    const int col = 4 * (c - r * C);
    const bool in = r0 + r < n;
    cp_async16_zfill(dst + r * LD + col,
                     src + (long)(in ? r0 + r : 0) * D + col, in ? 16 : 0);
  }
}

// The fp32 values this thread copied into the hi plane (stage_rows'
// mapping), split in place into hi and lo.
template <int D, int R, int T>
__device__ __forceinline__ void split_rows(uint32_t* hi, uint32_t* lo) {
  constexpr int LD = ld<D>();
  constexpr int C = D / 4;
  for (int c = threadIdx.x; c < R * C; c += T) {
    const int r = c / C;
    const int off = r * LD + 4 * (c - r * C);
    uint4 x = *reinterpret_cast<const uint4*>(hi + off);
    uint4 h, l;
    split(__uint_as_float(x.x), h.x, l.x);
    split(__uint_as_float(x.y), h.y, l.y);
    split(__uint_as_float(x.z), h.z, l.z);
    split(__uint_as_float(x.w), h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Max / sum over the 4 lanes of a quad (the owners of one score row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Moving tiles a stationary tile of SR rows starting at r0 must visit
// (tiles of R rows): all of them, or under the causal mask (kpos <= qpos
// from position 0) those starting at or before its last live row.
template <int SR, int R>
__device__ __forceinline__ int causal_tiles(int r0, int n_rows, int n_cols,
                                            bool causal) {
  const int nt = (n_cols + R - 1) / R;
  if (!causal) return nt;
  return min(nt, (min(r0 + SR, n_rows) - 1) / R + 1);
}

// c = A B^T over all D columns of two plane pairs in 3xTF32 (the
// score-like products S = Q K^T, dP = dO V^T): A the rows [ra, ra + 16)
// of (Ah, Al), B the rows [rb, rb + 8 N) of (Bh, Bl) as n (load_b_rows).
template <int D, int N>
__device__ __forceinline__ void rows_product(
    const uint32_t* Ah, const uint32_t* Al, int ra, const uint32_t* Bh,
    const uint32_t* Bl, int rb, float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    load_a<D>(Ah, ra, 8 * kk, ah);
    load_a<D>(Al, ra, 8 * kk, al);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t bh[2], bl[2];
      load_b_rows<D>(Bh, rb + 8 * n, 8 * kk, bh);
      load_b_rows<D>(Bl, rb + 8 * n, 8 * kk, bl);
      mma3(c[n], ah, al, bh, bl);
    }
  }
}

// out += S B over the rows of a plane pair in 3xTF32: S the warp's 16 x
// (8 N) score tile, split in registers, B the rows [rb, rb + 8 N) of
// (Bh, Bl) as k and all D columns (load_b_cols): O = P V, dV = P^T dO,
// dK = dS^T Q, dQ = dS K.
template <int D, int N>
__device__ __forceinline__ void cols_product(const float (&s)[N][4],
                                             const uint32_t* Bh,
                                             const uint32_t* Bl, int rb,
                                             float (&out)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint32_t ah[4], al[4];
    split_scores(s[n], ah, al);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      uint32_t bh[2], bl[2];
      load_b_cols<D>(Bh, rb + 8 * n, 8 * c, bh);
      load_b_cols<D>(Bl, rb + 8 * n, 8 * c, bl);
      mma3(out[c], ah, al, bh, bl);
    }
  }
}

#define PAM_TF32_CASE(D, REP)                   \
  if (d == D && rep == REP) {                   \
    const int rc = Launch<D, REP>::run(a, stream); \
    return rc ? rc : static_cast<int>(cudaGetLastError()); \
  }

// Dispatch of the forward / the backward over the built (head dim, group)
// pairs of attention_common.cuh; -1 for any other pair.
template <template <int, int> class Launch, typename Args>
int dispatch_fwd(int d, int rep, const Args& a, cudaStream_t stream) {
  PAM_ATTN_FWD_BUILT(PAM_TF32_CASE)
  return -1;
}

template <template <int, int> class Launch, typename Args>
int dispatch_bwd(int d, int rep, const Args& a, cudaStream_t stream) {
  PAM_ATTN_BWD_BUILT(PAM_TF32_CASE)
  return -1;
}
#undef PAM_TF32_CASE

}  // namespace tf32
}  // namespace pam
