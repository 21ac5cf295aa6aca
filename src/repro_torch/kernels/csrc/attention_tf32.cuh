// Shared device code of the fp32 full-sequence attention kernels on the
// tensor cores (flash_attention_tf32x3.cu: forward;
// flash_attention_bwd_tf32x3.cu: backward), on the 3xTF32 split and the
// fragment loaders of tf32_common.cuh; kernels/flash_attention.py::
// _fwd_tf32x3 / _bwd_tf32x3 model the split in plain PyTorch.
//
// Tiles. Every operand tile is row-major in shared memory with a row
// stride of D + 4 words, as a hi plane and a lo plane of tf32 bits (free
// of bank conflicts, tf32_common.cuh). A score tile that comes out of
// one product as C feeds the next as A in the permuted order, and the B
// operand of that product reads its rows 2t and 2t + 1 (load_b_cols).
// A CTA holds a stationary tile of 64 rows (16 a warp) for its life and
// walks moving tiles, double-buffered: the copy of tile j + 1 (cp.async,
// 16 bytes a thread, rows past the end zero-filled) runs while the warps
// multiply tile j. A thread splits
// exactly the chunks it copied, in place (raw fp32 into the hi plane,
// then hi and lo written), so a tile needs one barrier: after its split,
// which also frees the other buffer for the next copy.
#pragma once

#include <cstdint>

#include "attention_common.cuh"
#include "tf32_common.cuh"

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

// The fragment loaders of tf32_common.cuh at the row stride of head dim
// D: A rows [r0, r0 + 16), columns [k0, k0 + 8), natural order.
template <int D>
__device__ __forceinline__ void load_a(const uint32_t* p, int r0, int k0,
                                       uint32_t (&a)[4]) {
  frag_a<ld<D>()>(p, r0, k0, a);
}

// B fragment with the tile's rows as n: B[k][n] = tile[n0 + n][k0 + k]
// (the K of S = Q K^T).
template <int D>
__device__ __forceinline__ void load_b_rows(const uint32_t* p, int n0,
                                            int k0, uint32_t (&b)[2]) {
  frag_b_rows<ld<D>()>(p, n0, k0, b);
}

// B fragment with the tile's rows as k, in the score tiles' column order
// (the V of O = P V).
template <int D>
__device__ __forceinline__ void load_b_cols(const uint32_t* p, int k0,
                                            int n0, uint32_t (&b)[2]) {
  frag_b_cols<ld<D>()>(p, k0, n0, b);
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
