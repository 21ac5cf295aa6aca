// Shared device code of the full-sequence attention kernels
// (flash_attention.cu: forward; flash_attention_bwd.cu: backward).
//
// Tiling: a CUDA block of 256 threads works on 64 query rows x 64 key
// rows at a time. Thread (ty, tx) = (tid / 16, tid % 16) owns the score
// entries of query rows ty + 16 i and key columns tx + 16 j (i, j < 4),
// and the output entries of rows ty + 16 i and head-dim columns tx + 16 c
// (c < D / 16). A row's 16 owners are one half of a warp, so row maxima
// and sums are 4-step shuffles. Tiles live in shared memory as fp32 with a
// padded row stride (D + 1), so a half-warp reading one column of 16
// different rows touches 16 different banks. All products run on the CUDA
// cores in fp32: these kernels serve fp32 operands (whose tensor-core
// product would be TF32) and head dim 16 (the reduced configs); bf16 with
// head dim 128 runs the wgmma kernels of attention_sm90.cuh.
#pragma once

#include "decode_common.cuh"

namespace pam {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

namespace attn {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPLd = kTile + 1;  // padded stride of the 64 x 64 score tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [r0, r0 + 64) of a row-major (n, D) matrix into shared memory as
// fp32 with stride D + 1; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int n, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    float x = 0.f;
    if (r0 + r < n) x = to_float(src[(long)(r0 + r) * D + c]);
    dst[r * (D + 1) + c] = x;
  }
}

// Max / sum over the 16 lanes of a half-warp (the owners of one row).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// acc[i][j] += sum_kk A[ty + 16 i][kk] * B[tx + 16 j][kk] over kk < D:
// the 4 x 4 share of a 64 x 64 product A B^T of two padded tiles.
template <int D>
__device__ __forceinline__ void dot_rows(const float* __restrict__ A,
                                         const float* __restrict__ Bm,
                                         float (&acc)[4][4]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * LD + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// out[i][c] += sum_r P(row i, r) * M[r][tx + 16 c] over the 64 rows r of
// a padded (64, D) tile M, where P(row i, r) = P[(ty + 16 i) * kPLd + r]
// when `transposed` is false and P[r * kPLd + ty + 16 i] when it is true.
template <int D, bool transposed>
__device__ __forceinline__ void mul_tile(const float* __restrict__ P,
                                         const float* __restrict__ M,
                                         float (&out)[4][D / 16]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float p[4], m[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = transposed ? P[r * kPLd + ty + 16 * i]
                        : P[(ty + 16 * i) * kPLd + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) m[c] = M[r * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) out[i][c] += p[i] * m[c];
  }
}

// Launch over the GQA group sizes built (1 and 2) and the head dims (16
// and 128): Launch<T, D, REP>::run(args, stream); 0 or a CUDA error code.
template <template <typename, int, int> class Launch, typename T, int D,
          typename Args>
int dispatch_rep(int rep, const Args& a, cudaStream_t stream) {
  switch (rep) {
    case 1: Launch<T, D, 1>::run(a, stream); break;
    case 2: Launch<T, D, 2>::run(a, stream); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <template <typename, int, int> class Launch, typename T,
          typename Args>
int dispatch_d(int d, int rep, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return dispatch_rep<Launch, T, 16>(rep, a, stream);
    case 128: return dispatch_rep<Launch, T, 128>(rep, a, stream);
    default: return -1;
  }
}

// Dispatch over the (dtype, head dim, group size) triples these kernels
// serve: fp32 with head dim 16 or 128, and bf16 with head dim 16. bf16 with
// head dim 128 runs the wgmma kernels (flash_attention_sm90.cu,
// flash_attention_bwd_sm90.cu) and is not built here, so each triple has
// one kernel; -1 for any other triple.
template <template <typename, int, int> class Launch, typename Args>
int dispatch_cuda_core(int dtype, int d, int rep, const Args& a,
                       cudaStream_t stream) {
  if (dtype == 0) return dispatch_d<Launch, float>(d, rep, a, stream);
  if (dtype == 1 && d == 16)
    return dispatch_rep<Launch, __nv_bfloat16, 16>(rep, a, stream);
  return -1;
}

// Key tiles a query tile starting at q0 must visit: all of them, or under
// the causal mask (kpos <= qpos from position 0) those starting at or
// before its last row.
__device__ __forceinline__ int key_tiles(int q0, int Sk, bool causal) {
  const int nk = (Sk + kTile - 1) / kTile;
  return causal ? min(nk, q0 / kTile + 1) : nk;
}

}  // namespace attn
}  // namespace pam
