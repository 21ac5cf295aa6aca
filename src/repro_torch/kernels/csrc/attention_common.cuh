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
// cores in fp32: these kernels serve bf16 at head dim 16 (the reduced
// configs); bf16 at the head dims of PAM_ATTN_WGMMA_FWD_DIMS / _BWD_DIMS
// below runs the wgmma kernels of attention_sm90.cuh instead, and fp32 at
// every built pair the 3xTF32 tensor-core kernels of attention_tf32.cuh.
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

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
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

// The built (head dim, GQA group) pairs, listed once each for the
// forward and the backward: the configs' (qwen3-0.6b 128/2, pam-llama-7b
// 128/1, minicpm-2b 64/1, internvl2-1b 64/7, hubert-xlarge 80/1,
// zamba2-7b's shared block 112/1, qwen3-14b 128/5, deepseek-67b 128/8,
// qwen3-moe-235b-a22b 128/16: every one trains on the card) and the reduced variants' (head dim 16 at
// groups 1 and 2). The two lists
// are equal. kernels/flash_attention.py's BUILT and BUILT_BWD hold the
// same lists (a CPU test compares them) and refuse any other pair before
// a launch; here another pair returns -1. Each pair is an fp32
// instantiation of the tf32x3 kernels (flash_attention_tf32x3.cu,
// flash_attention_bwd_tf32x3.cu) and, at a head dim whose bf16 kernel is
// not a wgmma one, a bf16 one of the CUDA-core kernels, so the lists are
// kept short.
#define PAM_ATTN_FWD_BUILT(X) \
  X(16, 1) X(16, 2) \
  X(64, 1) X(64, 7) \
  X(80, 1) \
  X(112, 1) \
  X(128, 1) X(128, 2) X(128, 5) X(128, 8) X(128, 16)
#define PAM_ATTN_BWD_BUILT(X) \
  X(16, 1) X(16, 2) \
  X(64, 1) X(64, 7) \
  X(80, 1) \
  X(112, 1) \
  X(128, 1) X(128, 2) X(128, 5) X(128, 8) X(128, 16)

// The head dims whose bf16 forward / backward run the wgmma kernels
// (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu) and so have no
// bf16 instantiation here. kernels/flash_attention.py's WGMMA_FWD_DIMS and
// WGMMA_BWD_DIMS hold the same lists (a CPU test compares them).
#define PAM_ATTN_WGMMA_FWD_DIMS(X) X(64) X(80) X(112) X(128)
#define PAM_ATTN_WGMMA_BWD_DIMS(X) X(64) X(80) X(112) X(128)

#define PAM_ATTN_IS_DIM(D) || d == D
constexpr bool wgmma_fwd_dim(int d) {
  return false PAM_ATTN_WGMMA_FWD_DIMS(PAM_ATTN_IS_DIM);
}
constexpr bool wgmma_bwd_dim(int d) {
  return false PAM_ATTN_WGMMA_BWD_DIMS(PAM_ATTN_IS_DIM);
}
#undef PAM_ATTN_IS_DIM

// One built pair of the CUDA-core kernels: Launch<T, D, REP>::run(args,
// stream) for dtype 1 (bf16) unless the wgmma kernels take bf16 at D
// (kWgmma); 0 or a CUDA error code, -1 for fp32 (the tf32x3 kernels),
// another dtype, or bf16 at a wgmma head dim.
template <template <typename, int, int> class Launch, int D, int REP,
          bool kWgmma, typename Args>
int launch_pair(int dtype, const Args& a, cudaStream_t stream) {
  if constexpr (kWgmma) {
    return -1;
  } else {
    if (dtype != 1) return -1;
    Launch<__nv_bfloat16, D, REP>::run(a, stream);
    return static_cast<int>(cudaGetLastError());
  }
}

#define PAM_ATTN_FWD_CASE(D, REP) \
  if (d == D && rep == REP)            \
    return launch_pair<Launch, D, REP, wgmma_fwd_dim(D)>(dtype, a, stream);
#define PAM_ATTN_BWD_CASE(D, REP) \
  if (d == D && rep == REP)            \
    return launch_pair<Launch, D, REP, wgmma_bwd_dim(D)>(dtype, a, stream);

// Dispatch of the forward / the backward over their built pairs; -1 for
// any other (dtype, head dim, group size).
template <template <typename, int, int> class Launch, typename Args>
int dispatch_fwd(int dtype, int d, int rep, const Args& a,
                 cudaStream_t stream) {
  PAM_ATTN_FWD_BUILT(PAM_ATTN_FWD_CASE)
  return -1;
}

template <template <typename, int, int> class Launch, typename Args>
int dispatch_bwd(int dtype, int d, int rep, const Args& a,
                 cudaStream_t stream) {
  PAM_ATTN_BWD_BUILT(PAM_ATTN_BWD_CASE)
  return -1;
}
#undef PAM_ATTN_FWD_CASE
#undef PAM_ATTN_BWD_CASE

// Key tiles a query tile starting at q0 must visit: all of them, or under
// the causal mask (kpos <= qpos from position 0) those starting at or
// before its last row.
__device__ __forceinline__ int key_tiles(int q0, int Sk, bool causal) {
  const int nk = (Sk + kTile - 1) / kTile;
  return causal ? min(nk, q0 / kTile + 1) : nk;
}

}  // namespace attn
}  // namespace pam
