// Shared device code of the SSD scan kernels (ssd_scan.cu: forward;
// ssd_scan_bwd.cu: backward).
//
// A CUDA block of 256 threads works on one chunk of up to kQ = 128 tokens of
// one (batch, head). Products are block-wide: thread (ty, tx) = (tid / 16, tid
// % 16) owns output rows ty + 16 i and columns tx + 16 j, so a row's 16 owners
// are one half of a warp and row sums are 4-step shuffles. Operands live in
// shared memory as fp32 with odd row strides (kQ + 1, kP + 1, kNS + 1, N + 1),
// so a half-warp reading one column of 16 rows touches 16 banks. The kernels
// are templated on d_state N, built at N = 128 (mamba2-780m) and 64
// (zamba2-7b); the head dim is P = 64. All products run on the CUDA cores in
// fp32 (no tensor cores yet). The chunk length Q is a runtime value <= kQ; rows
// at or past Q, and tokens at or past the sequence length, are zero with
// dt = 0 (the identity), as the TPU kernel masks them.
#pragma once

#include <cuda_runtime.h>

namespace pam {
namespace ssd {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kQ = 128;        // rows of a chunk tile (the largest chunk)
constexpr int kP = 64;         // head dim
constexpr int kNS = 32;        // columns of a d_state slice
constexpr int kLdQ = kQ + 1;
constexpr int kLdP = kP + 1;
constexpr int kLdS = kNS + 1;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) * Bm(k, tx + 16 j): the
// thread's share of a block-wide (16 RI x K) (K x 16 CJ) product whose
// operands are read through the accessors A and Bm.
template <int RI, int CJ, typename FA, typename FB>
__device__ __forceinline__ void mm(int K, FA A, FB Bm, float (&acc)[RI][CJ]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = Bm(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int RI, int CJ>
__device__ __forceinline__ void zero(float (&acc)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 lanes of a half-warp (the owners of one row).
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Sum of v over the block, returned to every thread (fixed order: the
// result is deterministic). tmp holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* tmp) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  __syncthreads();  // tmp may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += tmp[w];
  return total;
}

// Rows [0, kQ) of a row-major matrix with row stride `stride` (elements),
// COLS columns, into shared memory as fp32 with row stride ld; rows at or
// past `valid` are zero.
template <int COLS, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          long long stride, int valid,
                                          float* __restrict__ dst, int ld) {
  for (int idx = threadIdx.x; idx < kQ * COLS; idx += kThreads) {
    const int r = idx / COLS;
    const int c = idx - r * COLS;
    dst[r * ld + c] =
        r < valid ? to_float(src[(long long)r * stride + c]) : 0.f;
  }
}

// The chunk's decay terms: dv[t] = dt (0 at or past `valid`), sv[t] =
// s_t = sum_{u <= t} dt_u a (in-chunk inclusive prefix sum), ev[t] =
// exp(s_t), wv[t] = exp(s_{Q-1} - s_t) dt_t. dt points at the chunk's
// first token of this (batch, head); its tokens are `stride` apart.
// Ends with a barrier; tmp holds 8 floats.
__device__ __forceinline__ void chunk_decay(const float* __restrict__ dt,
                                            long long stride, int valid,
                                            int Q, float a, float* sv,
                                            float* ev, float* wv, float* dv,
                                            float* tmp) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  float x = 0.f;
  if (t < kQ) {  // warps 0-3: a warp-shuffle scan, then the warp offsets
    const float d = t < valid ? dt[(long long)t * stride] : 0.f;
    dv[t] = d;
    x = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) tmp[t >> 5] = x;
  }
  __syncthreads();
  if (t < kQ) {
    float off = 0.f;
    for (int w = 0; w < (t >> 5); ++w) off += tmp[w];
    sv[t] = x + off;
  }
  __syncthreads();
  const float last = sv[Q - 1];
  if (t < kQ) {
    ev[t] = expf(sv[t]);
    wv[t] = expf(last - sv[t]) * dv[t];
  }
  __syncthreads();
}

// exp(s_t - s_u) for u <= t < Q, else 0; masked before the exp (gaps
// above the diagonal are positive and overflow).
__device__ __forceinline__ float decay(const float* sv, int t, int u, int Q) {
  return (u <= t && t < Q) ? expf(sv[t] - sv[u]) : 0.f;
}

// The built d_states (kernels/ssd_scan.py's SUPPORTED_NP, at P = 64).
#define PAM_SSD_BUILT_N(X) X(128) X(64)

// fp32 operands only, at the built (N, P): bf16 runs on the wgmma kernels
// (ssd_scan_sm90.cu, ssd_scan_bwd_sm90.cu). -1 for another (N, P).
template <template <typename, int> class Launch, typename Args>
int dispatch(int N, int P, const Args& a, cudaStream_t stream) {
  if (P != kP) return -1;
#define PAM_SSD_CASE(NS)              \
  if (N == NS) {                      \
    Launch<float, NS>::run(a, stream); \
    return static_cast<int>(cudaGetLastError()); \
  }
  PAM_SSD_BUILT_N(PAM_SSD_CASE)
#undef PAM_SSD_CASE
  return -1;
}

}  // namespace ssd
}  // namespace pam
