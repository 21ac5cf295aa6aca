// Shared device code of the split-KV decode kernels (flash_decode.cu,
// flash_decode_paged.cu): one CUDA block attends the REP query heads that
// share one kv head over a run of tokens and writes the partial triple
// (O, m, l) per query head, exactly the quantity the TPU kernels emit.
//
// Work split inside a block: each warp takes U consecutive tokens per
// iteration (tokens t = warp*U + j*NW*U ...). A lane holds EPL = D/32
// contiguous elements of a row (one 8- or 16-byte load per row for
// bf16/fp32 at D=128; at D=16 lanes 0..15 hold one element each), so a
// warp reads a K or V row as one coalesced transaction. QK^T is a lane-local dot plus a warp shuffle reduction;
// every warp keeps a running (m, l, O) online softmax in registers, and
// the warps merge through shared memory at the end. Tokens that do not
// participate are never loaded: the kernel reads only live rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pam {

// Dead-partition sentinel of the TPU kernels (flash_decode.py NEG_INF):
// a split or block with no live token emits (O=0, m=-1e30, l=0).
constexpr float kNegInf = -1e30f;
constexpr int kTokensPerWarp = 4;  // U: rows in flight per warp

template <int D>
struct Layout {
  static constexpr int EPL = D >= 32 ? D / 32 : 1;  // elements per lane
};

// EPL is 1 (D=16) or 4 (D=128), the head dims the wrappers accept.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[EPL]) {
  static_assert(EPL == 1 || EPL == 4, "head dim 16 or 128");
  if constexpr (EPL == 1) {
    if constexpr (std::is_same<T, float>::value) {
      out[0] = p[0];
    } else {
      out[0] = __bfloat162float(p[0]);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Shared-memory scratch of one block for the cross-warp merge.
template <int D, int REP, int NW>
struct MergeSmem {
  float m[NW][REP];
  float l[NW][REP];
  float o[NW][REP][D];
};

// Attend REP query heads (rows of q, fp32, D apart) over n tokens whose K
// and V rows sit at k + t*stride and v + t*stride. Token t participates iff
// t < live_limit and (mask == nullptr or mask[t] != 0). Writes, for head r,
// O to o_out[r*o_stride .. +D) and m, l to m_out[r*ml_stride],
// l_out[r*ml_stride]. Every thread of the block must call it.
template <typename T, int D, int REP, int NW>
__device__ __forceinline__ void attend_tokens(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, long stride, int n, int live_limit,
    const int8_t* __restrict__ mask, float scale, float* __restrict__ o_out,
    long o_stride, float* __restrict__ m_out, float* __restrict__ l_out,
    long ml_stride, MergeSmem<D, REP, NW>& sm) {
  constexpr int EPL = Layout<D>::EPL;
  constexpr int U = kTokensPerWarp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has = lane * EPL < D;  // D=16: only lanes 0..15 hold data
  const int off = has ? lane * EPL : 0;

  float qr[REP][EPL];
  float acc[REP][EPL];
  float mr[REP];
  float lr[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[r][e] = has ? q[r * D + off + e] : 0.f;
      acc[r][e] = 0.f;
    }
    mr[r] = kNegInf;
    lr[r] = 0.f;
  }

  const int limit = min(n, live_limit);
  for (int t0 = warp * U; t0 < limit; t0 += NW * U) {
    float kf[U][EPL];
    float vf[U][EPL];
    bool lv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      lv[u] = t < limit && (mask == nullptr || mask[t] != 0);
      if (lv[u] && has) {
        load_row<T, EPL>(k + t * stride + off, kf[u]);
        load_row<T, EPL>(v + t * stride + off, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kf[u][e] = 0.f;
          vf[u][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!lv[u]) continue;  // uniform across the warp
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[r][e] * kf[u][e];
        s = warp_sum(s) * scale;
        const float mn = fmaxf(mr[r], s);
        const float c = expf(mr[r] - mn);
        const float p = expf(s - mn);
        lr[r] = lr[r] * c + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * c + p * vf[u][e];
        mr[r] = mn;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm.m[warp][r] = mr[r];
      sm.l[warp][r] = lr[r];
    }
  }
  if (has) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm.o[warp][r][off + e] = acc[r][e];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < REP * D; idx += blockDim.x) {
    const int r = idx / D;
    const int e = idx - r * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm.m[w][r]);
    float o = 0.f;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(sm.m[w][r] - mx);  // all dead: wt=1, o=l=0
      o += wt * sm.o[w][r][e];
      l += wt * sm.l[w][r];
    }
    o_out[r * o_stride + e] = o;
    if (e == 0) {
      m_out[r * ml_stride] = mx;
      l_out[r * ml_stride] = l;
    }
  }
}

// The identity partial (O=0, m=-1e30, l=0) for REP heads.
template <int D, int REP>
__device__ __forceinline__ void write_identity(float* __restrict__ o_out,
                                               long o_stride,
                                               float* __restrict__ m_out,
                                               float* __restrict__ l_out,
                                               long ml_stride) {
  for (int idx = threadIdx.x; idx < REP * D; idx += blockDim.x) {
    const int r = idx / D;
    const int e = idx - r * D;
    o_out[r * o_stride + e] = 0.f;
    if (e == 0) {
      m_out[r * ml_stride] = kNegInf;
      l_out[r * ml_stride] = 0.f;
    }
  }
}

// Dispatch over the built (dtype, head dim, group size) triples: the
// dims and GQA groups of the port's configs (qwen3-0.6b: 128/2,
// pam-llama-7b: 128/1, their reduced variants: 16/2). The Python wrappers
// check the same sets before launching. Launch must be a
// functor template: Launch<T, D, REP>::run(args, stream).
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

template <template <typename, int, int> class Launch, typename Args>
int dispatch(int dtype, int d, int rep, const Args& a, cudaStream_t stream) {
  switch (dtype) {
    case 0: return dispatch_d<Launch, float>(d, rep, a, stream);
    case 1: return dispatch_d<Launch, __nv_bfloat16>(d, rep, a, stream);
    default: return -1;
  }
}

}  // namespace pam
