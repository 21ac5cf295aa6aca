// FlashAttention-2 forward, causal or bidirectional, GQA without
// repeating K/V.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_attn_kernel
// (wrapper flash_attention, pl.pallas_call at :122). The TPU kernel
// carries (m, l, acc) across a sequential kv-block grid axis; here one
// CUDA block per (64-row query tile, query head, batch) walks the key
// tiles in a loop with the same fp32 online softmax in registers, reads
// the kv head h / REP (the reference's _kv_row index map), masks
// kpos < Sk and, when causal, kpos <= qpos with the reference's -1e30
// sentinel, and finalises with its l_safe (l > 0 ? l : 1). Besides O (in
// the input dtype) it writes the per-row log-sum-exp m + log(l_safe) in
// fp32, which the backward (flash_attention_bwd.cu) reads. Query rows past
// Sq are computed on zero rows and never written.
//
// Bound on the H100: operations. This kernel runs the products on the
// CUDA cores in fp32 (exact to the plain version up to the order of sums),
// with causal tiles past the diagonal skipped. It serves fp32 operands
// (the fp32 train_parity path: a tensor-core product would be TF32) and
// head dim 16 (the reduced configs), bound by their FLOPs over the 67
// TFLOP/s fp32 peak. bf16 with head dim 128, the full-width train path,
// runs flash_attention_sm90.cu (wgmma on TMA-staged bf16 tiles) instead;
// kernels/flash_attention.py::_variant chooses.
#include "attention_common.cuh"

namespace pam {

struct FwdArgs {
  const void* q;  // (B, H, Sq, D)
  const void* k;  // (B, Hkv, Sk, D)
  const void* v;
  void* o;        // (B, H, Sq, D), the input dtype
  float* lse;     // (B, H, Sq)
  int B, H, Hkv, Sq, Sk, causal;
  float scale;
};

template <typename T, int D, int REP>
__global__ void __launch_bounds__(attn::kThreads)
    flash_attention_fwd_kernel(FwdArgs a) {
  using namespace attn;
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // kTile x kPLd

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long qhead = (long)b * a.H + h;
  const long khead = (long)b * a.Hkv + h / REP;
  const T* q = static_cast<const T*>(a.q) + qhead * a.Sq * D;
  const T* k = static_cast<const T*>(a.k) + khead * a.Sk * D;
  const T* v = static_cast<const T*>(a.v) + khead * a.Sk * D;
  const bool causal = a.causal != 0;

  load_tile<T, D>(q, q0, a.Sq, Qs);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int nk = key_tiles(q0, a.Sk, causal);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    load_tile<T, D>(k, k0, a.Sk, Ks);
    load_tile<T, D>(v, k0, a.Sk, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    dot_rows<D>(Qs, Ks, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < a.Sk && (!causal || kpos <= qpos);
        s[i][j] = live[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - mn) : 0.f;
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mul_tile<D, false>(Ps, Vs, acc);
  }

  T* o = static_cast<T*>(a.o) + qhead * a.Sq * D;
  float* lse = a.lse + qhead * a.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[(long)qpos * D + tx + 16 * c] = from_float<T>(acc[i][c] * inv);
    if (tx == 0) lse[qpos] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, int REP>
struct LaunchFwd {
  static void run(const FwdArgs& a, cudaStream_t stream) {
    constexpr int LD = D + 1;
    const int smem = (3 * attn::kTile * LD + attn::kTile * attn::kPLd) *
                     static_cast<int>(sizeof(float));
    auto kernel = flash_attention_fwd_kernel<T, D, REP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const dim3 grid((a.Sq + attn::kTile - 1) / attn::kTile, a.H, a.B);
    kernel<<<grid, attn::kThreads, smem, stream>>>(a);
  }
};

}  // namespace pam

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). Returns 0, a CUDA
// error code from cudaGetLastError(), or -1 for an unsupported
// (dtype, D, H / Hkv), bf16 with D = 128 among them (flash_attention_sm90.cu).
extern "C" int pam_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int H, int Hkv, int Sq, int Sk,
                                       int D, int causal, float scale,
                                       int dtype, void* stream) {
  pam::FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return pam::attn::dispatch_cuda_core<pam::LaunchFwd>(
      dtype, D, H / Hkv, a, static_cast<cudaStream_t>(stream));
}
