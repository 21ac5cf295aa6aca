// FlashAttention-2 backward: dQ, dK, dV of flash_attention.cu's forward.
//
// The TPU package has no counterpart: JAX cannot differentiate through
// the Pallas kernel (repro/kernels/flash_attention.py, pl.pallas_call at
// :122), so the reference trains only with its jnp attention. The port's
// train step runs the forward kernel on the card and needs this gradient.
//
// Given the forward's O and per-row log-sum-exp L, with S = scale Q K^T:
//   P = exp(S - L) on live entries (0 elsewhere), Delta = rowsum(dO * O),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
// Three kernels on one stream, all deterministic (no atomics):
//   1. delta: Delta per query row, one warp per row;
//   2. dkdv: one CUDA block per (64-row key tile, kv head, batch) loops
//      over the REP query heads of its group and their query tiles and
//      keeps dK, dV in registers, so GQA groups sum without races;
//   3. dq: one CUDA block per (64-row query tile, query head, batch) loops
//      over the key tiles and keeps dQ in registers.
// S and dP are recomputed in both 2 and 3, which is what keeps them free
// of atomics. Causal tiles above the diagonal are skipped in both.
//
// Bound on the H100: operations, as for the forward: five 64-wide products
// per tile pair (2.5x the forward's FLOPs). Products run on the CUDA cores
// in fp32. This backward serves bf16 at head dim 16 only, like
// flash_attention.cu; bf16 at head dims 64, 80, 112 and 128 runs
// flash_attention_bwd_sm90.cu (wgmma) and fp32 at every built pair
// flash_attention_bwd_tf32x3.cu (3xTF32), chosen by
// kernels/flash_attention.py::_variant.
#include "attention_common.cuh"

namespace pam {

struct BwdArgs {
  const void* q;   // (B, H, Sq, D)
  const void* k;   // (B, Hkv, Sk, D)
  const void* v;
  const void* o;   // (B, H, Sq, D)
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq) scratch
  void* dq;          // like q
  void* dk;          // like k
  void* dv;
  int B, H, Hkv, Sq, Sk, causal;
  float scale;
};

// Delta[row] = sum_c dO[row, c] * O[row, c], one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(attn::kThreads)
    flash_attention_delta_kernel(BwdArgs a) {
  const long rows = (long)a.B * a.H * a.Sq;
  const long row = (long)blockIdx.x * (attn::kThreads / 32) +
                   (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(a.o) + row * D;
  const T* g = static_cast<const T*>(a.dout) + row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s += attn::to_float(o[c]) * attn::to_float(g[c]);
  s = warp_sum(s);
  if (lane == 0) a.delta[row] = s;
}

// P and dS of one (query tile, key tile) pair into registers: entry
// (ty + 16 i, tx + 16 j). Needs Qs, dOs, Ks, Vs, and the tile's L and
// Delta in Ls / Ds, in shared memory.
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Ds, int q0, int k0, const BwdArgs& a,
    float (&p)[4][4], float (&ds)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const bool causal = a.causal != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = 0.f;
      ds[i][j] = 0.f;
    }
  attn::dot_rows<D>(Qs, Ks, p);    // S / scale
  attn::dot_rows<D>(dOs, Vs, ds);  // dP
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool live =
          qpos < a.Sq && kpos < a.Sk && (!causal || kpos <= qpos);
      const float pr = live ? expf(p[i][j] * a.scale - Ls[r]) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (ds[i][j] - Ds[r]);
    }
  }
}

__device__ __forceinline__ void load_rows(const float* src, int r0, int n,
                                          float* dst) {
  for (int t = threadIdx.x; t < attn::kTile; t += attn::kThreads)
    dst[t] = r0 + t < n ? src[r0 + t] : 0.f;
}

__device__ __forceinline__ void store_tile_regs(const float (&x)[4][4],
                                                float* P) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      P[(ty + 16 * i) * attn::kPLd + tx + 16 * j] = x[i][j];
}

template <typename T, int D, int NC>
__device__ __forceinline__ void write_rows(const float (&x)[4][NC], T* dst,
                                           int r0, int n, float mult) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dst[(long)r * D + tx + 16 * c] = attn::from_float<T>(x[i][c] * mult);
  }
}

template <int D>
constexpr int bwd_smem_bytes() {
  return (4 * attn::kTile * (D + 1) + attn::kTile * attn::kPLd +
          2 * attn::kTile) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D, int REP>
__global__ void __launch_bounds__(attn::kThreads)
    flash_attention_dkdv_kernel(BwdArgs a) {
  using namespace attn;
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;  // kTile x kPLd
  float* Ls = Ps + kTile * kPLd;
  float* Ds = Ls + kTile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const long khead = (long)b * a.Hkv + hk;
  load_tile<T, D>(static_cast<const T*>(a.k) + khead * a.Sk * D, k0, a.Sk,
                  Ks);
  load_tile<T, D>(static_cast<const T*>(a.v) + khead * a.Sk * D, k0, a.Sk,
                  Vs);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  const int nq = (a.Sq + kTile - 1) / kTile;
  // causal: query tiles whose last row reaches this key tile
  const int iq0 = a.causal ? blockIdx.x : 0;
  for (int r = 0; r < REP; ++r) {
    const long qhead = (long)b * a.H + hk * REP + r;
    const T* q = static_cast<const T*>(a.q) + qhead * a.Sq * D;
    const T* g = static_cast<const T*>(a.dout) + qhead * a.Sq * D;
    const float* lse = a.lse + qhead * a.Sq;
    const float* delta = a.delta + qhead * a.Sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();  // the previous tile's Qs / dOs / Ps are consumed
      load_tile<T, D>(q, q0, a.Sq, Qs);
      load_tile<T, D>(g, q0, a.Sq, dOs);
      load_rows(lse, q0, a.Sq, Ls);
      load_rows(delta, q0, a.Sq, Ds);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs_and_dscores<D>(Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, a, p, ds);
      store_tile_regs(p, Ps);
      __syncthreads();
      mul_tile<D, true>(Ps, dOs, dv);  // dV += P^T dO
      __syncthreads();
      store_tile_regs(ds, Ps);
      __syncthreads();
      mul_tile<D, true>(Ps, Qs, dk);   // dK += dS^T Q
    }
  }
  write_rows<T, D, NC>(dk, static_cast<T*>(a.dk) + khead * a.Sk * D, k0,
                       a.Sk, a.scale);
  write_rows<T, D, NC>(dv, static_cast<T*>(a.dv) + khead * a.Sk * D, k0,
                       a.Sk, 1.f);
}

template <typename T, int D, int REP>
__global__ void __launch_bounds__(attn::kThreads)
    flash_attention_dq_kernel(BwdArgs a) {
  using namespace attn;
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;   // kTile x kPLd
  float* Ls = Ps + kTile * kPLd;
  float* Ds = Ls + kTile;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long qhead = (long)b * a.H + h;
  const long khead = (long)b * a.Hkv + h / REP;
  const T* k = static_cast<const T*>(a.k) + khead * a.Sk * D;
  const T* v = static_cast<const T*>(a.v) + khead * a.Sk * D;
  load_tile<T, D>(static_cast<const T*>(a.q) + qhead * a.Sq * D, q0, a.Sq,
                  Qs);
  load_tile<T, D>(static_cast<const T*>(a.dout) + qhead * a.Sq * D, q0, a.Sq,
                  dOs);
  load_rows(a.lse + qhead * a.Sq, q0, a.Sq, Ls);
  load_rows(a.delta + qhead * a.Sq, q0, a.Sq, Ds);

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  const int nk = key_tiles(q0, a.Sk, a.causal != 0);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();  // the previous tile's Ks / Ps are consumed
    load_tile<T, D>(k, k0, a.Sk, Ks);
    load_tile<T, D>(v, k0, a.Sk, Vs);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<D>(Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, a, p, ds);
    store_tile_regs(ds, Ps);
    __syncthreads();
    mul_tile<D, false>(Ps, Ks, dq);    // dQ += dS K
  }
  write_rows<T, D, NC>(dq, static_cast<T*>(a.dq) + qhead * a.Sq * D, q0,
                       a.Sq, a.scale);
}

template <typename T, int D, int REP>
struct LaunchBwd {
  static void run(const BwdArgs& a, cudaStream_t stream) {
    constexpr int smem = bwd_smem_bytes<D>();
    const int rows_per_block = attn::kThreads / 32;
    const long rows = (long)a.B * a.H * a.Sq;
    flash_attention_delta_kernel<T, D>
        <<<static_cast<unsigned>((rows + rows_per_block - 1) /
                                 rows_per_block),
           attn::kThreads, 0, stream>>>(a);
    auto dkdv = flash_attention_dkdv_kernel<T, D, REP>;
    cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const dim3 gk((a.Sk + attn::kTile - 1) / attn::kTile, a.Hkv, a.B);
    dkdv<<<gk, attn::kThreads, smem, stream>>>(a);
    auto dq = flash_attention_dq_kernel<T, D, REP>;
    cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const dim3 gq((a.Sq + attn::kTile - 1) / attn::kTile, a.H, a.B);
    dq<<<gq, attn::kThreads, smem, stream>>>(a);
  }
};

}  // namespace pam

// dtype: 1 = bfloat16 (q, k, v, o, dout and the gradients). delta is an
// fp32 (B, H, Sq) scratch buffer. Returns 0, a CUDA error code from
// cudaGetLastError(), or -1 for an unsupported (dtype, D, H / Hkv): fp32
// (flash_attention_bwd_tf32x3.cu), and bf16 at a head dim of
// PAM_ATTN_WGMMA_BWD_DIMS (flash_attention_bwd_sm90.cu) among them.
extern "C" int pam_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int B, int H, int Hkv,
                                       int Sq, int Sk, int D, int causal,
                                       float scale, int dtype, void* stream) {
  pam::BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return pam::attn::dispatch_bwd<pam::LaunchBwd>(
      dtype, D, H / Hkv, a, static_cast<cudaStream_t>(stream));
}
