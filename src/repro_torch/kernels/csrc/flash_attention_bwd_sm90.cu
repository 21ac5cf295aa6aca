// FlashAttention backward for Hopper's tensor cores: dQ, dK, dV of
// flash_attention_sm90.cu's forward (bf16, head dim 128, GQA groups of 1
// or 2, causal or bidirectional).
//
// The TPU package has no counterpart: JAX cannot differentiate through
// the Pallas kernel (repro/kernels/flash_attention.py::_attn_kernel, :31,
// pl.pallas_call at :122), so the reference trains only with its jnp
// attention. fp32 and head dim 16 keep flash_attention_bwd.cu (CUDA
// cores); kernels/flash_attention.py::_variant picks one of the two.
//
// Given the forward's O and natural-log LSE L, with S = scale Q K^T:
//   P = exp(S - L) on live entries (0 elsewhere), Delta = rowsum(dO * O),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
// Three kernels on one stream, all deterministic (no atomics):
//   1. prep: Delta per query row and L * log2(e), both fp32 in buffers
//      padded to a multiple of 128 rows (Delta 0 and L +inf past Sq, so a
//      padded query row gets P = 0 and dS = 0 with no mask);
//   2. dkdv: one CTA per (128-key tile, kv head, batch), two warpgroups
//      of 64 keys. K and V stay in shared memory; the CTA walks the REP
//      query heads of its group and their 64-row query tiles (from the
//      diagonal on when causal), Q, dO, L and Delta staged two deep by
//      TMA. Per query tile: S^T = K Q^T and dP^T = V dO^T (wgmma
//      m64n64k16, both operands K-major in shared memory), P^T = exp2(S^T
//      scale log2(e) - L log2(e)) masked, dS^T = P^T (dP^T - Delta), then
//      dV += P^T dO and dK += dS^T Q (m64n128k16 with P^T and dS^T as bf16
//      register A operands, dO and Q MN-major). dK and dV sum in fp32
//      registers over the whole group and are scaled and rounded once,
//      which is how the GQA sum stays free of races;
//   3. dq: one CTA per (128-row query tile, query head, batch), heaviest
//      causal tiles first; per 64-key tile S = Q K^T, dP = dO V^T, P, dS,
//      then dQ += dS K (K MN-major), dQ in fp32 registers.
// In 2 and 3 thread 0 refills a stage after a __syncthreads of both
// warpgroups.
// S and dP are computed in both 2 and 3: seven products per (query tile,
// key tile) pair where five are the minimum. That keeps the backward
// deterministic (dQ would otherwise be summed across CTAs with atomics)
// and costs 1.4x the FLOPs of the bound.
//
// Bound on the H100: operations. At the training shape (B 4, H 16, S 2048,
// d 128, causal) the five products are 1.7e11 FLOPs (0.174 ms at 989
// TFLOP/s bf16) against 0.20 GB moved (0.060 ms at 3.35 TB/s).
// Shared memory: dkdv K, V 64 KiB + Q, dO 2 stages x 32 KiB + L, Delta;
// dq Q, dO 64 KiB + K, V 2 stages x 32 KiB.
#include "attention_sm90.cuh"

namespace pam {

struct BwdSm90Args {
  const __nv_bfloat16* o;     // (B, H, Sq, 128)
  const __nv_bfloat16* dout;  // (B, H, Sq, 128)
  const float* lse;           // (B, H, Sq), natural log
  float* delta;               // (B, H, Sq_pad) scratch
  float* lse2;                // (B, H, Sq_pad) scratch: lse * log2(e)
  __nv_bfloat16* dq;          // like q
  __nv_bfloat16* dk;          // like k
  __nv_bfloat16* dv;          // like v
  int BH, H, Hkv, Sq, Sk, Sq_pad, causal;
  float scale, scale_log2;
};

namespace bwd90 {
constexpr int kPad = 128;   // row padding of delta / lse2
constexpr int kKN = 128;    // dkdv: keys per CTA (2 warpgroups x 64)
constexpr int kKQ = 64;     // dkdv: query rows per tile
constexpr int kQM = 128;    // dq: query rows per CTA
constexpr int kQN = 64;     // dq: keys per tile
constexpr int kRowBytes = sm90::kD * 2;
constexpr int kDkdvSmem =
    (2 * kKN + 4 * kKQ) * kRowBytes + 4 * kKQ * 4 + 8 * 8;
constexpr int kDqSmem = (2 * kQM + 4 * kQN) * kRowBytes + 8 * 8;
}  // namespace bwd90

// Delta = rowsum(dO * O) and lse * log2(e), one warp per padded row.
__global__ void __launch_bounds__(256)
    flash_attention_prep_sm90_kernel(BwdSm90Args a) {
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= (long)a.BH * a.Sq_pad) return;
  const int lane = threadIdx.x & 31;
  const long bh = row / a.Sq_pad;
  const int i = static_cast<int>(row - bh * a.Sq_pad);
  float s = 0.f;
  if (i < a.Sq) {
    const long off = (bh * a.Sq + i) * sm90::kD + lane * 4;
    const uint2 ro = *reinterpret_cast<const uint2*>(a.o + off);
    const uint2 rg = *reinterpret_cast<const uint2*>(a.dout + off);
    const float2 o0 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ro.x));
    const float2 o1 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ro.y));
    const float2 g0 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rg.x));
    const float2 g1 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rg.y));
    s = o0.x * g0.x + o0.y * g0.y + o1.x * g1.x + o1.y * g1.y;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    a.delta[row] = s;
    a.lse2[row] = i < a.Sq ? a.lse[bh * a.Sq + i] * sm90::kLog2e
                           : __int_as_float(0x7f800000);  // +inf
  }
}

template <int REP>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_attention_dkdv_sm90_kernel(
        const __grid_constant__ CUtensorMap tmQ,   // box 64 rows
        const __grid_constant__ CUtensorMap tmdO,  // box 64 rows
        const __grid_constant__ CUtensorMap tmK,   // box 128 rows
        const __grid_constant__ CUtensorMap tmV,   // box 128 rows
        BwdSm90Args a) {
  using namespace sm90;
  using namespace bwd90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // (kKN, 128)
  bf16* Vs = Ks + kKN * kD;
  bf16* Qs = Vs + kKN * kD;                  // 2 stages of (kKQ, 128)
  bf16* dOs = Qs + 2 * kKQ * kD;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kKQ * kD);  // [2][kKQ]
  float* Ds = Ls + 2 * kKQ;                                  // [2][kKQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ds + 2 * kKQ);
  uint64_t* barKV = bars;
  uint64_t* barQ = bars + 1;  // [2]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int kvh = blockIdx.x;  // b * Hkv + hk
  const int b = kvh / a.Hkv;
  const int hk = kvh - b * a.Hkv;
  const int k0 = blockIdx.y * kKN;  // causal: the heaviest tile first
  const int nq = (a.Sq + kKQ - 1) / kKQ;
  const int iq0 = a.causal ? min(nq, k0 / kKQ) : 0;
  const int per_head = nq - iq0;
  const int total = REP * per_head;

  // (query head, first row) of step i of the walk
  auto step = [&](int i, int& qh, int& q0) {
    const int r = i / per_head;
    qh = b * a.H + hk * REP + r;
    q0 = (iq0 + i - r * per_head) * kKQ;
  };
  auto load_q = [&](int i) {
    int qh, q0;
    step(i, qh, q0);
    const int s = i & 1;
    bar_expect(barQ + s, 2 * kKQ * kRowBytes + 2 * kKQ * 4);
    tma_tile(Qs + s * kKQ * kD, &tmQ, barQ + s, kKQ, q0, qh);
    tma_tile(dOs + s * kKQ * kD, &tmdO, barQ + s, kKQ, q0, qh);
    bulk_load(Ls + s * kKQ, a.lse2 + (long)qh * a.Sq_pad + q0, kKQ * 4,
              barQ + s);
    bulk_load(Ds + s * kKQ, a.delta + (long)qh * a.Sq_pad + q0, kKQ * 4,
              barQ + s);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) bar_init(bars + i, 1);
    bar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(barKV, 2 * kKN * kRowBytes);
    tma_tile(Ks, &tmK, barKV, kKN, k0, kvh);
    tma_tile(Vs, &tmV, barKV, kKN, k0, kvh);
    for (int i = 0; i < 2 && i < total; ++i) load_q(i);
  }

  float dk[64], dv[64];
  zero(dk);
  zero(dv);
  const int key_lo = k0 + wg * 64;  // first key of this warpgroup
  bar_wait(barKV, 0);

  for (int i = 0; i < total; ++i) {
    const int st = i & 1;
    int qh, q0;
    step(i, qh, q0);
    const bf16* Qt = Qs + st * kKQ * kD;
    const bf16* dOt = dOs + st * kKQ * kD;
    const float* Lt = Ls + st * kKQ;
    const float* Dt = Ds + st * kKQ;
    bar_wait(barQ + st, (i >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 query rows each)
    float sT[32], dpT[32];
    zero(sT);
    zero(dpT);
    fence_regs(sT);
    fence_regs(dpT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(sT, desc_k(Ks, kKN, wg * 64, kk), desc_k(Qt, kKQ, 0, kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(dpT, desc_k(Vs, kKN, wg * 64, kk),
                   desc_k(dOt, kKQ, 0, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sT);

    // P^T; a key after a query row (causal) gets 0. Keys past Sk need no
    // mask: they only reach rows of dK and dV that are never written.
    const bool masked = a.causal && key_lo + 63 > q0;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int c = frag_col(t, v);
      float p = exp2f(sT[v] * a.scale_log2 - Lt[c]);
      if (masked && key_lo + frag_row(t, v) > q0 + c) p = 0.f;
      sT[v] = p;
    }
    uint32_t pa[16];
    pack_a(sT, pa);

    // dV += P^T dO
    fence_regs(pa);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128_mn(dv, pa + 4 * kk, desc_mn(dOt, kKQ, kk));
    wgmma_commit();

    // dS^T = P^T (dP^T - Delta)
    wgmma_wait<1>();
    fence_regs(dpT);
#pragma unroll
    for (int v = 0; v < 32; ++v) dpT[v] = sT[v] * (dpT[v] - Dt[frag_col(t, v)]);
    uint32_t dsa[16];
    pack_a(dpT, dsa);

    // dK += dS^T Q
    fence_regs(dsa);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128_mn(dk, dsa + 4 * kk, desc_mn(Qt, kKQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);

    __syncthreads();  // both warpgroups are done with stage st
    if (tid == 0 && i + 2 < total) load_q(i + 2);
  }

  store_rows(dk, a.dk + (long)kvh * a.Sk * kD, key_lo, a.Sk, a.scale);
  store_rows(dv, a.dv + (long)kvh * a.Sk * kD, key_lo, a.Sk, 1.f);
}

template <int REP>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_attention_dq_sm90_kernel(
        const __grid_constant__ CUtensorMap tmQ,   // box 128 rows
        const __grid_constant__ CUtensorMap tmdO,  // box 128 rows
        const __grid_constant__ CUtensorMap tmK,   // box 64 rows
        const __grid_constant__ CUtensorMap tmV,   // box 64 rows
        BwdSm90Args a) {
  using namespace sm90;
  using namespace bwd90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // (kQM, 128)
  bf16* dOs = Qs + kQM * kD;
  bf16* Ks = dOs + kQM * kD;                 // 2 stages of (kQN, 128)
  bf16* Vs = Ks + 2 * kQN * kD;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + 2 * kQN * kD);
  uint64_t* barQ = bars;
  uint64_t* barKV = bars + 1;  // [2]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int qh = blockIdx.x;  // b * H + h
  const int b = qh / a.H;
  const int kvh = b * a.Hkv + (qh - b * a.H) / REP;
  const int nqt = (a.Sq + kQM - 1) / kQM;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.y)) * kQM;
  const int nk_all = (a.Sk + kQN - 1) / kQN;
  const int nk = a.causal ? min(nk_all, (q0 + kQM + kQN - 1) / kQN) : nk_all;

  auto load_kv = [&](int j) {
    const int s = j & 1;
    bar_expect(barKV + s, 2 * kQN * kRowBytes);
    tma_tile(Ks + s * kQN * kD, &tmK, barKV + s, kQN, j * kQN, kvh);
    tma_tile(Vs + s * kQN * kD, &tmV, barKV + s, kQN, j * kQN, kvh);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) bar_init(bars + i, 1);
    bar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(barQ, 2 * kQM * kRowBytes);
    tma_tile(Qs, &tmQ, barQ, kQM, q0, qh);
    tma_tile(dOs, &tmdO, barQ, kQM, q0, qh);
    for (int j = 0; j < 2 && j < nk; ++j) load_kv(j);
  }

  const int row_lo = q0 + wg * 64;  // first query row of this warpgroup
  float L2[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long r = (long)qh * a.Sq_pad + row_lo + frag_row(t, 2 * i);
    L2[i] = a.lse2[r];
    Dl[i] = a.delta[r];
  }
  float dq[64];
  zero(dq);
  bar_wait(barQ, 0);

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    const bf16* Kt = Ks + st * kQN * kD;
    const bf16* Vt = Vs + st * kQN * kD;
    const int k0 = j * kQN;
    bar_wait(barKV + st, (j >> 1) & 1);

    // S = Q K^T and dP = dO V^T (64 query rows x 64 keys each)
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(s, desc_k(Qs, kQM, wg * 64, kk), desc_k(Kt, kQN, 0, kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(dp, desc_k(dOs, kQM, wg * 64, kk), desc_k(Vt, kQN, 0, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P; keys past Sk and (causal) after the row get 0
    const bool masked = k0 + kQN > a.Sk || (a.causal && k0 + kQN - 1 > row_lo);
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int i = (v >> 1) & 1;
      float p = exp2f(s[v] * a.scale_log2 - L2[i]);
      if (masked) {
        const int kpos = k0 + frag_col(t, v);
        if (kpos >= a.Sk || (a.causal && kpos > row_lo + frag_row(t, v)))
          p = 0.f;
      }
      s[v] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int v = 0; v < 32; ++v) dp[v] = s[v] * (dp[v] - Dl[(v >> 1) & 1]);
    uint32_t dsa[16];
    pack_a(dp, dsa);

    // dQ += dS K
    fence_regs(dsa);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128_mn(dq, dsa + 4 * kk, desc_mn(Kt, kQN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsa);

    __syncthreads();  // both warpgroups are done with stage st
    if (tid == 0 && j + 2 < nk) load_kv(j + 2);
  }

  store_rows(dq, a.dq + (long)qh * a.Sq * kD, row_lo, a.Sq, a.scale);
}

template <int REP>
int launch_bwd_sm90(const void* q, const void* k, const void* v, int B,
                    const BwdSm90Args& a, cudaStream_t stream) {
  using namespace bwd90;
  const long bh = (long)B * a.H;
  const long bhk = (long)B * a.Hkv;
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!make_map(&q64, q, bh, a.Sq, kKQ) ||
      !make_map(&do64, a.dout, bh, a.Sq, kKQ) ||
      !make_map(&k128, k, bhk, a.Sk, kKN) ||
      !make_map(&v128, v, bhk, a.Sk, kKN) ||
      !make_map(&q128, q, bh, a.Sq, kQM) ||
      !make_map(&do128, a.dout, bh, a.Sq, kQM) ||
      !make_map(&k64, k, bhk, a.Sk, kQN) ||
      !make_map(&v64, v, bhk, a.Sk, kQN))
    return -2;
  const long prep_rows = bh * a.Sq_pad;
  flash_attention_prep_sm90_kernel<<<static_cast<unsigned>((prep_rows + 7) /
                                                           8),
                                     256, 0, stream>>>(a);
  auto dkdv = flash_attention_dkdv_sm90_kernel<REP>;
  const int smem_kv = smem_with_align(kDkdvSmem);
  cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_kv);
  const dim3 gk(static_cast<unsigned>(bhk), (a.Sk + kKN - 1) / kKN);
  dkdv<<<gk, sm90::kThreads, smem_kv, stream>>>(q64, do64, k128, v128, a);
  auto dq = flash_attention_dq_sm90_kernel<REP>;
  const int smem_q = smem_with_align(kDqSmem);
  cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_q);
  const dim3 gq(static_cast<unsigned>(bh), (a.Sq + kQM - 1) / kQM);
  dq<<<gq, sm90::kThreads, smem_q, stream>>>(q128, do128, k64, v64, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pam

// bf16 q, o, dout, dq (B, H, Sq, 128); k, v, dk, dv (B, Hkv, Sk, 128); lse
// (B, H, Sq) fp32; delta and lse2 fp32 scratch of (B, H, Sq_pad) with
// Sq_pad = Sq rounded up to a multiple of 128. All contiguous and 16-byte
// aligned. Returns 0, a CUDA error code from cudaGetLastError(), -1 for a
// group size H / Hkv other than 1 or 2 or a wrong Sq_pad, or -2 if the
// driver refuses a tensor map.
extern "C" int pam_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* lse2, void* dq,
    void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int Sq_pad,
    int causal, float scale, void* stream) {
  if (Sq_pad % pam::bwd90::kPad != 0 || Sq_pad < Sq) return -1;
  pam::BwdSm90Args a;
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.lse2 = static_cast<float*>(lse2);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.BH = B * H;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Sq_pad = Sq_pad;
  a.causal = causal;
  a.scale = scale;
  a.scale_log2 = scale * pam::sm90::kLog2e;
  auto s = static_cast<cudaStream_t>(stream);
  switch (H / Hkv) {
    case 1: return pam::launch_bwd_sm90<1>(q, k, v, B, a, s);
    case 2: return pam::launch_bwd_sm90<2>(q, k, v, B, a, s);
    default: return -1;
  }
}
