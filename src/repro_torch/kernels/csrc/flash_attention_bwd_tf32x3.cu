// FlashAttention-2 backward in fp32 on the tensor cores (3xTF32): dQ, dK,
// dV of flash_attention_tf32x3.cu's forward.
//
// The TPU package has no counterpart: JAX cannot differentiate through
// the Pallas kernel (repro/kernels/flash_attention.py, pl.pallas_call at
// :122), so the reference trains only with its jnp attention. The port's
// fp32 train paths (the parity phases that hold the port to the plain
// attention at full width) run the forward kernel on the card and need
// this gradient. bf16 runs flash_attention_bwd_sm90.cu (wgmma) at head
// dims 64-128 and flash_attention_bwd.cu (CUDA cores) at 16.
//
// Given the forward's O and per-row log-sum-exp L, with S = scale Q K^T:
//   P = exp(S - L) on live entries (0 elsewhere), Delta = rowsum(dO * O),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
// Deterministic passes on one stream, no atomics:
//   1. delta: Delta per query row, one warp per row (fp32 FMAs);
//   2. dkdv: one CTA per (query head and batch, 64-row key tile) walks
//      that head's query tiles and keeps the head's dK, dV in registers;
//   3. reduce (group > 1): dK, dV of a kv head = the sum of its group's
//      per-head partials in head order (scratch the wrapper allocates);
//      at group 1 the dkdv pass writes dK, dV itself;
//   4. dq: one CTA per (query head and batch, 64-row query tile) walks
//      the key tiles and keeps dQ in registers.
// S and dP are recomputed in 2 and 4; causal tiles above the diagonal
// are skipped in both, and both grids run the longest causal tiles of
// every head first (y = the tile, x = the head). Two calls on the same
// inputs give equal bits.
//
// Bound on the H100: operations, five 64-wide products a tile pair (2.5x
// the forward's FLOPs). The CUDA-core kernel this replaces ran
// them as fp32 FMAs and launched its dK / dV pass as one CTA per (key
// tile, kv head), which walked the whole GQA group serially: at group 16,
// B 2, S 500, 64 CTAs on 132 SMs, each over 16 heads x 8 query tiles, so
// its time grew with the group (3.25x SDPA's at (128, 16)). Here every
// product runs on the tensor cores in 3xTF32 (attention_tf32.cuh; bound
// 3x the FLOPs over 495 TFLOP/s), the dK / dV pass has a CTA per query
// head (1,024 at that shape), and each pass double-buffers its moving
// tiles with cp.async. The dkdv pass holds K and V (hi / lo) for 64 keys
// and walks 32-row query tiles (16 at head dims 112 and 128: shared
// memory) of Q and dO (hi / lo) with their L and Delta; the dq pass holds
// Q and dO for 64 queries and walks key tiles of K and V of the same
// size. As in the forward, latency rather than the products holds the
// passes back, so each CTA is eight warps: warp w takes rows 16 (w % 4)
// of the stationary tile and half w / 4 of each moving tile, and the
// halves' dK, dV (dQ) are summed at the end. P and dS are split in
// registers into the A operands of dV / dK (the transposed scores,
// computed as K Q^T and V dO^T) and of dQ. Shared memory: 203 KB at D 128
// (one CTA an SM), 172 KB at D 80.
#include "attention_tf32.cuh"

namespace pam {

struct Tf32BwdArgs {
  const float* q;     // (B, H, Sq, D)
  const float* k;     // (B, Hkv, Sk, D)
  const float* v;
  const float* o;     // (B, H, Sq, D)
  const float* dout;
  const float* lse;   // (B, H, Sq)
  float* delta;       // (B, H, Sq) scratch
  float* dk_part;     // (B, H, Sk, D) scratch, group > 1 only
  float* dv_part;
  float* dq;          // like q
  float* dk;          // like k
  float* dv;
  int B, H, Hkv, Sq, Sk, causal;
  float scale;
};

namespace tf32 {

// Eight warps over a 64-row stationary tile: warp w takes its rows
// 16 (w % 4) and half w / 4 of every moving tile, and the two halves'
// accumulators (dK and dV, or dQ) are summed at the end, in that order.
constexpr int kThreads = 256;
constexpr int kRows = 64;                // rows of the stationary tile

template <int D>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return (4 * kRows + 8 * move_rows<D>()) * ld<D>() * 4 +
         2 * 2 * move_rows<D>() * 4;
}

// Delta[row] = sum_c dO[row, c] * O[row, c], one warp per row.
template <int D>
__global__ void __launch_bounds__(256)
    flash_attention_delta_tf32x3_kernel(Tf32BwdArgs a) {
  const long rows = (long)a.B * a.H * a.Sq;
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* o = a.o + row * D;
  const float* g = a.dout + row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += o[c] * g[c];
  s = warp_sum(s);
  if (lane == 0) a.delta[row] = s;
}

template <int D, int REP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_dkdv_tf32x3_kernel(Tf32BwdArgs a) {
  constexpr int LD = ld<D>();
  constexpr int BQ = move_rows<D>();
  constexpr int NT = D / 8;    // 8-column tiles of dK, dV
  constexpr int NS = BQ / 16;  // 8-column tiles of a warp's S^T
  constexpr int SPLANE = kRows * LD;
  constexpr int PLANE = BQ * LD;
  extern __shared__ __align__(16) uint32_t tf32_smem[];
  uint32_t* Kh = tf32_smem;
  uint32_t* Kl = Kh + SPLANE;
  uint32_t* Vh = Kl + SPLANE;
  uint32_t* Vl = Vh + SPLANE;
  uint32_t* mov = Vl + SPLANE;   // 2 x {Q hi, Q lo, dO hi, dO lo}
  float* vecs = reinterpret_cast<float*>(mov + 8 * PLANE);  // 2 x {L, Delta}

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  // heaviest first: the first (causal: longest) key tiles of every head
  const int k0 = blockIdx.y * kRows;
  const int h = blockIdx.x % a.H;
  const int b = blockIdx.x / a.H;
  const long qhead = (long)b * a.H + h;
  const long khead = (long)b * a.Hkv + h / REP;
  const float* q = a.q + qhead * a.Sq * D;
  const float* dout = a.dout + qhead * a.Sq * D;
  const float* lse = a.lse + qhead * a.Sq;
  const float* delta = a.delta + qhead * a.Sq;
  const bool causal = a.causal != 0;
  const int nq = (a.Sq + BQ - 1) / BQ;
  // causal: the query tiles from this key tile's first row on
  const int iq0 = causal ? k0 / BQ : 0;

  // one query tile's Q, dO, L and Delta into buffer `which`
  auto stage = [&](int iq, int which) {
    uint32_t* p = mov + which * 4 * PLANE;
    stage_rows<D, BQ, kThreads>(q, iq * BQ, a.Sq, p);
    stage_rows<D, BQ, kThreads>(dout, iq * BQ, a.Sq, p + 2 * PLANE);
    float* vv = vecs + which * 2 * BQ;
    const int i = threadIdx.x;
    if (i < 2 * BQ) {
      const int r = iq * BQ + (i % BQ);
      const bool in = r < a.Sq;
      cp_async4_zfill(vv + i, (i < BQ ? lse : delta) + (in ? r : 0),
                      in ? 4 : 0);
    }
  };

  stage_rows<D, kRows, kThreads>(a.k + khead * a.Sk * D, k0, a.Sk, Kh);
  stage_rows<D, kRows, kThreads>(a.v + khead * a.Sk * D, k0, a.Sk, Vh);
  if (iq0 < nq) stage(iq0, 0);
  cp_async_commit();

  const int r0 = 16 * (warp & 3);         // the warp's keys
  const int qh = (BQ / 2) * (warp >> 2);  // and its queries in each tile
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[c][e] = 0.f;
      dv[c][e] = 0.f;
    }

  for (int iq = iq0, j = 0; iq < nq; ++iq, ++j) {
    uint32_t* buf = mov + (j & 1) * 4 * PLANE;
    const float* Ls = vecs + (j & 1) * 2 * BQ;
    const float* Ds = Ls + BQ;
    cp_async_wait<0>();
    if (j == 0) {
      split_rows<D, kRows, kThreads>(Kh, Kl);
      split_rows<D, kRows, kThreads>(Vh, Vl);
    }
    split_rows<D, BQ, kThreads>(buf, buf + PLANE);
    split_rows<D, BQ, kThreads>(buf + 2 * PLANE, buf + 3 * PLANE);
    __syncthreads();   // tile j split; the other buffer is free
    if (iq + 1 < nq) {
      stage(iq + 1, (j + 1) & 1);
      cp_async_commit();
    }
    const uint32_t* Qh = buf;
    const uint32_t* Ql = buf + PLANE;
    const uint32_t* Gh = buf + 2 * PLANE;
    const uint32_t* Gl = buf + 3 * PLANE;

    // S^T = K Q^T and dP^T = V dO^T over the warp's 16 keys and the
    // tile's queries
    float st[NS][4], dpt[NS][4];
    rows_product<D, NS>(Kh, Kl, r0, Qh, Ql, qh, st);
    rows_product<D, NS>(Vh, Vl, r0, Gh, Gl, qh, dpt);

    // P^T and dS^T: entry (key g + 8 hf, query 8 n + 2 t + e)
    const int q0 = iq * BQ;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = qh + 8 * n + 2 * t + e;
        const int qpos = q0 + col;
        const float L = Ls[col];
        const float Dq = Ds[col];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kpos = k0 + r0 + g + 8 * hf;
          const bool live =
              qpos < a.Sq && kpos < a.Sk && (!causal || kpos <= qpos);
          const float p = live ? expf(st[n][2 * hf + e] * a.scale - L)
                               : 0.f;
          st[n][2 * hf + e] = p;
          dpt[n][2 * hf + e] = p * (dpt[n][2 * hf + e] - Dq);
        }
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T split in registers
    cols_product<D, NS>(st, Gh, Gl, qh, dv);
    cols_product<D, NS>(dpt, Qh, Ql, qh, dk);
  }
  cp_async_wait<0>();
  __syncthreads();   // the moving buffers are free for the halves' sum

  // the second query half's dK, dV through shared memory to the first
  float* dkx = reinterpret_cast<float*>(mov);   // (64, LD) dK, then dV
  float* dvx = dkx + kRows * LD;
  if (warp >= 4) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        *reinterpret_cast<float2*>(dkx + r * LD + 8 * c + 2 * t) =
            make_float2(dk[c][2 * hf], dk[c][2 * hf + 1]);
        *reinterpret_cast<float2*>(dvx + r * LD + 8 * c + 2 * t) =
            make_float2(dv[c][2 * hf], dv[c][2 * hf + 1]);
      }
    }
  }
  __syncthreads();
  if (warp >= 4) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const float2 x =
          *reinterpret_cast<const float2*>(dkx + r * LD + 8 * c + 2 * t);
      const float2 y =
          *reinterpret_cast<const float2*>(dvx + r * LD + 8 * c + 2 * t);
      dk[c][2 * hf] += x.x;
      dk[c][2 * hf + 1] += x.y;
      dv[c][2 * hf] += y.x;
      dv[c][2 * hf + 1] += y.y;
    }
  }

  // group 1: dK (scaled) and dV themselves; else this head's partials
  const bool direct = REP == 1;
  float* dkp = direct ? a.dk + khead * a.Sk * D : a.dk_part + qhead * a.Sk * D;
  float* dvp = direct ? a.dv + khead * a.Sk * D : a.dv_part + qhead * a.Sk * D;
  const float mult = direct ? a.scale : 1.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = k0 + r0 + g + 8 * hf;
    if (kpos >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const long off = (long)kpos * D + 8 * c + 2 * t;
      *reinterpret_cast<float2*>(dkp + off) =
          make_float2(dk[c][2 * hf] * mult, dk[c][2 * hf + 1] * mult);
      *reinterpret_cast<float2*>(dvp + off) =
          make_float2(dv[c][2 * hf], dv[c][2 * hf + 1]);
    }
  }
}

// dK = scale sum_r dK_part[head r of the group], dV = sum_r dV_part, over
// the group in head order; 4 values a thread.
template <int D, int REP>
__global__ void __launch_bounds__(256)
    flash_attention_reduce_tf32x3_kernel(Tf32BwdArgs a) {
  const long per_head = (long)a.Sk * D / 4;
  const long n = (long)a.B * a.Hkv * per_head;
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const long kh = i / per_head;          // b * Hkv + kv head
  const long w = i - kh * per_head;
  const long first = kh * REP * per_head + w;   // head (kv head) * REP
  const float4* pk = reinterpret_cast<const float4*>(a.dk_part) + first;
  const float4* pv = reinterpret_cast<const float4*>(a.dv_part) + first;
  float4 sk = pk[0], sv = pv[0];
#pragma unroll
  for (int r = 1; r < REP; ++r) {
    const float4 x = pk[r * per_head], y = pv[r * per_head];
    sk.x += x.x;
    sk.y += x.y;
    sk.z += x.z;
    sk.w += x.w;
    sv.x += y.x;
    sv.y += y.y;
    sv.z += y.z;
    sv.w += y.w;
  }
  reinterpret_cast<float4*>(a.dk)[i] =
      make_float4(sk.x * a.scale, sk.y * a.scale, sk.z * a.scale,
                  sk.w * a.scale);
  reinterpret_cast<float4*>(a.dv)[i] = sv;
}

template <int D, int REP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_dq_tf32x3_kernel(Tf32BwdArgs a) {
  constexpr int LD = ld<D>();
  constexpr int BK = move_rows<D>();
  constexpr int NT = D / 8;    // 8-column tiles of dQ
  constexpr int NS = BK / 16;  // 8-column tiles of a warp's S
  constexpr int SPLANE = kRows * LD;
  constexpr int PLANE = BK * LD;
  extern __shared__ __align__(16) uint32_t tf32_smem[];
  uint32_t* Qh = tf32_smem;
  uint32_t* Ql = Qh + SPLANE;
  uint32_t* Gh = Ql + SPLANE;
  uint32_t* Gl = Gh + SPLANE;
  uint32_t* mov = Gl + SPLANE;   // 2 x {K hi, K lo, V hi, V lo}

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  // heaviest first: the last (causal: longest) query tiles of every head
  const int h = blockIdx.x % a.H;
  const int b = blockIdx.x / a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const long qhead = (long)b * a.H + h;
  const long khead = (long)b * a.Hkv + h / REP;
  const float* k = a.k + khead * a.Sk * D;
  const float* v = a.v + khead * a.Sk * D;
  const bool causal = a.causal != 0;
  const int nk = causal_tiles<kRows, BK>(q0, a.Sq, a.Sk, causal);

  stage_rows<D, kRows, kThreads>(a.q + qhead * a.Sq * D, q0, a.Sq, Qh);
  stage_rows<D, kRows, kThreads>(a.dout + qhead * a.Sq * D, q0, a.Sq, Gh);
  stage_rows<D, BK, kThreads>(k, 0, a.Sk, mov);
  stage_rows<D, BK, kThreads>(v, 0, a.Sk, mov + 2 * PLANE);
  cp_async_commit();

  const int r0 = 16 * (warp & 3);         // the warp's queries
  const int kh = (BK / 2) * (warp >> 2);  // and its keys in each tile
  float L[2], Dq[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = q0 + r0 + g + 8 * hf;
    const bool in = qpos < a.Sq;
    L[hf] = in ? a.lse[qhead * a.Sq + qpos] : 0.f;
    Dq[hf] = in ? a.delta[qhead * a.Sq + qpos] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[c][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    uint32_t* buf = mov + (j & 1) * 4 * PLANE;
    cp_async_wait<0>();
    if (j == 0) {
      split_rows<D, kRows, kThreads>(Qh, Ql);
      split_rows<D, kRows, kThreads>(Gh, Gl);
    }
    split_rows<D, BK, kThreads>(buf, buf + PLANE);
    split_rows<D, BK, kThreads>(buf + 2 * PLANE, buf + 3 * PLANE);
    __syncthreads();   // tile j split; the other buffer is free
    if (j + 1 < nk) {
      uint32_t* nxt = mov + ((j + 1) & 1) * 4 * PLANE;
      stage_rows<D, BK, kThreads>(k, (j + 1) * BK, a.Sk, nxt);
      stage_rows<D, BK, kThreads>(v, (j + 1) * BK, a.Sk, nxt + 2 * PLANE);
      cp_async_commit();
    }
    const uint32_t* Kh = buf;
    const uint32_t* Kl = buf + PLANE;
    const uint32_t* Vh = buf + 2 * PLANE;
    const uint32_t* Vl = buf + 3 * PLANE;

    // S = Q K^T and dP = dO V^T over the warp's 16 queries
    float s[NS][4], dp[NS][4];
    rows_product<D, NS>(Qh, Ql, r0, Kh, Kl, kh, s);
    rows_product<D, NS>(Gh, Gl, r0, Vh, Vl, kh, dp);

    // dS = P (dP - Delta): entry (query g + 8 hf, key 8 n + 2 t + e)
    const int k0 = j * BK + kh;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qpos = q0 + r0 + g + 8 * hf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * n + 2 * t + e;
          const bool live =
              qpos < a.Sq && kpos < a.Sk && (!causal || kpos <= qpos);
          const int i = 2 * hf + e;
          const float p = live ? expf(s[n][i] * a.scale - L[hf]) : 0.f;
          dp[n][i] = p * (dp[n][i] - Dq[hf]);
        }
    }

    // dQ += dS K, dS split in registers
    cols_product<D, NS>(dp, Kh, Kl, kh, dq);
  }
  cp_async_wait<0>();
  __syncthreads();   // the moving buffers are free for the halves' sum

  // the second key half's dQ through shared memory to the first
  float* dqx = reinterpret_cast<float*>(mov);   // (64, LD)
  if (warp >= 4) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
#pragma unroll
      for (int c = 0; c < NT; ++c)
        *reinterpret_cast<float2*>(dqx + r * LD + 8 * c + 2 * t) =
            make_float2(dq[c][2 * hf], dq[c][2 * hf + 1]);
    }
  }
  __syncthreads();
  if (warp >= 4) return;

  float* out = a.dq + qhead * a.Sq * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    const int qpos = q0 + r;
    if (qpos >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const float2 x =
          *reinterpret_cast<const float2*>(dqx + r * LD + 8 * c + 2 * t);
      *reinterpret_cast<float2*>(out + (long)qpos * D + 8 * c + 2 * t) =
          make_float2((dq[c][2 * hf] + x.x) * a.scale,
                      (dq[c][2 * hf + 1] + x.y) * a.scale);
    }
  }
}

template <int D, int REP>
struct LaunchBwd {
  static int run(const Tf32BwdArgs& a, cudaStream_t stream) {
    constexpr int smem = bwd_smem_bytes<D>();
    const long rows = (long)a.B * a.H * a.Sq;
    flash_attention_delta_tf32x3_kernel<D>
        <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(a);
    auto dkdv = flash_attention_dkdv_tf32x3_kernel<D, REP>;
    cudaError_t e = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dkdv<<<dim3(a.H * a.B, (a.Sk + kRows - 1) / kRows), kThreads, smem,
           stream>>>(a);
    if constexpr (REP > 1) {
      const long n = (long)a.B * a.Hkv * a.Sk * D / 4;
      flash_attention_reduce_tf32x3_kernel<D, REP>
          <<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(a);
    }
    auto dq = flash_attention_dq_tf32x3_kernel<D, REP>;
    e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dq<<<dim3(a.H * a.B, (a.Sq + kRows - 1) / kRows), kThreads, smem,
         stream>>>(a);
    return 0;
  }
};

}  // namespace tf32
}  // namespace pam

// fp32 operands and gradients. delta is an fp32 (B, H, Sq) scratch
// buffer; dk_part and dv_part fp32 (B, H, Sk, D) scratch buffers when
// H > Hkv (null otherwise). Returns 0, a CUDA error code, or -1 for a
// (D, H / Hkv) pair outside PAM_ATTN_BWD_BUILT or a missing scratch.
extern "C" int pam_flash_attention_bwd_tf32x3(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dk_part,
    void* dv_part, void* dq, void* dk, void* dv, int B, int H, int Hkv,
    int Sq, int Sk, int D, int causal, float scale, void* stream) {
  if (H != Hkv && (dk_part == nullptr || dv_part == nullptr)) return -1;
  pam::Tf32BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dk_part = static_cast<float*>(dk_part);
  a.dv_part = static_cast<float*>(dv_part);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return pam::tf32::dispatch_bwd<pam::tf32::LaunchBwd>(
      D, H / Hkv, a, static_cast<cudaStream_t>(stream));
}
