// Mamba-2 SSD chunked scan, backward, for Hopper's tensor cores: the
// gradients of ssd_scan_sm90.cu's y with respect to x, dt, a, B, C and D
// (bf16 x, B, C, dy; N = 128 or 64, P = 64; chunks of up to 128 tokens).
// Every kernel that depends on d_state is templated on it: the B and C
// tiles are N / 64 sub-tiles, the state tile N rows, the products over
// d_state N / 16 k-steps, and dC and dB run at wgmma N = d_state
// (m64n128k16 or m64n64k16).
//
// The TPU package has no backward for repro/kernels/ssd_scan.py::
// _ssd_kernel (JAX cannot differentiate the Pallas call). This keeps the
// port's derivation (kernels/ssd_scan.py::_bwd_plain), its five outputs
// and its stages; fp32 runs ssd_scan_bwd_tf32x3.cu, and
// kernels/ssd_scan.py::_variant picks one of the two. Per chunk, with g =
// dy, S' = C B^T, E the masked exp(s_t - s_u), G = g x^T, A' = S' o E o G,
// Pb = G o E dt_u and dh the gradient of the chunk's final state:
//
//   dC = exp(s_t) g h_in^T + Pb B        dB = (w o x) dh^T + Pb^T C
//   dx = (S' o E dt_u)^T g + w (B dh) + D g
//   ds_t = exp(s_t) g_t . (C h_in)_t + rowsum_t(A' dt_u) - dt_t colsum_t A'
//          - w_t beta_t,  beta = x . (B dh),  plus at t = Q - 1 exp(s_Q)
//          <dh, h_in> + sum_u w_u beta_u;  dla = reverse cumsum of ds;
//   ddt = colsum A' + exp(s_Q - s) beta + a dla; da = sum dla dt; dD = g . x
//
// Kernels on one stream, all deterministic (no atomics):
//   1. ssd90_decay_kernel, ssd90_chunk_state_kernel<false> and
//      ssd90_pass_kernel<true> (ssd_sm90.cuh): V_c = C^T (exp(s) o g) on
//      wgmma in parallel over chunks (exp(s) o g rounded to bf16), then the
//      reverse elementwise pass dh_c-1 = exp(s_Q) dh_c + V_c, which also
//      writes the parts of <dh_c, h_in_c>;
//   2. ssd90_bwd_t_kernel (the t-side): one CTA per (chunk, batch, block of
//      hb heads of one group), two warpgroups of 64 tokens t, the group's
//      C and B tiles loaded once. Per head C h_in (for ds), g h_in^T scaled
//      by exp(s_t), then per half of u S' = C B^T and G = g x^T, the row
//      sums of A' dt_u and Pb (bf16 A fragments), dC += Pb B (B MN-major);
//      dC summed in registers over the block's heads and written once;
//   3. ssd90_bwd_u_kernel (the u-side): the same CTAs with the roles of t
//      and u exchanged. Per head B dh and beta, then per half of t S'^T = B
//      C^T and G^T = x g^T, the column sums of A', dB += Pb^T C and dx +=
//      (S' o E dt_u)^T g (both A fragments rounded to bf16, C and g
//      MN-major) on top of w B dh + D g; then dB += (w o x) dh^T with w o
//      x written over x's tile, and the chunk's dD part;
//   4. ssd90_ds_kernel: ds from the row terms of 2 and 3, its reverse
//      cumsum, ddt and the chunk's da part;
//   5. ssd90_reduce_bc_kernel (twice) and ssd90_reduce_heads_kernel: dB and
//      dC over each group's head blocks, da and dD over batch and chunks,
//      in a fixed order.
// h_in and dh enter the products as bf16 copies of the fp32 states; the
// sums of A' and of ds stay fp32. kernels/ssd_scan.py::_bwd_rounded models
// every rounding point.
//
// Bound on the H100: operations. At the training shape the TPU-side count
// of the backward's products is 8.4e10 FLOPs (0.085 ms at 989 TFLOP/s
// bf16). The side kernels recompute S' per head and half rather than keep
// it (registers are what limits them, not the tensor cores). Shared memory
// of each at N = 128 (64): C, B 64 (32) KiB + the state 16 (8) KiB (bf16)
// + 32 (16) KiB (fp32, staged) + x, dy 2 stages x 32 KiB, one CTA per SM;
// the next head's x, dy, state and decay row arrive by TMA and bulk copy
// meanwhile. At zamba2-7b's shape (B 2, L 2048, H 112, N 64) the
// backward's products are 5.2e10 FLOPs (0.053 ms).
#include <algorithm>

#include "ssd_sm90.cuh"

namespace pam {
namespace ssd90 {

namespace side {
template <int N>
constexpr int smem() {
  return 2 * Dims<N>::kSubs * kSubBytes /* C, B */ + N * 128 /* state */ +
         4 * kSubBytes /* x, dy */ + Dims<N>::kStateBytes /* staged */ +
         4 * kQ * 4 /* decay rows */ + 16 * 4 + 64;
}
}  // namespace side

// Shared memory of the two side kernels.
struct Side {
  bf16 *Ct, *Bt, *Ht, *Xt, *Gt;
  float *Fs, *raw, *s2, *dtv, *tmp;
  uint64_t* bars;  // CB, XG[2], F
};

template <int N>
__device__ __forceinline__ Side side_smem(uint8_t* smem) {
  Side s;
  s.Ct = reinterpret_cast<bf16*>(smem);
  s.Bt = s.Ct + Dims<N>::kSubs * kQ * 64;
  s.Ht = s.Bt + Dims<N>::kSubs * kQ * 64;  // the head's state, bf16 (N, P)
  s.Xt = s.Ht + N * 64;         // 2 stages
  s.Gt = s.Xt + 2 * kQ * 64;    // 2 stages
  s.Fs = reinterpret_cast<float*>(s.Gt + 2 * kQ * 64);  // state, fp32
  s.raw = s.Fs + N * kP;        // s_t, dt as stored
  s.s2 = s.raw + 2 * kQ;
  s.dtv = s.s2 + kQ;
  s.tmp = s.dtv + kQ;           // 16
  s.bars = reinterpret_cast<uint64_t*>(s.tmp + 16);
  return s;
}

// Thread 0: the fp32 state of head h0 + j of `states` and its decay row
// into the staging buffers, by bulk copy.
template <int N>
__device__ __forceinline__ void side_stage(const Side& m, const Args& a,
                                           const float* states, int b,
                                           int h, int ic) {
  using namespace sm90;
  constexpr int kStateBytes = Dims<N>::kStateBytes;
  const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
  const long long nrow = (long long)a.B * a.H * a.nc * kQ;
  bar_expect(m.bars + 3, kStateBytes + 2 * kQ * 4);
  bulk_load(m.Fs, states + bhc * N * kP, kStateBytes, m.bars + 3);
  bulk_load(m.raw, a.dec + bhc * kQ, kQ * 4, m.bars + 3);
  bulk_load(m.raw + kQ, a.dec + nrow + bhc * kQ, kQ * 4, m.bars + 3);
}

// Barriers, zeroed tiles (Q < 128), then C, B, the first two heads' x and
// dy by TMA and the first head's state (thread 0).
template <int N>
__device__ __forceinline__ void side_start(const Side& m, const Args& a,
                                           const CUtensorMap* tmX,
                                           const CUtensorMap* tmG,
                                           const CUtensorMap* tmB,
                                           const CUtensorMap* tmC,
                                           const float* states, int grp,
                                           int h0, int p0, int ic, int b) {
  using namespace sm90;
  constexpr int kSubs = Dims<N>::kSubs;
  const uint32_t sbytes = a.Q * 128;
  if (a.Q < kQ)   // C, B, the state and the x, dy stages
    zero_smem(reinterpret_cast<uint8_t*>(m.Ct),
              (2 * kSubs + 4) * kSubBytes + N * 128);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) bar_init(m.bars + i, 1);
    bar_fence_init();
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    side_stage<N>(m, a, states, b, h0, ic);
    bar_expect(m.bars, 2 * kSubs * sbytes);
    for (int i = 0; i < kSubs; ++i) {
      tma_load4(m.Ct + i * kQ * 64, tmC, m.bars, 64 * i, grp, p0, b);
      tma_load4(m.Bt + i * kQ * 64, tmB, m.bars, 64 * i, grp, p0, b);
    }
    for (int j = 0; j < 2 && j < a.hb; ++j) {
      bar_expect(m.bars + 1 + j, 2 * sbytes);
      tma_load4(m.Xt + j * kQ * 64, tmX, m.bars + 1 + j, 0, h0 + j, p0, b);
      tma_load4(m.Gt + j * kQ * 64, tmG, m.bars + 1 + j, 0, h0 + j, p0, b);
    }
  }
  bar_wait(m.bars, 0);
}

// The top of head j: refill the x / dy stage of head j - 1 with head j + 1,
// take head j's decay row and its state (as bf16, into Ht) from the
// staging buffers, then stage head j + 1's. Ends with x and dy of head j
// landed.
template <int N>
__device__ __forceinline__ void side_head(const Side& m, const Args& a,
                                          const CUtensorMap* tmX,
                                          const CUtensorMap* tmG,
                                          const float* states, int j, int h0,
                                          int p0, int ic, int b) {
  using namespace sm90;
  __syncthreads();  // the previous head is done with every buffer
  if (threadIdx.x == 0 && j >= 1 && j + 1 < a.hb) {
    const int so = (j + 1) & 1;
    bar_expect(m.bars + 1 + so, 2 * a.Q * 128);
    tma_load4(m.Xt + so * kQ * 64, tmX, m.bars + 1 + so, 0, h0 + j + 1, p0,
              b);
    tma_load4(m.Gt + so * kQ * 64, tmG, m.bars + 1 + so, 0, h0 + j + 1, p0,
              b);
  }
  bar_wait(m.bars + 3, j & 1);
  if (threadIdx.x < kQ) {
    m.s2[threadIdx.x] = m.raw[threadIdx.x] * kLog2e;
    m.dtv[threadIdx.x] = m.raw[kQ + threadIdx.x];
  }
  state_to_tile<N>(m.Fs, m.Ht, nullptr);
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0 && j + 1 < a.hb)
    side_stage<N>(m, a, states, b, h0 + j + 1, ic);
  bar_wait(m.bars + 1 + (j & 1), (j >> 1) & 1);
}

// Sum over the 4 lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// A (128, N) fp32 accumulator pair of rows (64 wg + frag rows) as
// row-major fp32 rows [p0 + row) of `dst` (row stride N), rows < Q.
template <int N>
__device__ __forceinline__ void store_part(const float (&acc)[N / 2],
                                           float* dst, int Q, int wg, int t) {
  using namespace sm90;
#pragma unroll
  for (int v = 0; v < N / 2; v += 2) {
    const int row = 64 * wg + frag_row(t, v);
    if (row < Q)
      *reinterpret_cast<float2*>(dst + (long long)row * N + frag_col(t, v)) =
          make_float2(acc[v], acc[v + 1]);
  }
}

// One half (64 columns, from col0) of the product of two K-major (128,
// N) tiles, A rows 64 wg .. 64 wg + 63: S' = C B^T (t-side) or S'^T = B
// C^T (u-side), recomputed per head and half instead of kept.
template <int N>
__device__ __forceinline__ void issue_square_half(float (&acc)[32],
                                                  const bf16* A, const bf16* B,
                                                  int wg, int col0) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss_n64(acc, desc_k(A, kQ, wg * 64, kk), desc_k(B, kQ, col0, kk));
}

// ------------------------------------------------------------ 2. t-side
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd90_bwd_t_kernel(const __grid_constant__ CUtensorMap tmX,
                       const __grid_constant__ CUtensorMap tmG,
                       const __grid_constant__ CUtensorMap tmB,
                       const __grid_constant__ CUtensorMap tmC, Args a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const Side m = side_smem<N>(align1024(smem_raw));
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int ic = blockIdx.x, b = blockIdx.y;
  const int h0 = blockIdx.z * a.hb;
  const int grp = h0 / (a.H / a.G);
  const int p0 = ic * a.Q;
  const long long nrow = (long long)a.B * a.H * a.nc * kQ;
  side_start<N>(m, a, &tmX, &tmG, &tmB, &tmC, a.states, grp, h0, p0, ic, b);

  const int r0 = 64 * wg + frag_row(t, 0);
  float dc[N / 2];
  zero(dc);
  for (int j = 0; j < a.hb; ++j) {
    const int h = h0 + j, st = j & 1;
    const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
    side_head<N>(m, a, &tmX, &tmG, a.states, j, h0, p0, ic, b);
    const bf16* xs = m.Xt + st * kQ * 64;
    const bf16* gs = m.Gt + st * kQ * 64;
    const float st0 = m.s2[r0], st1 = m.s2[r0 + 8];

    // C h_in (t, p), for the row sums g . (C h_in)
    float chin[32];
    zero(chin);
    fence_regs(chin);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_n64_mn(chin, desc_k(m.Ct, kQ, wg * 64, kk),
                      desc_mn(m.Ht, N, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(chin);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const float2 gv = ld_pair(gs, r0 + 8 * ((v >> 1) & 1), frag_col(t, v));
      rs[(v >> 1) & 1] += chin[v] * gv.x + chin[v + 1] * gv.y;
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    if ((t & 3) == 0) {
      a.rows[nrow + bhc * kQ + r0] = rs[0];
      a.rows[nrow + bhc * kQ + r0 + 8] = rs[1];
    }

    // dC += exp(s_t) g h_in^T, in N / 64 blocks of 64 n (entries 32 hn ..
    // of dC's fragment are block hn's)
    const float e0 = exp2f(st0), e1 = exp2f(st1);
#pragma unroll
    for (int hn = 0; hn < N / 64; ++hn) {
      float tmp[32];
      zero(tmp);
      fence_regs(tmp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(tmp, desc_k(gs, kQ, wg * 64, kk),
                     desc_k(m.Ht, N, 64 * hn, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
#pragma unroll
      for (int v = 0; v < 32; ++v)
        dc[32 * hn + v] += ((v >> 1) & 1 ? e1 : e0) * tmp[v];
    }

    // per half of u: S' = C B^T and G = g x^T (t, u), the row sums of A'
    // dt_u, Pb = G o E dt_u as bf16 A fragments, and dC += Pb B over the
    // half's k-steps 4 hu .. 4 hu + 3
    float ra[2] = {0.f, 0.f};
#pragma unroll 1
    for (int hu = 0; hu < 2; ++hu) {  // not unrolled: one half's registers
      float sp[32], g[32];
      zero(sp);
      zero(g);
      fence_regs(sp);
      fence_regs(g);
      wgmma_fence();
      issue_square_half<N>(sp, m.Ct, m.Bt, wg, 64 * hu);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(g, desc_k(gs, kQ, wg * 64, kk),
                     desc_k(xs, kQ, 64 * hu, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sp);
      fence_regs(g);
      uint32_t pb[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int v = 2 * i;
        const int hi = (v >> 1) & 1;
        const int row = r0 + 8 * hi;
        const int u = 64 * hu + frag_col(t, v);
        const float sr = hi ? st1 : st0;
        const float ea = u <= row ? exp2f(sr - m.s2[u]) : 0.f;
        const float eb = u + 1 <= row ? exp2f(sr - m.s2[u + 1]) : 0.f;
        const float da_ = m.dtv[u], db_ = m.dtv[u + 1];
        ra[hi] += sp[v] * ea * g[v] * da_ + sp[v + 1] * eb * g[v + 1] * db_;
        pb[i] = pack_bf16(g[v] * ea * da_, g[v + 1] * eb * db_);
      }
      fence_regs(dc);
      fence_regs(pb);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn<N>(dc, pb + 4 * kk, desc_mn(m.Bt, kQ, 4 * hu + kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dc);
      fence_regs(pb);
    }
    ra[0] = quad_sum(ra[0]);
    ra[1] = quad_sum(ra[1]);
    if ((t & 3) == 0) {
      a.rows[bhc * kQ + r0] = ra[0];
      a.rows[bhc * kQ + r0 + 8] = ra[1];
    }
  }
  const int Lp = a.nc * a.Q;
  store_part<N>(dc,
                a.dc_part + (((long long)b * (a.H / a.hb) + blockIdx.z) * Lp +
                             p0) * N,
                a.Q, wg, t);
}

// ------------------------------------------------------------ 3. u-side
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd90_bwd_u_kernel(const __grid_constant__ CUtensorMap tmX,
                       const __grid_constant__ CUtensorMap tmG,
                       const __grid_constant__ CUtensorMap tmB,
                       const __grid_constant__ CUtensorMap tmC, Args a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const Side m = side_smem<N>(align1024(smem_raw));
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int ic = blockIdx.x, b = blockIdx.y;
  const int h0 = blockIdx.z * a.hb;
  const int grp = h0 / (a.H / a.G);
  const int p0 = ic * a.Q;
  const int Q = a.Q;
  const int valid = min(Q, a.L - p0);
  const long long nrow = (long long)a.B * a.H * a.nc * kQ;
  side_start<N>(m, a, &tmX, &tmG, &tmB, &tmC, a.dstates, grp, h0, p0, ic,
                b);

  const int r0 = 64 * wg + frag_row(t, 0);
  float db[N / 2];
  zero(db);
  for (int j = 0; j < a.hb; ++j) {
    const int h = h0 + j, st = j & 1;
    const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
    side_head<N>(m, a, &tmX, &tmG, a.dstates, j, h0, p0, ic, b);
    bf16* xs = m.Xt + st * kQ * 64;
    const bf16* gs = m.Gt + st * kQ * 64;
    const float sq = m.s2[Q - 1];
    const float su0 = m.s2[r0], su1 = m.s2[r0 + 8];
    const float du0 = m.dtv[r0], du1 = m.dtv[r0 + 8];
    const float w0 = exp2f(sq - su0) * du0;
    const float w1 = exp2f(sq - su1) * du1;

    // B dh (u, p), then beta = x . (B dh), the dD part g . x, and the dx
    // accumulator started at w (B dh) + D g
    float dx[32];
    zero(dx);
    fence_regs(dx);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_n64_mn(dx, desc_k(m.Bt, kQ, wg * 64, kk),
                      desc_mn(m.Ht, N, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dx);
    const float D = a.d[h];
    float bb[2] = {0.f, 0.f}, gx = 0.f;
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int hi = (v >> 1) & 1;
      const int row = r0 + 8 * hi;
      const int p = frag_col(t, v);
      const float2 xv = ld_pair(xs, row, p);
      const float2 gv = ld_pair(gs, row, p);
      bb[hi] += xv.x * dx[v] + xv.y * dx[v + 1];
      gx += xv.x * gv.x + xv.y * gv.y;
      const float w = hi ? w1 : w0;
      dx[v] = w * dx[v] + D * gv.x;
      dx[v + 1] = w * dx[v + 1] + D * gv.y;
    }
    bb[0] = quad_sum(bb[0]);
    bb[1] = quad_sum(bb[1]);
    if ((t & 3) == 0) {
      a.rows[3 * nrow + bhc * kQ + r0] = bb[0];
      a.rows[3 * nrow + bhc * kQ + r0 + 8] = bb[1];
    }

    // per half of t: S'^T = B C^T and G^T = x g^T (u, t); the column sums
    // of A' (rows here); Pb^T = G^T o E^T dt_u and S'^T o E^T dt_u as bf16
    // A fragments; dB += Pb^T C and dx += (S' o E dt_u)^T g over the half's
    // k-steps 4 ht .. 4 ht + 3
    float ca[2] = {0.f, 0.f};
#pragma unroll 1
    for (int ht = 0; ht < 2; ++ht) {  // not unrolled: one half's registers
      float sp[32], g[32];
      zero(sp);
      zero(g);
      fence_regs(sp);
      fence_regs(g);
      wgmma_fence();
      issue_square_half<N>(sp, m.Bt, m.Ct, wg, 64 * ht);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(g, desc_k(xs, kQ, wg * 64, kk),
                     desc_k(gs, kQ, 64 * ht, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sp);
      fence_regs(g);
      uint32_t pb[16], sa[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int v = 2 * i;
        const int hi = (v >> 1) & 1;
        const int row = r0 + 8 * hi;  // u
        const int tc = 64 * ht + frag_col(t, v);
        const float su = hi ? su1 : su0;
        const float du = hi ? du1 : du0;
        const float ea = row <= tc ? exp2f(m.s2[tc] - su) : 0.f;
        const float eb = row <= tc + 1 ? exp2f(m.s2[tc + 1] - su) : 0.f;
        ca[hi] += sp[v] * ea * g[v] + sp[v + 1] * eb * g[v + 1];
        pb[i] = pack_bf16(g[v] * ea * du, g[v + 1] * eb * du);
        sa[i] = pack_bf16(sp[v] * ea * du, sp[v + 1] * eb * du);
      }
      fence_regs(db);
      fence_regs(dx);
      fence_regs(pb);
      fence_regs(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn<N>(db, pb + 4 * kk, desc_mn(m.Ct, kQ, 4 * ht + kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64_mn(dx, sa + 4 * kk, desc_mn(gs, kQ, 4 * ht + kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(db);
      fence_regs(dx);
      fence_regs(pb);
      fence_regs(sa);
    }
    ca[0] = quad_sum(ca[0]);
    ca[1] = quad_sum(ca[1]);
    if ((t & 3) == 0) {
      a.rows[2 * nrow + bhc * kQ + r0] = ca[0];
      a.rows[2 * nrow + bhc * kQ + r0 + 8] = ca[1];
    }
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int row = r0 + 8 * ((v >> 1) & 1);
      if (row >= valid) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          a.dx + (((long long)b * a.L + p0 + row) * a.H + h) * kP +
          frag_col(t, v)) = __floats2bfloat162_rn(dx[v], dx[v + 1]);
    }
    const float gx_sum = block_sum(gx, m.tmp);  // also: x's tile is free

    // w o x over x's tile (bf16), then dB += (w o x) dh^T
    for (int i = tid; i < kQ * 8; i += kThreads) {
      const int row = i >> 3;
      const float w = exp2f(sq - m.s2[row]) * m.dtv[row];
      uint4* p = reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(xs) +
                                          16 * i);
      float f[8];
      unpack8(*p, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] *= w;
      pack8(f, p, nullptr);
    }
    fence_async_smem();
    __syncthreads();
    fence_regs(db);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<N>(db, desc_k(xs, kQ, wg * 64, kk), desc_k(m.Ht, N, 0, kk));
    wgmma_commit();
    if (tid == 0) a.dd_part[bhc] = gx_sum;
    wgmma_wait<0>();
    fence_regs(db);
  }
  const int Lp = a.nc * a.Q;
  store_part<N>(db,
                a.db_part + (((long long)b * (a.H / a.hb) + blockIdx.z) * Lp +
                             p0) * N,
                a.Q, wg, t);
}

// ------------------------------------------------------------ 5. reductions
// out[b, l, g, n] = sum of the group's rep / hb head-block parts.
template <int N>
__global__ void ssd90_reduce_bc_kernel(const float* __restrict__ part,
                                       bf16* __restrict__ out, int B, int L,
                                       int Lp, int Hb, int G) {
  const long long total = (long long)B * L * G * N;
  const int per = Hb / G;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int n = idx % N;
    const long long rest = idx / N;
    const int g = rest % G;
    const long long bl = rest / G;
    const int l = bl % L;
    const int b = bl / L;
    const float* p = part + (((long long)b * Hb + g * per) * Lp + l) * N + n;
    float s = 0.f;
    for (int r = 0; r < per; ++r) s += p[(long long)r * Lp * N];
    out[idx] = __float2bfloat16(s);
  }
}

template <int N>
int launch_bwd(const Args& args, const void* x, const void* dy,
               const void* b, const void* c, const SeqStrides& sd,
               cudaStream_t s) {
  const int B = args.B, L = args.L, H = args.H, G = args.G, Q = args.Q;
  const int nc = args.nc, hb = args.hb;
  CUtensorMap tx, tg, tb, tc;
  const long long row_hp = (long long)H * kP;
  if (!make_seq_map(&tx, x, kP, H, L, B, sd.x_sl, sd.x_sb, Q) ||
      !make_seq_map(&tg, dy, kP, H, L, B, row_hp, row_hp * L, Q) ||
      !make_seq_map(&tb, b, N, G, L, B, sd.b_sl, sd.b_sb, Q) ||
      !make_seq_map(&tc, c, N, G, L, B, sd.c_sl, sd.c_sb, Q))
    return -2;
  launch_states<false, N>(args, tc, tg, s);
  const int smem = smem_with_align(side::smem<N>());
  const dim3 grid(nc, B, H / hb);
  cudaFuncSetAttribute(ssd90_bwd_t_kernel<N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ssd90_bwd_t_kernel<N><<<grid, kThreads, smem, s>>>(tx, tg, tb, tc, args);
  cudaFuncSetAttribute(ssd90_bwd_u_kernel<N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ssd90_bwd_u_kernel<N><<<grid, kThreads, smem, s>>>(tx, tg, tb, tc, args);
  ssd90_ds_kernel<N><<<dim3(nc, B * H), kQ, 0, s>>>(args);
  const long long n_bc = (long long)B * L * G * N;
  const int blocks =
      static_cast<int>(std::min<long long>((n_bc + kThreads - 1) / kThreads,
                                           4096));
  ssd90_reduce_bc_kernel<N><<<blocks, kThreads, 0, s>>>(
      args.db_part, args.db, B, L, nc * Q, H / hb, G);
  ssd90_reduce_bc_kernel<N><<<blocks, kThreads, 0, s>>>(
      args.dc_part, args.dc, B, L, nc * Q, H / hb, G);
  ssd90_reduce_heads_kernel<<<(H + 63) / 64, 64, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd90
}  // namespace pam

// bf16 x (B, L, H, 64), b and c (B, L, G, N) with any batch and sequence
// strides (elements; last two axes contiguous, base and strides 16-byte
// aligned); fp32 dt (B, L, H), a and d (H,); states (B, H, nc, N, 64) fp32
// from the forward; dy (B, L, H, 64) bf16 contiguous. Outputs dx like dy,
// ddt (B, L, H) fp32, da and dd (H,) fp32, db and dc (B, L, G, N) bf16
// contiguous. Scratch (fp32): dec (2, B, H, nc, 128), dstates like states,
// frob (B, H, nc, N / 2), rows (4, B, H, nc, 128), db_part and dc_part (B,
// H / hb, nc Q, N), da_part and dd_part (B, H, nc). Returns 0, a CUDA
// error code from cudaGetLastError(), -1 for a bad shape or an N outside
// PAM_SSD90_BUILT_N, or -2 if the driver refuses a tensor map.
extern "C" int pam_ssd_scan_bwd_sm90(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* states, const void* dy,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dd, void* dec,
    void* dstates, void* frob, void* rows, void* db_part, void* dc_part,
    void* da_part, void* dd_part, int B, int L, int H, int G, int Q, int nc,
    int hb, int N, long long x_sb, long long x_sl, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, void* stream) {
  using namespace pam::ssd90;
  if (Q < 1 || Q > kQ || hb < 1 || H % G || (H / G) % hb) return -1;
  Args args = {};
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.d = static_cast<const float*>(d);
  args.states = static_cast<float*>(const_cast<void*>(states));
  args.dec = static_cast<float*>(dec);
  args.dx = static_cast<bf16*>(dx);
  args.ddt = static_cast<float*>(ddt);
  args.da = static_cast<float*>(da);
  args.dd = static_cast<float*>(dd);
  args.db = static_cast<bf16*>(db);
  args.dc = static_cast<bf16*>(dc);
  args.dstates = static_cast<float*>(dstates);
  args.frob = static_cast<float*>(frob);
  args.rows = static_cast<float*>(rows);
  args.db_part = static_cast<float*>(db_part);
  args.dc_part = static_cast<float*>(dc_part);
  args.da_part = static_cast<float*>(da_part);
  args.dd_part = static_cast<float*>(dd_part);
  args.B = B;
  args.L = L;
  args.H = H;
  args.G = G;
  args.Q = Q;
  args.nc = nc;
  args.hb = hb;
  const pam::SeqStrides sd = {x_sb, x_sl, b_sb, b_sl, c_sb, c_sl};
  auto s = static_cast<cudaStream_t>(stream);
#define PAM_SSD90_BWD_CASE(NS) \
  if (N == NS) return launch_bwd<NS>(args, x, dy, b, c, sd, s);
  PAM_SSD90_BUILT_N(PAM_SSD90_BWD_CASE)
#undef PAM_SSD90_BWD_CASE
  return -1;
}
