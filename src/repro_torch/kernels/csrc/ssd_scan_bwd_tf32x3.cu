// Mamba-2 SSD chunked scan, backward, in fp32 on the tensor cores
// (3xTF32): the gradients of ssd_scan_tf32x3.cu's y with respect to x,
// dt, a, B, C and D (fp32 x, B, C, dy; N = 128 or 64, P = 64; chunks of
// up to 128 tokens).
//
// The TPU package has no backward for repro/kernels/ssd_scan.py::
// _ssd_kernel (JAX cannot differentiate the Pallas call). This keeps the
// port's derivation (kernels/ssd_scan.py::_bwd_plain) and the bf16
// kernels' stages (ssd_scan_bwd_sm90.cu); kernels/ssd_scan.py::_variant
// picks one of the two. Per chunk, with g = dy, S' = C B^T, E the masked
// exp(s_t - s_u), G = g x^T, Pb = G o E dt_u and dh the gradient of the
// chunk's final state:
//
//   dC = exp(s_t) g h_in^T + Pb B        dB = w o (x dh^T) + Pb^T C
//   dx = dt_u (S' o E)^T g + w (B dh) + D g
//   ds_t = exp(s_t) g_t . (C h_in)_t + rowsum_t(A' dt_u) - dt_t colsum_t A'
//          - w_t beta_t, A' = S' o E o G, beta = x . (B dh), plus at t =
//          Q - 1 exp(s_Q) <dh, h_in> + sum_u w_u beta_u; dla = reverse
//          cumsum of ds; ddt = colsum A' + exp(s_Q - s) beta + a dla
//
// The row and column sums of A' cancel in da's sum for the most part (its
// diagonal, E = 1, enters both), so both come from the same fp32 values
// of A', as in the plain version (taken through two different products,
// their 3xTF32 errors left da outside 1e-3 of its largest entry in the
// parity runs); and S' = C B^T, the same for every head of a group, is
// computed once per group and read by both side kernels. g_t . (C h_in)_t
// is taken as C_t . (g h_in^T)_t, the t-side's dC product dotted with C's
// row. Kernels on one stream, all deterministic (no atomics):
//   1. ssd90_decay_kernel, ssd_state_tf32x3_kernel<false> (V_c = C^T
//      (exp(s) o g), every chunk in parallel) and ssd90_pass_kernel<true>
//      (dh_c-1 = exp(s_Q) dh_c + V_c, with the parts of <dh_c, h_in_c>);
//   2. ssd_cb_tf32x3_kernel: S' per (chunk, batch, group), its causal
//      tiles (a CTA per 16-row block), into a buffer as S' and as S'^T;
//   3. ssd_bwd_t_tf32x3_kernel (the t-side), per (chunk, batch, head),
//      each warp a 16-row block of t (row_block), g whole in shared
//      memory: dC = g h_in^T over head-dim slices of h_in and g . (C
//      h_in); then per block of 32 rows u (x's and B's rows staged): G =
//      g x^T, A' = S' o E o G with S' from the buffer, its row sums
//      (times dt_u) and column sums (over the warp's rows, then the warps
//      in order through shared memory), Pb = G o E dt_u split in
//      registers as the A operand of dC += Pb B (blocks past the warp's
//      rows skipped); writes the head's dC and three row terms;
//   4. ssd_bwd_u_tf32x3_kernel (the u-side's dx half), a 16-row block of u
//      a warp: B dh over d_state slices, then (S'^T o E^T) g with S'^T
//      from the buffer (g whole), giving dx, beta and the chunk's dD part;
//   5. ssd_bwd_db_tf32x3_kernel (its dB half), x whole in shared memory:
//      dB = w o (x dh^T) over head-dim slices of dh, then per block of 32
//      rows t (g's and C's rows staged): G^T = x g^T, Pb^T = G^T o E^T
//      dt_u and dB += Pb^T C (blocks before the warp's rows skipped);
//      writes the head's dB;
//   6. ssd90_ds_kernel: ds from the four row terms of 3 and 4, its reverse
//      cumsum, ddt and the chunk's da part;
//   7. ssd_reduce_bc_tf32x3_kernel (twice) and ssd90_reduce_heads_kernel:
//      dB and dC over each group's heads, da and dD over batch and
//      chunks, in a fixed order.
//
// Bound on the H100: operations. At mamba2-780m's train_parity shape the
// backward's products are 1.05e10 FLOPs (0.063 ms in 3xTF32) against
// 0.016 ms for its operands, the states and the gradients. What bounds
// the side kernels is latency: a warp holds one 16 x 128 accumulator (and
// a 16 x 32 block of G), so each runs two CTAs of eight warps an SM, at
// most 128 registers (kSideCtas); with two such accumulators and one CTA
// an SM they took 1.4x as long. Operands are split in registers as their
// fragments are loaded, and each head's dB and dC go to per-head fp32
// parts that the reduction sums over the group.
#include "ssd_tf32.cuh"

namespace pam {
namespace ssdtf {

// The side kernels walk the chunk in blocks of 32 rows (kBlk) of u
// (t-side) or t (dB half), a block's 16 x 32 products beside one 16 x 128
// accumulator a warp, so that each runs two CTAs of eight warps an SM
// (at most 128 registers, kSideCtas) in two stage buffers, beside a
// whole (128, 64) tile of g or x that stays in shared memory.
constexpr int kBlk = 32;
constexpr int kSideCtas = 2;
constexpr int kSideStages = 2;
constexpr int kWhole = kQ * kLdP;   // a persistent (128, 64) tile

// Stage words of a block stage: a (32, 64) tile and a (32, N) one.
template <int N>
__host__ __device__ constexpr int blk_words() {
  return kBlk * kLdP + kBlk * (N + 4);
}
// of the t-side and the dB half: state slices (N, 32) or a block stage
template <int N>
__host__ __device__ constexpr int side_words() {
  return blk_words<N>() > N * kLdS ? blk_words<N>() : N * kLdS;
}
// of the dx half: (B, dh) slices or g whole
template <int N>
__host__ __device__ constexpr int dx_words() {
  return kWhole > kSliceWords + kSlice * kLdP ? kWhole
                                              : kSliceWords + kSlice * kLdP;
}

// Issues the cp.async group of a persistent (128, 64) tile of the chunk
// (rows past the chunk zero-filled) before a kernel's stage pipeline:
// the pipeline's first wait also waits for it.
__device__ __forceinline__ void load_whole(const float* src, long long sl,
                                           int valid, uint32_t* dst) {
  Stage st;
  st.t[0] = tile(src, sl, kQ, kP, valid, 0);
  st.n = 1;
  stage_issue(st, dst);
  tf32::cp_async_commit();
}

// ------------------------------------------------------------ 2. S'
// S' = C B^T of one (chunk, batch, group), the causal tiles the side
// kernels read (u tiles at or before each 16-row block of t), into sbuf as
// S' and as S'^T: both side kernels read these same values, so the row and
// column sums of A' = S' o E o G take S' alike. A CTA per 16-row block of
// t, its warp w the column tiles w and w + 8.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_cb_tf32x3_kernel(Args a) {
  constexpr int NS = N / kSlice;
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ic = blockIdx.x, b = blockIdx.y;
  const int grp = blockIdx.z / 8, rb = blockIdx.z % 8;
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const int r0 = 16 * rb, nmax = 2 * rb + 1;
  const float* Bm = a.b + b * a.b_sb + p0 * a.b_sl + grp * N;
  const float* Cm = a.c + b * a.c_sb + p0 * a.c_sl + grp * N;
  auto prog = [&](int k) {
    Stage st;
    st.t[0] = tile(Cm + kSlice * k, a.c_sl, kQ, kSlice, valid, 0);
    st.t[1] = tile(Bm + kSlice * k, a.b_sl, kQ, kSlice, valid, kSliceWords);
    st.n = 2;
    return st;
  };
  auto pipe = make_pipe<3>(smem, 2 * kSliceWords, NS, prog);
  float sp[2][4] = {};
  for (int k = 0; k < NS; ++k) {
    const uint32_t* Ct = pipe.next();
    const uint32_t* Bt = Ct + kSliceWords;
#pragma unroll
    for (int kk = 0; kk < kSlice / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_rows<kLdS>(Ct, r0, 8 * kk, ah, al);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (warp + 8 * j > nmax) continue;
        uint32_t bh[2], bl[2];
        b_rows<kLdS>(Bt, 8 * (warp + 8 * j), 8 * kk, bh, bl);
        mma3(sp[j], ah, al, bh, bl);
      }
    }
  }
  const long long bgc = ((long long)b * a.G + grp) * a.nc + ic;
  float* S = a.sbuf + bgc * kQ * kQ;
  float* ST = a.sbuf + ((long long)a.B * a.G * a.nc + bgc) * kQ * kQ;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (warp + 8 * j > nmax) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf, u = 8 * (warp + 8 * j) + 2 * t;
      *reinterpret_cast<float2*>(S + row * kQ + u) =
          make_float2(sp[j][2 * hf], sp[j][2 * hf + 1]);
      ST[u * kQ + row] = sp[j][2 * hf];
      ST[(u + 1) * kQ + row] = sp[j][2 * hf + 1];
    }
  }
}

// ------------------------------------------------------------ 3. t-side
template <int N>
__global__ void __launch_bounds__(kThreads, kSideCtas)
    ssd_bwd_t_tf32x3_kernel(Args a) {
  constexpr int NP = kP / kSlice;
  constexpr int kWords = side_words<N>();
  constexpr int kLdN = N + 4;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* gs = smem;                       // g, whole
  uint32_t* bufs = gs + kWhole;
  float* sv = reinterpret_cast<float*>(bufs + kSideStages * kWords);
  float* dv = sv + kQ;
  float* colpart = dv + kQ;   // (8 warps, kQ): colsum A' over a warp's rows

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ic = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const int rb = row_block(warp);
  const int r0 = 16 * rb, t0 = r0 + g, t1 = t0 + 8;
  const int nmax = 2 * rb + 1;
  const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
  const long long nrow = (long long)a.B * a.H * a.nc * kQ;
  const long long g_sl = (long long)a.H * kP;
  const float* gm = a.dy + ((long long)b * a.L + p0) * g_sl + h * kP;
  const float* xm = a.x + b * a.x_sb + p0 * a.x_sl + h * kP;
  const float* hin = a.states + bhc * N * kP;
  const float* Bm = a.b + b * a.b_sb + p0 * a.b_sl + grp * N;
  const float* Cm = a.c + b * a.c_sb + p0 * a.c_sl + grp * N;

  // g whole; stages: NP head-dim slices of h_in, then per block of 32 u
  // rows, x's and B's rows
  load_whole(gm, g_sl, valid, gs);
  auto prog = [&](int s) {
    Stage st;
    if (s < NP) {
      st.t[0] = tile(hin + kSlice * s, kP, N, kSlice, N, 0);
      st.n = 1;
      return st;
    }
    const int ub = s - NP, v = valid - kBlk * ub;
    const int r = v > 0 ? kBlk * ub : 0;   // an address in the tensor
    st.t[0] = tile(xm + r * a.x_sl, a.x_sl, kBlk, kP, v, 0);
    st.t[1] = tile(Bm + r * a.b_sl, a.b_sl, kBlk, N, v, kBlk * kLdP);
    st.n = 2;
    return st;
  };
  auto pipe = make_pipe<kSideStages>(bufs, kWords, NP + kQ / kBlk, prog);
  load_decay(a, bhc, sv, dv);
  for (int i = threadIdx.x; i < 8 * kQ; i += kThreads) colpart[i] = 0.f;

  // dC = g h_in^T over the head dim; g . (C h_in) = C . (g h_in^T); then
  // dC times exp(s_t)
  float dc[N / 8][4] = {};
  for (int k = 0; k < NP; ++k) {
    const uint32_t* Ht = pipe.next();
#pragma unroll
    for (int kk = 0; kk < kSlice / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_rows<kLdP>(gs, r0, kSlice * k + 8 * kk, ah, al);
#pragma unroll
      for (int c = 0; c < N / 8; ++c) {
        uint32_t bh[2], bl[2];
        b_rows<kLdS>(Ht, 8 * c, 8 * kk, bh, bl);
        mma3(dc[c], ah, al, bh, bl);
      }
    }
  }
  float dsi[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? t1 : t0;
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      if (row >= valid) continue;
      const float2 cv = *reinterpret_cast<const float2*>(
          Cm + row * a.c_sl + 8 * c + 2 * t);
      dsi[hf] += cv.x * dc[c][2 * hf] + cv.y * dc[c][2 * hf + 1];
    }
    dsi[hf] = quad_sum(dsi[hf]);
  }
  const float e0 = expf(sv[t0]), e1 = expf(sv[t1]);
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    dc[c][0] *= e0;
    dc[c][1] *= e0;
    dc[c][2] *= e1;
    dc[c][3] *= e1;
  }

  // per block of u: G = g x^T; A' = S' o E o G with S' from sbuf, its row
  // sums (times dt_u) and column sums (over the warp's rows here, then
  // the warps in order) from the same values; Pb = G o E dt_u; dC += Pb
  // B over the block's rows
  const float* S = a.sbuf + (((long long)b * a.G + grp) * a.nc + ic) *
                                kQ * kQ;
  float rowa[2] = {0.f, 0.f};
  for (int ub = 0; ub < kQ / kBlk; ++ub) {
    const uint32_t* Xt = pipe.next();
    const uint32_t* Bt = Xt + kBlk * kLdP;
    if (4 * ub > nmax) continue;     // the block lies past the warp's rows
    float gb[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kP / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_rows<kLdP>(gs, r0, 8 * kk, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * ub + j > nmax) continue;
        uint32_t bh[2], bl[2];
        b_rows<kLdP>(Xt, 8 * j, 8 * kk, bh, bl);
        mma3(gb[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * ub + j;
      if (n > nmax) continue;
      const float2 s0 = *reinterpret_cast<const float2*>(
          S + t0 * kQ + 8 * n + 2 * t);
      const float2 s1 = *reinterpret_cast<const float2*>(
          S + t1 * kQ + 8 * n + 2 * t);
      const float sp[4] = {s0.x, s0.y, s1.x, s1.y};
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? t0 : t1;
        const int u = 8 * n + 2 * t + (e & 1);
        const float ex = u <= row ? expf(sv[row] - sv[u]) : 0.f;
        const float ap = sp[e] * ex * gb[j][e];
        rowa[e >> 1] += ap * dv[u];
        cs[e & 1] += ap;
        gb[j][e] *= ex * dv[u];   // Pb = G o E dt_u
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {   // over the warp's rows
        cs[0] += __shfl_xor_sync(0xffffffffu, cs[0], o);
        cs[1] += __shfl_xor_sync(0xffffffffu, cs[1], o);
      }
      if (g == 0)
        *reinterpret_cast<float2*>(colpart + warp * kQ + 8 * n + 2 * t) =
            make_float2(cs[0], cs[1]);
      uint32_t ah[4], al[4];
      split_scores(gb[j], ah, al);
#pragma unroll
      for (int c = 0; c < N / 8; ++c) {
        uint32_t bh[2], bl[2];
        b_cols<kLdN>(Bt, 8 * j, 8 * c, bh, bl);
        mma3(dc[c], ah, al, bh, bl);
      }
    }
  }
  rowa[0] = quad_sum(rowa[0]);
  rowa[1] = quad_sum(rowa[1]);
  __syncthreads();   // every warp's column sums are in

  // the head's dC part and the row terms rowsum(A' dt_u), g . (C h_in),
  // colsum A'
  const int Lp = a.nc * a.Q;
  float* part = a.dc_part + (((long long)b * a.H + h) * Lp + p0) * N;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? t1 : t0;
    if (t == 0) {
      a.rows[bhc * kQ + row] = rowa[hf];
      a.rows[nrow + bhc * kQ + row] = dsi[hf];
    }
    if (row >= valid) continue;
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
      *reinterpret_cast<float2*>(part + (long long)row * N + 8 * c + 2 * t) =
          make_float2(dc[c][2 * hf], dc[c][2 * hf + 1]);
  }
  if (threadIdx.x < kQ) {
    float cs = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) cs += colpart[w * kQ + threadIdx.x];
    a.rows[2 * nrow + bhc * kQ + threadIdx.x] = cs;
  }
}

// ------------------------------------------------------------ 4. dx half
template <int N>
__global__ void __launch_bounds__(kThreads, kSideCtas)
    ssd_bwd_u_tf32x3_kernel(Args a) {
  constexpr int NS = N / kSlice;
  constexpr int kWords = dx_words<N>();
  extern __shared__ __align__(16) uint32_t smem[];
  float* sv = reinterpret_cast<float*>(smem + kSideStages * kWords);
  float* dv = sv + kQ;
  float* tmp = dv + kQ;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ic = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const int rb = row_block(warp);
  const int r0 = 16 * rb, u0 = r0 + g, u1 = u0 + 8;
  const int nmin = 2 * rb;       // t tiles at or after the warp's rows
  const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
  const long long nrow = (long long)a.B * a.H * a.nc * kQ;
  const long long g_sl = (long long)a.H * kP;
  const float* gm = a.dy + ((long long)b * a.L + p0) * g_sl + h * kP;
  const float* xm = a.x + b * a.x_sb + p0 * a.x_sl + h * kP;
  const float* dh = a.dstates + bhc * N * kP;
  const float* Bm = a.b + b * a.b_sb + p0 * a.b_sl + grp * N;

  // stages: NS d_state slices of (B, dh rows), then g whole
  auto prog = [&](int s) {
    Stage st;
    if (s < NS) {
      st.t[0] = tile(Bm + kSlice * s, a.b_sl, kQ, kSlice, valid, 0);
      st.t[1] = tile(dh + kSlice * s * kP, kP, kSlice, kP, kSlice,
                     kSliceWords);
      st.n = 2;
    } else {
      st.t[0] = tile(gm, g_sl, kQ, kP, valid, 0);
      st.n = 1;
    }
    return st;
  };
  auto pipe = make_pipe<kSideStages>(smem, kWords, NS + 1, prog);
  load_decay(a, bhc, sv, dv);

  // B dh
  float bdh[8][4] = {};
  for (int k = 0; k < NS; ++k) {
    const uint32_t* Bt = pipe.next();
    const uint32_t* Dt = Bt + kSliceWords;
#pragma unroll
    for (int kk = 0; kk < kSlice / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_perm<kLdS>(Bt, r0, 8 * kk, ah, al);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t bh[2], bl[2];
        b_cols<kLdP>(Dt, 8 * kk, 8 * c, bh, bl);
        mma3(bdh[c], ah, al, bh, bl);
      }
    }
  }
  // Q1 = (S'^T o E^T) g, S'^T from sbuf
  const float sQ = sv[a.Q - 1];
  float q1[8][4] = {};
  {
    const float* ST = a.sbuf + ((long long)a.B * a.G * a.nc +
                                ((long long)b * a.G + grp) * a.nc + ic) *
                                   kQ * kQ;
    const uint32_t* Gt = pipe.next();
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (n < nmin) continue;
      const float2 s0 = *reinterpret_cast<const float2*>(
          ST + u0 * kQ + 8 * n + 2 * t);
      const float2 s1 = *reinterpret_cast<const float2*>(
          ST + u1 * kQ + 8 * n + 2 * t);
      const float sp[4] = {s0.x, s0.y, s1.x, s1.y};
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? u0 : u1;
        const int tc = 8 * n + 2 * t + (e & 1);
        const float ex = tc >= row ? expf(sv[tc] - sv[row]) : 0.f;
        m[e] = sp[e] * ex;
      }
      uint32_t ah[4], al[4];
      split_scores(m, ah, al);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t bh[2], bl[2];
        b_cols<kLdP>(Gt, 8 * n, 8 * c, bh, bl);
        mma3(q1[c], ah, al, bh, bl);
      }
    }
  }
  // dx = dt_u Q1 + w (B dh) + D g; beta = x . (B dh); the chunk's dD part
  // g . x
  const float D = a.d[h];
  float gx = 0.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? u1 : u0;
    const bool live = row < valid;
    const float du = dv[row];
    const float w = expf(sQ - sv[row]) * du;
    float be = 0.f;
    const float* xr = xm + row * a.x_sl;
    const float* gr = gm + row * g_sl;
    float* dxr = a.dx + (((long long)b * a.L + p0 + row) * a.H + h) * kP;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (!live) continue;
      const int col = 8 * c + 2 * t;
      const float2 xv = *reinterpret_cast<const float2*>(xr + col);
      const float2 gv = *reinterpret_cast<const float2*>(gr + col);
      const float qa = q1[c][2 * hf], qb = q1[c][2 * hf + 1];
      const float ba = bdh[c][2 * hf], bb = bdh[c][2 * hf + 1];
      be += xv.x * ba + xv.y * bb;
      gx += xv.x * gv.x + xv.y * gv.y;
      *reinterpret_cast<float2*>(dxr + col) =
          make_float2(du * qa + w * ba + D * gv.x,
                      du * qb + w * bb + D * gv.y);
    }
    be = quad_sum(be);
    if (t == 0) a.rows[3 * nrow + bhc * kQ + row] = be;
  }
  const float gx_sum = block_sum(gx, tmp);
  if (threadIdx.x == 0) a.dd_part[bhc] = gx_sum;
}

// ------------------------------------------------------------ 5. dB half
template <int N>
__global__ void __launch_bounds__(kThreads, kSideCtas)
    ssd_bwd_db_tf32x3_kernel(Args a) {
  constexpr int NP = kP / kSlice;
  constexpr int kWords = side_words<N>();
  constexpr int kLdN = N + 4;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;                       // x, whole
  uint32_t* bufs = xs + kWhole;
  float* sv = reinterpret_cast<float*>(bufs + kSideStages * kWords);
  float* dv = sv + kQ;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ic = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const int rb = row_block(warp);
  const int r0 = 16 * rb, u0 = r0 + g, u1 = u0 + 8;
  const int nmin = 2 * rb;
  const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
  const long long g_sl = (long long)a.H * kP;
  const float* gm = a.dy + ((long long)b * a.L + p0) * g_sl + h * kP;
  const float* xm = a.x + b * a.x_sb + p0 * a.x_sl + h * kP;
  const float* dh = a.dstates + bhc * N * kP;
  const float* Cm = a.c + b * a.c_sb + p0 * a.c_sl + grp * N;

  // x whole; stages: NP head-dim slices of dh, then per block of 32 t
  // rows, g's and C's rows
  load_whole(xm, a.x_sl, valid, xs);
  auto prog = [&](int s) {
    Stage st;
    if (s < NP) {
      st.t[0] = tile(dh + kSlice * s, kP, N, kSlice, N, 0);
      st.n = 1;
      return st;
    }
    const int tb = s - NP, v = valid - kBlk * tb;
    const int r = v > 0 ? kBlk * tb : 0;   // an address in the tensor
    st.t[0] = tile(gm + r * g_sl, g_sl, kBlk, kP, v, 0);
    st.t[1] = tile(Cm + r * a.c_sl, a.c_sl, kBlk, N, v, kBlk * kLdP);
    st.n = 2;
    return st;
  };
  auto pipe = make_pipe<kSideStages>(bufs, kWords, NP + kQ / kBlk, prog);
  load_decay(a, bhc, sv, dv);

  // dB = x dh^T over the head dim, then times w
  float db[N / 8][4] = {};
  for (int k = 0; k < NP; ++k) {
    const uint32_t* Ht = pipe.next();
#pragma unroll
    for (int kk = 0; kk < kSlice / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_rows<kLdP>(xs, r0, kSlice * k + 8 * kk, ah, al);
#pragma unroll
      for (int c = 0; c < N / 8; ++c) {
        uint32_t bh[2], bl[2];
        b_rows<kLdS>(Ht, 8 * c, 8 * kk, bh, bl);
        mma3(db[c], ah, al, bh, bl);
      }
    }
  }
  {
    const float sQ = sv[a.Q - 1];
    const float w0 = expf(sQ - sv[u0]) * dv[u0];
    const float w1 = expf(sQ - sv[u1]) * dv[u1];
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      db[c][0] *= w0;
      db[c][1] *= w0;
      db[c][2] *= w1;
      db[c][3] *= w1;
    }
  }
  // per block of t: G^T = x g^T, Pb^T = G^T o E^T dt_u, dB += Pb^T C over
  // the block's rows
  for (int tb = 0; tb < kQ / kBlk; ++tb) {
    const uint32_t* Gt = pipe.next();
    const uint32_t* Ct = Gt + kBlk * kLdP;
    if (4 * tb + 3 < nmin) continue;   // the block lies before the warp's
    float gt[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kP / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_rows<kLdP>(xs, r0, 8 * kk, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * tb + j < nmin) continue;
        uint32_t bh[2], bl[2];
        b_rows<kLdP>(Gt, 8 * j, 8 * kk, bh, bl);
        mma3(gt[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * tb + j;
      if (n < nmin) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? u0 : u1;
        const int tc = 8 * n + 2 * t + (e & 1);
        const float ex = tc >= row ? expf(sv[tc] - sv[row]) : 0.f;
        gt[j][e] *= ex * dv[row];
      }
      uint32_t ah[4], al[4];
      split_scores(gt[j], ah, al);
#pragma unroll
      for (int c = 0; c < N / 8; ++c) {
        uint32_t bh[2], bl[2];
        b_cols<kLdN>(Ct, 8 * j, 8 * c, bh, bl);
        mma3(db[c], ah, al, bh, bl);
      }
    }
  }
  const int Lp = a.nc * a.Q;
  float* part = a.db_part + (((long long)b * a.H + h) * Lp + p0) * N;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? u1 : u0;
    if (row >= valid) continue;
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
      *reinterpret_cast<float2*>(part + (long long)row * N + 8 * c + 2 * t) =
          make_float2(db[c][2 * hf], db[c][2 * hf + 1]);
  }
}

template <int N>
int launch_bwd(const Args& a, cudaStream_t s) {
  const ssd90::Args a90 = args90(a);
  ssd90::ssd90_decay_kernel<<<dim3(a.nc, a.B, (a.H + 3) / 4), 128, 0, s>>>(
      a90);
  const int st_smem = smem_bytes(kStateStages, state_words<N>());
  int rc = set_smem(ssd_state_tf32x3_kernel<false, N>, st_smem);
  if (rc) return rc;
  ssd_state_tf32x3_kernel<false, N>
      <<<dim3(a.nc, a.B, a.H), kThreads, st_smem, s>>>(a);
  ssd90::ssd90_pass_kernel<true, N>
      <<<dim3(ssd90::Dims<N>::kPassBlocks, a.B * a.H), ssd90::kPassThreads,
         0, s>>>(a90, a.dstates, a.states);
  const int cb_smem = smem_bytes(3, 2 * kSliceWords);
  rc = set_smem(ssd_cb_tf32x3_kernel<N>, cb_smem);
  if (rc) return rc;
  ssd_cb_tf32x3_kernel<N>
      <<<dim3(a.nc, a.B, 8 * a.G), kThreads, cb_smem, s>>>(a);
  const dim3 grid(a.nc, a.B, a.H);
  const int side_smem = smem_bytes(kSideStages, side_words<N>()) +
                        kWhole * 4;
  rc = set_smem(ssd_bwd_t_tf32x3_kernel<N>, side_smem);
  if (rc) return rc;
  ssd_bwd_t_tf32x3_kernel<N><<<grid, kThreads, side_smem, s>>>(a);
  const int dx_smem = smem_bytes(kSideStages, dx_words<N>());
  rc = set_smem(ssd_bwd_u_tf32x3_kernel<N>, dx_smem);
  if (rc) return rc;
  ssd_bwd_u_tf32x3_kernel<N><<<grid, kThreads, dx_smem, s>>>(a);
  rc = set_smem(ssd_bwd_db_tf32x3_kernel<N>, side_smem);
  if (rc) return rc;
  ssd_bwd_db_tf32x3_kernel<N><<<grid, kThreads, side_smem, s>>>(a);
  ssd90::ssd90_ds_kernel<N><<<dim3(a.nc, a.B * a.H), kQ, 0, s>>>(a90);
  const long long n_bc = (long long)a.B * a.L * a.G * N / 4;  // float4s
  const long long want = n_bc * kReduceLanes / kThreads + 1;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  const int Lp = a.nc * a.Q;
  ssd_reduce_bc_tf32x3_kernel<N><<<blocks, kThreads, 0, s>>>(
      a.db_part, a.db, a.B, a.L, Lp, a.H, a.G);
  ssd_reduce_bc_tf32x3_kernel<N><<<blocks, kThreads, 0, s>>>(
      a.dc_part, a.dc, a.B, a.L, Lp, a.H, a.G);
  ssd90::ssd90_reduce_heads_kernel<<<(a.H + 63) / 64, 64, 0, s>>>(a90);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssdtf
}  // namespace pam

// fp32 x (B, L, H, 64), b and c (B, L, G, N) with any batch and sequence
// strides (elements; last two axes contiguous, base and strides 16-byte
// aligned); fp32 dt (B, L, H), a and d (H,); states (B, H, nc, N, 64) fp32
// from the forward; dy (B, L, H, 64) contiguous. Outputs dx like dy, ddt
// (B, L, H), da and dd (H,), db and dc (B, L, G, N), all fp32 contiguous.
// Scratch (fp32): dec (2, B, H, nc, 128), dstates like states, frob (B, H,
// nc, N / 2), rows (4, B, H, nc, 128), sbuf (2, B, G, nc, 128, 128),
// db_part and dc_part (B, H, nc Q, N), da_part and dd_part (B, H, nc).
// Returns 0, a CUDA error code, or -1 for a bad shape or an N outside
// PAM_SSD90_BUILT_N.
extern "C" int pam_ssd_scan_bwd_tf32x3(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* states, const void* dy,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dd, void* dec,
    void* dstates, void* frob, void* rows, void* sbuf, void* db_part,
    void* dc_part, void* da_part, void* dd_part, int B, int L, int H, int G,
    int Q, int nc, int N, long long x_sb, long long x_sl, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, void* stream) {
  using namespace pam::ssdtf;
  if (Q < 1 || Q > kQ || H % G) return -1;
  Args args = {};
  args.x = static_cast<const float*>(x);
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = static_cast<const float*>(b);
  args.c = static_cast<const float*>(c);
  args.d = static_cast<const float*>(d);
  args.states = static_cast<float*>(const_cast<void*>(states));
  args.dy = static_cast<const float*>(dy);
  args.dx = static_cast<float*>(dx);
  args.ddt = static_cast<float*>(ddt);
  args.da = static_cast<float*>(da);
  args.db = static_cast<float*>(db);
  args.dc = static_cast<float*>(dc);
  args.dd = static_cast<float*>(dd);
  args.dec = static_cast<const float*>(dec);
  args.dstates = static_cast<float*>(dstates);
  args.frob = static_cast<float*>(frob);
  args.rows = static_cast<float*>(rows);
  args.sbuf = static_cast<float*>(sbuf);
  args.db_part = static_cast<float*>(db_part);
  args.dc_part = static_cast<float*>(dc_part);
  args.da_part = static_cast<float*>(da_part);
  args.dd_part = static_cast<float*>(dd_part);
  args.x_sb = x_sb;
  args.x_sl = x_sl;
  args.b_sb = b_sb;
  args.b_sl = b_sl;
  args.c_sb = c_sb;
  args.c_sl = c_sl;
  args.B = B;
  args.L = L;
  args.H = H;
  args.G = G;
  args.Q = Q;
  args.nc = nc;
  args.hb = 1;
  auto s = static_cast<cudaStream_t>(stream);
#define PAM_SSDTF_BWD_CASE(NS) \
  if (N == NS) return launch_bwd<NS>(args, s);
  PAM_SSD90_BUILT_N(PAM_SSDTF_BWD_CASE)
#undef PAM_SSDTF_BWD_CASE
  return -1;
}
