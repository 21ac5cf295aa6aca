// Mamba-2 SSD chunked scan, forward, for Hopper's tensor cores: bf16 x, B
// and C, d_state N = 128 (mamba2-780m) or 64 (zamba2-7b), head dim P = 64,
// chunks of up to 128 tokens.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (:36; wrapper
// ssd_scan, pl.pallas_call at :121) for bf16 operands with (N, P) = (128, 64)
// or (64, 64). fp32 runs the 3xTF32 tensor-core kernel of ssd_scan_tf32x3.cu;
// kernels/ssd_scan.py::_variant picks one of the two, and another (N, P) raises
// there, with no fallback. Computes what _ssd_kernel computes (formulas in
// ssd_sm90.cuh), and also writes the fp32 chunk-start states
// h_in, (B, H, nc, N, P), that the backward (ssd_scan_bwd_sm90.cu) reads.
//
// Bound on the H100: operations. At the training shape (B 4, L 2048, H 48,
// G 1, chunk 128) the TPU kernel's products are 3.2e10 FLOPs (0.033 ms at
// 989 TFLOP/s bf16) against about 0.1 GB of operands and output; at
// zamba2-7b's (B 2, L 2048, H 112, N 64) 2.25e10 FLOPs (0.023 ms) against
// about 0.12 GB (0.035 ms: there the bytes bound it).
//
// Design: the chunked SSD decomposition, four kernels on one stream, every
// chunk in parallel except an elementwise state pass.
//   1. ssd90_decay_kernel: s_t and the masked dt per (batch, head, chunk);
//   2. ssd90_chunk_state_kernel<true>: U_c = B^T (w o x) on wgmma, B^T
//      read MN-major from the swizzled B tile, w o x a hi / lo pair of
//      bf16 tiles (two products), per CTA a (chunk, batch, block of heads)
//      with the group's B tile loaded once;
//   3. ssd90_pass_kernel<false>: h_c+1 = exp(s_Q) h_c + U_c, fp32, in place
//      over the states buffer;
//   4. ssd90_out_kernel (below): one CTA per (chunk, batch, block of hb
//      heads of one group), two warpgroups of 64 tokens. S = C B^T once
//      with wgmma m64n128k16 (both tiles K-major, as Q K^T in
//      flash_attention_sm90.cu; N / 16 k-steps over d_state), kept in fp32
//      registers for all its heads;
//      then per head Y = exp(s_t) (C h_in) + (S o E dt_u) x + D x: h_in
//      staged as a hi / lo pair of bf16 tiles (C h_in two m64n64k16
//      products, B operand MN-major), M = S o E dt_u (masked before the
//      exp) rounded in registers to a hi / lo pair of bf16 A fragments (the
//      accumulator layout is the A-fragment layout, as P in
//      flash_attention_sm90.cu), x the MN-major B operand. x tiles come by
//      TMA two heads deep, each head's fp32 state by bulk copy one ahead.
// The hi / lo pairs keep y within the bf16 tolerance of the plain version
// where y is a small difference of large terms (slow decay), and the
// states within 1e-3 of their largest entry: one bf16 rounding of w o x,
// h_in or M does not (kernels/ssd_scan.py::_fwd_rounded models this).
// Shared memory of the output kernel at N = 128 (64): C, B 64 (32) KiB + x
// 2 x 16 KiB + h_in hi and lo 2 x 16 (8) KiB + h_in fp32 32 (16) KiB.
#include "ssd_sm90.cuh"

namespace pam {
namespace ssd90 {

namespace out {
template <int N>
constexpr int smem() {
  return 2 * Dims<N>::kSubs * kSubBytes /* C, B */ + 2 * kSubBytes /* x */ +
         2 * N * 128 /* h_in hi, lo */ +
         Dims<N>::kStateBytes /* h_in fp32, staged */ + 4 * kQ * 4 + 64;
}
}  // namespace out

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd90_out_kernel(const __grid_constant__ CUtensorMap tmX,
                     const __grid_constant__ CUtensorMap tmB,
                     const __grid_constant__ CUtensorMap tmC, Args a) {
  using namespace sm90;
  constexpr int kSubs = Dims<N>::kSubs;
  constexpr int kStateBytes = Dims<N>::kStateBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* Ct = reinterpret_cast<bf16*>(smem);   // (128, N): N / 64 sub-tiles
  bf16* Bt = Ct + kSubs * kQ * 64;
  bf16* Xt = Bt + kSubs * kQ * 64;            // 2 stages of (128, 64)
  bf16* Hh = Xt + 2 * kQ * 64;                // h_in hi, (N, P)
  bf16* Hl = Hh + N * 64;                     // h_in lo
  float* Fs = reinterpret_cast<float*>(Hl + N * 64);  // h_in fp32, staged
  float* raw = Fs + N * kP;                   // s_t, dt staged
  float* s2 = raw + 2 * kQ;
  float* dtv = s2 + kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dtv + kQ);  // CB, X[2], F

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int ic = blockIdx.x, b = blockIdx.y;
  const int h0 = blockIdx.z * a.hb;
  const int grp = h0 / (a.H / a.G);
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const uint32_t sbytes = a.Q * 128;

  if (a.Q < kQ) zero_smem(smem, (2 * kSubs + 2) * kSubBytes);
  const long long nrow = (long long)a.B * a.H * a.nc * kQ;
  // the next head's fp32 state and decay row, by bulk copy beside the
  // products of this one
  auto stage = [&](int j) {
    const long long bhc = ((long long)b * a.H + h0 + j) * a.nc + ic;
    bar_expect(bars + 3, kStateBytes + 2 * kQ * 4);
    bulk_load(Fs, a.states + bhc * N * kP, kStateBytes, bars + 3);
    bulk_load(raw, a.dec + bhc * kQ, kQ * 4, bars + 3);
    bulk_load(raw + kQ, a.dec + nrow + bhc * kQ, kQ * 4, bars + 3);
  };
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) bar_init(bars + i, 1);
    bar_fence_init();
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    stage(0);
    bar_expect(bars, 2 * kSubs * sbytes);
    for (int i = 0; i < kSubs; ++i) {
      tma_load4(Ct + i * kQ * 64, &tmC, bars, 64 * i, grp, p0, b);
      tma_load4(Bt + i * kQ * 64, &tmB, bars, 64 * i, grp, p0, b);
    }
    for (int j = 0; j < 2 && j < a.hb; ++j) {
      bar_expect(bars + 1 + j, sbytes);
      tma_load4(Xt + j * kQ * 64, &tmX, bars + 1 + j, 0, h0 + j, p0, b);
    }
  }

  // S = C B^T: this warpgroup's 64 tokens t x 128 tokens u, fp32
  float s[64];
  zero(s);
  bar_wait(bars, 0);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss_n128(s, desc_k(Ct, kQ, wg * 64, kk), desc_k(Bt, kQ, 0, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  const int r0 = 64 * wg + frag_row(t, 0);  // this thread's rows r0, r0 + 8
  for (int j = 0; j < a.hb; ++j) {
    const int h = h0 + j, st = j & 1;
    __syncthreads();  // the previous head is done with h_in and its x stage
    if (tid == 0 && j >= 1 && j + 1 < a.hb) {
      const int so = (j + 1) & 1;
      bar_expect(bars + 1 + so, sbytes);
      tma_load4(Xt + so * kQ * 64, &tmX, bars + 1 + so, 0, h + 1, p0, b);
    }
    bar_wait(bars + 3, j & 1);
    if (tid < kQ) {
      s2[tid] = raw[tid] * kLog2e;
      dtv[tid] = raw[kQ + tid];
    }
    state_to_tile<N>(Fs, Hh, Hl);
    fence_async_smem();
    __syncthreads();
    if (tid == 0 && j + 1 < a.hb) stage(j + 1);  // Fs and raw are read

    // Y = C h_in (hi + lo), then scaled by exp(s_t) per row
    float y[32];
    zero(y);
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_n64_mn(y, desc_k(Ct, kQ, wg * 64, kk), desc_mn(Hh, N, kk));
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_n64_mn(y, desc_k(Ct, kQ, wg * 64, kk), desc_mn(Hl, N, kk));
    wgmma_commit();

    // M = S o E dt_u beside the products, as hi / lo bf16 A fragments
    const float st0 = s2[r0], st1 = s2[r0 + 8];
    uint32_t mh[32], ml[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float m[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int v = 2 * i + k;
        const int row = r0 + 8 * ((v >> 1) & 1);
        const int u = frag_col(t, v);
        const float sr = ((v >> 1) & 1) ? st1 : st0;
        m[k] = u <= row ? s[v] * exp2f(sr - s2[u]) * dtv[u] : 0.f;
      }
      const __nv_bfloat162 hv = __floats2bfloat162_rn(m[0], m[1]);
      mh[i] = *reinterpret_cast<const uint32_t*>(&hv);
      const float2 back = __bfloat1622float2(hv);
      ml[i] = pack_bf16(m[0] - back.x, m[1] - back.y);
    }
    wgmma_wait<0>();
    fence_regs(y);
    const float e0 = exp2f(st0), e1 = exp2f(st1);
#pragma unroll
    for (int v = 0; v < 32; ++v) y[v] *= ((v >> 1) & 1) ? e1 : e0;

    // Y += M x (hi + lo)
    bar_wait(bars + 1 + st, (j >> 1) & 1);
    const bf16* xs = Xt + st * kQ * 64;
    fence_regs(y);
    fence_regs(mh);
    fence_regs(ml);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_n64_mn(y, mh + 4 * kk, desc_mn(xs, kQ, kk));
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_n64_mn(y, ml + 4 * kk, desc_mn(xs, kQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    fence_regs(mh);
    fence_regs(ml);

    // + D x, written in x's dtype for live tokens
    const float D = a.d[h];
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int row = r0 + 8 * ((v >> 1) & 1);
      if (row >= valid) continue;
      const int p = frag_col(t, v);
      const float2 xv = ld_pair(xs, row, p);
      *reinterpret_cast<__nv_bfloat162*>(
          a.y + (((long long)b * a.L + p0 + row) * a.H + h) * kP + p) =
          __floats2bfloat162_rn(y[v] + D * xv.x, y[v + 1] + D * xv.y);
    }
  }
}

}  // namespace ssd90
}  // namespace pam

namespace pam {
namespace ssd90 {

template <int N>
int launch_fwd(const Args& args, const void* x, const void* b,
               const void* c, const SeqStrides& sd, cudaStream_t s) {
  CUtensorMap tx, tb, tc;
  if (!make_seq_map(&tx, x, kP, args.H, args.L, args.B, sd.x_sl, sd.x_sb,
                    args.Q) ||
      !make_seq_map(&tb, b, N, args.G, args.L, args.B, sd.b_sl, sd.b_sb,
                    args.Q) ||
      !make_seq_map(&tc, c, N, args.G, args.L, args.B, sd.c_sl, sd.c_sb,
                    args.Q))
    return -2;
  launch_states<true, N>(args, tb, tx, s);
  const int smem = smem_with_align(out::smem<N>());
  cudaFuncSetAttribute(ssd90_out_kernel<N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ssd90_out_kernel<N><<<dim3(args.nc, args.B, args.H / args.hb), kThreads,
                         smem, s>>>(tx, tb, tc, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd90
}  // namespace pam

// bf16 x (B, L, H, 64), b and c (B, L, G, N) with any batch and sequence
// strides (elements; the last two axes contiguous, base and strides 16-byte
// aligned); fp32 dt (B, L, H), a and d (H,); y (B, L, H, 64) bf16 and states
// (B, H, nc, N, 64) fp32, contiguous; dec fp32 scratch of (2, B, H, nc,
// 128). hb heads of one group per CTA (hb divides H / G). Returns 0, a CUDA
// error code from cudaGetLastError(), -1 for a bad shape or an N outside
// PAM_SSD90_BUILT_N, or -2 if the driver refuses a tensor map.
extern "C" int pam_ssd_scan_fwd_sm90(const void* x, const void* dt,
                                     const void* a, const void* b,
                                     const void* c, const void* d, void* y,
                                     void* states, void* dec, int B, int L,
                                     int H, int G, int Q, int nc, int hb,
                                     int N, long long x_sb, long long x_sl,
                                     long long b_sb, long long b_sl,
                                     long long c_sb, long long c_sl,
                                     void* stream) {
  using namespace pam::ssd90;
  if (Q < 1 || Q > kQ || hb < 1 || H % G || (H / G) % hb) return -1;
  Args args = {};
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.d = static_cast<const float*>(d);
  args.y = static_cast<bf16*>(y);
  args.states = static_cast<float*>(states);
  args.dec = static_cast<float*>(dec);
  args.B = B;
  args.L = L;
  args.H = H;
  args.G = G;
  args.Q = Q;
  args.nc = nc;
  args.hb = hb;
  const pam::SeqStrides sd = {x_sb, x_sl, b_sb, b_sl, c_sb, c_sl};
  auto s = static_cast<cudaStream_t>(stream);
#define PAM_SSD90_FWD_CASE(NS) \
  if (N == NS) return launch_fwd<NS>(args, x, b, c, sd, s);
  PAM_SSD90_BUILT_N(PAM_SSD90_FWD_CASE)
#undef PAM_SSD90_FWD_CASE
  return -1;
}
