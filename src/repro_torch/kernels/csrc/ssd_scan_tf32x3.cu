// Mamba-2 SSD chunked scan, forward, in fp32 on the tensor cores (3xTF32):
// fp32 x, B and C, d_state N = 128 (mamba2-780m) or 64 (zamba2-7b), head
// dim P = 64, chunks of up to 128 tokens.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (:36;
// wrapper ssd_scan, pl.pallas_call at :121) for fp32 operands with (N, P)
// = (128, 64) or (64, 64); bf16 runs ssd_scan_sm90.cu (wgmma), and
// kernels/ssd_scan.py::_variant picks one of the two (another (N, P)
// raises there, with no fallback). The TPU kernel walks the chunks of a
// (batch, head) in order and carries the state in VMEM; here every chunk
// runs on its own (ssd_tf32.cuh). Four kernels on one stream:
//   1. ssd90_decay_kernel (ssd_sm90.cuh): s_t and the masked dt;
//   2. ssd_state_tf32x3_kernel<true> (ssd_tf32.cuh): U_c = B^T (w o x)
//      per (chunk, batch, head);
//   3. ssd90_pass_kernel<false>: h_c+1 = exp(s_Q) h_c + U_c, fp32,
//      elementwise, in place over the states buffer;
//   4. ssd_out_tf32x3_kernel (below): y = exp(s_t) (C h_in) + (S o E dt_u)
//      x + D x per (chunk, batch, block of hb heads of one group).
// Besides y it writes the fp32 chunk-start states h_in, (B, H, nc, N, P),
// that the backward (ssd_scan_bwd_tf32x3.cu) reads.
//
// Bound on the H100: operations. At mamba2-780m's train_parity shape (B
// 2, L 500, H 48, chunk 128) the TPU kernel's products are 4.0e9 FLOPs:
// 3 x that over the 495 TFLOP/s TF32 peak is 0.024 ms, against 0.011 ms
// for x, B, C, y and the states at 3.35 TB/s; the CUDA-core kernel this
// replaces ran one CTA per (head, batch) over its chunks in order, 96
// CTAs on 132 SMs. The output kernel: eight warps, each a 16-row block of
// the chunk's rows t (row_block: the causal triangle balanced over the
// SM's sub-partitions). S = C B^T once per block of heads
// (d_state in four or two slices of 32 columns; tiles of u past the
// warp's last row skipped), kept in registers; then per head C h_in (C
// and h_in streamed again in slices: C as a row-major A, h_in by
// columns), M = S o E dt_u (masked before the exp) split in registers as
// the A operand of M x (x by columns), the decay rows staged with x. The
// head block (kernels/ssd_scan.py::_tf32x3_head_block) fills the 132 SMs:
// 3 at mamba2-780m's 48 heads (128 CTAs at B 2, L 500), 7 at zamba2-7b's
// 112. Every operand is split into its TF32 halves in registers as its
// fragment is loaded. Shared memory: four stage buffers of 36 KB; the
// registers of S (16 x 128 a warp) and Z hold one CTA an SM.
#include "ssd_tf32.cuh"

namespace pam {
namespace ssdtf {

// stage words: C and B slices (S), C slice and h_in rows (C h_in), or x
// and the decay rows (M x)
constexpr int kOutWords = 2 * kSliceWords;
constexpr int kOutStages = 4;
static_assert(kSliceWords + 32 * kLdP <= kOutWords, "C h_in stage");
static_assert(kQ * kLdP + 2 * kQ <= kOutWords, "x stage");

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_out_tf32x3_kernel(Args a) {
  constexpr int NS = N / kSlice;
  extern __shared__ __align__(16) uint32_t smem[];

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ic = blockIdx.x, b = blockIdx.y;
  const int h0 = blockIdx.z * a.hb;
  const int grp = h0 / (a.H / a.G);
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const int rb = row_block(warp);
  const int r0 = 16 * rb, t0 = r0 + g, t1 = t0 + 8;
  const int nmax = 2 * rb + 1;       // u tiles at or before the warp's rows
  const long long nrow = (long long)a.B * a.H * a.nc * kQ;
  const float* C = a.c + b * a.c_sb + p0 * a.c_sl + grp * N;
  const float* Bm = a.b + b * a.b_sb + p0 * a.b_sl + grp * N;

  // stages: NS slices of (C, B), then per head NS slices of (C, h_in
  // rows) and one of (x, s, dt)
  auto prog = [&](int s) {
    Stage st;
    if (s < NS) {
      st.t[0] = tile(C + kSlice * s, a.c_sl, kQ, kSlice, valid, 0);
      st.t[1] = tile(Bm + kSlice * s, a.b_sl, kQ, kSlice, valid,
                     kSliceWords);
      st.n = 2;
      return st;
    }
    const int j = (s - NS) / (NS + 1), k = (s - NS) % (NS + 1);
    const int h = h0 + j;
    const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
    if (k < NS) {
      st.t[0] = tile(C + kSlice * k, a.c_sl, kQ, kSlice, valid, 0);
      st.t[1] = tile(a.states + (bhc * N + kSlice * k) * kP, kP, kSlice, kP,
                     kSlice, kSliceWords);
      st.n = 2;
      return st;
    }
    st.t[0] = tile(a.x + b * a.x_sb + p0 * a.x_sl + h * kP, a.x_sl, kQ, kP,
                   valid, 0);
    st.t[1] = tile(a.dec + bhc * kQ, 0, 1, kQ, 1, kQ * kLdP);
    st.t[2] = tile(a.dec + nrow + bhc * kQ, 0, 1, kQ, 1, kQ * kLdP + kQ);
    st.n = 3;
    return st;
  };
  auto pipe = make_pipe<kOutStages>(smem, kOutWords, NS + a.hb * (NS + 1),
                                    prog);

  // S = C B^T over this warp's rows, all 128 columns u (tiles past nmax
  // stay 0 and are never read)
  float sacc[16][4] = {};
  for (int k = 0; k < NS; ++k) {
    const uint32_t* Ct = pipe.next();
    const uint32_t* Bt = Ct + kSliceWords;
#pragma unroll
    for (int kk = 0; kk < kSlice / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_rows<kLdS>(Ct, r0, 8 * kk, ah, al);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (n > nmax) continue;
        uint32_t bh[2], bl[2];
        b_rows<kLdS>(Bt, 8 * n, 8 * kk, bh, bl);
        mma3(sacc[n], ah, al, bh, bl);
      }
    }
  }

  for (int j = 0; j < a.hb; ++j) {
    const int h = h0 + j;
    // Z = C h_in
    float z[8][4] = {};
    for (int k = 0; k < NS; ++k) {
      const uint32_t* Ct = pipe.next();
      const uint32_t* Ht = Ct + kSliceWords;
#pragma unroll
      for (int kk = 0; kk < kSlice / 8; ++kk) {
        uint32_t ah[4], al[4];
        a_perm<kLdS>(Ct, r0, 8 * kk, ah, al);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          uint32_t bh[2], bl[2];
          b_cols<kLdP>(Ht, 8 * kk, 8 * c, bh, bl);
          mma3(z[c], ah, al, bh, bl);
        }
      }
    }
    // y = exp(s_t) Z + M x, M = S o E dt_u
    const uint32_t* Xt = pipe.next();
    const float* sv = reinterpret_cast<const float*>(Xt + kQ * kLdP);
    const float* dv = sv + kQ;
    const float e0 = expf(sv[t0]), e1 = expf(sv[t1]);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      z[c][0] *= e0;
      z[c][1] *= e0;
      z[c][2] *= e1;
      z[c][3] *= e1;
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (n > nmax) continue;
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? t0 : t1;
        const int u = 8 * n + 2 * t + (e & 1);
        const float ex = u <= row ? expf(sv[row] - sv[u]) : 0.f;
        m[e] = sacc[n][e] * ex * dv[u];
      }
      uint32_t ah[4], al[4];
      split_scores(m, ah, al);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t bh[2], bl[2];
        b_cols<kLdP>(Xt, 8 * n, 8 * c, bh, bl);
        mma3(z[c], ah, al, bh, bl);
      }
    }
    // + D x, for the chunk's live tokens
    const float D = a.d[h];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = hf ? t1 : t0;
      if (row >= valid) continue;
      const float* xr = a.x + b * a.x_sb + (p0 + row) * a.x_sl + h * kP;
      float* yr = a.y + (((long long)b * a.L + p0 + row) * a.H + h) * kP;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * t;
        const float2 xv = *reinterpret_cast<const float2*>(xr + col);
        *reinterpret_cast<float2*>(yr + col) =
            make_float2(z[c][2 * hf] + D * xv.x, z[c][2 * hf + 1] + D * xv.y);
      }
    }
  }
}

template <int N>
int launch_fwd(const Args& a, cudaStream_t s) {
  const ssd90::Args a90 = args90(a);
  ssd90::ssd90_decay_kernel<<<dim3(a.nc, a.B, (a.H + 3) / 4), 128, 0, s>>>(
      a90);
  const int st_smem = smem_bytes(kStateStages, state_words<N>());
  int rc = set_smem(ssd_state_tf32x3_kernel<true, N>, st_smem);
  if (rc) return rc;
  ssd_state_tf32x3_kernel<true, N>
      <<<dim3(a.nc, a.B, a.H), kThreads, st_smem, s>>>(a);
  ssd90::ssd90_pass_kernel<false, N>
      <<<dim3(ssd90::Dims<N>::kPassBlocks, a.B * a.H), ssd90::kPassThreads,
         0, s>>>(a90, a.states, nullptr);
  const int out_smem = smem_bytes(kOutStages, kOutWords);
  rc = set_smem(ssd_out_tf32x3_kernel<N>, out_smem);
  if (rc) return rc;
  ssd_out_tf32x3_kernel<N>
      <<<dim3(a.nc, a.B, a.H / a.hb), kThreads, out_smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssdtf
}  // namespace pam

// fp32 x (B, L, H, 64), b and c (B, L, G, N) with any batch and sequence
// strides (elements; the last two axes contiguous, base and strides
// 16-byte aligned); fp32 dt (B, L, H), a and d (H,); y (B, L, H, 64) and
// states (B, H, nc, N, 64), contiguous; dec fp32 scratch of (2, B, H, nc,
// 128). hb heads of one group per output CTA (hb divides H / G). Returns
// 0, a CUDA error code, or -1 for a bad shape or an N outside
// PAM_SSD90_BUILT_N.
extern "C" int pam_ssd_scan_fwd_tf32x3(const void* x, const void* dt,
                                       const void* a, const void* b,
                                       const void* c, const void* d, void* y,
                                       void* states, void* dec, int B, int L,
                                       int H, int G, int Q, int nc, int hb,
                                       int N, long long x_sb, long long x_sl,
                                       long long b_sb, long long b_sl,
                                       long long c_sb, long long c_sl,
                                       void* stream) {
  using namespace pam::ssdtf;
  if (Q < 1 || Q > kQ || hb < 1 || H % G || (H / G) % hb) return -1;
  Args args = {};
  args.x = static_cast<const float*>(x);
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = static_cast<const float*>(b);
  args.c = static_cast<const float*>(c);
  args.d = static_cast<const float*>(d);
  args.y = static_cast<float*>(y);
  args.states = static_cast<float*>(states);
  args.dec = static_cast<const float*>(dec);
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
  args.hb = hb;
  auto s = static_cast<cudaStream_t>(stream);
#define PAM_SSDTF_FWD_CASE(NS) \
  if (N == NS) return launch_fwd<NS>(args, s);
  PAM_SSD90_BUILT_N(PAM_SSDTF_FWD_CASE)
#undef PAM_SSDTF_FWD_CASE
  return -1;
}
