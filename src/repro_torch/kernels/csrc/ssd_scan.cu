// Mamba-2 SSD chunked scan, forward.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (wrapper
// ssd_scan, pl.pallas_call at :121). The TPU kernel runs the grid (B, H,
// n_chunks) with the chunk axis sequential and carries the (N, P) state in
// VMEM scratch; here one CUDA block per (head, batch) walks its chunks in
// order and keeps the state in shared memory. Per chunk of Q tokens, with
// s_t the in-chunk prefix sum of dt a:
//
//   y_t   = exp(s_t) C_t h_in + sum_{u <= t} (C_t . B_u) exp(s_t - s_u)
//           dt_u x_u + D x_t
//   h_out = exp(s_Q) h_in + sum_u exp(s_Q - s_u) dt_u B_u x_u^T
//
// Every decay is formed as exp(difference), masked before the exp. Tokens
// at or past the sequence length get dt = 0, so they leave the state
// unchanged, and are never written. x, B and C are read through their
// batch and sequence strides, so the views of the conv output that
// ssm_forward passes need no copy; the group of head h is h / (H / G).
// Besides y (the input dtype) the kernel writes each chunk's starting
// state h_in, (B, H, n_chunks, N, P) fp32, which the backward reads.
//
// This kernel takes fp32 operands (the parity runs); bf16 runs on the
// wgmma kernel (ssd_scan_sm90.cu). It runs the products on the CUDA cores
// in fp32: the C B^T and C h_in products stream d_state in slices of 32 so
// that x, the state, the masked Q x Q scores and two slices fit in 165 KiB
// of shared memory.
#include "ssd_common.cuh"

namespace pam {
namespace ssd {

struct FwdArgs {
  const void* x;   // (B, L, H, P), strides x_sb, x_sl
  const float* dt; // (B, L, H) post-softplus
  const float* a;  // (H,) negative
  const void* b;   // (B, L, G, N), strides b_sb, b_sl
  const void* c;   // (B, L, G, N), strides c_sb, c_sl
  const float* d;  // (H,)
  void* y;         // (B, L, H, P) contiguous, the input dtype
  float* states;   // (B, H, nc, N, P) chunk-start states
  int B, L, H, G, Q, nc;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

constexpr int kFwdSmemFloats =
    kN * kLdP + kQ * kLdP + kQ * kLdQ + 2 * kQ * kLdS + 4 * kQ + 8;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  float* hs = smem;              // kN x kLdP   running state
  float* xs = hs + kN * kLdP;    // kQ x kLdP   x of the chunk
  float* Ss = xs + kQ * kLdP;    // kQ x kLdQ   masked scores
  float* Cs = Ss + kQ * kLdQ;    // kQ x kLdS   C, one d_state slice
  float* Bs = Cs + kQ * kLdS;    // kQ x kLdS   B, the same slice
  float* sv = Bs + kQ * kLdS;
  float* ev = sv + kQ;
  float* wv = ev + kQ;
  float* dv = wv + kQ;
  float* tmp = dv + kQ;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int Q = a.Q;
  const float A = a.a[h];
  const float D = a.d[h];
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * kP;
  const T* bm = static_cast<const T*>(a.b) + b * a.b_sb + g * kN;
  const T* cm = static_cast<const T*>(a.c) + b * a.c_sb + g * kN;
  const float* dt = a.dt + (long long)b * a.L * a.H + h;
  T* y = static_cast<T*>(a.y) + (long long)b * a.L * a.H * kP + h * kP;
  const long long y_sl = (long long)a.H * kP;
  float* states = a.states + ((long long)b * a.H + h) * a.nc * kN * kP;

  for (int i = threadIdx.x; i < kN * kLdP; i += kThreads) hs[i] = 0.f;

  for (int ic = 0; ic < a.nc; ++ic) {
    const int p0 = ic * Q;
    const int valid = min(Q, a.L - p0);
    __syncthreads();  // the previous chunk is done with every buffer
    float* st = states + (long long)ic * kN * kP;
    for (int i = threadIdx.x; i < kN * kP; i += kThreads)
      st[i] = hs[(i / kP) * kLdP + (i % kP)];
    chunk_decay(dt + (long long)p0 * a.H, a.H, valid, Q, A, sv, ev, wv, dv,
                tmp);
    load_rows<kP>(x + p0 * a.x_sl, a.x_sl, valid, xs, kLdP);
    const float e_last = expf(sv[Q - 1]);

    float S[8][8], Y[8][4];
    zero(S);
    zero(Y);
    for (int n0 = 0; n0 < kN; n0 += kNS) {
      load_rows<kNS>(cm + p0 * a.c_sl + n0, a.c_sl, valid, Cs, kLdS);
      load_rows<kNS>(bm + p0 * a.b_sl + n0, a.b_sl, valid, Bs, kLdS);
      __syncthreads();
      // S += C B^T and Y += C h_in over this slice of d_state
      mm(kNS, [&](int r, int k) { return Cs[r * kLdS + k]; },
         [&](int k, int col) { return Bs[col * kLdS + k]; }, S);
      mm(kNS, [&](int r, int k) { return Cs[r * kLdS + k]; },
         [&](int k, int col) { return hs[(n0 + k) * kLdP + col]; }, Y);
      __syncthreads();  // every thread has read these state rows
      // state rows n0 .. n0 + 31: h = exp(s_Q) h + sum_u B_u w_u x_u^T
      float U[2][4];
      zero(U);
      mm(Q, [&](int r, int k) { return Bs[k * kLdS + r] * wv[k]; },
         [&](int k, int col) { return xs[k * kLdP + col]; }, U);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = hs + (n0 + ty + 16 * i) * kLdP + tx + 16 * j;
          *hp = e_last * *hp + U[i][j];
        }
      __syncthreads();  // Cs / Bs are reloaded next
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = ty + 16 * i;
        const int u = tx + 16 * j;
        Ss[t * kLdQ + u] = S[i][j] * decay(sv, t, u, Q) * dv[u];
      }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Y[i][j] *= ev[ty + 16 * i];
    __syncthreads();
    mm(Q, [&](int r, int k) { return Ss[r * kLdQ + k]; },
       [&](int k, int col) { return xs[k * kLdP + col]; }, Y);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      if (t >= valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        y[(p0 + t) * y_sl + p] =
            from_float<T>(Y[i][j] + D * xs[t * kLdP + p]);
      }
    }
  }
}

template <typename T>
struct LaunchFwd {
  static void run(const FwdArgs& a, cudaStream_t stream) {
    const int smem = kFwdSmemFloats * static_cast<int>(sizeof(float));
    auto kernel = ssd_scan_fwd_kernel<T>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kernel<<<dim3(a.H, a.B), kThreads, smem, stream>>>(a);
  }
};

}  // namespace ssd
}  // namespace pam

// fp32 x, b, c and y. Returns 0, a CUDA error code from
// cudaGetLastError(), or -1 for an unsupported (N, P).
extern "C" int pam_ssd_scan_fwd(const void* x, const void* dt, const void* a,
                                const void* b, const void* c, const void* d,
                                void* y, void* states, int B, int L, int H,
                                int G, int Q, int nc, long long x_sb,
                                long long x_sl, long long b_sb,
                                long long b_sl, long long c_sb,
                                long long c_sl, int N, int P,
                                void* stream) {
  pam::ssd::FwdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.d = static_cast<const float*>(d);
  args.y = y;
  args.states = static_cast<float*>(states);
  args.B = B;
  args.L = L;
  args.H = H;
  args.G = G;
  args.Q = Q;
  args.nc = nc;
  args.x_sb = x_sb;
  args.x_sl = x_sl;
  args.b_sb = b_sb;
  args.b_sl = b_sl;
  args.c_sb = c_sb;
  args.c_sl = c_sl;
  return pam::ssd::dispatch<pam::ssd::LaunchFwd>(
      N, P, args, static_cast<cudaStream_t>(stream));
}
