// Mamba-2 SSD chunked scan, backward: the gradients of ssd_scan.cu's y with
// respect to x, dt, a, B, C and D.
//
// The TPU package has no backward for repro/kernels/ssd_scan.py::
// _ssd_kernel (JAX cannot differentiate the Pallas call), so this is the
// port's own; its derivation is written out in ssd_scan.py::_bwd_plain,
// which it follows step by step. Three kernels on one stream:
//
//  1. ssd_dstate_kernel, one block per (head, batch), walks the chunks in
//     reverse and carries dh, the gradient of a chunk's final state, in
//     registers: dh_in = exp(s_Q) dh + sum_t exp(s_t) C_t g_t^T. It writes
//     each chunk's dh to `dstates`.
//  2. ssd_chunk_bwd_kernel, one block per (chunk, head, batch): with the
//     forward's chunk-start state h_in and this dh every chunk is
//     independent. It recomputes S' = C B^T and G = g x^T, keeps S' o E
//     and G o E dt_u (E the masked exp(s_t - s_u)) in shared memory, and
//     forms dx, the per-head partial dB and dC, ddt (through the reverse
//     in-chunk cumsum of ds) and per-chunk partials of da and dD.
//  3. ssd_reduce_bc_kernel / ssd_reduce_heads_kernel sum dB and dC over
//     the heads of each group, and da and dD over batch and chunks, in a
//     fixed order: no atomics, so the result is deterministic.
//
// Padded tokens (at or past the sequence length) have dt = 0 and zero
// operands, and nothing is written for them.
//
// Bound on the H100: operations, about 2.4x the forward's (S', G and the
// four Q x Q x {N, P} products, plus four Q x N x P products). As the
// forward, it takes fp32 operands (bf16 runs on ssd_scan_bwd_sm90.cu) and
// runs everything on the CUDA cores in fp32; the chunk kernel
// keeps two Q x Q fp32 tiles, g and x in 203 KiB of shared memory and
// streams d_state in slices of 32 through the space of the first tile.
#include "ssd_common.cuh"

namespace pam {
namespace ssd {

struct BwdArgs {
  const void* x;       // (B, L, H, P), strides x_sb, x_sl
  const float* dt;     // (B, L, H)
  const float* a;      // (H,)
  const void* b;       // (B, L, G, N), strides b_sb, b_sl
  const void* c;       // (B, L, G, N), strides c_sb, c_sl
  const float* d;      // (H,)
  const float* states; // (B, H, nc, N, P) chunk-start states (forward)
  const void* dy;      // (B, L, H, P) contiguous
  void* dx;            // (B, L, H, P) contiguous, the input dtype
  float* ddt;          // (B, L, H)
  float* da;           // (H,)
  void* db;            // (B, L, G, N) contiguous, the input dtype
  void* dc;
  float* dd;           // (H,)
  float* dstates;      // (B, H, nc, N, P) scratch
  float* db_part;      // (B, H, nc * Q, N) scratch, per-head dB
  float* dc_part;
  float* da_part;      // (B, H, nc) scratch
  float* dd_part;
  int B, L, H, G, Q, nc;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// ------------------------------------------------------------ 1. dstates
constexpr int kDstateSmemFloats = kQ * kLdN + kQ * kLdP + 4 * kQ + 8;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_dstate_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* Cs = smem;             // kQ x kLdN   C of the chunk
  float* gs = Cs + kQ * kLdN;   // kQ x kLdP   dy of the chunk
  float* sv = gs + kQ * kLdP;
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
  const T* cm = static_cast<const T*>(a.c) + b * a.c_sb + g * kN;
  const T* dy = static_cast<const T*>(a.dy) + (long long)b * a.L * a.H * kP +
                h * kP;
  const long long dy_sl = (long long)a.H * kP;
  const float* dt = a.dt + (long long)b * a.L * a.H + h;
  float* dstates = a.dstates + ((long long)b * a.H + h) * a.nc * kN * kP;

  float dh[8][4];  // rows n = ty + 16 i, columns p = tx + 16 j
  zero(dh);
  for (int ic = a.nc - 1; ic >= 0; --ic) {
    float* out = dstates + (long long)ic * kN * kP;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(ty + 16 * i) * kP + tx + 16 * j] = dh[i][j];
    if (ic == 0) break;
    const int p0 = ic * Q;
    const int valid = min(Q, a.L - p0);
    __syncthreads();  // the previous chunk is done with Cs / gs
    chunk_decay(dt + (long long)p0 * a.H, a.H, valid, Q, a.a[h], sv, ev, wv,
                dv, tmp);
    load_rows<kN>(cm + p0 * a.c_sl, a.c_sl, valid, Cs, kLdN);
    load_rows<kP>(dy + p0 * dy_sl, dy_sl, valid, gs, kLdP);
    __syncthreads();
    const float e_last = expf(sv[Q - 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[i][j] *= e_last;
    mm(Q, [&](int r, int k) { return Cs[k * kLdN + r] * ev[k]; },
       [&](int k, int col) { return gs[k * kLdP + col]; }, dh);
  }
}

// ------------------------------------------------------------ 2. chunks
constexpr int kChunkSmemFloats =
    2 * kQ * kLdQ + 2 * kQ * kLdP + 9 * kQ + 8 * kQ + 16;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* Sb = smem;              // kQ x kLdQ  S' o E; later d_state slices
  float* Pb = Sb + kQ * kLdQ;    // kQ x kLdQ  G o E dt_u
  float* gs = Pb + kQ * kLdQ;    // kQ x kLdP  dy; first the S' slices
  float* xs = gs + kQ * kLdP;    // kQ x kLdP  x
  float* sv = xs + kQ * kLdP;
  float* ev = sv + kQ;
  float* wv = ev + kQ;
  float* dv = wv + kQ;
  float* rowA = dv + kQ;         // sum_u A[t, u]
  float* colA = rowA + kQ;       // sum_t A'[t, u]
  float* beta = colA + kQ;       // x_u . (B dh)_u
  float* dsi = beta + kQ;        // g_t . (C h_in)_t
  float* dsv = dsi + kQ;         // ds, then its reverse cumsum
  float* colpart = dsv + kQ;     // 8 x kQ, per-warp column sums
  float* tmp = colpart + 8 * kQ;   // 16: block sums, then scan offsets

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ic = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int Q = a.Q;
  const int p0 = ic * Q;
  const int valid = min(Q, a.L - p0);
  const float A = a.a[h];
  const float D = a.d[h];
  const long long bh = (long long)b * a.H + h;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + p0 * a.x_sl + h * kP;
  const T* bm = static_cast<const T*>(a.b) + b * a.b_sb + p0 * a.b_sl + g * kN;
  const T* cm = static_cast<const T*>(a.c) + b * a.c_sb + p0 * a.c_sl + g * kN;
  const long long row_hp = (long long)a.H * kP;
  const long long tok0 = (long long)b * a.L + p0;  // first token's row
  const T* dy = static_cast<const T*>(a.dy) + tok0 * row_hp + h * kP;
  const float* hin = a.states + (bh * a.nc + ic) * kN * kP;
  const float* dhs = a.dstates + (bh * a.nc + ic) * kN * kP;

  chunk_decay(a.dt + tok0 * a.H + h, a.H, valid, Q, A, sv, ev, wv, dv, tmp);
  const float s_last = sv[Q - 1];
  const float e_last = expf(s_last);

  // S' = C B^T over d_state slices (staged where g and x go next)
  float acc[8][8];
  zero(acc);
  {
    float* Cs = gs;
    float* Bs = gs + kQ * kLdS;
    for (int n0 = 0; n0 < kN; n0 += kNS) {
      load_rows<kNS>(cm + n0, a.c_sl, valid, Cs, kLdS);
      load_rows<kNS>(bm + n0, a.b_sl, valid, Bs, kLdS);
      __syncthreads();
      mm(kNS, [&](int r, int k) { return Cs[r * kLdS + k]; },
         [&](int k, int col) { return Bs[col * kLdS + k]; }, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = ty + 16 * i;
      const int u = tx + 16 * j;
      Sb[t * kLdQ + u] = acc[i][j] * decay(sv, t, u, Q);
    }

  // G = g x^T; A' = S' o E o G; Pb = G o E dt_u
  load_rows<kP>(dy, row_hp, valid, gs, kLdP);
  load_rows<kP>(x, a.x_sl, valid, xs, kLdP);
  __syncthreads();
  zero(acc);
  mm(kP, [&](int r, int k) { return gs[r * kLdP + k]; },
     [&](int k, int col) { return xs[col * kLdP + k]; }, acc);
  float rowp[8], colp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rowp[i] = colp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = ty + 16 * i;
      const int u = tx + 16 * j;
      const float ap = Sb[t * kLdQ + u] * acc[i][j];
      Pb[t * kLdQ + u] = acc[i][j] * decay(sv, t, u, Q) * dv[u];
      rowp[i] += ap * dv[u];
      colp[j] += ap;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float r = half_sum(rowp[i]);
    if (tx == 0) rowA[ty + 16 * i] = r;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // the warp's two rows ty, then 8 warps
    const float cpart = colp[j] + __shfl_xor_sync(0xffffffffu, colp[j], 16);
    if ((tid & 31) < 16) colpart[(tid >> 5) * kQ + tx + 16 * j] = cpart;
  }

  // dD partial; dx = (S' o E dt_u)^T g (+ the state and skip terms below)
  float gx = 0.f;
  for (int idx = tid; idx < kQ * kP; idx += kThreads) {
    const int r = idx / kP;
    const int col = idx - r * kP;
    gx += gs[r * kLdP + col] * xs[r * kLdP + col];
  }
  const float gx_sum = block_sum(gx, tmp);  // its barriers publish Pb too
  if (tid < kQ) {
    float cs = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) cs += colpart[w * kQ + tid];
    colA[tid] = cs;
  }
  float dxa[8][4];
  zero(dxa);
  mm(Q, [&](int r, int k) { return Sb[k * kLdQ + r]; },
     [&](int k, int col) { return gs[k * kLdP + col]; }, dxa);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dxa[i][j] *= dv[ty + 16 * i];
  __syncthreads();  // Sb is reused for the d_state slices

  // per d_state slice: B dh, C h_in, <dh, h_in>, dC and dB
  float* Bsl = Sb;                  // kQ x kLdS
  float* Csl = Bsl + kQ * kLdS;     // kQ x kLdS
  float* Hsl = Csl + kQ * kLdS;     // kNS x kLdP  h_in rows
  float* Dsl = Hsl + kNS * kLdP;    // kNS x kLdP  dh rows
  float bdh[8][4], chin[8][4];
  zero(bdh);
  zero(chin);
  float frob = 0.f;
  float* dbp = a.db_part + (bh * a.nc * Q + p0) * kN;
  float* dcp = a.dc_part + (bh * a.nc * Q + p0) * kN;
  for (int n0 = 0; n0 < kN; n0 += kNS) {
    load_rows<kNS>(bm + n0, a.b_sl, valid, Bsl, kLdS);
    load_rows<kNS>(cm + n0, a.c_sl, valid, Csl, kLdS);
    for (int idx = tid; idx < kNS * kP; idx += kThreads) {
      const int r = idx / kP;
      const int col = idx - r * kP;
      const float hv = hin[(n0 + r) * kP + col];
      const float dv_ = dhs[(n0 + r) * kP + col];
      Hsl[r * kLdP + col] = hv;
      Dsl[r * kLdP + col] = dv_;
      frob += hv * dv_;
    }
    __syncthreads();
    mm(kNS, [&](int r, int k) { return Bsl[r * kLdS + k]; },
       [&](int k, int col) { return Dsl[k * kLdP + col]; }, bdh);
    mm(kNS, [&](int r, int k) { return Csl[r * kLdS + k]; },
       [&](int k, int col) { return Hsl[k * kLdP + col]; }, chin);
    // dC[t, n] = es_t g_t . h_in[n] + sum_u Pb[t, u] B[u, n]
    float o[8][2];
    zero(o);
    mm(kP, [&](int r, int k) { return gs[r * kLdP + k]; },
       [&](int k, int col) { return Hsl[col * kLdP + k]; }, o);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) o[i][j] *= ev[ty + 16 * i];
    mm(Q, [&](int r, int k) { return Pb[r * kLdQ + k]; },
       [&](int k, int col) { return Bsl[k * kLdS + col]; }, o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      if (t >= Q) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        dcp[(long long)t * kN + n0 + tx + 16 * j] = o[i][j];
    }
    // dB[u, n] = sum_t Pb[t, u] C[t, n] + w_u x_u . dh[n]
    zero(o);
    mm(Q, [&](int r, int k) { return Pb[k * kLdQ + r]; },
       [&](int k, int col) { return Csl[k * kLdS + col]; }, o);
    mm(kP, [&](int r, int k) { return xs[r * kLdP + k] * wv[r]; },
       [&](int k, int col) { return Dsl[col * kLdP + k]; }, o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = ty + 16 * i;
      if (u >= Q) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        dbp[(long long)u * kN + n0 + tx + 16 * j] = o[i][j];
    }
    __syncthreads();  // the slices are reloaded next
  }

  // dx = dxa + w_u (B dh)_u + D g_u; beta_u = x_u . (B dh)_u;
  // dsi_t = g_t . (C h_in)_t
  T* dx = static_cast<T*>(a.dx) + tok0 * row_hp + h * kP;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = ty + 16 * i;
    float bsum = 0.f, csum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      bsum += xs[u * kLdP + p] * bdh[i][j];
      csum += gs[u * kLdP + p] * chin[i][j];
      if (u < valid)
        dx[u * row_hp + p] = from_float<T>(
            dxa[i][j] + wv[u] * bdh[i][j] + D * gs[u * kLdP + p]);
    }
    bsum = half_sum(bsum);
    csum = half_sum(csum);
    if (tx == 0) {
      beta[u] = bsum;
      dsi[u] = csum;
    }
  }
  const float frob_sum = block_sum(frob, tmp);
  const float wb = tid < kQ ? wv[tid] * beta[tid] : 0.f;
  const float wb_sum = block_sum(wb, tmp);

  // ds, its reverse cumsum dla, then ddt and the da partial
  if (tid < kQ) {
    float ds = 0.f;
    if (tid < Q) {
      ds = ev[tid] * dsi[tid] + rowA[tid] - dv[tid] * colA[tid] - wb;
      if (tid == Q - 1) ds += e_last * frob_sum + wb_sum;
    }
    dsv[kQ - 1 - tid] = ds;  // reversed, for an inclusive prefix sum
  }
  __syncthreads();
  float run = 0.f;
  if (tid < kQ) {  // warps 0-3, as in chunk_decay
    const int lane = tid & 31;
    run = dsv[tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run += y;
    }
    if (lane == 31) tmp[8 + (tid >> 5)] = run;
  }
  __syncthreads();
  float dla_dt = 0.f;
  if (tid < kQ) {
    float off = 0.f;
    for (int w = 0; w < (tid >> 5); ++w) off += tmp[8 + w];
    const int t = kQ - 1 - tid;  // dla_t = sum_{t' >= t} ds_t'
    const float dla = run + off;
    if (t < valid) {
      a.ddt[(tok0 + t) * a.H + h] =
          colA[t] + expf(s_last - sv[t]) * beta[t] + A * dla;
      dla_dt = dla * dv[t];
    }
  }
  const float da_sum = block_sum(dla_dt, tmp);
  if (tid == 0) {
    a.da_part[bh * a.nc + ic] = da_sum;
    a.dd_part[bh * a.nc + ic] = gx_sum;
  }
}

// ------------------------------------------------------------ 3. reductions
template <typename T>
__global__ void ssd_reduce_bc_kernel(const float* __restrict__ part,
                                     T* __restrict__ out, int B, int L,
                                     int Lp, int H, int G) {
  const long long total = (long long)B * L * G * kN;
  const int rep = H / G;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int n = idx % kN;
    const long long rest = idx / kN;
    const int g = rest % G;
    const long long bl = rest / G;
    const int l = bl % L;
    const int b = bl / L;
    const float* p =
        part + (((long long)b * H + g * rep) * Lp + l) * kN + n;
    float s = 0.f;
    for (int r = 0; r < rep; ++r) s += p[(long long)r * Lp * kN];
    out[idx] = from_float<T>(s);
  }
}

__global__ void ssd_reduce_heads_kernel(const float* __restrict__ da_part,
                                        const float* __restrict__ dd_part,
                                        float* da, float* dd, int B, int H,
                                        int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) {
      sa += da_part[((long long)b * H + h) * nc + c];
      sd += dd_part[((long long)b * H + h) * nc + c];
    }
  da[h] = sa;
  dd[h] = sd;
}

template <typename T>
struct LaunchBwd {
  static void run(const BwdArgs& a, cudaStream_t stream) {
    const int smem1 = kDstateSmemFloats * static_cast<int>(sizeof(float));
    auto k1 = ssd_dstate_kernel<T>;
    cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem1);
    k1<<<dim3(a.H, a.B), kThreads, smem1, stream>>>(a);
    const int smem2 = kChunkSmemFloats * static_cast<int>(sizeof(float));
    auto k2 = ssd_chunk_bwd_kernel<T>;
    cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem2);
    k2<<<dim3(a.nc, a.H, a.B), kThreads, smem2, stream>>>(a);
    const long long n_bc = (long long)a.B * a.L * a.G * kN;
    const int blocks = static_cast<int>(
        (n_bc + kThreads - 1) / kThreads < 4096
            ? (n_bc + kThreads - 1) / kThreads : 4096);
    const int Lp = a.nc * a.Q;
    ssd_reduce_bc_kernel<T><<<blocks, kThreads, 0, stream>>>(
        a.db_part, static_cast<T*>(a.db), a.B, a.L, Lp, a.H, a.G);
    ssd_reduce_bc_kernel<T><<<blocks, kThreads, 0, stream>>>(
        a.dc_part, static_cast<T*>(a.dc), a.B, a.L, Lp, a.H, a.G);
    ssd_reduce_heads_kernel<<<(a.H + 63) / 64, 64, 0, stream>>>(
        a.da_part, a.dd_part, a.da, a.dd, a.B, a.H, a.nc);
  }
};

}  // namespace ssd
}  // namespace pam

// fp32 x, b, c, dy, dx, db and dc. Returns 0, a CUDA error code from
// cudaGetLastError(), or -1 for an unsupported (N, P).
extern "C" int pam_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* states, const void* dy,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dd,
    void* dstates, void* db_part, void* dc_part, void* da_part,
    void* dd_part, int B, int L, int H, int G, int Q, int nc, long long x_sb,
    long long x_sl, long long b_sb, long long b_sl, long long c_sb,
    long long c_sl, int N, int P, void* stream) {
  pam::ssd::BwdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.d = static_cast<const float*>(d);
  args.states = static_cast<const float*>(states);
  args.dy = dy;
  args.dx = dx;
  args.ddt = static_cast<float*>(ddt);
  args.da = static_cast<float*>(da);
  args.db = db;
  args.dc = dc;
  args.dd = static_cast<float*>(dd);
  args.dstates = static_cast<float*>(dstates);
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
  args.x_sb = x_sb;
  args.x_sl = x_sl;
  args.b_sb = b_sb;
  args.b_sl = b_sl;
  args.c_sb = c_sb;
  args.c_sl = c_sl;
  return pam::ssd::dispatch<pam::ssd::LaunchBwd>(
      N, P, args, static_cast<cudaStream_t>(stream));
}
