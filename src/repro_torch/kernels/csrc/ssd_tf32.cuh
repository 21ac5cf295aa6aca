// Shared code of the fp32 SSD scan kernels on the tensor cores
// (ssd_scan_tf32x3.cu: forward; ssd_scan_bwd_tf32x3.cu: backward), for
// d_state N = 128 (mamba2-780m) or 64 (zamba2-7b), head dim P = 64, chunks
// of up to 128 tokens. Every product runs in 3xTF32 on mma.sync m16n8k8
// (tf32_common.cuh); kernels/ssd_scan.py::_fwd_tf32x3 / _bwd_tf32x3 model
// the split in plain PyTorch.
//
// The decomposition is the bf16 kernels' (ssd_sm90.cuh): every chunk on
// its own, and only an elementwise pass over the (N, P) states sequential
// over chunks. The decay, pass, ds and head-sum kernels are the bf16
// library's own (fp32 already); this header adds the stage pipeline and
// fragment loaders, the fp32 chunk-state kernel and the dB / dC group sum.
//
// Tiles. Every kernel here is eight warps (256 threads) on the tiles of
// one (chunk, batch, head or block of heads). Its operands arrive as a
// program of stages in two to four stage buffers (Pipe): the copies of the
// next stages (cp.async, 16 bytes a thread, read through the operand's own
// batch and sequence strides, rows past the chunk zero-filled) run while
// the warps multiply stage s, with one barrier a stage. A stage holds up
// to three tiles, each raw fp32, row-major with a row stride of its
// columns + 4 words; every fragment is split into its hi and lo TF32
// halves in registers as it is loaded (split_bits), and a per-row factor
// (w o x, exp(s) o dy) is applied there too, so a tile is never rewritten
// in shared memory. Products stream d_state, or the head dim, in slices of
// 32 columns.
#pragma once

#include "ssd_sm90.cuh"
#include "tf32_common.cuh"

namespace pam {
namespace ssdtf {

using tf32::mma3;
using tf32::quad_sum;
using tf32::split_bits;
using tf32::split_scores;

constexpr int kQ = 128;         // rows of a chunk tile
constexpr int kP = 64;          // head dim
constexpr int kThreads = 256;   // eight warps
constexpr int kSlice = 32;      // columns of a d_state or head-dim slice
constexpr int kLdS = kSlice + 4;  // row stride of a slice plane (words)
constexpr int kLdP = kP + 4;
constexpr int kSliceWords = kQ * kLdS;   // a (128, 32) tile
// s, dt, a row factor or sums, and the t-side's column sums
constexpr int kExtraWords = 11 * kQ + 8;

struct Args {
  const float* x;      // (B, L, H, P), strides x_sb, x_sl
  const float* dt;     // (B, L, H)
  const float* a;      // (H,) decay rates
  const float* b;      // (B, L, G, N), strides b_sb, b_sl
  const float* c;
  const float* d;      // (H,)
  const float* dy;     // (B, L, H, P) contiguous
  float* y;            // (B, L, H, P) contiguous
  float* states;       // (B, H, nc, N, P) chunk-start states h_in
  float* dstates;      // (B, H, nc, N, P): V_c, then dh_c
  const float* dec;    // (2, B, H, nc, kQ): s_t, then the masked dt
  float* dx;           // (B, L, H, P) contiguous
  float* db;           // (B, L, G, N) contiguous
  float* dc;
  float* rows;         // (4, B, H, nc, kQ), as ssd90_ds_kernel reads them
  float* db_part;      // (B, H, nc Q, N) per-head dB
  float* dc_part;
  float* dd_part;      // (B, H, nc)
  float* sbuf;         // (2, B, G, nc, kQ, kQ): S' = C B^T of each
                       // (batch, group, chunk), and its transpose
  // read or written only by the bf16 library's kernels
  float* ddt;          // (B, L, H)
  float* da;           // (H,)
  float* dd;           // (H,)
  float* frob;         // (B, H, nc, N P / 128) parts of <dh_c, h_in_c>
  float* da_part;      // (B, H, nc)
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
  int B, L, H, G, Q, nc, hb;
};

// One operand tile of a stage: rows [0, rows) of a row-major fp32 matrix
// from src (row stride `stride` elements, `cols` columns of 32, 64 or
// 128), rows at or past `valid` zero-filled, `off` words into the stage
// buffer with a row stride of cols + 4.
struct Tile {
  const float* src;
  long long stride;
  int rows, cols, valid, off;
};

struct Stage {
  Tile t[3];
  int n;
};

__device__ __forceinline__ Tile tile(const float* src, long long stride,
                                     int rows, int cols, int valid,
                                     int off) {
  return Tile{src, stride, rows, cols, valid, off};
}

__device__ __forceinline__ void stage_issue(const Stage& st, uint32_t* buf) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const Tile& t = st.t[i];
    if (i >= st.n) continue;
    const int cpr = t.cols / 4;
    const int ld = t.cols + 4;
    for (int c = threadIdx.x; c < t.rows * cpr; c += kThreads) {
      const int r = c / cpr;
      const int col = 4 * (c - r * cpr);
      const bool in = r < t.valid;
      tf32::cp_async16_zfill(buf + t.off + r * ld + col,
                             t.src + (in ? r : 0) * t.stride + col,
                             in ? 16 : 0);
    }
  }
}

// The stage pipeline over a kernel's program `prog(s) -> Stage`, s in [0,
// n), in NB buffers of `words`: start() issues stages 0 .. NB - 2; each
// next() waits for stage s, passes the barrier (stage s landed for every
// thread, and every thread is done with stage s - 1), issues stage s + NB
// - 1 into the buffer stage s - 1 used and returns stage s's buffer. One
// cp.async group a stage (empty past the end), so that waiting for all
// but the newest NB - 2 groups waits for stage s.
template <int NB, class Prog>
struct Pipe {
  uint32_t* buf;
  int words, n, s;
  Prog prog;

  __device__ __forceinline__ void issue(int i) {
    if (i < n) stage_issue(prog(i), buf + (i % NB) * words);
    tf32::cp_async_commit();
  }

  __device__ __forceinline__ void start() {
    s = 0;
#pragma unroll
    for (int i = 0; i < NB - 1; ++i) issue(i);
  }

  __device__ __forceinline__ const uint32_t* next() {
    const uint32_t* cur = buf + (s % NB) * words;
    tf32::cp_async_wait<NB - 2>();
    __syncthreads();
    issue(s + NB - 1);
    ++s;
    return cur;
  }
};

template <int NB, class Prog>
__device__ __forceinline__ Pipe<NB, Prog> make_pipe(uint32_t* buf, int words,
                                                    int n, Prog prog) {
  Pipe<NB, Prog> p{buf, words, n, 0, prog};
  p.start();
  return p;
}

// Fragments of a raw fp32 tile (tf32_common.cuh's loaders), split into
// hi and lo as they are loaded.
template <int N>
__device__ __forceinline__ void split_frag(const uint32_t (&r)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_bits(r[i], hi[i], lo[i]);
}

template <int LD>
__device__ __forceinline__ void a_rows(const uint32_t* p, int r0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  uint32_t r[4];
  tf32::frag_a<LD>(p, r0, k0, r);
  split_frag(r, hi, lo);
}

template <int LD>
__device__ __forceinline__ void a_perm(const uint32_t* p, int r0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  uint32_t r[4];
  tf32::frag_a_perm<LD>(p, r0, k0, r);
  split_frag(r, hi, lo);
}

template <int LD>
__device__ __forceinline__ void a_trans(const uint32_t* p, int m0, int k0,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  uint32_t r[4];
  tf32::frag_a_trans<LD>(p, m0, k0, r);
  split_frag(r, hi, lo);
}

template <int LD>
__device__ __forceinline__ void b_rows(const uint32_t* p, int n0, int k0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  uint32_t r[2];
  tf32::frag_b_rows<LD>(p, n0, k0, r);
  split_frag(r, hi, lo);
}

// By columns (rows k0 + 2t, k0 + 2t + 1 as k), each row times its factor
// f0, f1 when given.
template <int LD>
__device__ __forceinline__ void b_cols(const uint32_t* p, int k0, int n0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2],
                                       float f0 = 1.f, float f1 = 1.f) {
  uint32_t r[2];
  tf32::frag_b_cols<LD>(p, k0, n0, r);
  r[0] = __float_as_uint(__uint_as_float(r[0]) * f0);
  r[1] = __float_as_uint(__uint_as_float(r[1]) * f1);
  split_frag(r, hi, lo);
}

// The decay row of (batch, head, chunk) bhc into shared memory: s_t and
// the masked dt (threads 0 .. kQ - 1; the caller syncs).
__device__ __forceinline__ void load_decay(const Args& a, long long bhc,
                                           float* sv, float* dv) {
  if (threadIdx.x < kQ) {
    const long long n = (long long)a.B * a.H * a.nc * kQ;
    sv[threadIdx.x] = a.dec[bhc * kQ + threadIdx.x];
    dv[threadIdx.x] = a.dec[n + bhc * kQ + threadIdx.x];
  }
}

// Sum over the block, to every thread, in a fixed order; tmp holds 8
// floats.
__device__ __forceinline__ float block_sum(float v, float* tmp) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += tmp[w];
  return total;
}

// ------------------------------------------------------------ chunk states
// out[b, h, c] = M^T (r o S) over the chunk's 128 rows: the forward's U_c
// (M = B, S = x, r = w = exp(s_Q - s) dt) into `states`, or the
// backward's V_c (M = C, S = dy, r = exp(s)) into `dstates`. One CTA per
// (chunk, batch, head), the rows in four stages of 32 (M's and S's
// rows); M^T is read as a transposed A fragment, S by columns with r
// applied as the fragment is loaded. At N = 128 warp w owns state rows
// 16 w .. 16 w + 15 and all 64 columns; at N = 64 rows 16 (w % 4) .. and
// the columns 32 (w / 4) ...
template <int N>
__host__ __device__ constexpr int state_words() {
  return 32 * (N + 4) + 32 * kLdP;
}
constexpr int kStateStages = 4;   // every stage in flight at once

template <bool FWD, int N>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_state_tf32x3_kernel(Args a) {
  constexpr int kLdN = N + 4;
  constexpr int NT = N == 128 ? 8 : 4;   // 8-column tiles of P a warp
  constexpr int kWords = state_words<N>();
  extern __shared__ __align__(16) uint32_t smem[];
  float* sv = reinterpret_cast<float*>(smem + kStateStages * kWords);
  float* dv = sv + kQ;
  float* rv = dv + kQ;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ic = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
  const int m0 = N == 128 ? 16 * warp : 16 * (warp & 3);
  const int cb = N == 128 ? 0 : 4 * (warp >> 2);

  const float* M = FWD ? a.b + b * a.b_sb + grp * N
                       : a.c + b * a.c_sb + grp * N;
  const long long m_sl = FWD ? a.b_sl : a.c_sl;
  const float* S = FWD ? a.x + b * a.x_sb + h * kP
                       : a.dy + (long long)b * a.L * a.H * kP + h * kP;
  const long long s_sl = FWD ? a.x_sl : (long long)a.H * kP;
  auto prog = [&](int k) {
    const int r0 = p0 + 32 * k;
    const int v = max(0, min(32, valid - 32 * k));
    const int rs = v > 0 ? r0 : p0;   // an address in the tensor
    Stage st;
    st.t[0] = tile(M + rs * m_sl, m_sl, 32, N, v, 0);
    st.t[1] = tile(S + rs * s_sl, s_sl, 32, kP, v, 32 * kLdN);
    st.n = 2;
    return st;
  };
  auto pipe = make_pipe<kStateStages>(smem, kWords, kQ / 32, prog);
  load_decay(a, bhc, sv, dv);
  __syncthreads();
  if (threadIdx.x < kQ) {
    const int u = threadIdx.x;
    rv[u] = FWD ? expf(sv[a.Q - 1] - sv[u]) * dv[u] : expf(sv[u]);
  }   // read after the first stage's barrier

  float acc[NT][4] = {};
  for (int k = 0; k < kQ / 32; ++k) {
    const uint32_t* Mt = pipe.next();
    const uint32_t* St = Mt + 32 * kLdN;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int u = 32 * k + 8 * kk + 2 * t;
      const float f0 = rv[u], f1 = rv[u + 1];
      uint32_t ah[4], al[4];
      a_trans<kLdN>(Mt, m0, 8 * kk, ah, al);
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        uint32_t bh[2], bl[2];
        b_cols<kLdP>(St, 8 * kk, 8 * (cb + c), bh, bl, f0, f1);
        mma3(acc[c], ah, al, bh, bl);
      }
    }
  }
  float* out = (FWD ? a.states : a.dstates) + bhc * N * kP;
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(out + (m0 + g + 8 * hf) * kP +
                                 8 * (cb + c) + 2 * t) =
          make_float2(acc[c][2 * hf], acc[c][2 * hf + 1]);
}

// ------------------------------------------------------------ dB / dC
// out[b, l, g, n .. n + 3] = the sum of the group's per-head parts, eight
// lanes a float4 of the output: lane i adds heads i, i + 8, ... in order,
// then the eight sums meet in a fixed shuffle tree (deterministic).
constexpr int kReduceLanes = 8;

template <int N>
__global__ void ssd_reduce_bc_tf32x3_kernel(const float* __restrict__ part,
                                            float* __restrict__ out, int B,
                                            int L, int Lp, int H, int G) {
  const long long total = (long long)B * L * G * N / 4;
  const int rep = H / G;
  const int lane = threadIdx.x % kReduceLanes;
  // the warp's four outputs advance together: every lane reaches the
  // shuffles
  const long long first = (blockIdx.x * (long long)blockDim.x +
                           (threadIdx.x & ~31)) / kReduceLanes;
  const long long stride = (long long)gridDim.x * blockDim.x / kReduceLanes;
  for (long long i0 = first; i0 < total; i0 += stride) {
    const long long idx = i0 + (threadIdx.x & 31) / kReduceLanes;
    const bool live = idx < total;
    const long long o = live ? idx : 0;
    const int n = 4 * (o % (N / 4));
    const long long rest = o / (N / 4);
    const int g = rest % G;
    const long long bl = rest / G;
    const int l = bl % L;
    const int b = bl / L;
    const float* p = part + (((long long)b * H + g * rep) * Lp + l) * N + n;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = lane; live && r < rep; r += kReduceLanes) {
      const float4 v =
          *reinterpret_cast<const float4*>(p + (long long)r * Lp * N);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
#pragma unroll
    for (int o = kReduceLanes / 2; o > 0; o >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
    }
    if (live && lane == 0) reinterpret_cast<float4*>(out)[idx] = s;
  }
}

// The bf16 library's Args for its decay, pass, ds and head-sum kernels,
// which take fp32 operands only.
inline ssd90::Args args90(const Args& a) {
  ssd90::Args r = {};
  r.dt = a.dt;
  r.a = a.a;
  r.d = a.d;
  r.states = a.states;
  r.dec = const_cast<float*>(a.dec);
  r.dstates = a.dstates;
  r.rows = a.rows;
  r.dd_part = a.dd_part;
  r.ddt = a.ddt;
  r.da = a.da;
  r.dd = a.dd;
  r.frob = a.frob;
  r.da_part = a.da_part;
  r.B = a.B;
  r.L = a.L;
  r.H = a.H;
  r.G = a.G;
  r.Q = a.Q;
  r.nc = a.nc;
  r.hb = a.hb;
  return r;
}

// The 16-row block of a chunk tile that warp w owns in the causal
// products: warps w and w + 4 share an SM sub-partition, so w < 4 takes
// block w and w + 4 block 7 - w, and each sub-partition's pair visits 18
// of the triangle's 72 column tiles of 16 x 8 (with block w for warp w,
// the sub-partitions took 24, 20, 16 and 12).
__device__ __forceinline__ int row_block(int warp) {
  return warp < 4 ? warp : 11 - warp;
}

// Dynamic shared memory of a kernel with nb stage buffers of `words`.
__host__ __device__ constexpr int smem_bytes(int nb, int words) {
  return (nb * words + kExtraWords) * 4;
}

template <class K>
inline int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace ssdtf
}  // namespace pam
