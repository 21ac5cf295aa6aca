// FlashAttention-2 forward in fp32 on the tensor cores (3xTF32), causal
// or bidirectional, GQA without repeating K/V.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_attn_kernel
// (wrapper flash_attention, pl.pallas_call at :122) for fp32 operands at
// every built (head dim, group) pair; bf16 runs flash_attention_sm90.cu
// (wgmma) at head dims 64-128 and flash_attention.cu (CUDA cores) at 16,
// kernels/flash_attention.py::_variant chooses. The TPU kernel carries
// (m, l, acc) across a sequential kv-block grid axis; here one CTA per
// (64-row query tile, query head, batch) walks 32-row key tiles in a loop
// with the same fp32 online softmax in registers (its eight warps split
// each tile's keys in two halves, each with its own (m, l, O), merged at
// the end as Alg. 1 merges partials), reads the kv head
// h / REP (the reference's _kv_row index map), masks kpos < Sk and, when
// causal, kpos <= qpos with the reference's -1e30 sentinel (tiles past
// the diagonal are skipped), and finalises with its l_safe (l > 0 ? l :
// 1). Besides O it writes the per-row log-sum-exp m + log(l_safe) in
// fp32, which the backward (flash_attention_bwd_tf32x3.cu) reads. Query
// rows past Sq are computed on zero rows and never written.
//
// Bound on the H100: operations. The CUDA-core kernel this replaces
// ran the products as fp32 FMAs, bound by their FLOPs over the
// 67 TFLOP/s fp32 peak, and reached 3-27 % of it. Here S = Q K^T and
// O += P V run on the tensor cores in 3xTF32 (attention_tf32.cuh: three
// mma.sync m16n8k8 TF32 products a fragment pair, fp32 accuracy), whose
// bound is 3x the FLOPs over the 495 TFLOP/s TF32 peak. What holds the
// kernel back at these shapes is latency, not the products: with one or
// two CTAs an SM every phase of a tile (split, products, softmax) waits
// on the last. So eight warps share a 64-row query tile (warp w: rows
// 16 (w % 4), keys 16 (w / 4) of each tile), a tile's interior skips the
// mask, and the grid runs the longest causal query tiles of every head
// first. Q's hi / lo planes stay in shared memory for the CTA's life
// (split once), each K / V tile is split once as it lands, and the next
// tile's cp.async copy overlaps the current tile's products (two tiles
// in flight). P leaves the first product as accumulators and is split in
// registers into the second's A operand, with no shared-memory round
// trip. Shared memory: 64 + 64 rows of Q and 2 x 4 x 32 of K / V at
// D + 4 words, 203 KB at D 128 (one CTA an SM), 104 KB at D 64 (two).
#include "attention_tf32.cuh"

namespace pam {

struct Tf32FwdArgs {
  const float* q;  // (B, H, Sq, D)
  const float* k;  // (B, Hkv, Sk, D)
  const float* v;
  float* o;        // (B, H, Sq, D)
  float* lse;      // (B, H, Sq)
  int B, H, Hkv, Sq, Sk, causal;
  float scale;
};

namespace tf32 {

constexpr int kFwdThreads = 256;   // eight warps
constexpr int kFwdRows = 64;       // query rows a CTA

constexpr int kFwdMove = 32;       // key rows a tile

template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (2 * kFwdRows + 8 * kFwdMove) * ld<D>() * 4;
}

// One tile's online-softmax step of a warp's rows g (entries 0, 1) and
// g + 8 (entries 2, 3): S scaled (and, with kMask, masked to the
// reference's -1e30 where kpos >= Sk or, causal, kpos > qpos), the
// running max and sum updated, O rescaled, S replaced by P.
template <bool kMask, int N, int NT>
__device__ __forceinline__ void softmax_step(float (&s)[N][4],
                                             float (&o)[NT][4],
                                             float (&m)[2], float (&l)[2],
                                             int qrow, int k0,
                                             const Tf32FwdArgs& a) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = qrow + 8 * hf;
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * n + 2 * t + e;
        float& x = s[n][2 * hf + e];
        x = !kMask || (kpos < a.Sk && (!a.causal || kpos <= qpos))
                ? x * a.scale
                : kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = quad_max(mx);
    const float mn = fmaxf(m[hf], mx);
    const float alpha = expf(m[hf] - mn);
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * n + 2 * t + e;
        float& x = s[n][2 * hf + e];
        x = !kMask || (kpos < a.Sk && (!a.causal || kpos <= qpos))
                ? expf(x - mn)
                : 0.f;
        rs += x;
      }
    rs = quad_sum(rs);
    l[hf] = l[hf] * alpha + rs;
    m[hf] = mn;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      o[c][2 * hf] *= alpha;
      o[c][2 * hf + 1] *= alpha;
    }
  }
}

template <int D, int REP>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_attention_fwd_tf32x3_kernel(Tf32FwdArgs a) {
  constexpr int LD = ld<D>();
  constexpr int T = kFwdThreads;
  constexpr int BQ = kFwdRows;
  constexpr int BK = kFwdMove;
  constexpr int NT = D / 8;        // 8-column tiles of O
  constexpr int NS = BK / 16;      // 8-column tiles of a warp's S
  constexpr int PLANE = BK * LD;
  extern __shared__ __align__(16) uint32_t tf32_smem[];
  uint32_t* Qh = tf32_smem;
  uint32_t* Ql = Qh + BQ * LD;
  uint32_t* mov = Ql + BQ * LD;   // 2 x {K hi, K lo, V hi, V lo}

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = 16 * (warp & 3);          // the warp's query rows
  const int kh = (BK / 2) * (warp >> 2);   // and its keys in each tile
  // heaviest first: the last (causal: longest) query tiles of every head
  const int h = blockIdx.x % a.H;
  const int b = blockIdx.x / a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long qhead = (long)b * a.H + h;
  const long khead = (long)b * a.Hkv + h / REP;
  const float* q = a.q + qhead * a.Sq * D;
  const float* k = a.k + khead * a.Sk * D;
  const float* v = a.v + khead * a.Sk * D;
  const bool causal = a.causal != 0;
  const int nk = causal_tiles<BQ, BK>(q0, a.Sq, a.Sk, causal);

  stage_rows<D, BQ, T>(q, q0, a.Sq, Qh);
  stage_rows<D, BK, T>(k, 0, a.Sk, mov);
  stage_rows<D, BK, T>(v, 0, a.Sk, mov + 2 * PLANE);
  cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < nk; ++j) {
    uint32_t* buf = mov + (j & 1) * 4 * PLANE;
    cp_async_wait<0>();
    if (j == 0) split_rows<D, BQ, T>(Qh, Ql);
    split_rows<D, BK, T>(buf, buf + PLANE);
    split_rows<D, BK, T>(buf + 2 * PLANE, buf + 3 * PLANE);
    __syncthreads();   // tile j split; the other buffer is free
    if (j + 1 < nk) {
      uint32_t* nxt = mov + ((j + 1) & 1) * 4 * PLANE;
      stage_rows<D, BK, T>(k, (j + 1) * BK, a.Sk, nxt);
      stage_rows<D, BK, T>(v, (j + 1) * BK, a.Sk, nxt + 2 * PLANE);
      cp_async_commit();
    }

    // S = Q K^T over the warp's 16 rows and its keys
    float s[NS][4];
    rows_product<D, NS>(Qh, Ql, r0, buf, buf + PLANE, kh, s);
    const int k0 = j * BK + kh;
    const int klast = k0 + BK / 2 - 1;
    if (klast < a.Sk && (!causal || klast <= q0 + r0))
      softmax_step<false>(s, o, m, l, q0 + r0 + g, k0, a);
    else
      softmax_step<true>(s, o, m, l, q0 + r0 + g, k0, a);
    // O += P V over the warp's keys
    cols_product<D, NS>(s, buf + 2 * PLANE, buf + 3 * PLANE, kh, o);
  }
  cp_async_wait<0>();
  __syncthreads();   // the K / V buffers are free for the merge

  // the second key half's (m, l, O) through shared memory to the first
  float* ox = reinterpret_cast<float*>(mov);   // (64, LD) O, then m, l
  float* mlx = ox + BQ * LD;
  if (warp >= 4) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
#pragma unroll
      for (int c = 0; c < NT; ++c)
        *reinterpret_cast<float2*>(ox + r * LD + 8 * c + 2 * t) =
            make_float2(o[c][2 * hf], o[c][2 * hf + 1]);
      if (t == 0) {
        mlx[r] = m[hf];
        mlx[BQ + r] = l[hf];
      }
    }
  }
  __syncthreads();
  if (warp >= 4) return;

  float* out = a.o + qhead * a.Sq * D;
  float* lse = a.lse + qhead * a.Sq;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    const int qpos = q0 + r;
    if (qpos >= a.Sq) continue;
    const float m1 = mlx[r];
    const float mn = fmaxf(m[hf], m1);
    const float f0 = expf(m[hf] - mn);
    const float f1 = expf(m1 - mn);
    const float ln = l[hf] * f0 + mlx[BQ + r] * f1;
    const float l_safe = ln > 0.f ? ln : 1.f;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const float2 x =
          *reinterpret_cast<const float2*>(ox + r * LD + 8 * c + 2 * t);
      *reinterpret_cast<float2*>(out + (long)qpos * D + 8 * c + 2 * t) =
          make_float2((o[c][2 * hf] * f0 + x.x * f1) * inv,
                      (o[c][2 * hf + 1] * f0 + x.y * f1) * inv);
    }
    if (t == 0) lse[qpos] = mn + logf(l_safe);
  }
}

template <int D, int REP>
struct LaunchFwd {
  static int run(const Tf32FwdArgs& a, cudaStream_t stream) {
    constexpr int smem = fwd_smem_bytes<D>();
    auto kernel = flash_attention_fwd_tf32x3_kernel<D, REP>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(a.H * a.B, (a.Sq + kFwdRows - 1) / kFwdRows);
    kernel<<<grid, kFwdThreads, smem, stream>>>(a);
    return 0;
  }
};

}  // namespace tf32
}  // namespace pam

// fp32 q, k, v, o and lse. Returns 0, a CUDA error code, or -1 for a
// (D, H / Hkv) pair outside PAM_ATTN_FWD_BUILT.
extern "C" int pam_flash_attention_fwd_tf32x3(const void* q, const void* k,
                                              const void* v, void* o,
                                              void* lse, int B, int H,
                                              int Hkv, int Sq, int Sk, int D,
                                              int causal, float scale,
                                              void* stream) {
  pam::Tf32FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return pam::tf32::dispatch_fwd<pam::tf32::LaunchFwd>(
      D, H / Hkv, a, static_cast<cudaStream_t>(stream));
}
