// FlashAttention forward for Hopper's tensor cores: bf16, head dim 64, 80,
// 112 or 128, causal or bidirectional, GQA without repeating K/V.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_attn_kernel
// (:31; wrapper flash_attention, pl.pallas_call at :122) for bf16 operands
// at the built (head dim, group) pairs of PAM_ATTN_FWD90_BUILT below:
// head dim 128 with groups 1, 2, 5, 8 and 16 (pam-llama-7b, qwen3-0.6b,
// qwen3-14b, deepseek-67b, qwen3-moe-235b-a22b), 64 with groups 1 and 7 (minicpm-2b;
// internvl2-1b, causal), 80 with group 1 (hubert-xlarge's bidirectional
// encoder) and 112 with group 1 (zamba2-7b's shared attention block,
// causal). fp32 at every pair and bf16 at head dim 16 keep
// the CUDA-core kernel of flash_attention.cu; the head dims listed in
// attention_common.cuh's PAM_ATTN_WGMMA_FWD_DIMS leave bf16 out of it, and
// kernels/flash_attention.py::_variant picks one of the two for each
// (dtype, head dim), with no fallback.
//
// Computes what _attn_kernel computes: an fp32 online softmax over key
// tiles with the reference's -1e30 sentinel, the mask kpos < Sk and, when
// causal, kpos <= qpos from position 0, and its l_safe (l > 0 ? l : 1)
// finalize; it also writes the fp32 natural-log LSE m + log(l_safe) that
// the backward (flash_attention_bwd_sm90.cu) reads. Scores are kept in the
// log2 domain (scale * log2(e) folded into one multiply, exp2f for the
// exponentials); the LSE is converted back with ln(2).
//
// Bound on the H100: operations. At the training shape (B 4, H 16, S 2048,
// d 128, causal) the two products are 6.9e10 FLOPs (0.070 ms at 989
// TFLOP/s bf16) against 0.10 GB moved (0.030 ms at 3.35 TB/s); at
// internvl2-1b's (B 4, 14 / 2 heads of 64, S 2048, causal) 3.0e10 FLOPs
// (0.030 ms) against 34 MB (0.010 ms); at hubert-xlarge's (B 8, 16 heads
// of 80, S 1500, bidirectional) 9.2e10 FLOPs (0.093 ms) against 0.10 GB;
// at zamba2-7b's (B 2, 32 heads of 112, S 2048, causal) 6.0e10 FLOPs
// (0.061 ms) against 59 MB.
//
// Design:
//   - one CTA per (128-row query tile, query head, batch), two consumer
//     warpgroups of 64 rows each (256 threads); the query head h reads
//     kv head h / REP;
//   - S = Q K^T with wgmma m64n128k16 (bf16 in, fp32 out), Q and the
//     128-key K tile both read from 128-byte-swizzled shared memory
//     (K-major: K is row-major (key, d), already B^T), one k-step per 16
//     columns of the head dim: 4, 5, 7 or 8;
//   - the online softmax on the accumulator fragment: a row's max and sum
//     come from the 4 lanes that share it (two shuffles);
//   - O += P V with P rounded to bf16 in registers as the A operand (the
//     accumulator layout of m64nNk16 is the A-fragment layout) and V the
//     MN-major B operand (transpose bit), N = the head dim;
//   - staging by TMA (cp.async.bulk.tensor, CU_TENSOR_MAP_SWIZZLE_128B)
//     with one mbarrier per buffer: Q once, K and V two stages deep, so
//     tile j + 1 is in flight while tile j is in the products. The two
//     warpgroups never wait for each other: the later one to finish with
//     a stage refills it (release_last), so one's softmax runs beside the
//     other's products. Rows past Sk arrive as zeros and are masked;
//     rows past Sq are never written;
//   - causal: key tiles past the diagonal are skipped, only tiles that
//     cross it (or the ragged last tile) are masked, and the grid runs
//     the heaviest query tiles first (blockIdx.y = 0 is the last tile).
// Head dim 64: a tile is one 64-column swizzle sub-tile, so shared memory
// is Q 16 KiB + K, V 2 stages x 2 x 16 KiB = 80 KiB, and at 128 registers
// a thread two CTAs share an SM; __launch_bounds__(256, 2), which would
// force that, measured no faster on the H100. Head dim 80: the tensor maps
// are 80 columns wide with 64-column boxes, so the second sub-tile of every
// tile holds columns 64-79 and TMA zero-fills 80-127 (the mbarrier still
// counts the whole box's bytes); QK^T runs 5 k-steps and skips the zeros
// exactly. P V runs at N = 80 (m64n80k16): the first 64 columns from V's
// first swizzle atom, the last 16 from the second, LBO bytes on. PTX
// defines the MN-major 128-byte-swizzle layout in whole 64-column atoms,
// so this partial atom was checked on the H100 against N = 128 over both
// whole atoms (exact: V's zero columns give zero accumulators that the
// store never writes): the same errors against the plain version, 130
// registers a thread instead of 154, the (80, 1) row 4 % faster
// (scripts/attention_fwd_variants.py builds and times both, and the
// two-CTA bound). Head dim 112 is built the same way: 112-column maps
// (row stride 224 bytes, a multiple of 16) whose second box holds columns
// 64-111 and TMA's zero fill for 112-127, QK^T in 7 k-steps, P V at N =
// 112 (m64n112k16, the second atom read in part; the same check against N
// = 128 over both atoms is in scripts/attention_fwd_variants.py). Head
// dims 80, 112 and 128: Q 32 KiB + K, V 2 stages x 2 x 32 KiB = 160 KiB,
// one CTA an SM.
#include "attention_sm90.cuh"

// The built (head dim, group) pairs of this kernel: attention_common.cuh's
// PAM_ATTN_FWD_BUILT at the head dims of PAM_ATTN_WGMMA_FWD_DIMS (a CPU
// test compares them with kernels/flash_attention.py).
#define PAM_ATTN_FWD90_BUILT(X) \
  X(64, 1) X(64, 7) \
  X(80, 1) \
  X(112, 1) \
  X(128, 1) X(128, 2) X(128, 5) X(128, 8) X(128, 16)

namespace pam {

struct FwdSm90Args {
  __nv_bfloat16* o;  // (B, H, Sq, D)
  float* lse;    // (B, H, Sq)
  int H, Hkv, Sq, Sk, causal;
  float scale_log2;  // scale * log2(e)
};

namespace fwd90 {
constexpr int kBM = 128;  // query rows per CTA (2 warpgroups x 64)
constexpr int kBN = 128;  // keys per tile

// The tile shapes of head dim D.
template <int D>
struct Shape {
  static_assert(D == 64 || D == 80 || D == 112 || D == 128,
                "a wgmma forward head dim");
  static constexpr int kSubs = (D + sm90::kSub - 1) / sm90::kSub;
  static constexpr int kCols = kSubs * sm90::kSub;  // tile width
  static constexpr int kSteps = D / 16;             // k-steps of Q K^T
  static constexpr int kN = D;                      // P V's N
  static constexpr int kTileBytes = kBN * kCols * 2;
  static constexpr int kSmem = (kBM + 4 * kBN) * kCols * 2 + 8 * 8 + 2 * 4;
};
}  // namespace fwd90

template <int D, int REP>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                                    const __grid_constant__ CUtensorMap tmK,
                                    const __grid_constant__ CUtensorMap tmV,
                                    FwdSm90Args a) {
  using namespace sm90;
  using namespace fwd90;
  using Sh = Shape<D>;
  constexpr int kC = Sh::kCols;
  constexpr int kN = Sh::kN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // (kBM, kC)
  bf16* Ks = Qs + kBM * kC;                  // 2 stages of (kBN, kC)
  bf16* Vs = Ks + 2 * kBN * kC;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + 2 * kBN * kC);
  uint64_t* barQ = bars;
  uint64_t* barK = bars + 1;  // [2]
  uint64_t* barV = bars + 3;  // [2]
  int* done = reinterpret_cast<int*>(bars + 5);  // [2] releases

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / a.H;
  const int kvh = b * a.Hkv + (bh - b * a.H) / REP;
  const int nq = (a.Sq + kBM - 1) / kBM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const int nk_all = (a.Sk + kBN - 1) / kBN;
  const int nk = a.causal ? min(nk_all, (q0 + kBM + kBN - 1) / kBN) : nk_all;

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) bar_init(bars + i, 1);
    done[0] = done[1] = 0;
    bar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(barQ, kBM * kC * 2);
    tma_tile<Sh::kSubs>(Qs, &tmQ, barQ, kBM, q0, bh);
    for (int s = 0; s < 2 && s < nk; ++s) {
      bar_expect(barK + s, Sh::kTileBytes);
      tma_tile<Sh::kSubs>(Ks + s * kBN * kC, &tmK, barK + s, kBN, s * kBN,
                          kvh);
      bar_expect(barV + s, Sh::kTileBytes);
      tma_tile<Sh::kSubs>(Vs + s * kBN * kC, &tmV, barV + s, kBN, s * kBN,
                          kvh);
    }
  }

  float o[kN / 2];
  zero(o);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int row_lo = q0 + wg * 64;  // first query row of this warpgroup
  bar_wait(barQ, 0);

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    const int ph = (j >> 1) & 1;
    const bf16* Kt = Ks + st * kBN * kC;
    const bf16* Vt = Vs + st * kBN * kC;
    const int k0 = j * kBN;

    // S = Q K^T (this warpgroup's 64 rows x 128 keys)
    float s[64];
    zero(s);
    bar_wait(barK + st, ph);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::kSteps; ++kk)
      wgmma_ss_n128(s, desc_k(Qs, kBM, wg * 64, kk), desc_k(Kt, kBN, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax in the log2 domain
    const bool masked = k0 + kBN > a.Sk ||
                        (a.causal && k0 + kBN - 1 > row_lo);
    if (masked) {
#pragma unroll
      for (int v = 0; v < 64; ++v) {
        const int kpos = k0 + frag_col(t, v);
        const int qpos = row_lo + frag_row(t, v);
        const bool live = kpos < a.Sk && (!a.causal || kpos <= qpos);
        s[v] = live ? s[v] * a.scale_log2 : kNegInf;
      }
    } else {
#pragma unroll
      for (int v = 0; v < 64; ++v) s[v] *= a.scale_log2;
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int v = 2 * i; v < 64; v += 4) mx = fmaxf(mx, fmaxf(s[v], s[v + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = exp2f(m[i] - mn);
      m[i] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < 64; ++v) {
      const int i = (v >> 1) & 1;
      // a masked entry holds the sentinel exactly and contributes 0, also
      // while its row has seen no live key (m still the sentinel)
      const float p = (masked && s[v] == kNegInf) ? 0.f : exp2f(s[v] - m[i]);
      s[v] = p;
      rs[i] += p;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int v = 0; v < kN / 2; ++v) o[v] *= alpha[(v >> 1) & 1];
    uint32_t pa[32];
    pack_a(s, pa);

    // O += P V
    bar_wait(barV + st, ph);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_mn<kN>(o, pa + 4 * kk, desc_mn(Vt, kBN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);

    // the later warpgroup to finish with stage st refills it
    if (release_last(done + st, wg) && j + 2 < nk) {
      bar_expect(barK + st, Sh::kTileBytes);
      tma_tile<Sh::kSubs>(Ks + st * kBN * kC, &tmK, barK + st, kBN,
                          (j + 2) * kBN, kvh);
      bar_expect(barV + st, Sh::kTileBytes);
      tma_tile<Sh::kSubs>(Vs + st * kBN * kC, &tmV, barV + st, kBN,
                          (j + 2) * kBN, kvh);
    }
  }

  // finalize: l_safe, O / l_safe, LSE = m ln 2 + log(l_safe)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    inv[i] = 1.f / l_safe;
    const int qpos = row_lo + frag_row(t, 2 * i);
    if ((t & 3) == 0 && qpos < a.Sq)
      a.lse[(long)bh * a.Sq + qpos] =
          m[i] == kNegInf ? kNegInf : m[i] * kLn2 + logf(l_safe);
  }
#pragma unroll
  for (int v = 0; v < kN / 2; ++v) o[v] *= inv[(v >> 1) & 1];
  store_rows<D>(o, a.o + (long)bh * a.Sq * D, row_lo, a.Sq, 1.f);
}

template <int D, int REP>
int launch_fwd_sm90(const void* q, const void* k, const void* v, int B,
                    const FwdSm90Args& a, cudaStream_t stream) {
  using namespace fwd90;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, (long)B * a.H, a.Sq, kBM, D) ||
      !make_map(&tk, k, (long)B * a.Hkv, a.Sk, kBN, D) ||
      !make_map(&tv, v, (long)B * a.Hkv, a.Sk, kBN, D))
    return -2;
  auto kernel = flash_attention_fwd_sm90_kernel<D, REP>;
  const int smem = smem_with_align(Shape<D>::kSmem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid(B * a.H, (a.Sq + kBM - 1) / kBM);
  kernel<<<grid, sm90::kThreads, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pam

// bf16 q (B, H, Sq, D), k, v (B, Hkv, Sk, D), o like q, lse (B, H, Sq)
// fp32, all contiguous and 16-byte aligned. Returns 0, a CUDA error code
// from cudaGetLastError(), -1 for a (D, H / Hkv) outside
// PAM_ATTN_FWD90_BUILT, or -2 if the driver refuses a tensor map.
extern "C" int pam_flash_attention_fwd_sm90(const void* q, const void* k,
                                            const void* v, void* o,
                                            void* lse, int B, int H,
                                            int Hkv, int Sq, int Sk, int D,
                                            int causal, float scale,
                                            void* stream) {
  pam::FwdSm90Args a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale_log2 = scale * pam::sm90::kLog2e;
  auto s = static_cast<cudaStream_t>(stream);
  const int rep = H / Hkv;
#define PAM_FWD90_CASE(DIM, REP) \
  if (D == DIM && rep == REP)     \
    return pam::launch_fwd_sm90<DIM, REP>(q, k, v, B, a, s);
  PAM_ATTN_FWD90_BUILT(PAM_FWD90_CASE)
#undef PAM_FWD90_CASE
  return -1;
}
