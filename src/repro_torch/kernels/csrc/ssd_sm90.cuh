// Shared code of the bf16 SSD scan kernels for Hopper's tensor cores
// (ssd_scan_sm90.cu: forward; ssd_scan_bwd_sm90.cu: backward), for d_state
// N = 128 and head dim P = 64 (mamba2-780m), chunks of up to 128 tokens.
//
// The decomposition is Mamba-2's own chunked SSD: every chunk's work runs
// on its own on the tensor cores, and only an elementwise pass over the
// (N, P) states stays sequential over chunks. Per chunk of Q tokens, with
// s_t the in-chunk inclusive prefix sum of dt a, w_u = exp(s_Q - s_u) dt_u
// and E_tu = exp(s_t - s_u) for u <= t (else 0):
//
//   U_c   = sum_u B_u (w_u x_u)^T                    (chunk state, N x P)
//   h_c+1 = exp(s_Q) h_c + U_c                       (the state pass)
//   y_t   = exp(s_t) (C h_c)_t + sum_u (C_t . B_u) E_tu dt_u x_u + D x_t
//
// Kernels here:
//   ssd90_decay_kernel   s_t and the masked dt of every (batch, head,
//                        chunk) into a small fp32 buffer, (B, H, nc, 128)
//                        (dt is strided by H between tokens, so it is read
//                        once, here);
//   ssd90_chunk_state_kernel   M^T (r o S) on wgmma for a block of heads of
//                        one group, the (chunk, batch)'s M tile (B or C)
//                        loaded once: the forward's U_c (M = B, r = w, S =
//                        x) and the backward's V_c (M = C, r = exp(s), S =
//                        dy);
//   ssd90_pass_kernel    the elementwise pass over chunks, forward (h) or
//                        reverse (dh), in place over the per-chunk terms.
//
// Tiles. x, dy, B and C reach the kernels through 4-D TMA tensor maps
// (columns, heads or groups, sequence, batch) with their own strides, so
// the column views of the conv output that ssm_forward passes need no copy;
// a box is (64 columns, 1 head, Q rows), one 128-byte swizzle row per
// token, and rows past the sequence length arrive as zeros. Tiles keep
// attention_sm90.cuh's format: (128, 64) bf16 sub-tiles, 1024-byte aligned,
// a (128, 128) tile as two of them. Rows Q .. 127 of a tile are zeroed once
// when Q < 128 (TMA never writes them), so every product runs over 128
// rows. The row-scaled operands (w o x, exp(s) o dy) and the states (h_in,
// dh) are written by the threads in the same swizzled format, then made
// visible to the tensor cores with fence.proxy.async.
#pragma once

#include "attention_sm90.cuh"

namespace pam {
namespace ssd90 {

using sm90::bf16;

constexpr int kQ = 128;               // rows of a chunk tile
constexpr int kN = 128;               // d_state
constexpr int kP = 64;                // head dim
constexpr int kThreads = 256;         // two warpgroups
constexpr int kSubBytes = kQ * 128;   // a (128, 64) bf16 sub-tile
constexpr int kPassThreads = 256;     // state pass: float4 per thread
constexpr int kPassBlocks = kN * kP / 4 / kPassThreads;  // blocks a (b, h)
constexpr int kFrobParts = kPassBlocks * kPassThreads / 32;  // warps a (b, h)
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* dt;     // (B, L, H) post-softplus
  const float* a;      // (H,)
  const float* d;      // (H,)
  bf16* y;             // (B, L, H, P) forward output
  float* states;       // (B, H, nc, N, P) chunk-start states h_in
  float* dec;          // (2, B, H, nc, kQ): s_t, then the masked dt
  // backward
  bf16* dx;            // (B, L, H, P)
  float* ddt;          // (B, L, H)
  float* da;           // (H,)
  float* dd;           // (H,)
  bf16* db;            // (B, L, G, N)
  bf16* dc;
  float* dstates;      // (B, H, nc, N, P): V_c, then dh_c in place
  float* frob;         // (B, H, nc, kFrobParts) parts of <dh_c, h_in_c>
  float* rows;         // (4, B, H, nc, kQ): rowsum A' dt, g . (C h_in),
                       // colsum A', beta
  float* db_part;      // (B, H / hb, nc * Q, N) dB over a head block
  float* dc_part;
  float* da_part;      // (B, H, nc)
  float* dd_part;
  int B, L, H, G, Q, nc, hb;
};

// ------------------------------------------------------------ helpers
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Box (c0 .. c0 + 63, head, r0 .. r0 + rows - 1, batch) of a 4-D map (see
// make_seq_map) into `dst`; rows past the sequence arrive as zeros.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int head,
                                          int r0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)),
      "r"(c0), "r"(head), "r"(r0), "r"(batch)
      : "memory");
}

// Byte offset of element (row, col < 64) in a 128-byte-swizzled (rows, 64)
// bf16 sub-tile.
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ float2 ld_pair(const bf16* tile, int row,
                                          int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      reinterpret_cast<const uint8_t*>(tile) + sw128(row, col)));
}

// 16-byte chunk i (of 8 per row) of a swizzled sub-tile: 8 bf16 of row
// i / 8. Scaling a whole row needs no unswizzling.
__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 q = __bfloat1622float2(p[i]);
    f[2 * i] = q.x;
    f[2 * i + 1] = q.y;
  }
}

// 8 floats as bf16 (hi) and, when lo is given, bf16(f - hi).
__device__ __forceinline__ void pack8(const float (&f)[8], uint4* hi,
                                      uint4* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    h[i] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 back = __bfloat1622float2(v);
    l[i] = sm90::pack_bf16(f[2 * i] - back.x, f[2 * i + 1] - back.y);
  }
  *hi = make_uint4(h[0], h[1], h[2], h[3]);
  if (lo != nullptr) *lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// An (N, P) fp32 state in device memory (row-major) into a swizzled (128,
// 64) bf16 sub-tile `hi`, and the remainder into `lo` when given. All
// threads of the block; the caller fences and syncs.
__device__ __forceinline__ void state_to_tile(const float* __restrict__ src,
                                              bf16* hi, bf16* lo) {
  for (int i = threadIdx.x; i < kN * 8; i += kThreads) {
    const int row = i >> 3, ch = i & 7;
    const float4 a = *reinterpret_cast<const float4*>(src + row * kP + 8 * ch);
    const float4 b =
        *reinterpret_cast<const float4*>(src + row * kP + 8 * ch + 4);
    const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int off = row * 128 + ((ch ^ (row & 7)) << 4);
    pack8(f, reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(hi) + off),
          lo == nullptr ? nullptr
                        : reinterpret_cast<uint4*>(
                              reinterpret_cast<uint8_t*>(lo) + off));
  }
}

// Zero `bytes` (a multiple of 16) of shared memory from `p`; all threads.
__device__ __forceinline__ void zero_smem(uint8_t* p, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// The decay row of (batch, head, chunk): s_t (times log2 e) and dt_t
// into shared memory (kQ each), threads 0 .. kQ - 1.
__device__ __forceinline__ void load_decay(const Args& a, long long bhc,
                                           float* s2, float* dtv) {
  if (threadIdx.x < kQ) {
    const long long n = (long long)a.B * a.H * a.nc * kQ;
    s2[threadIdx.x] = a.dec[bhc * kQ + threadIdx.x] * kLog2e;
    dtv[threadIdx.x] = a.dec[n + bhc * kQ + threadIdx.x];
  }
}

// Sum over the block, to every thread (fixed order: deterministic); tmp
// holds kThreads / 32 floats.
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

// ------------------------------------------------------------ 1. decay
// One warp per (chunk, batch, head), four warps a block: the in-chunk
// inclusive prefix sum of dt a, 4 tokens a lane, then a shuffle scan of
// the lanes' totals. Tokens at or past the sequence length, and rows Q ..
// 127, get dt = 0, so s stays at s_{Q-1} there.
constexpr int kDecayWarps = 4;

__global__ void __launch_bounds__(32 * kDecayWarps)
    ssd90_decay_kernel(Args a) {
  const int ic = blockIdx.x, b = blockIdx.y;
  const int h = blockIdx.z * kDecayWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= a.H) return;
  const int p0 = ic * a.Q;
  const int valid = min(a.Q, a.L - p0);
  const float* src = a.dt + ((long long)b * a.L + p0) * a.H + h;
  const float A = a.a[h];
  float d[4], s[4], run = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    d[j] = t < valid ? src[(long long)t * a.H] : 0.f;
    run += d[j] * A;
    s[j] = run;
  }
  float off = run;  // inclusive scan of the lanes' totals
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, off, o);
    if (lane >= o) off += y;
  }
  off -= run;
  const long long n = (long long)a.B * a.H * a.nc * kQ;
  const long long row = (((long long)b * a.H + h) * a.nc + ic) * kQ;
  *reinterpret_cast<float4*>(a.dec + row + 4 * lane) =
      make_float4(s[0] + off, s[1] + off, s[2] + off, s[3] + off);
  *reinterpret_cast<float4*>(a.dec + n + row + 4 * lane) =
      make_float4(d[0], d[1], d[2], d[3]);
}

// ------------------------------------------------------------ 2. states
// out[b, h, c] = M^T (r o S) over the chunk's 128 rows, for the hb heads
// h0 .. h0 + hb - 1 of one group: M the (Q, 128) tile of the group (B or
// C), S the head's (Q, 64) tile (x or dy), r_t = w_t (FWD) or exp(s_t)
// (backward). r o S is rounded to bf16 as the B operand; with PAIR also its
// remainder, a second product. wgmma m64n64k16 with both operands MN-major:
// warpgroup wg computes rows n = 64 wg .. 64 wg + 63.
namespace state {
constexpr int kSmem = 2 * kSubBytes /* M */ + 2 * kSubBytes /* S stages */ +
                      2 * kSubBytes /* r o S, hi and lo */ + 8 * kQ + 64;
}

template <bool FWD>
__global__ void __launch_bounds__(kThreads, 1)
    ssd90_chunk_state_kernel(const __grid_constant__ CUtensorMap tmM,
                             const __grid_constant__ CUtensorMap tmS,
                             Args a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* Mt = reinterpret_cast<bf16*>(smem);           // 2 sub-tiles
  bf16* St = Mt + 2 * kQ * 64;                        // 2 stages
  bf16* Rh = St + 2 * kQ * 64;                        // r o S, hi
  bf16* Rl = Rh + kQ * 64;                            // r o S, lo
  float* s2 = reinterpret_cast<float*>(Rl + kQ * 64);
  float* dtv = s2 + kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dtv + kQ);  // M, S[2]

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int ic = blockIdx.x, b = blockIdx.y;
  const int h0 = blockIdx.z * a.hb;
  const int grp = h0 / (a.H / a.G);
  const int p0 = ic * a.Q;
  const uint32_t sbytes = a.Q * 128;
  float* out = FWD ? a.states : a.dstates;

  if (a.Q < kQ) zero_smem(smem, 4 * kSubBytes);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) bar_init(bars + i, 1);
    bar_fence_init();
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    bar_expect(bars, 2 * sbytes);
    tma_load4(Mt, &tmM, bars, 0, grp, p0, b);
    tma_load4(Mt + kQ * 64, &tmM, bars, 64, grp, p0, b);
    for (int j = 0; j < 2 && j < a.hb; ++j) {
      bar_expect(bars + 1 + j, sbytes);
      tma_load4(St + j * kQ * 64, &tmS, bars + 1 + j, 0, h0 + j, p0, b);
    }
  }
  bar_wait(bars, 0);

  for (int j = 0; j < a.hb; ++j) {
    const int h = h0 + j, st = j & 1;
    const long long bhc = ((long long)b * a.H + h) * a.nc + ic;
    __syncthreads();  // the previous head's products are complete
    if (tid == 0 && j >= 1 && j + 1 < a.hb) {  // stage of head j - 1
      const int so = (j + 1) & 1;
      bar_expect(bars + 1 + so, sbytes);
      tma_load4(St + so * kQ * 64, &tmS, bars + 1 + so, 0, h + 1, p0, b);
    }
    load_decay(a, bhc, s2, dtv);
    __syncthreads();
    bar_wait(bars + 1 + st, (j >> 1) & 1);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(St + st * kQ * 64);
    const float sq = s2[a.Q - 1];
    for (int i = tid; i < kQ * 8; i += kThreads) {
      const int row = i >> 3;
      const float r = FWD ? exp2f(sq - s2[row]) * dtv[row] : exp2f(s2[row]);
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(src + 16 * i), f);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] *= r;
      pack8(f, reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(Rh) +
                                        16 * i),
            FWD ? reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(Rl) +
                                           16 * i)
                : nullptr);
    }
    fence_async_smem();
    __syncthreads();

    float acc[32];
    zero(acc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64_tt(acc, desc_mn(Mt + wg * kQ * 64, kQ, kk),
                      desc_mn(Rh, kQ, kk));
    if (FWD) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_n64_tt(acc, desc_mn(Mt + wg * kQ * 64, kQ, kk),
                        desc_mn(Rl, kQ, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    float* o = out + bhc * kN * kP;
#pragma unroll
    for (int v = 0; v < 32; v += 2)
      *reinterpret_cast<float2*>(o + (64 * wg + frag_row(t, v)) * kP +
                                 frag_col(t, v)) =
          make_float2(acc[v], acc[v + 1]);
  }
}

// ------------------------------------------------------------ 3. the pass
// In place over the (B, H, nc, N, P) per-chunk terms: forward, slot c holds
// U_c and becomes h_c (h_0 = 0, h_c+1 = exp(s_Q,c) h_c + U_c); reverse,
// slot c holds V_c and becomes dh_c (dh_nc-1 = 0, dh_c-1 = exp(s_Q,c) dh_c
// + V_c), and with `hin` each chunk's parts of <dh_c, h_in_c> are written
// (one per warp, summed in a fixed order later). A block of 256 threads
// takes 1024 of a (batch, head)'s N P entries, a float4 a thread; the
// chunks' terms are loaded kBatch at a time before the dependent updates,
// so the loads are in flight together.
constexpr int kBatch = 8;

template <bool REVERSE>
__global__ void __launch_bounds__(kPassThreads)
    ssd90_pass_kernel(Args a, float* __restrict__ slots,
                      const float* __restrict__ hin) {
  const long long bh = blockIdx.y;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;  // float4 index
  const int step = kN * kP / 4;
  float4* base = reinterpret_cast<float4*>(slots + bh * a.nc * kN * kP) + e;
  const float4* hb =
      hin == nullptr ? nullptr
                     : reinterpret_cast<const float4*>(hin + bh * a.nc * kN *
                                                              kP) + e;
  const float* s = a.dec + bh * a.nc * kQ + (a.Q - 1);  // s_Q of chunk 0
  const int lane = threadIdx.x & 31;
  float* frob = a.frob + bh * a.nc * kFrobParts + (e >> 5);  // this warp's
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < a.nc; i0 += kBatch) {
    float4 v[kBatch], hv[kBatch];
    float el[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k;
      if (i >= a.nc) break;
      const int c = REVERSE ? a.nc - 1 - i : i;
      v[k] = base[(long long)c * step];
      if (REVERSE && hb != nullptr) hv[k] = hb[(long long)c * step];
      el[k] = expf(s[(long long)c * kQ]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k;
      if (i >= a.nc) break;
      const int c = REVERSE ? a.nc - 1 - i : i;
      base[(long long)c * step] = run;
      if (REVERSE && hb != nullptr) {
        float p = run.x * hv[k].x + run.y * hv[k].y + run.z * hv[k].z +
                  run.w * hv[k].w;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) frob[(long long)c * kFrobParts] = p;
      }
      run = make_float4(el[k] * run.x + v[k].x, el[k] * run.y + v[k].y,
                        el[k] * run.z + v[k].z, el[k] * run.w + v[k].w);
    }
  }
}

}  // namespace ssd90

// ------------------------------------------------------------ host side
// A 4-D map over a (batch, seq, heads, cols) bf16 tensor whose last axis is
// contiguous, with row (sequence) and batch strides in elements: dims (cols,
// heads, seq, batch), boxes of (64 columns, 1 head, box_rows rows, 1
// batch), 128-byte swizzle; reads past the sequence fill zeros. False if the
// driver refuses it (a base or a stride not a multiple of 16 bytes).
inline bool make_seq_map(CUtensorMap* map, const void* base, int cols,
                         int heads, int seq, int batch, long long row_stride,
                         long long batch_stride, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Strides of the SSD operands, in elements.
struct SeqStrides {
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// Decay terms, then one chunk-state kernel and the pass: the forward's
// states (FWD) or the backward's dstates.
template <bool FWD>
inline void launch_states(const ssd90::Args& a, const CUtensorMap& tmM,
                          const CUtensorMap& tmS, cudaStream_t stream) {
  using namespace ssd90;
  ssd90_decay_kernel<<<dim3(a.nc, a.B, (a.H + kDecayWarps - 1) / kDecayWarps),
                       32 * kDecayWarps, 0, stream>>>(a);
  auto k = ssd90_chunk_state_kernel<FWD>;
  const int smem = smem_with_align(state::kSmem);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<dim3(a.nc, a.B, a.H / a.hb), kThreads, smem, stream>>>(tmM, tmS, a);
  ssd90_pass_kernel<!FWD><<<dim3(kPassBlocks, a.B * a.H), kPassThreads, 0,
                            stream>>>(a, FWD ? a.states : a.dstates,
                                      FWD ? nullptr : a.states);
}

}  // namespace pam
