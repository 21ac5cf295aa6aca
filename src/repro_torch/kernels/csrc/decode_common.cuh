// Shared device code of the split-KV decode kernels (flash_decode.cu,
// flash_decode_paged.cu). One CUDA block of 128 threads attends the REP
// query heads that share one kv head over a run of tokens (a split of a
// dense cache, or a run of logical blocks of a paged pool) and writes the
// run's partial triple (O, m, l) per query head, the quantity the TPU
// kernels emit; optionally it also writes the fp32 scaled score of every
// token of the run (-1e30 where the token does not participate), and a
// merged launch reduces the runs of a (batch, kv head) in run order.
//
// Bound on the H100: bytes and latency. At GQA group 2 the work is about 4
// FLOPs per byte of bf16 K/V, a fifth of the fp32 peak at full HBM rate,
// and q and P must stay fp32 (the tolerance refuses bf16 tensor-core
// operands), so the arithmetic is fp32 on the CUDA cores. The design:
//   1. compaction: the block first evaluates every token's participation
//      (length bounds, mask, live page; all of these loads and q's in
//      flight together) and writes a packed list of the participating
//      tokens into shared memory (warp ballots, in token order);
//      non-participating tokens get their -1e30 score here and are never
//      staged, so a tile holds only live rows;
//   2. staging: the K and V rows of a tile of listed tokens (about 30 KB a
//      block: the whole run when one stage holds it, at head dim 128 up to
//      56 bf16 / 29 fp32 rows, else two stages of 24 bf16 / 8 fp32 rows)
//      are copied into shared
//      memory with cp.async, 16 bytes a lane, two tiles deep; every load of
//      a tile is issued before its first dot product, and the next tile's
//      loads fly during this one's arithmetic. Rows are padded by 16 bytes
//      so that lane-per-token reads of 16-byte chunks hit distinct banks;
//   3. QK^T, one lane per (token, query head): each warp owns a contiguous
//      block of a tile's rows, and a lane computes a whole dot product from
//      shared memory, q in shared memory as fp32 (a broadcast read), four
//      independent accumulators, no cross-lane reduction;
//   4. online softmax on the tile, fp32, per warp: the max and sum over
//      the warp's rows of a head by shuffles in a 16-lane segment, the
//      running (m, l) in registers, so the warps never wait on each other
//      inside a tile (two block barriers a tile, both for the staging);
//   5. PV, one lane per output dimension (4 of them at head dim 128), P
//      broadcast by shuffle from the lane that scored the row, the
//      accumulators in registers; the four warps' partials merge in warp
//      order at the end of the run;
//   6. merge (the merged launch): the runs of one (batch, kv head) form a
//      thread-block cluster of at most 8 blocks; each run stores its
//      (O, m, l) into rank 0's shared memory and arrives on rank 0's
//      mbarrier (release, cluster scope), then exits; rank 0 waits for
//      every arrival and reduces the partials in run order, so no partial
//      goes through device memory and the arithmetic has no atomics.
// exp is __expf (ex2.approx): its relative error, about 2^-21 near the
// arguments softmax uses, is far inside the tolerance against the plain
// version (rtol 1e-4); the scores are exact fp32 dot products.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pam {

// Dead-partition sentinel of the TPU kernels (flash_decode.py NEG_INF): a
// run with no live token emits (O=0, m=-1e30, l=0), and a token that does
// not participate scores -1e30.
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;    // listed tokens staged per tile
constexpr int kPerThread = 4;   // candidates a thread tests per pass
constexpr int kMaxSplits = 8;   // runs merged in one (portable) cluster

// Shared-memory geometry of a K or V row of D elements of T.
template <typename T, int D>
struct Row {
  static constexpr int kBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kBytes / 16;   // 16-byte cp.async chunks
  static constexpr int kPitch = kBytes + 16;    // padded: conflict-free
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static_assert(kBytes % 16 == 0, "rows must be whole 16-byte chunks");
};

// Bytes of a run's token list, rounded up to the 16-byte chunk.
__host__ __device__ __forceinline__ long list_bytes(int cap) {
  return (4L * cap + 15) & ~15L;
}

// Tile rows the host launches with for a run of L tokens: about 30 KB of
// staged K/V a block (so that five or more blocks share an SM and a grid
// of four blocks an SM is resident at once), one stage when the run fits
// it, else two stages of a multiple of 8 rows.
template <typename T, int D>
inline int tile_rows(int L) {
  constexpr int kBudget = 30 * 1024;
  constexpr int kPitch = Row<T, D>::kPitch;
  constexpr int one = kBudget / (2 * kPitch) < kMaxTile
                          ? kBudget / (2 * kPitch) : kMaxTile;
  constexpr int two = kBudget / (4 * kPitch) / 8 * 8 < kMaxTile
                          ? kBudget / (4 * kPitch) / 8 * 8 : kMaxTile;
  return L <= one ? L : two;
}

// The cluster barrier in two halves, so that its latency hides behind
// other work: a relaxed arrive, later the wait (acquire). Every thread of
// every block of the cluster takes part.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The merge's arrival barrier in rank 0's shared memory: every thread of
// every run arrives once (release, cluster scope) after pushing its part
// of the run's partial; rank 0 waits for phase 0 (acquire).
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(a),
      "r"(count)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_rank0(unsigned long long* bar) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
               : "=r"(remote)
               : "r"(a));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}
__device__ __forceinline__ void mbar_wait_phase0(unsigned long long* bar) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n.reg .pred done;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "0;\n@!done bra WAIT%=;\n}\n" ::"r"(a)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ float to_float(T x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

// One 16-byte chunk of a row as fp32 (8 bf16 or 4 fp32 values).
template <typename T>
__device__ __forceinline__ void chunk_to_float(const uint4& raw,
                                               float (&f)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  } else {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> fp32 is a 16-bit shift: low half first (little endian)
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Rank 0's side of a merged launch: every run's pushed partial, the merge
// weights and the arrival barrier.
template <int D, int REP>
struct MergeSlots {
  float o[kMaxSplits][REP][D];
  float m[kMaxSplits][REP];
  float l[kMaxSplits][REP];
  float w[kMaxSplits][REP];
  unsigned long long arrived;
};
struct NoSlots {};

// EPL consecutive elements of a staged row as fp32 (EPL 1 or 4).
template <typename T, int EPL>
__device__ __forceinline__ void load_dims(const T* p, float (&v)[EPL]) {
  static_assert(EPL == 1 || EPL == 4, "head dim 16 or 128");
  if constexpr (EPL == 1) {
    v[0] = to_float(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  }
}

// Per-block state outside the staged tiles.
template <int D, int REP, bool MERGED>
struct RunSmem {
  alignas(16) float q[REP][D];  // the group's query rows, fp32
  float wm[kWarps][REP];        // each warp's running (m, l) and O at the
  float wl[kWarps][REP];        // end of the run
  float wo[kWarps][REP][D];
  int warp_count[kPerThread][kWarps];
  std::conditional_t<MERGED, MergeSlots<D, REP>, NoSlots> slots;
};

// Where a block's outputs go. A stacked launch writes its run's partial
// to o (rows, nsplit, D), m / l (rows, nsplit), row = b * H + query head;
// a merged launch (a cluster of the nsplit runs of one batch row and kv
// head) writes the merged o (rows, D), m / l (rows).
struct Outputs {
  float* o;
  float* m;
  float* l;
  float* scores;      // (rows, n_pos) or nullptr
  long n_pos;         // score positions per row (S or nb * bs)
  int nsplit;
  bool merged;
};

// Attend the REP query heads of kv head h of batch b over one run. Src is
// the run's token source:
//   int n                    candidate tokens of the run
//   Raw fetch(t)             the global loads that decide participation
//   bool live(t, raw)        participation from them (a paged source also
//                            records the page of t in shared memory)
//   long pos(t)              absolute position of candidate t
//   const T* row(t, kv)      the K (kv=0) or V (kv=1) row of candidate t
// q points at the group's first query row ((REP, D) of TQ). The dynamic
// shared memory (dyn_smem_bytes) holds the list of up to `cap` >= Src::n
// token indices, then one or two stages of `tile` K and V rows. Every
// thread of the block must call this.
template <typename T, typename TQ, int D, int REP, bool MERGED,
          typename Src>
__device__ __forceinline__ void attend_run(
    const Src& src, const TQ* __restrict__ q, float scale, int tile,
    int cap, long row0, const Outputs& out, RunSmem<D, REP, MERGED>& sm,
    unsigned char* dyn) {
  using R = Row<T, D>;
  static_assert(kThreads % D == 0, "head dim divides the block");
  constexpr int QPT = (REP * D + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* list = reinterpret_cast<int*>(dyn);
  unsigned char* stage = dyn + list_bytes(cap);          // [stage][K|V][tile]

  if constexpr (MERGED) {   // rank 0's arrival barrier; "this block runs"
    if (blockIdx.x == 0 && tid == 0)
      mbar_init(&sm.slots.arrived, out.nsplit * kThreads);
    cluster_arrive_relaxed();
  }
  float qv[QPT];    // in flight with the participation loads below
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * kThreads;
    qv[k] = i < REP * D ? to_float(q[i]) : 0.f;
  }

  // 1. participation of kPerThread candidates a thread, their loads all
  // in flight together, then compaction in token order
  int n_live = 0;
  for (int p0 = 0; p0 < src.n; p0 += kPerThread * kThreads) {
    typename Src::Raw raw[kPerThread];
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int t = p0 + c * kThreads + tid;
      if (t < src.n) raw[c] = src.fetch(t);
    }
    if (p0 == 0) {
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const int i = tid + k * kThreads;
        if (i < REP * D) sm.q[i / D][i % D] = qv[k];
      }
    }
    bool lv[kPerThread];
    unsigned ballot[kPerThread];
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int t = p0 + c * kThreads + tid;
      lv[c] = t < src.n && src.live(t, raw[c]);
      if (t < src.n && !lv[c] && out.scores != nullptr) {
#pragma unroll
        for (int r = 0; r < REP; ++r)
          out.scores[(row0 + r) * out.n_pos + src.pos(t)] = kNegInf;
      }
      ballot[c] = __ballot_sync(0xffffffffu, lv[c]);
      if (lane == 0) sm.warp_count[c][warp] = __popc(ballot[c]);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      int before = n_live;
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int cnt = sm.warp_count[c][w];
        before += w < warp ? cnt : 0;
        total += cnt;
      }
      if (lv[c])
        list[before + __popc(ballot[c] & ((1u << lane) - 1u))] =
            p0 + c * kThreads + tid;
      n_live += total;
    }
    __syncthreads();
  }

  // 2. staging: tile i of the list into stage i % 2, a warp copying
  // 32 / kChunks rows a step, one 16-byte chunk a lane
  const int ntiles = (n_live + tile - 1) / tile;
  auto issue = [&](int i) {
    constexpr int kRowsPerStep = 32 / R::kChunks;
    unsigned char* buf = stage + 2L * (i & 1) * tile * R::kPitch;
    const int j0 = i * tile;
    const int rows = min(tile, n_live - j0);
    const int ch = (lane % R::kChunks) * 16;
    for (int j = warp * kRowsPerStep + lane / R::kChunks; j < rows;
         j += kWarps * kRowsPerStep) {
      const int t = list[j0 + j];
      cp_async16(buf + (long)j * R::kPitch + ch,
                 reinterpret_cast<const unsigned char*>(src.row(t, 0)) + ch);
      cp_async16(buf + (long)(tile + j) * R::kPitch + ch,
                 reinterpret_cast<const unsigned char*>(src.row(t, 1)) + ch);
    }
    cp_async_commit();
  };
  if (ntiles > 0) issue(0);
  if (ntiles > 1) issue(1);

  // Each warp owns a contiguous block of every tile's rows (at most 16;
  // contiguous, so that lane-per-row reads of 16-byte chunks hit distinct
  // banks) and keeps its own online softmax: lane (r, u) = (lane / 16,
  // lane % 16) scores the warp's row u for head r; for PV, a lane holds
  // head dims [lane * EPL, lane * EPL + EPL) of every head.
  constexpr int EPL = D >= 32 ? D / 32 : 1;
  constexpr int kRowsPerWarp = kMaxTile / kWarps;
  static_assert(REP * kRowsPerWarp <= 32, "one lane per (head, row)");
  const bool has_dims = lane * EPL < D;
  float m_run[REP];
  float l_run[REP];
  float acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }
  const int qr = lane / kRowsPerWarp;   // this lane's head and row in QK
  const int qu = lane % kRowsPerWarp;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // every thread's copies of tile i have landed
    const unsigned char* kbuf = stage + 2L * (i & 1) * tile * R::kPitch;
    const unsigned char* vbuf = kbuf + (long)tile * R::kPitch;
    const int j0 = i * tile;
    const int rows = min(tile, n_live - j0);
    // a short tile spreads over the warps (latency); a longer one fills
    // 16 rows a warp, every lane of a warp scoring (throughput)
    const int per = rows <= kRowsPerWarp ? (rows + kWarps - 1) / kWarps
                                         : kRowsPerWarp;
    const int w0 = warp * per;                       // the warp's rows
    const int nw = max(0, min(per, rows - w0));
    if (nw > 0) {      // warp-uniform
      // 3. QK^T: lane (r, u) computes the whole dot product of its row
      const bool mine = qr < REP && qu < nw;
      float s = kNegInf;
      if (mine) {
        const int j = w0 + qu;
        const uint4* kr =
            reinterpret_cast<const uint4*>(kbuf + j * R::kPitch);
        const float4* q4 = reinterpret_cast<const float4*>(sm.q[qr]);
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < R::kChunks; ++c) {
          float kf[R::kElems];
          chunk_to_float<T>(kr[c], kf);
#pragma unroll
          for (int e4 = 0; e4 < R::kElems / 4; ++e4) {
            const float4 qv4 = q4[c * (R::kElems / 4) + e4];
            a[0] = fmaf(qv4.x, kf[4 * e4], a[0]);
            a[1] = fmaf(qv4.y, kf[4 * e4 + 1], a[1]);
            a[2] = fmaf(qv4.z, kf[4 * e4 + 2], a[2]);
            a[3] = fmaf(qv4.w, kf[4 * e4 + 3], a[3]);
          }
        }
        s = ((a[0] + a[1]) + (a[2] + a[3])) * scale;
        if (out.scores != nullptr)
          out.scores[(row0 + qr) * out.n_pos + src.pos(list[j0 + j])] = s;
      }
      // 4. online softmax, one 16-lane segment a head, in registers
      float mx = s;
#pragma unroll
      for (int o = kRowsPerWarp / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float m_new[REP];
      float corr[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float t = __shfl_sync(0xffffffffu, mx, r * kRowsPerWarp);
        m_new[r] = fmaxf(m_run[r], t);
        corr[r] = __expf(m_run[r] - m_new[r]);
      }
      float mq = m_new[0];
#pragma unroll
      for (int r = 1; r < REP; ++r) mq = qr == r ? m_new[r] : mq;
      const float p = mine ? __expf(s - mq) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = kRowsPerWarp / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float t = __shfl_sync(0xffffffffu, sum, r * kRowsPerWarp);
        l_run[r] = l_run[r] * corr[r] + t;
        m_run[r] = m_new[r];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] *= corr[r];
      }
      // 5. PV: lane-per-dimension, P broadcast from the scoring lane
      for (int u = 0; u < nw; ++u) {
        float pr[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r)
          pr[r] = __shfl_sync(0xffffffffu, p, r * kRowsPerWarp + u);
        if (has_dims) {
          float v[EPL];
          load_dims<T, EPL>(reinterpret_cast<const T*>(
              vbuf + (w0 + u) * R::kPitch) + lane * EPL, v);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[r][e] = fmaf(pr[r], v[e], acc[r][e]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for tile i + 2
    if (i + 2 < ntiles) issue(i + 2);
  }

  // the run's partial: merge the warps' partials in warp order
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm.wm[warp][r] = m_run[r];
      sm.wl[warp][r] = l_run[r];
    }
    if (has_dims) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm.wo[warp][r][lane * EPL + e] = acc[r][e];
    }
  }
  __syncthreads();
  const int run = blockIdx.x;
  namespace cg = cooperative_groups;
  float* slot_o = nullptr;
  if constexpr (MERGED) {
    // merge: the cluster holds this (b, kv head)'s runs, one block each
    // (the grid's x); every run pushes (O, m, l) into rank 0's shared
    // memory, which reduces them in run order (osm.merge_many with finite
    // sentinels: an all-dead row keeps m = -1e30 and o = l = 0)
    cluster_wait();   // every block has started: rank 0's memory exists
    cg::cluster_group cluster = cg::this_cluster();
    slot_o = cluster.map_shared_rank(&sm.slots.o[run][0][0], 0);
  }
  for (int idx = tid; idx < REP * D; idx += kThreads) {
    const int r = idx / D;
    const int e = idx - r * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.wm[w][r]);
    float o = 0.f;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(sm.wm[w][r] - mx);   // all dead: 1, o = l = 0
      o += c * sm.wo[w][r][e];
      l += c * sm.wl[w][r];
    }
    if constexpr (MERGED) {
      slot_o[idx] = o;
      if (e == 0) {
        *cg::this_cluster().map_shared_rank(&sm.slots.m[run][r], 0) = mx;
        *cg::this_cluster().map_shared_rank(&sm.slots.l[run][r], 0) = l;
      }
    } else {
      const long prow = (row0 + r) * out.nsplit + run;
      out.o[prow * D + e] = o;
      if (e == 0) {
        out.m[prow] = mx;
        out.l[prow] = l;
      }
    }
  }
  if constexpr (MERGED) {
    mbar_arrive_rank0(&sm.slots.arrived);   // releases this thread's pushes
    if (run != 0) return;
    mbar_wait_phase0(&sm.slots.arrived);
    const int ns = out.nsplit;
    if (tid < REP) {
      const int r = tid;
      float mx = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < ns) mx = fmaxf(mx, sm.slots.m[s][r]);
      float l = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        const float w = s < ns ? __expf(sm.slots.m[s][r] - mx) : 0.f;
        sm.slots.w[s][r] = w;
        l += w * (s < ns ? sm.slots.l[s][r] : 0.f);
      }
      out.m[row0 + r] = mx;
      out.l[row0 + r] = l;
    }
    __syncthreads();
    for (int idx = tid; idx < REP * D; idx += kThreads) {
      const int r = idx / D;
      const int e = idx - r * D;
      float o = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        o += s < ns ? sm.slots.w[s][r] * sm.slots.o[s][r][e] : 0.f;
      out.o[(row0 + r) * D + e] = o;
    }
  }
}

// Dynamic shared memory of a launch: the token list of a run of L
// candidates, then the stages of `tile` K and V rows (one stage when a run
// fits one tile).
template <typename T, int D>
inline size_t dyn_smem_bytes(int tile, int L) {
  const size_t stages = L > tile ? 2 : 1;
  return list_bytes(L) + stages * 2 * tile * Row<T, D>::kPitch;
}

// Dispatch over the built (K/V dtype, q dtype, head dim, group size): the
// dims and GQA groups of the port's configs (qwen3-0.6b: 128/2,
// pam-llama-7b: 128/1, their reduced variants: 16/2). The Python wrappers
// check the same sets before launching. Launch must be a functor template:
// Launch<T, TQ, D, REP>::run(args, stream) returning a cudaError_t.
template <template <typename, typename, int, int> class Launch, typename T,
          typename TQ, int D, typename Args>
int dispatch_rep(int rep, const Args& a, cudaStream_t stream) {
  switch (rep) {
    case 1: return static_cast<int>(Launch<T, TQ, D, 1>::run(a, stream));
    case 2: return static_cast<int>(Launch<T, TQ, D, 2>::run(a, stream));
    default: return -1;
  }
}

template <template <typename, typename, int, int> class Launch, typename T,
          typename TQ, typename Args>
int dispatch_d(int d, int rep, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return dispatch_rep<Launch, T, TQ, 16>(rep, a, stream);
    case 128: return dispatch_rep<Launch, T, TQ, 128>(rep, a, stream);
    default: return -1;
  }
}

template <template <typename, typename, int, int> class Launch, typename T,
          typename Args>
int dispatch_q(int qtype, int d, int rep, const Args& a,
               cudaStream_t stream) {
  switch (qtype) {
    case 0: return dispatch_d<Launch, T, float>(d, rep, a, stream);
    case 1: return dispatch_d<Launch, T, __nv_bfloat16>(d, rep, a, stream);
    default: return -1;
  }
}

template <template <typename, typename, int, int> class Launch,
          typename Args>
int dispatch(int dtype, int qtype, int d, int rep, const Args& a,
             cudaStream_t stream) {
  switch (dtype) {
    case 0: return dispatch_q<Launch, float>(qtype, d, rep, a, stream);
    case 1: return dispatch_q<Launch, __nv_bfloat16>(qtype, d, rep, a, stream);
    default: return -1;
  }
}

// Launch a decode kernel with `smem` bytes of dynamic shared memory
// (opting in above 48 KB once per kernel); a merged launch (Kernel is the
// MERGED instantiation) groups the grid's x dimension, the runs of one
// batch row and kv head, into one cluster.
template <auto Kernel, typename Args>
cudaError_t launch_run_kernel(dim3 grid, size_t smem, bool merged,
                              cudaStream_t stream, const Args& a) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  if (!merged) {
    Kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = grid.x;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel, a);
}

}  // namespace pam
