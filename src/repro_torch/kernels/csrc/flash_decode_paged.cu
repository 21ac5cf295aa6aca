// Decode attention over a paged KV pool through a block table.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_paged_decode_kernel
// (wrapper flash_decode_paged, pl.pallas_call at :314). One CUDA block per
// (run of R logical blocks, kv head h, batch b) walks its run of table
// entries itself (the TPU kernel's scalar prefetch): an entry is live when
// block_live[b, i] != 0 (when given) and its physical id lies in the pool
// slice [block_offset, block_offset + NB_local); a dead entry is skipped
// without touching KV. The participating tokens of the live pages (mask at
// logical positions) are compacted and their K/V rows for kv head h (row
// stride Hkv * D) staged by cp.async two tiles deep, and one running
// partial is kept across the run's pages (decode_common.cuh). Pool layout
// is (NB_local, bs, Hkv, D), ids localised by block_offset in the kernel.
//
// The stacked launch (flash_decode_paged) runs one block per logical block
// (R = 1), the reference's contract: a dead block writes the merge
// identity (O=0, m=-1e30, l=0). The merged launch
// (flash_decode_paged_merged) takes R from the wrapper's shape-only choice,
// keeps one partial per run, writes every position's score, and merges
// the runs of a (batch, kv head) inside their cluster.
//
// Bound on the H100: bytes read from HBM, the participating tokens' K/V
// rows over 3.35 TB/s, plus the table, masks and outputs. Dead pages cost
// one table-entry read; only participating rows are loaded.
#include "decode_common.cuh"

namespace pam {

constexpr int kMaxRunPages = 128;   // table entries a block walks

struct PagedArgs {
  const void* q;           // (B, H, D) fp32 or bf16
  const void* k_pool;      // (NB_local, bs, Hkv, D)
  const void* v_pool;
  const int32_t* table;    // (B, nb) physical ids
  const uint8_t* live;     // (B, nb) bool, or nullptr (all live)
  const uint8_t* mask;     // (B, nb * bs) logical participation
  Outputs out;
  int B, H, Hkv, nb, bs, R, nb_local, block_offset, tile;
  float scale;
};

template <typename T, int D>
struct PagedSrc {
  struct Raw {
    uint8_t m;
    uint8_t live;
    int32_t id;
  };
  const T* k_pool;         // kv head h of row 0 of physical block 0
  const T* v_pool;
  const int32_t* table;    // the run's first table entry
  const uint8_t* blive;    // its block_live entry, or nullptr
  const uint8_t* mask;     // mask entry of the run's first position
  int* phys;               // shared: the run's local ids, -1 when dead
  long p0;
  long page_stride;        // elements between physical blocks
  long row_stride;         // elements between rows of a block (Hkv * D)
  int bs, n, nb_local, block_offset;

  __device__ Raw fetch(int t) const {
    const int i = t / bs;
    return {mask[t], blive ? blive[i] : uint8_t(1), table[i]};
  }
  // records the page's local id (first token of a page), then decides
  __device__ bool live(int t, const Raw& raw) const {
    const int local = raw.id - block_offset;
    const bool ok = (raw.live != 0) & (local >= 0) & (local < nb_local);
    if (t % bs == 0) phys[t / bs] = ok ? local : -1;
    return ok & (raw.m != 0);
  }
  __device__ long pos(int t) const { return p0 + t; }
  __device__ const T* row(int t, int kv) const {
    const long off = phys[t / bs] * page_stride + (t % bs) * row_stride;
    return (kv ? v_pool : k_pool) + off;
  }
};

template <typename T, typename TQ, int D, int REP, bool MERGED>
__global__ void __launch_bounds__(kThreads)
    flash_decode_paged_kernel(PagedArgs a) {
  __shared__ typename BlockSmem<D, REP, MERGED>::type sm;
  __shared__ int phys[kMaxRunPages];
  extern __shared__ __align__(16) unsigned char dyn[];
  const int run = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = run * a.R;
  const long bi = (long)b * a.nb + i0;
  PagedSrc<T, D> src;
  src.k_pool = static_cast<const T*>(a.k_pool) + (long)h * D;
  src.v_pool = static_cast<const T*>(a.v_pool) + (long)h * D;
  src.table = a.table + bi;
  src.blive = a.live == nullptr ? nullptr : a.live + bi;
  src.phys = phys;
  src.p0 = (long)i0 * a.bs;
  src.mask = a.mask + bi * a.bs;
  src.row_stride = (long)a.Hkv * D;
  src.page_stride = (long)a.bs * src.row_stride;
  src.bs = a.bs;
  src.n = min(a.R, a.nb - i0) * a.bs;
  src.nb_local = a.nb_local;
  src.block_offset = a.block_offset;
  const long row0 = (long)b * a.H + (long)h * REP;
  const TQ* q = static_cast<const TQ*>(a.q) + row0 * D;
  if constexpr (REP > kMaxNarrowRep)
    attend_run_wide<T, TQ, D, REP, MERGED>(src, q, a.scale, a.tile,
                                           a.R * a.bs, row0, a.out, sm, dyn);
  else
    attend_run<T, TQ, D, REP, MERGED>(src, q, a.scale, a.tile, a.R * a.bs,
                                      row0, a.out, sm, dyn);
}

template <typename T, typename TQ, int D, int REP>
struct LaunchPaged {
  static cudaError_t run(PagedArgs a, cudaStream_t stream) {
    const dim3 grid(a.out.nsplit, a.Hkv, a.B);
    a.tile = tile_rows<T, D>(a.R * a.bs);
    const size_t smem = dyn_smem_bytes<T, D>(a.tile, a.R * a.bs);
    if (a.out.merged)
      return launch_run_kernel<flash_decode_paged_kernel<T, TQ, D, REP, true>>(
          grid, smem, true, stream, a);
    return launch_run_kernel<flash_decode_paged_kernel<T, TQ, D, REP, false>>(
        grid, smem, false, stream, a);
  }
};

}  // namespace pam

// dtype / qtype: 0 = float32, 1 = bfloat16 (pool storage, q). A block
// walks R table entries (at most 128); nruns = ceil(nb / R). Outputs as
// pam_flash_decode's, with runs in place of splits and scores (B, H,
// nb * bs). Returns 0, a CUDA error code, or -1 for an unsupported
// (dtype, qtype, D, rep), run length or number of merged runs.
extern "C" int pam_flash_decode_paged(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* live, const void* mask, void* o, void* m, void* l,
    void* scores, int B, int H, int Hkv, int nb, int bs, int D, int R,
    int nruns, int merged, int nb_local, int block_offset, float scale,
    int dtype, int qtype, void* stream) {
  if (R < 1 || R > pam::kMaxRunPages) return -1;
  if (merged && nruns > pam::kMaxSplits) return -1;
  pam::PagedArgs a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.table = static_cast<const int32_t*>(table);
  a.live = static_cast<const uint8_t*>(live);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = {static_cast<float*>(o), static_cast<float*>(m),
           static_cast<float*>(l), static_cast<float*>(scores),
           (long)nb * bs, nruns, merged != 0};
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.nb = nb;
  a.bs = bs;
  a.R = R;
  a.nb_local = nb_local;
  a.block_offset = block_offset;
  a.scale = scale;
  return pam::dispatch<pam::LaunchPaged>(dtype, qtype, D, H / Hkv, a,
                                         static_cast<cudaStream_t>(stream));
}
