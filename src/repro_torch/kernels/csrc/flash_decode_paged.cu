// Decode attention over a paged KV pool through a block table.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_paged_decode_kernel
// (wrapper flash_decode_paged, pl.pallas_call at :314). One CUDA block per
// (logical block i, kv head h, batch b) reads block_table[b, i] and
// block_live[b, i] itself (the TPU kernel's scalar prefetch): a dead block
// writes the merge identity (O=0, m=-1e30, l=0) without touching KV; a live
// block attends the REP grouped query heads over the bs tokens of physical
// block table[b, i] at kv head h and writes the block's (O, m, l). Pool
// layout is (NB+1, bs, Hkv, D), sentinel block last; the wrapper has
// already remapped dead table entries onto the sentinel and localised
// block ids (block_offset).
//
// Bound on the H100: bytes read from HBM — the live tokens' K/V rows over
// 3.35 TB/s. Pages with no participating token cost one 4-byte table read
// and the identity write; inside a live page only participating rows are
// loaded. Each row is one coalesced load per warp. Not yet done: folding
// the union-mass scores into this walk (the reference still scores the
// whole logical gather in plain tensor code) and cp.async/TMA staging.
#include "decode_common.cuh"

namespace pam {

struct PagedArgs {
  const float* q;        // (B, H, D) fp32
  const void* k_pool;    // (NB+1, bs, Hkv, D)
  const void* v_pool;
  const int32_t* table;  // (B, nb) physical ids, dead entries -> sentinel
  const int32_t* live;   // (B, nb)
  const int8_t* mask;    // (B, nb*bs) logical participation
  float* o;              // (B, H, nb, D)
  float* m;              // (B, H, nb)
  float* l;
  int B, H, Hkv, nb, bs;
  float scale;
};

// Warps per block: a pool block holds bs (16 on the main path) tokens.
constexpr int kPagedWarps = 4;

template <typename T, int D, int REP>
__global__ void flash_decode_paged_kernel(PagedArgs a) {
  constexpr int NW = kPagedWarps;
  __shared__ MergeSmem<D, REP, NW> sm;
  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long bi = (long)b * a.nb + i;
  const long qrow = (long)b * a.H + (long)h * REP;
  const long out = qrow * a.nb + i;
  if (a.live[bi] == 0) {  // whole block takes this branch
    write_identity<D, REP>(a.o + out * D, (long)a.nb * D, a.m + out,
                           a.l + out, a.nb);
    return;
  }
  const long phys = a.table[bi];
  const long base = (phys * a.bs * a.Hkv + h) * D;
  attend_tokens<T, D, REP, NW>(
      a.q + qrow * D, static_cast<const T*>(a.k_pool) + base,
      static_cast<const T*>(a.v_pool) + base, (long)a.Hkv * D, a.bs, a.bs,
      a.mask + bi * a.bs, a.scale, a.o + out * D, (long)a.nb * D, a.m + out,
      a.l + out, a.nb, sm);
}

template <typename T, int D, int REP>
struct LaunchPaged {
  static void run(const PagedArgs& a, cudaStream_t stream) {
    const dim3 grid(a.nb, a.Hkv, a.B);
    flash_decode_paged_kernel<T, D, REP><<<grid, kPagedWarps * 32, 0,
                                            stream>>>(a);
  }
};

}  // namespace pam

// dtype: 0 = float32, 1 = bfloat16 (pool storage). Returns 0, a CUDA error
// code from cudaGetLastError(), or -1 for an unsupported (dtype, D, rep).
extern "C" int pam_flash_decode_paged(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* live, const void* mask,
                                      void* o, void* m, void* l, int B, int H,
                                      int Hkv, int nb, int bs, int D,
                                      float scale, int dtype, void* stream) {
  pam::PagedArgs a;
  a.q = static_cast<const float*>(q);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.table = static_cast<const int32_t*>(table);
  a.live = static_cast<const int32_t*>(live);
  a.mask = static_cast<const int8_t*>(mask);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.nb = nb;
  a.bs = bs;
  a.scale = scale;
  return pam::dispatch<pam::LaunchPaged>(dtype, D, H / Hkv, a,
                                         static_cast<cudaStream_t>(stream));
}
