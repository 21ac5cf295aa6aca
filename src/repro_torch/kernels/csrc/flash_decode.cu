// Split-KV decode attention over a dense (B, Hkv, S, D) cache.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_decode_kernel
// (wrapper flash_decode, pl.pallas_call at :173). One CUDA block per
// (split of L tokens, kv head, batch) attends the REP grouped query heads
// over its split (decode_common.cuh: participating tokens compacted,
// their K/V rows staged by cp.async two tiles deep, lane-per-token QK^T,
// fp32 online softmax, lane-per-dimension PV). The stacked launch
// (flash_decode) uses the reference's block_s as L and writes each
// split's (O, m, l); the merged launch (flash_decode_merged) takes L from
// the wrapper's shape-only choice (at least two waves of blocks on the
// card where at most 8 splits allow it), also writes every token's score,
// and merges the splits of a (batch, kv head) inside their cluster.
//
// Bound on the H100: bytes, and the latency of a short cache. The design
// reads only participating rows, each once, with all of a tile's loads in
// flight before its arithmetic, and keeps enough blocks in flight to cover
// the latency. The participation of token t is t < kv_len, t < kv_lens[b]
// (when given) and mask[b, t] != 0 (when given), all read in the kernel.
#include "decode_common.cuh"

namespace pam {

struct DenseArgs {
  const void* q;          // (B, H, D) fp32 or bf16
  const void* k;          // (B, Hkv, S, D)
  const void* v;
  const uint8_t* mask;    // (B, S) bool, or nullptr
  const int32_t* lens;    // (B,) int32, or nullptr
  Outputs out;
  int B, H, Hkv, S, L, kv_len, tile;
  float scale;
};

template <typename T, int D>
struct DenseSrc {
  struct Raw {
    uint8_t m;
    int len;
  };
  const T* k;             // row 0 of the split
  const T* v;
  const uint8_t* mask;    // mask entry of row 0, or nullptr
  const int32_t* len;     // this row's kv_lens entry, or nullptr
  long t0;
  int n;                  // rows of the split inside S
  int limit;              // kv_len - t0, clamped to the split

  __device__ Raw fetch(int t) const {
    return {mask ? mask[t] : uint8_t(1), len ? *len : 0x7fffffff};
  }
  __device__ bool live(int t, const Raw& raw) const {
    return (t < limit) & (t0 + t < raw.len) & (raw.m != 0);
  }
  __device__ long pos(int t) const { return t0 + t; }
  __device__ const T* row(int t, int kv) const {
    return (kv ? v : k) + (long)t * D;
  }
};

template <typename T, typename TQ, int D, int REP, bool MERGED>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(DenseArgs a) {
  __shared__ RunSmem<D, REP, MERGED> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long t0 = (long)split * a.L;
  const long head = (long)b * a.Hkv + h;
  DenseSrc<T, D> src;
  src.k = static_cast<const T*>(a.k) + (head * a.S + t0) * D;
  src.v = static_cast<const T*>(a.v) + (head * a.S + t0) * D;
  src.mask = a.mask == nullptr ? nullptr : a.mask + (long)b * a.S + t0;
  src.len = a.lens == nullptr ? nullptr : a.lens + b;
  src.t0 = t0;
  src.n = (int)min((long)a.L, a.S - t0);
  src.limit = (int)max(-1L, min((long)a.kv_len - t0, (long)a.L));
  const long row0 = (long)b * a.H + (long)h * REP;
  attend_run<T, TQ, D, REP, MERGED>(src, static_cast<const TQ*>(a.q) + row0 * D,
                            a.scale, a.tile, a.L, row0, a.out, sm, dyn);
}

template <typename T, typename TQ, int D, int REP>
struct LaunchDense {
  static cudaError_t run(DenseArgs a, cudaStream_t stream) {
    const dim3 grid(a.out.nsplit, a.Hkv, a.B);
    a.tile = tile_rows<T, D>(a.L);
    const size_t smem = dyn_smem_bytes<T, D>(a.tile, a.L);
    if (a.out.merged)
      return launch_run_kernel<flash_decode_kernel<T, TQ, D, REP, true>>(
          grid, smem, true, stream, a);
    return launch_run_kernel<flash_decode_kernel<T, TQ, D, REP, false>>(
        grid, smem, false, stream, a);
  }
};

}  // namespace pam

// dtype / qtype: 0 = float32, 1 = bfloat16 (K/V storage, q). Stacked
// (merged = 0): o (B, H, nsplit, D), m / l (B, H, nsplit) get every
// split's partial. Merged (merged = 1, nsplit <= 8): o (B, H, D), m / l
// (B, H) get the merged partial. scores (B, H, S) or null. Returns 0, a
// CUDA error code, or -1 for an unsupported (dtype, qtype, D, rep) or
// more than 8 merged splits.
extern "C" int pam_flash_decode(const void* q, const void* k, const void* v,
                                const void* mask, const void* lens, void* o,
                                void* m, void* l, void* scores, int B, int H,
                                int Hkv, int S, int D, int L, int nsplit,
                                int merged, int kv_len, float scale,
                                int dtype, int qtype, void* stream) {
  if (merged && nsplit > pam::kMaxSplits) return -1;
  pam::DenseArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.lens = static_cast<const int32_t*>(lens);
  a.out = {static_cast<float*>(o), static_cast<float*>(m),
           static_cast<float*>(l), static_cast<float*>(scores), (long)S,
           nsplit, merged != 0};
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.L = L;
  a.kv_len = kv_len;
  a.scale = scale;
  return pam::dispatch<pam::LaunchDense>(dtype, qtype, D, H / Hkv, a,
                                         static_cast<cudaStream_t>(stream));
}
