// Split-KV decode attention over a dense (B, Hkv, S, D) cache.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_decode_kernel
// (wrapper flash_decode, pl.pallas_call at :173). One CUDA block per
// (split, kv head, batch) attends the REP grouped query heads over the
// split's block_s tokens and writes the split's (O, m, l); the Python
// wrapper keeps the reference's block_s/nsplit semantics, so the stacked
// output has the reference's shape. The ragged tail is masked by the
// split length instead of padding the cache.
//
// Bound on the H100: bytes read from HBM. A decode step does ~2 FLOPs per
// K/V element, far below the ~295 FLOP/byte ridge, so the least time is
// the live K/V rows over 3.35 TB/s. The design reads each live row once,
// as one coalesced 8/16-byte-per-lane load, never reads masked rows, keeps
// the softmax state in registers, and writes only the small per-split
// partials. Not yet done: cp.async/TMA pipelining and more blocks per SM
// for short caches (B*Hkv*nsplit blocks can be fewer than the 132 SMs).
#include "decode_common.cuh"

namespace pam {

struct DenseArgs {
  const float* q;       // (B, H, D) fp32
  const void* k;        // (B, Hkv, S, D)
  const void* v;
  const int8_t* mask;   // (B, S), kv_lens already folded in
  float* o;             // (B, H, nsplit, D)
  float* m;             // (B, H, nsplit)
  float* l;
  int B, H, Hkv, S, block_s, nsplit, kv_len;
  float scale;
};

// Warps per block: a split holds up to block_s = 512 tokens.
constexpr int kDenseWarps = 8;

template <typename T, int D, int REP>
__global__ void flash_decode_kernel(DenseArgs a) {
  constexpr int NW = kDenseWarps;
  __shared__ MergeSmem<D, REP, NW> sm;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t_begin = split * a.block_s;
  const int n = min(a.block_s, a.S - t_begin);
  const long head = (long)b * a.Hkv + h;
  const T* k = static_cast<const T*>(a.k) + (head * a.S + t_begin) * D;
  const T* v = static_cast<const T*>(a.v) + (head * a.S + t_begin) * D;
  const long qrow = (long)b * a.H + (long)h * REP;
  const long out = qrow * a.nsplit + split;
  attend_tokens<T, D, REP, NW>(
      a.q + qrow * D, k, v, D, n, a.kv_len - t_begin,
      a.mask + (long)b * a.S + t_begin, a.scale, a.o + out * D,
      (long)a.nsplit * D, a.m + out, a.l + out, a.nsplit, sm);
}

template <typename T, int D, int REP>
struct LaunchDense {
  static void run(const DenseArgs& a, cudaStream_t stream) {
    const dim3 grid(a.nsplit, a.Hkv, a.B);
    flash_decode_kernel<T, D, REP><<<grid, kDenseWarps * 32, 0, stream>>>(a);
  }
};

}  // namespace pam

// dtype: 0 = float32, 1 = bfloat16 (K/V storage). Returns 0, a CUDA error
// code from cudaGetLastError(), or -1 for an unsupported (dtype, D, rep).
extern "C" int pam_flash_decode(const void* q, const void* k, const void* v,
                                const void* mask, void* o, void* m, void* l,
                                int B, int H, int Hkv, int S, int D,
                                int block_s, int nsplit, int kv_len,
                                float scale, int dtype, void* stream) {
  pam::DenseArgs a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.mask = static_cast<const int8_t*>(mask);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.block_s = block_s;
  a.nsplit = nsplit;
  a.kv_len = kv_len;
  a.scale = scale;
  return pam::dispatch<pam::LaunchDense>(dtype, D, H / Hkv, a,
                                         static_cast<cudaStream_t>(stream));
}
