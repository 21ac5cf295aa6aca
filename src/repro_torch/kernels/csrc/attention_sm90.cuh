// Hopper building blocks of the bf16 full-sequence attention kernels
// (flash_attention_sm90.cu: forward; flash_attention_bwd_sm90.cu:
// backward): TMA tile copies with mbarriers, wgmma shared-memory
// descriptors over 128-byte-swizzled tiles, the wgmma instructions the
// kernels issue, and the host-side tensor maps.
//
// Tile format. A (rows, 128) bf16 tile of a row-major (.., rows, 128)
// tensor lives in shared memory as two sub-tiles of (rows, 64): columns
// 0-63, then 64-127. A tensor of head dim 64 is one sub-tile; one of head
// dim 80 or 112 is two, the second holding columns 64-79 (64-111) and
// TMA's zero fill for 80-127 (112-127): its map is 80 (112) columns wide.
// A sub-tile row is one 128-byte swizzle row; TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8)), and every sub-tile starts on a 1024-byte boundary, which
// is what the wgmma descriptors' 128B layout expects.
// Read with the head dim as the reduction dim (Q K^T: both operands), a
// tile is K-major: a descriptor per 16-column step starts 32 bytes
// further inside the 128-byte row, and the second sub-tile holds steps
// 4-7. Read with the rows as the reduction dim (P V, dS K, P^T dO, dS^T
// Q), the same tile is MN-major and the instruction's transpose bit is
// set: a 16-row step is 2048 bytes, and the two 64-column sub-tiles are
// the two halves of the N = 128 output (leading byte offset = sub-tile
// bytes).
//
// Fragments. The fp32 accumulator of wgmma m64nNk16 gives thread t of
// the warpgroup (warp w = t / 32, lane) the entries d[v], v < N / 2, at
// row 16 w + lane / 4 + 8 ((v >> 1) & 1) and column 2 (lane % 4) + (v & 1)
// + 8 (v >> 2). The bf16 A fragment of a register-sourced m64k16 has the
// same layout for its 16 columns, so columns 16 kk .. 16 kk + 15 of an
// accumulator, rounded to bf16 in pairs, are the A operand of step kk
// (pack_a below): P and dS never leave registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pam {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;           // the widest head dim (two sub-tiles)
constexpr int kSub = 64;          // columns of a 128-byte swizzle row
constexpr int kThreads = 256;     // two consumer warpgroups
constexpr float kNegInf = -1e30f;  // the reference's masked-score sentinel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, int phase) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(phase)
      : "memory");
  return done != 0;
}

// Wait for phase `phase` of `bar` to complete. A copy that never lands (a
// wrong byte count) traps after about 2^26 tries instead of hanging the
// card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int phase) {
  for (int n = 0; !bar_try(bar, phase); ++n)
    if (n == (1 << 26)) __trap();
}

// Release of a staged buffer that both consumer warpgroups read. Each
// warpgroup, once its products on the buffer are complete, syncs its own
// 128 threads (named barrier 1 + wg) and one thread adds 1 to `count`;
// the warpgroup that arrives second sees an odd count and is the one to
// refill. Returns true in that one thread. Neither warpgroup waits for the
// other, so one's softmax can run beside the other's products. A counter
// serves every other step: a warpgroup cannot run two steps ahead of the
// other, since the copies it would need are issued by the later one.
__device__ __forceinline__ bool release_last(int* count, int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
  bool last = false;
  if ((threadIdx.x & 127) == 0) {
    __threadfence_block();
    last = (atomicAdd(count, 1) & 1) != 0;
    __threadfence_block();
  }
  return last;
}

// ------------------------------------------------------------ TMA
// Box (c0 .. c0 + 63, r0 .. r0 + rows - 1) of head `head` of a 3-D map
// (see make_map) into `dst`; rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0), "r"(head)
      : "memory");
}

// A whole (rows, 64 SUBS) tile: its SUBS 64-column sub-tiles (two: a
// (rows, 128) tile).
template <int SUBS = 2>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int r0,
                                         int head) {
#pragma unroll
  for (int i = 0; i < SUBS; ++i)
    tma_load(dst + i * rows * kSub, map, bar, i * kSub, r0, head);
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: 16-column step kk (0..7) of the 64 x 128 rows starting
// at `tile` (a sub-tile base) + `row0` rows, in a tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows,
                                           int row0, int kk) {
  const uint32_t a = smem_u32(tile) + (kk >> 2) * rows * 128 + row0 * 128 +
                     (kk & 3) * 32;
  return desc(a, 16, 1024);
}

// MN-major operand: 16-row step kk of a (rows, 128) tile, N = 128.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows,
                                            int kk) {
  return desc(smem_u32(tile) + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous instructions' issue and completion.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64x64) += A(64x16) B(16x64); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D(64x128) += A(64x16) B(16x128); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D(64x128) += A(64x16) B(16x128); A in registers (4 x bf16x2), B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64x80) += A(64x16) B(16x80); A in registers (4 x bf16x2), B MN-major
// in shared memory (transpose bit set): the first 64 columns from the
// swizzle atom at the descriptor's address, the last 16 from the next
// atom, LBO bytes on (head dim 80's P V).
__device__ __forceinline__ void wgmma_rs_n80_mn(float (&d)[40],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64x112) += A(64x16) B(16x112); A in registers (4 x bf16x2), B
// MN-major in shared memory (transpose bit set): the first 64 columns
// from the swizzle atom at the descriptor's address, the last 48 from the
// next atom, LBO bytes on, read in part as at N = 80 (head dim 112's P V,
// dV, dK and dQ; zamba2-7b's shared attention block).
__device__ __forceinline__ void wgmma_rs_n112_mn(float (&d)[56],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The shapes below serve the SSD scan kernels (ssd_scan_sm90.cu,
// ssd_scan_bwd_sm90.cu), whose head dim P = 64 is the N of an m64n64k16.

// D(64x64) += A(64x16) B(16x64); A and B both MN-major in shared memory
// (both transpose bits set): A^T and B as stored.
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D(64x64) += A(64x16) B(16x64); A K-major, B MN-major (transpose bit),
// both in shared memory.
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D(64x64) += A(64x16) B(16x64); A in registers (4 x bf16x2), B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64xN) += A(64x16) B(16xN) at N = 64, 80, 112 or 128 (a head dim, or
// the SSD kernels' d_state): A in registers, B MN-major in shared memory;
// the accumulator has N / 2 entries a thread.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t* a,
                                            uint64_t db) {
  static_assert(N == 64 || N == 80 || N == 112 || N == 128,
                "an N of a head dim or a d_state");
  if constexpr (N == 64)
    wgmma_rs_n64_mn(d, a, db);
  else if constexpr (N == 80)
    wgmma_rs_n80_mn(d, a, db);
  else if constexpr (N == 112)
    wgmma_rs_n112_mn(d, a, db);
  else
    wgmma_rs_n128_mn(d, a, db);
}

// D(64xN) += A(64x16) B(16xN) at N = 64 or 128 (the SSD kernels' d_state):
// A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "a built d_state");
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db);
  else
    wgmma_ss_n128(d, da, db);
}

// ------------------------------------------------------------ fragments
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An fp32 accumulator (N / 2 entries) as bf16 A fragments, N / 16 steps
// of 4 registers.
template <int NACC>
__device__ __forceinline__ void pack_a(const float (&x)[NACC],
                                       uint32_t (&a)[NACC / 2]) {
#pragma unroll
  for (int i = 0; i < NACC / 2; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Row and column of accumulator entry v for this thread (t = thread index
// inside the warpgroup).
__device__ __forceinline__ int frag_row(int t, int v) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int t, int v) {
  return 2 * (t & 3) + (v & 1) + 8 * (v >> 2);
}

// Rows [r0, r0 + 64) of a warpgroup's (64, 2 NACC) fp32 accumulator,
// times `mult`, to a row-major (n, D) bf16 matrix: its first D columns
// (D <= 2 NACC, a multiple of 8); rows at or past n are not written.
template <int D = kD, int NACC>
__device__ __forceinline__ void store_rows(const float (&acc)[NACC],
                                           bf16* dst, int r0, int n,
                                           float mult) {
  static_assert(D % 8 == 0 && D <= 2 * NACC, "D columns of the accumulator");
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + frag_row(t, 2 * half);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int v = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)r * D +
                                         frag_col(t, v)) =
          __floats2bfloat162_rn(acc[v] * mult, acc[v + 1] * mult);
    }
  }
}

}  // namespace sm90

// ------------------------------------------------------------ host side
// cuTensorMapEncodeTiled is a driver API entry point; it is fetched once
// through the runtime (cudaGetDriverEntryPointByVersion), so the libraries
// link against the runtime alone (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous (heads, rows, cols) bf16 tensor with boxes
// of (1 head, box_rows rows, 64 columns), 128-byte swizzle; reads past
// `rows` or `cols` fill zeros (cols: a head dim, 64, 80, 112 or 128; the
// row stride, 2 cols bytes, must be a multiple of 16). False if the
// driver refuses it.
inline bool make_map(CUtensorMap* map, const void* base, long heads,
                     int rows, int box_rows, int cols = sm90::kD) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * 2,
      static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(sm90::kSub),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory of a kernel: `bytes` plus room to align the base
// to 1024 bytes.
constexpr int smem_with_align(int bytes) { return bytes + 1024; }

}  // namespace pam
