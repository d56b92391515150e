// The tensor-core forward core that flash_fwd.cu and flash_stats.cu share
// for bf16 inputs on Hopper (sm_90a): S = Q K^T and O += P V as warpgroup
// products (wgmma) on tiles that cp.async copies into shared memory, with
// an fp32 online softmax on the accumulator fragments between them.
//
// Block: two warpgroups (256 threads), 128 query rows, 64 per warpgroup.
// Tiles of BK keys (128 at D = 64, 64 at D = 128) stream through a ring of
// two stages: while a warpgroup multiplies tile j, the copies of tile j + 1
// are in flight. Each row visits the keys `col < limit[row]`, which the
// caller gives (the causal mask, all of Lk, or the stats kernel's visible
// counts); the block stops at the largest limit among its rows, and a
// warpgroup skips the tiles past the largest among its own.
//
// Shared memory. Q [128][D] and each K and V tile [BK][D] are stored in
// panels of 64 columns (128 bytes a row), each panel a stack of swizzle
// atoms of 8 rows x 128 bytes in which the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8): the 128-byte swizzle that the wgmma descriptors name
// (layout type 1). D = 128 is two panels. Every region starts on a
// 1024-byte boundary, since the swizzle reads the address bits.
//
// Products. S: A = Q from shared memory and B = the K tile, both K-major
// (D contiguous), m64 n BK k16, fp32 sums; the scale is applied to S in
// fp32 (folding it into a bf16 Q would round Q). P V: A = p in registers
// as bf16 (a 16-bit A fragment is laid out as the accumulator it comes
// from), B = the V tile MN-major (D contiguous, transpose bit set),
// m64 n D k16, into the fp32 O fragment. P V runs twice, with
// p = p_hi + p_lo in bf16, which keeps p to about 2^-17 (1.5x the tensor
// work of one product). One bf16 p (2^-9 a term) would not do for either
// kernel: the stats kernel's output is fp32 and held to 1e-4, and in the
// forward an o off by 2^-9 before its rounding to bf16 flips roundings
// that di = rowsum(o dO) carries into the backward's dq.
//
// What bounds it. It is the bf16 body of the ports of the TPU kernels
// `_flash_attention_bhld` / `_flash_kernel`, `_tpu_flash`'s forward and
// `_flash_stats_bhld` / `_flash_stats_kernel` (ray_tpu/ops/attention.py).
// At the main paths' shapes (L of 1024 to 8192, D of 64 and 128, 4 query
// heads per kv head) their work is bound by operations, so the products
// go to the tensor cores (989 TFLOP/s in bf16, against 67 on the fp32
// CUDA cores). What stays on the CUDA cores is the softmax between the
// products (one exp and a few fp32 operations per score), which at D = 64
// costs about as much as the products, and the two warpgroups wait on one
// barrier per tile, so the one's softmax rarely overlaps the other's
// products. TMA copies, a producer warp and a persistent grid are the
// next step.
//
// Accumulator fragment of m64nN (f32): thread `lane` of warp w of a
// warpgroup holds d[4i + 2h + e] = row 16 w + lane / 4 + 8 h, column
// 8 i + 2 (lane % 4) + e, so a row is spread over 4 neighbouring lanes.

#pragma once

#include <cstdint>

#include "flash_common.cuh"

namespace ray_flash {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBlockQ = 64 * kWarpgroups;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int block_k = D == 64 ? 128 : 64;

// Layout of a block's dynamic shared memory, in bytes from a 1024-aligned
// base: Q, then per stage the K tile and the V tile, then one int per warp
// for the block's reduction of the limits.
template <int D>
struct Smem {
  static constexpr int kQ = kBlockQ * D * 2;
  static constexpr int kTile = block_k<D> * D * 2;
  static constexpr int kRed = kQ + kStages * 2 * kTile;
  static constexpr int kBytes = 1024 + kRed + 4 * (kThreads / 32);
  static __device__ __forceinline__ int k_tile(int stage) {
    return kQ + stage * 2 * kTile;
  }
  static __device__ __forceinline__ int v_tile(int stage) {
    return k_tile(stage) + kTile;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// `full` is false (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Makes this thread's writes to shared memory visible to wgmma's reads
// (the async proxy).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's launch and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// 2^x by the special-function unit alone (2^-22 relative, subnormal
// results flushed to 0; 2^-inf = 0): exp2f adds a range fix-up of several
// instructions to each of the softmax's exponentials.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as a bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64 n N k16, fp32 += bf16 x bf16. wgmma_ss: A and B from shared
// memory, both K-major; `accumulate` 0 overwrites d. wgmma_rs: A from
// registers, B MN-major from shared memory, accumulating.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Copies rows [row0, row0 + ROWS) of a [L, D] bf16 matrix (row stride
// `ld` elements, 16-byte aligned rows) into the panel layout at `dst`;
// rows at or past `rows_end` are zero-filled. Neighbouring threads copy
// neighbouring 16-byte chunks of a row.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int row0,
                                          int rows_end, int tid) {
  constexpr int kChunksPerRow = D / 8;
  static_assert(ROWS * kChunksPerRow % kThreads == 0, "tile / threads");
#pragma unroll
  for (int it = 0; it < ROWS * kChunksPerRow / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunksPerRow, c = i % kChunksPerRow;
    const uint32_t at = dst + (c / 8) * (ROWS * 128) + r * 128 +
                        (((c % 8) ^ (r % 8)) << 4);
    const bool in = row0 + r < rows_end;
    cp_async16(at, in ? src + (row0 + r) * ld + c * 8 : src, in);
  }
}

// wgmma descriptors, step kk of 16 along the product's depth. Q (A) and
// the K tile (B) are K-major: the step is 32 bytes into a 128-byte panel
// row, SBO the 1024 bytes to the next 8 rows. The V tile (B) is MN-major:
// the step is 16 key rows (2048 bytes), SBO the next 8 keys, LBO the next
// 64-column panel.
template <int D>
__device__ __forceinline__ uint64_t q_desc(uint32_t q, int wg, int kk) {
  return make_desc(q + (kk / 4) * kBlockQ * 128 + wg * 64 * 128 +
                       (kk % 4) * 32,
                   16, 1024);
}
template <int D>
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * block_k<D> * 128 + (kk % 4) * 32, 16,
                   1024);
}
template <int D>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, block_k<D> * 128, 1024);
}

// A block's query tile and (batch, head). The grid is 1-D, n_tiles x B x H
// blocks, and runs the last query tiles first: under a causal or diagonal
// mask they see the most keys, so the grid does not end on a tail of long
// blocks.
struct BlockAt {
  int q0, b, h;
};
__device__ __forceinline__ BlockAt block_at(int Lq, int H) {
  const int tiles = (Lq + kBlockQ - 1) / kBlockQ;
  const int heads = gridDim.x / tiles;  // B x H
  const int bh = blockIdx.x % heads;
  return {static_cast<int>(gridDim.x - 1 - blockIdx.x) / heads * kBlockQ,
          bh / H, bh % H};
}
inline long long grid_blocks(int B, int Lq, int H) {
  return static_cast<long long>((Lq + kBlockQ - 1) / kBlockQ) * B * H;
}

// The query rows of this thread: r[h] = q0 + 64 wg + 16 w + lane / 4 + 8 h.
__device__ __forceinline__ void thread_rows(int q0, int (&r)[2]) {
  const int tid = threadIdx.x;
  r[0] = q0 + (tid / 128) * 64 + ((tid / 32) % 4) * 16 + (tid % 32) / 4;
  r[1] = r[0] + 8;
}

// The block's attention over keys `col < limit[h]` for this thread's rows
// thread_rows(q0) (limit 0 for a row past Lq). q, k, v point at the
// block's (batch, head) with row strides q_ld, k_ld, v_ld. Returns, for
// each of the thread's two rows, the O fragment (unnormalised, fp32, in
// the accumulator layout over D), the row max m of the scaled scores
// (kNegInf if the row sees nothing) and the row sum l. Every thread of the
// block must call it.
template <int D>
__device__ __forceinline__ void attend(const bf16* __restrict__ q,
                                       long long q_ld,
                                       const bf16* __restrict__ k,
                                       long long k_ld,
                                       const bf16* __restrict__ v,
                                       long long v_ld, int q0, int Lq,
                                       int Lk, const int (&limit)[2],
                                       float scale, float (&o)[D / 2],
                                       float (&m)[2], float (&l)[2]) {
  constexpr int BK = block_k<D>;
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  int* const red = reinterpret_cast<int*>(base_ptr + S::kRed);

  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128;
  const int t = lane % 4;

#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;

  // The block's and this warpgroup's last visible key.
  const int wmax = __reduce_max_sync(kFull, max(limit[0], limit[1]));
  if (lane == 0) red[tid / 32] = wmax;
  __syncthreads();
  int block_end = 0, wg_end = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    block_end = max(block_end, red[w]);
    if (w / 4 == wg) wg_end = max(wg_end, red[w]);
  }
  const int n_tiles = (block_end + BK - 1) / BK;
  if (n_tiles == 0) return;

  load_tile<D, kBlockQ>(base, q, q_ld, q0, Lq, tid);
  load_tile<D, BK>(base + S::k_tile(0), k, k_ld, 0, Lk, tid);
  load_tile<D, BK>(base + S::v_tile(0), v, v_ld, 0, Lk, tid);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages, k0 = j * BK;
    cp_async_wait_all();  // tile j (and Q) has landed for this thread
    fence_async_proxy();
    __syncthreads();  // ... for every thread; tile j - 1 is consumed
    if (j + 1 < n_tiles) {
      const int next = (j + 1) % kStages;
      load_tile<D, BK>(base + S::k_tile(next), k, k_ld, k0 + BK, Lk, tid);
      load_tile<D, BK>(base + S::v_tile(next), v, v_ld, k0 + BK, Lk, tid);
      cp_async_commit();
    }
    if (k0 >= wg_end) continue;  // no row of this warpgroup sees the tile

    // S = Q K^T over D in steps of 16.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, q_desc<D>(base, wg, kk),
                   k_desc<D>(base + S::k_tile(stage), kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Online softmax on the fragment: mask, row max over the 4 lanes that
    // hold a row, rescale, p = exp(scale s - m).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool masked = k0 + BK > limit[h];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * i + 2 * h + e];
          if (masked && k0 + 8 * i + 2 * t + e >= limit[h]) x = -INFINITY;
          mx[h] = fmaxf(mx[h], x);
        }
    }
    float m_log2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale);
      const float alpha = exp2_approx((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      m_log2[h] = m_new * kLog2e;
      l[h] *= alpha;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i + 2 * h] *= alpha;
        o[4 * i + 2 * h + 1] *= alpha;
      }
    }
    // A masked score is -inf, so its p is 0, also in a row that has seen
    // nothing yet (m = kNegInf).
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * i + 2 * h + e];
          x = exp2_approx(fmaf(x, scale_log2, -m_log2[h]));
          l[h] += x;
        }

    // O += P V over the tile's keys in steps of 16: the A fragment of keys
    // 16 kk.. is s[8 kk .. 8 kk + 7] in pairs.
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
        p_hi[kk][r] = pack_bf16(a, b);
        const __nv_bfloat162 hi =
            *reinterpret_cast<const __nv_bfloat162*>(&p_hi[kk][r]);
        p_lo[kk][r] = pack_bf16(a - __low2float(hi), b - __high2float(hi));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = v_desc<D>(base + S::v_tile(stage), kk);
      wgmma_rs<D>(o, p_hi[kk], vd);
      wgmma_rs<D>(o, p_lo[kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
}

}  // namespace tc
}  // namespace ray_flash
