// The pieces the tensor-core backward kernels of flash_bwd.cu add to
// flash_tc.cuh (whose forward code they leave as it is): tile sizes and
// shared-memory layouts of the dK/dV and dQ kernels, descriptors for a
// tile of any row count, wgmma m64n32k16 for 32-row and 32-key tiles,
// and a 4-byte cp.async for the rows' fp32 statistics.
//
// Every tile is stored as flash_tc.cuh stores Q, K and V: [rows][D], D
// contiguous, in 64-column panels with the 128-byte swizzle. One tile can
// then be read both ways. K-major (D is the product's depth) for
// S = Q K^T, dP = dO V^T and their transposes; MN-major (the rows are the
// depth, D is N) for dV += P^T dO, dK += dS^T Q and dQ += dS K, as the
// forward reads V.

#pragma once

#include <cstdint>

#include "flash_tc.cuh"

namespace ray_flash {
namespace tc {

// dK/dV kernel: a block owns KEYS keys. With 128 keys each warpgroup owns
// 64 of them and both multiply the same query tile; with 64 keys both
// warpgroups own all 64 and take turns over the (query head, query tile)
// pairs, each summing its own dK and dV, which are added at the end: twice
// the blocks, each half as long, for grids that would leave the card
// short. Query tiles of BQ rows: 64 at D = 64, 32 at D = 128, where the dK
// and dV sums alone take 128 fp32 registers a thread.
template <int D>
constexpr int dkdv_block_q = D == 64 ? 64 : 32;

// dQ kernel: a block owns kBlockQ = 128 query rows (block_at's tiles) and
// streams key tiles of 32 at D = 64, where that keeps it within 128
// registers a thread so that two blocks share a multiprocessor, and of 64
// at D = 128.
template <int D>
constexpr int dq_block_k = D == 64 ? 32 : 64;
template <int D>
constexpr int dq_blocks_per_sm = D == 64 ? 2 : 1;

// dK/dV block's dynamic shared memory, in bytes from a 1024-aligned base:
// the K and V tiles [KEYS][D], then per stage and query tile (one, or one
// per warpgroup with 64 keys) the Q and dO tiles [BQ][D], then the
// tiles' lse and di, fp32 [BQ] each. With 64 keys, after the loop the
// tiles' place holds the second warpgroup's sums, fp32, D a thread.
template <int D, int KEYS>
struct DkdvSmem {
  static constexpr int BQ = dkdv_block_q<D>;
  static constexpr int kTilesPerStage = KEYS == 64 ? kWarpgroups : 1;
  static constexpr int kKV = KEYS * D * 2;
  static constexpr int kQ = BQ * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kTiles = 2 * kKV;
  static constexpr int kStats = kTiles + kStages * kTilesPerStage * 2 * kQ;
  static constexpr int kBytes =
      1024 + kStats + kStages * kTilesPerStage * 2 * BQ * 4;
  static constexpr int kSums = kTiles;
  static_assert(KEYS == 128 || kStats - kTiles >= 128 * D * 4,
                "the sums fit the tiles");
  static __device__ __forceinline__ int q_tile(int stage, int i) {
    return kTiles + (stage * kTilesPerStage + i) * 2 * kQ;
  }
  static __device__ __forceinline__ int do_tile(int stage, int i) {
    return q_tile(stage, i) + kQ;
  }
  static __device__ __forceinline__ int lse(int stage, int i) {
    return kStats + (stage * kTilesPerStage + i) * 2 * BQ * 4;
  }
  static __device__ __forceinline__ int di(int stage, int i) {
    return lse(stage, i) + BQ * 4;
  }
};

// dQ block's dynamic shared memory: the Q and dO tiles [128][D], then per
// stage the K and V tiles [dq_block_k][D].
template <int D>
struct DqSmem {
  static constexpr int kQ = kBlockQ * D * 2;
  static constexpr int kTile = dq_block_k<D> * D * 2;
  static constexpr int kQt = 0;
  static constexpr int kDo = kQ;
  static constexpr int kBytes = 1024 + 2 * kQ + kStages * 2 * kTile;
  static __device__ __forceinline__ int k_tile(int stage) {
    return 2 * kQ + stage * 2 * kTile;
  }
  static __device__ __forceinline__ int v_tile(int stage) {
    return k_tile(stage) + kTile;
  }
};

// 4 bytes from global to shared memory, asynchronously; zero where `full`
// is false. The rows' statistics start at any float of a [B, H, L] array,
// so they cannot take the 16-byte copy.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// Descriptors of a tile of ROWS rows, step kk of 16 along the depth.
// K-major (depth = D): 64 rows from row0 for an A operand, all ROWS for a
// B operand; the step is 32 bytes into a 128-byte panel row, SBO the 1024
// bytes to the next 8 rows (flash_tc.cuh's q_desc and k_desc). MN-major
// B (depth = the rows, N = D): the step is 16 rows, SBO the next 8 rows,
// LBO the next 64-column panel (v_desc).
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  return make_desc(tile + (kk / 4) * ROWS * 128 + row0 * 128 + (kk % 4) * 32,
                   16, 1024);
}
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// acc = A B^T over D (the depth), A the 64 rows from a_row0 of a tile of
// A_ROWS rows and B a tile of N rows, both K-major: S, dP and their
// transposes. Overwrites acc.
template <int N, int D, int A_ROWS>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint32_t a_tile,
                                       int a_row0, uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(acc, kmajor_desc<A_ROWS>(a_tile, a_row0, kk),
                kmajor_desc<N>(b_tile, 0, kk), kk > 0);
}

// acc += X T over the N columns of the accumulator fragment x (the depth),
// T the tile of N rows at `tile` read MN-major: dV, dK and dQ. x enters as
// two bf16 A fragments, hi and the rounding's remainder lo, so that
// hi + lo keeps x to about 2^-17 (flash_bwd.cu's note says why); the
// fragment of columns 16 kk.. is x[8 kk .. 8 kk + 7] in pairs (pack_bf16's
// note).
template <int N, int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const float (&x)[N / 2],
                                       uint32_t tile) {
  uint32_t hi[N / 16][4], lo[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      hi[kk][r] = pack_bf16(a, b);
      const __nv_bfloat162 h =
          *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
      lo[kk][r] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t desc = mnmajor_desc<N>(tile, kk);
    wgmma_rs<D>(acc, hi[kk], desc);
    wgmma_rs<D>(acc, lo[kk], desc);
  }
}

}  // namespace tc
}  // namespace ray_flash
