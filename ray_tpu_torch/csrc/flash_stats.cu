// Ring attention's block step for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by ray_tpu_torch/ops/attention.py.
//
// Replaces the JAX package's TPU kernel ray_tpu/ops/attention.py
// `_flash_stats_bhld` / `_flash_stats_kernel`, the kernel behind
// `flash_attention_stats` that each step of the flash ring
// (ray_tpu/parallel/ring_attention.py `_ring_flash_forward`) launches.
// It computes what that kernel computes: for each query row an fp32 online
// softmax of the scaled scores over the key columns c < visible[b, h, row],
// written out unnormalised, o = sum_c exp(s_c - m) v_c in fp32, with the
// row's max m and sum l, so that a ring can merge the blocks its ranks hold.
// It differs from it where the TPU shaped it:
//   * K/V are streamed in tiles. The Pallas kernel holds a head's whole
//     K/V shard in VMEM, which bounded the shard length (the JAX ring's
//     `_FLASH_KV_VMEM_BUDGET` gate); here nothing bounds it.
//   * A block stops at the largest visible count among its rows, so rows and
//     blocks that see no key visit no K/V tile (flash_fwd.cu's causal
//     `kv_end`, for any mask of this shape).
//   * Masked keys get p = 0, so a row that sees no key keeps m = -1e30,
//     l = 0 and o = 0. The TPU kernel leaves o and l of such a row undefined;
//     what a ring relies on is m == -1e30, which both give.
//   * GQA: query head h reads kv head h / (H / Hkv); K/V are never repeated.
//     Layout: [B, L, H, D] through strides, and `visible` [B, H, Lq] through
//     strides too, so a broadcast over B and H (stride 0) is never
//     materialised. Lq and Lk may differ, and any length is taken.
//
// What bounds it. Per visible (query, key) pair and query head it does 4 D
// operations (the score and the P.V product). With every key visible at the
// ring shard shape Lq = Lk = 2048, H = 32, Hkv = 8, D = 64 that is 3.4e10
// operations against about 13 MB read and 17 MB written, so at the card's
// bf16 tensor-core rate it is bound by operations.
//
// Two routes, by dtype:
//   * bf16 (the ring's main path): flash_stats_tc_kernel, the tensor-core
//     core of flash_tc.cuh that flash_fwd.cu's bf16 route also runs, with
//     the visible counts as each row's limit and an fp32 epilogue. Its
//     output is fp32 and held to 1e-4, which P V with p = p_hi + p_lo in
//     bf16 meets (p to ~2^-17) and one bf16 p (2^-9) would not. Blocks of
//     128 query rows, the last query tiles launched first (under a causal
//     ring's diagonal counts they see the most keys). Rows need 16-byte
//     aligned starts (the wrapper checks).
//   * fp32: flash_stats_kernel, the first version's CUDA-core code in
//     flash_fwd.cu's fp32 layout (4 warps, 64 query rows, 32-key tiles, one
//     key per lane), kept because fp32 models on the card are held to the
//     CPU at 1e-4, which TF32 products would not meet. A warp stops at the
//     largest count among its rows.

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using namespace ray_flash;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;

template <int D>
constexpr int smem_floats() {
  return kBlockQ * D + kBlockK * (D + 1) + kBlockK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ visible,
                   float* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out, int Lq, int Lk, int group,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   Strides vis_s, float scale) {
  constexpr int E = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [kBlockQ][D], pre-scaled
  float* Ks = Qs + kBlockQ * D;        // [kBlockK][D + 1], padded: no bank
  float* Vs = Ks + kBlockK * (D + 1);  // [kBlockK][D]       conflicts
  __shared__ int seen[kBlockQ];        // each row's visible count, in [0, Lk]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int* visb = visible + b * vis_s.b + h * vis_s.h;

  for (int i = tid; i < kBlockQ; i += kWarps * 32) {
    const int row = q0 + i;
    seen[i] = row < Lq ? min(max(visb[row * vis_s.l], 0), Lk) : 0;
  }
  for (int i = tid; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[i] = row < Lq ? to_f32(qb[row * qs.l + d]) * scale : 0.f;
  }
  __syncthreads();

  // The block stops at the largest count among its rows, a warp at the
  // largest among its own.
  int kv_end = 0, warp_end = 0;
  for (int i = 0; i < kBlockQ; ++i) kv_end = max(kv_end, seen[i]);
  const int* seen_w = seen + warp * kRowsPerWarp;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) warp_end = max(warp_end, seen_w[r]);

  float acc[kRowsPerWarp][E];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;
  const float* Qw = Qs + warp * kRowsPerWarp * D;

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * D; i += kWarps * 32) {
      const int j = i / D, d = i % D, col = k0 + j;
      const bool in = col < Lk;
      Ks[j * (D + 1) + d] = in ? to_f32(kb[col * ks.l + d]) : 0.f;
      Vs[j * D + d] = in ? to_f32(vb[col * vs.l + d]) : 0.f;
    }
    __syncthreads();
    // A tile past every row of this warp adds nothing.
    if (k0 >= warp_end) continue;

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float k0v = kr[d], k1v = kr[d + 1], k2v = kr[d + 2],
                  k3v = kr[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * D + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool in = col < seen_w[r];  // seen_w[r] <= Lk
      const float sr = in ? s[r] : kNegInf;
      float mt = sr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      const float p = in ? expf(sr - m_new) : 0.f;
      m[r] = m_new;
      l[r] = l[r] * alpha + p;
      s[r] = p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vs[j * D + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float lr = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lr += __shfl_xor_sync(kFull, lr, off);
    const int row = row0 + r;
    if (row < Lq) {
      // m is the warp's row max, the same on every lane.
      if (lane == 0) {
        const long long at =
            (static_cast<long long>(b) * gridDim.y + h) * Lq + row;
        m_out[at] = m[r];
        l_out[at] = lr;
      }
      float* out = o + b * os.b + row * os.l + h * os.h;
#pragma unroll
      for (int e = 0; e < E; ++e) out[lane + 32 * e] = acc[r][e];
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* visible,
           float* o, float* m, float* l, int B, int Lq, int Lk, int H,
           int Hkv, const long long* st, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(flash_stats_kernel<T, D>), smem,
      smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  flash_stats_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), visible, o, m, l, Lq, Lk, H / Hkv,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
flash_stats_tc_kernel(const tc::bf16* __restrict__ q,
                      const tc::bf16* __restrict__ k,
                      const tc::bf16* __restrict__ v,
                      const int* __restrict__ visible, float* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int Lq, int Lk, int H, int group, Strides qs,
                      Strides ks, Strides vs, Strides os, Strides vis_s,
                      float scale) {
  const tc::BlockAt at = tc::block_at(Lq, H);
  const int b = at.b, h = at.h, hk = h / group;
  const int* visb = visible + b * vis_s.b + h * vis_s.h;
  int rows[2], limit[2];
  tc::thread_rows(at.q0, rows);
  for (int i = 0; i < 2; ++i)
    limit[i] = rows[i] >= Lq ? 0 : min(max(visb[rows[i] * vis_s.l], 0), Lk);
  float acc[D / 2], m[2], l[2];
  tc::attend<D>(q + b * qs.b + h * qs.h, qs.l, k + b * ks.b + hk * ks.h, ks.l,
                v + b * vs.b + hk * vs.h, vs.l, at.q0, Lq, Lk, limit, scale,
                acc, m, l);
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Lq) continue;
    if (t == 0) {
      const long long row = (static_cast<long long>(b) * H + h) * Lq + rows[i];
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
    float* out = o + b * os.b + rows[i] * os.l + h * os.h + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(out + 8 * c) =
          make_float2(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const int* visible,
              float* o, float* m, float* l, int B, int Lq, int Lk, int H,
              int Hkv, const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem = tc::Smem<D>::kBytes;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(flash_stats_tc_kernel<D>), smem,
      smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = tc::grid_blocks(B, Lq, H);
  if (blocks > 0x7fffffff) return -3;
  flash_stats_tc_kernel<D><<<static_cast<unsigned>(blocks), tc::kThreads, smem,
                             stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), visible, o, m, l, Lq, Lk, H, H / Hkv,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, and a
// negative code for arguments the kernel does not take: -1 dtype, -2 head
// dim, -3 shapes. dtype of q, k, v: 0 = float32, 1 = bfloat16. visible:
// int32 [B, H, Lq]. o: float32 [B, Lq, H, D]; m, l: float32 [B, H, Lq]
// contiguous. strides: 15 values, (batch, seq, head) for q, k, v, o and
// visible in that order, in elements.
extern "C" int ray_flash_stats(const void* q, const void* k, const void* v,
                               const int* visible, float* o, float* m,
                               float* l, int dtype, int B, int Lq, int Lk,
                               int H, int Hkv, int D,
                               const long long* strides, float scale,
                               void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 ||
      H > 65535)
    return -3;
  if (D != 64 && D != 128) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? launch<float, 64>(q, k, v, visible, o, m, l, B, Lq, Lk,
                                       H, Hkv, strides, scale, s)
                   : launch<float, 128>(q, k, v, visible, o, m, l, B, Lq, Lk,
                                        H, Hkv, strides, scale, s);
  if (dtype == 1)
    return D == 64 ? launch_tc<64>(q, k, v, visible, o, m, l, B, Lq, Lk, H, Hkv,
                                   strides, scale, s)
                   : launch_tc<128>(q, k, v, visible, o, m, l, B, Lq, Lk, H,
                                    Hkv, strides, scale, s);
  return -1;
}
