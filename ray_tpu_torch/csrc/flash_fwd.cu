// Forward flash attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by ray_tpu_torch/ops/attention.py.
//
// Replaces the JAX package's TPU kernels for the forward pass:
//   * ray_tpu/ops/attention.py `_flash_attention_bhld` / `_flash_kernel`
//     (the in-tree Pallas kernel, public as `pallas_flash_reference`);
//   * ray_tpu/ops/attention.py `_tpu_flash`, forward half (the Mosaic
//     library kernel `jax.experimental.pallas.ops.tpu.flash_attention`).
// It computes what they compute, softmax(scale * Q K^T) V with an optional
// causal mask `row >= col`, an fp32 online softmax, and the output divided
// by max(l, 1e-30). For the backward pass it can also write each row's
// log-sum-exp of the scaled scores, lse = m + log(max(l, 1e-30)), fp32
// [B, H, Lq]: Mosaic's forward saves l and m as residuals for the same use.
// It differs from them where the TPU shaped them:
//   * GQA: query head h reads kv head h / (H / Hkv); K/V are never repeated.
//   * Layout: it reads [B, L, H, D] through strides, so no transpose copy.
//   * Ragged L: any length; the tile edge is masked in the kernel.
//
// What bounds it. Causal attention at D = 128 with 4 query heads per kv
// head does about L / 2.4 FLOPs per byte it must move, so at the card's
// bf16 tensor-core rate it is bound by bytes up to L ~ 700 and by
// operations past it; at the main paths' shapes (L = 1024 and 2048) by
// operations.
//
// Two routes, by dtype:
//   * bf16 (every main path): flash_fwd_tc_kernel, the tensor-core core of
//     flash_tc.cuh. S = Q K^T and P V are wgmma products with fp32 sums,
//     and K/V tiles arrive by cp.async in a ring of two stages while the
//     previous tile is multiplied. P V takes p as p_hi + p_lo in bf16, not
//     one bf16 p as FlashAttention 2 and 3 do: o off by 2^-9 before its
//     rounding flips bf16 roundings of o, which the backward's
//     di = rowsum(o dO) carries into dq, past the rule that holds a ring's
//     gradients to this path's. Blocks of 128 query rows; the heaviest
//     causal tiles are launched first, so the grid does not end on a tail
//     of long blocks. Rows need 16-byte aligned starts (the wrapper
//     checks).
//   * fp32: flash_fwd_kernel, the first version's CUDA-core code, kept
//     because fp32 models on the card are held to the CPU at 1e-4, which
//     TF32 products would not meet. Block: 4 warps, 64 query rows (16 per
//     warp), K/V tiles of 32 keys converted to fp32 in shared memory; a
//     lane computes its key's score for each of its warp's rows, and P.V
//     broadcasts p by shuffles.

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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int group,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int causal) {
  constexpr int E = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [kBlockQ][D], pre-scaled
  float* Ks = Qs + kBlockQ * D;        // [kBlockK][D + 1], padded: no bank
  float* Vs = Ks + kBlockK * (D + 1);  // [kBlockK][D]       conflicts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[i] = row < Lq ? to_f32(qb[row * qs.l + d]) * scale : 0.f;
  }

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
  // Causal: stop at the tile that holds the block's last row.
  const int kv_end = causal ? min(Lk, q0 + kBlockQ) : Lk;

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // Qs is written; the previous tile is consumed
    for (int i = tid; i < kBlockK * D; i += kWarps * 32) {
      const int j = i / D, d = i % D, col = k0 + j;
      const bool in = col < Lk;
      Ks[j * (D + 1) + d] = in ? to_f32(kb[col * ks.l + d]) : 0.f;
      Vs[j * D + d] = in ? to_f32(vb[col * vs.l + d]) : 0.f;
    }
    __syncthreads();
    // A tile wholly above this warp's rows adds nothing.
    if (causal && k0 > row0 + kRowsPerWarp - 1) continue;

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
      const bool visible = col < Lk && (!causal || row0 + r >= col);
      const float sr = visible ? s[r] : kNegInf;
      float mt = sr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      const float p = visible ? expf(sr - m_new) : 0.f;
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
      const float denom = fmaxf(lr, 1e-30f);
      // m is the warp's row max, the same on every lane.
      if (lse != nullptr && lane == 0)
        lse[(static_cast<long long>(b) * gridDim.y + h) * Lq + row] =
            m[r] + logf(denom);
      T* out = o + b * os.b + row * os.l + h * os.h;
#pragma unroll
      for (int e = 0; e < E; ++e) store(out + lane + 32 * e, acc[r][e] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Lq, int Lk, int H, int Hkv, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(flash_fwd_kernel<T, D>), smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Lq, Lk, H / Hkv,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
flash_fwd_tc_kernel(const tc::bf16* __restrict__ q,
                    const tc::bf16* __restrict__ k,
                    const tc::bf16* __restrict__ v, tc::bf16* __restrict__ o,
                    float* __restrict__ lse, int Lq, int Lk, int H, int group,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    float scale, int causal) {
  const tc::BlockAt at = tc::block_at(Lq, H);
  const int b = at.b, h = at.h, hk = h / group;
  int rows[2], limit[2];
  tc::thread_rows(at.q0, rows);
  for (int i = 0; i < 2; ++i)
    limit[i] = rows[i] >= Lq ? 0 : causal ? min(rows[i] + 1, Lk) : Lk;
  float acc[D / 2], m[2], l[2];
  tc::attend<D>(q + b * qs.b + h * qs.h, qs.l, k + b * ks.b + hk * ks.h, ks.l,
                v + b * vs.b + hk * vs.h, vs.l, at.q0, Lq, Lk, limit, scale,
                acc, m, l);
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f), inv = 1.f / denom;
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * H + h) * Lq + rows[i]] =
          m[i] + logf(denom);
    tc::bf16* out = o + b * os.b + rows[i] * os.l + h * os.h + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * i] * inv, acc[4 * c + 2 * i + 1] * inv);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Lq, int Lk, int H, int Hkv,
              const long long* st, float scale, int causal,
              cudaStream_t stream) {
  constexpr int smem = tc::Smem<D>::kBytes;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(flash_fwd_tc_kernel<D>), smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = tc::grid_blocks(B, Lq, H);
  if (blocks > 0x7fffffff) return -3;
  flash_fwd_tc_kernel<D><<<static_cast<unsigned>(blocks), tc::kThreads, smem,
                           stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), lse, Lq, Lk,
      H, H / Hkv, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, and a
// negative code for arguments the kernel does not take: -1 dtype, -2 head
// dim, -3 shapes. dtype: 0 = float32, 1 = bfloat16. strides: 12 values,
// (batch, seq, head) for q, k, v and o in that order, in elements. lse:
// null, or fp32 [B, H, Lq] contiguous for the rows' log-sum-exp.
extern "C" int ray_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int dtype, int B, int Lq,
                             int Lk, int H, int Hkv, int D,
                             const long long* strides, float scale,
                             int causal, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv != 0 ||
      (causal && Lq != Lk) || B > 65535 || H > 65535)
    return -3;
  if (D != 64 && D != 128) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? launch<float, 64>(q, k, v, o, lse, B, Lq, Lk, H, Hkv,
                                       strides, scale, causal, s)
                   : launch<float, 128>(q, k, v, o, lse, B, Lq, Lk, H, Hkv,
                                        strides, scale, causal, s);
  if (dtype == 1)
    return D == 64 ? launch_tc<64>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, strides,
                                   scale, causal, s)
                   : launch_tc<128>(q, k, v, o, lse, B, Lq, Lk, H, Hkv,
                                    strides, scale, causal, s);
  return -1;
}
