// Backward flash attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by ray_tpu_torch/ops/attention.py.
//
// Replaces the backward half of ray_tpu/ops/attention.py `_tpu_flash`: the
// Mosaic kernels `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`
// of jax/experimental/pallas/ops/tpu/flash_attention.py, which jax.grad
// reaches through its `_flash_attention_bwd`. From q, k, v, dO, the
// forward's row log-sum-exp `lse` (Mosaic saves l and m instead) and
// di = rowsum(o * dO) (a plain reduction outside the kernels, as in Mosaic)
// it recomputes the probabilities tile by tile, p = exp(scale q.k - lse),
// masked ones set to 0 as in the forward kernel, and forms
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - di),
//   dK = scale dS^T Q,   dQ = scale dS K.
//
// Two kernels, so that neither needs atomics:
//   * dK/dV: one block per (batch, kv head, tile of keys). It loops over
//     the G query heads of its kv head's group and over the query tiles
//     that can see its keys (under the causal mask only those at or below
//     the diagonal) and sums dK and dV over all of them in registers. So
//     GQA needs no repeated K/V, and the sum over a group, which Mosaic
//     leaves to the VJP of its caller's jnp.repeat, is taken in one fixed
//     order: the result is deterministic.
//   * dQ: one block per (batch, head, tile of 64 queries), looping over the
//     key tiles its rows can see, like the forward kernel.
// Both read [B, L, H, D] tensors through strides (no transpose copies) and
// take any L (the tile edges are masked) and D in {64, 128}.
//
// What bounds it. The backward needs five products of the forward's size
// (S, dP, dV, dK, dQ): 10 B H D (visible pairs) operations, about 2.5
// times the forward's, over the same bytes plus dO, dQ, dK and dV, so on
// the card's bf16 tensor cores it is bound by operations past L ~ 300.
// This first version recomputes S and dP in both kernels (seven products)
// on the fp32 CUDA cores, so it is bound by operations from the smallest L
// on, and by shared-memory reads within that. Its design keeps the
// probabilities and dS out of device memory: they live in registers and
// pass between lanes by shuffles. Tensor cores (wgmma), TMA and one pass
// that shares S between dQ and dK/dV are later work.
//
// dK/dV block: 4 warps, each owning KPW keys (16 at D = 64, 8 at D = 128,
// so the dK and dV sums take 64 registers a lane either way). A query tile
// holds 32 rows, one per lane: a lane computes its row's score and dP for
// each of its warp's keys, then each lane accumulates D/32 columns of dK
// and dV (d = lane + 32 e) while p and dS are broadcast row by row.
// dQ block: 4 warps of 16 query rows; each K/V tile holds 32 keys, one per
// lane, as in the forward kernel.

#include "flash_common.cuh"

namespace {

using namespace ray_flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// dK/dV kernel tiles.
template <int D>
constexpr int kKeysPerWarp = 1024 / D;
constexpr int kDkvBlockQ = 32;

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kWarps * kKeysPerWarp<D> * D + 2 * kDkvBlockQ * (D + 1) +
         2 * kDkvBlockQ;
}

// dQ kernel tiles.
constexpr int kDqRowsPerWarp = 16;
constexpr int kDqBlockQ = kWarps * kDqRowsPerWarp;
constexpr int kDqBlockK = 32;

template <int D>
constexpr int dq_smem_floats() {
  return 2 * kDqBlockQ * D + 2 * kDqBlockK * (D + 1) + 2 * kDqBlockQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Lq, int Lk, int group,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dks, Strides dvs, float scale, int causal) {
  constexpr int KPW = kKeysPerWarp<D>;
  constexpr int BK = kWarps * KPW;
  constexpr int BQ = kDkvBlockQ;
  constexpr int E = D / 32;  // dK/dV columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [BK][D]
  float* Vs = Ks + BK * D;            // [BK][D]
  float* Qs = Vs + BK * D;            // [BQ][D + 1], pre-scaled; padded so
  float* dOs = Qs + BQ * (D + 1);     // [BQ][D + 1]  a lane's own row is
  float* lse_s = dOs + BQ * (D + 1);  // [BQ]         free of conflicts
  float* di_s = lse_s + BQ;           // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < BK * D; i += kThreads) {
    const int j = i / D, d = i % D, col = k0 + j;
    const bool in = col < Lk;
    Ks[i] = in ? to_f32(kb[col * ks.l + d]) : 0.f;
    Vs[i] = in ? to_f32(vb[col * vs.l + d]) : 0.f;
  }

  float dk_acc[KPW][E], dv_acc[KPW][E];
#pragma unroll
  for (int r = 0; r < KPW; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;
  }

  const int key0 = k0 + warp * KPW;  // this warp's first key
  const float* Kw = Ks + warp * KPW * D;
  const float* Vw = Vs + warp * KPW * D;
  // Causal: rows before the block's first key see none of its keys.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long stat0 = (static_cast<long long>(b) * H + h) * Lq;
    for (int q0 = q_begin; q0 < Lq; q0 += BQ) {
      __syncthreads();  // K/V are written; the previous tile is consumed
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int r = i / D, d = i % D, row = q0 + r;
        const bool in = row < Lq;
        Qs[r * (D + 1) + d] = in ? to_f32(qb[row * qs.l + d]) * scale : 0.f;
        dOs[r * (D + 1) + d] = in ? to_f32(dob[row * dos.l + d]) : 0.f;
      }
      if (tid < BQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < Lq ? lse[stat0 + row] : 0.f;
        di_s[tid] = row < Lq ? di[stat0 + row] : 0.f;
      }
      __syncthreads();
      // A tile of rows wholly before this warp's keys adds nothing.
      if (causal && q0 + BQ - 1 < key0) continue;

      float s[KPW], dp[KPW];
#pragma unroll
      for (int r = 0; r < KPW; ++r) s[r] = dp[r] = 0.f;
      const float* qr = Qs + lane * (D + 1);
      const float* orow = dOs + lane * (D + 1);
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float q0v = qr[d], q1v = qr[d + 1], q2v = qr[d + 2],
                    q3v = qr[d + 3];
        const float o0v = orow[d], o1v = orow[d + 1], o2v = orow[d + 2],
                    o3v = orow[d + 3];
#pragma unroll
        for (int r = 0; r < KPW; ++r) {
          const float4 kv = *reinterpret_cast<const float4*>(Kw + r * D + d);
          const float4 vv = *reinterpret_cast<const float4*>(Vw + r * D + d);
          s[r] = fmaf(q0v, kv.x, s[r]);
          s[r] = fmaf(q1v, kv.y, s[r]);
          s[r] = fmaf(q2v, kv.z, s[r]);
          s[r] = fmaf(q3v, kv.w, s[r]);
          dp[r] = fmaf(o0v, vv.x, dp[r]);
          dp[r] = fmaf(o1v, vv.y, dp[r]);
          dp[r] = fmaf(o2v, vv.z, dp[r]);
          dp[r] = fmaf(o3v, vv.w, dp[r]);
        }
      }

      const int row = q0 + lane;
      const float lse_r = lse_s[lane], di_r = di_s[lane];
#pragma unroll
      for (int r = 0; r < KPW; ++r) {
        const int col = key0 + r;
        const bool visible = row < Lq && col < Lk && (!causal || row >= col);
        const float p = visible ? expf(s[r] - lse_r) : 0.f;
        s[r] = p;
        dp[r] = p * (dp[r] - di_r);  // dS
      }

#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float qv[E], ov[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          qv[e] = Qs[i * (D + 1) + lane + 32 * e];
          ov[e] = dOs[i * (D + 1) + lane + 32 * e];
        }
#pragma unroll
        for (int r = 0; r < KPW; ++r) {
          const float p = __shfl_sync(kFull, s[r], i);
          const float ds = __shfl_sync(kFull, dp[r], i);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dv_acc[r][e] = fmaf(p, ov[e], dv_acc[r][e]);
            dk_acc[r][e] = fmaf(ds, qv[e], dk_acc[r][e]);  // Qs is scaled
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KPW; ++r) {
    const int col = key0 + r;
    if (col < Lk) {
      T* dkr = dk + b * dks.b + col * dks.l + hk * dks.h;
      T* dvr = dv + b * dvs.b + col * dvs.l + hk * dvs.h;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        store(dkr + lane + 32 * e, dk_acc[r][e]);
        store(dvr + lane + 32 * e, dv_acc[r][e]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int Lq,
                    int Lk, int group, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs, float scale, int causal) {
  constexpr int R = kDqRowsPerWarp;
  constexpr int BQ = kDqBlockQ;
  constexpr int BK = kDqBlockK;
  constexpr int E = D / 32;  // dQ columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BQ][D], pre-scaled
  float* dOs = Qs + BQ * D;           // [BQ][D]
  float* Ks = dOs + BQ * D;           // [BK][D + 1], padded: no bank
  float* Vs = Ks + BK * (D + 1);      // [BK][D + 1]  conflicts
  float* lse_s = Vs + BK * (D + 1);   // [BQ]
  float* di_s = lse_s + BQ;           // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const long long stat0 = (static_cast<long long>(b) * gridDim.y + h) * Lq;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, row = q0 + r;
    const bool in = row < Lq;
    Qs[i] = in ? to_f32(qb[row * qs.l + d]) * scale : 0.f;
    dOs[i] = in ? to_f32(dob[row * dos.l + d]) : 0.f;
  }
  if (tid < BQ) {
    const int row = q0 + tid;
    lse_s[tid] = row < Lq ? lse[stat0 + row] : 0.f;
    di_s[tid] = row < Lq ? di[stat0 + row] : 0.f;
  }

  float acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int row0 = q0 + warp * R;
  const float* Qw = Qs + warp * R * D;
  const float* dOw = dOs + warp * R * D;
  const float* lse_w = lse_s + warp * R;
  const float* di_w = di_s + warp * R;
  // Causal: stop at the tile that holds the block's last row.
  const int kv_end = causal ? min(Lk, q0 + BQ) : Lk;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Qs/dOs are written; the previous tile is consumed
    for (int i = tid; i < BK * D; i += kThreads) {
      const int j = i / D, d = i % D, col = k0 + j;
      const bool in = col < Lk;
      Ks[j * (D + 1) + d] = in ? to_f32(kb[col * ks.l + d]) : 0.f;
      Vs[j * (D + 1) + d] = in ? to_f32(vb[col * vs.l + d]) : 0.f;
    }
    __syncthreads();
    // A tile wholly above this warp's rows adds nothing.
    if (causal && k0 > row0 + R - 1) continue;

    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* vr = Vs + lane * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float k0v = kr[d], k1v = kr[d + 1], k2v = kr[d + 2],
                  k3v = kr[d + 3];
      const float v0v = vr[d], v1v = vr[d + 1], v2v = vr[d + 2],
                  v3v = vr[d + 3];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * D + d);
        const float4 ov = *reinterpret_cast<const float4*>(dOw + r * D + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
        dp[r] = fmaf(ov.x, v0v, dp[r]);
        dp[r] = fmaf(ov.y, v1v, dp[r]);
        dp[r] = fmaf(ov.z, v2v, dp[r]);
        dp[r] = fmaf(ov.w, v3v, dp[r]);
      }
    }

    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool visible = row < Lq && col < Lk && (!causal || row >= col);
      const float p = visible ? expf(s[r] - lse_w[r]) : 0.f;
      s[r] = p * (dp[r] - di_w[r]);  // dS
    }

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = Ks[j * (D + 1) + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ds = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(ds, kv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < Lq) {
      T* out = dq + b * dqs.b + row * dqs.l + h * dqs.h;
#pragma unroll
      for (int e = 0; e < E; ++e)
        store(out + lane + 32 * e, acc[r][e] * scale);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dq, void* dk, void* dv,
           int B, int Lq, int Lk, int H, int Hkv, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  const int group = H / Hkv;
  const Strides qs = strides_at(st, 0), ks = strides_at(st, 1),
                vs = strides_at(st, 2), dos = strides_at(st, 3),
                dqs = strides_at(st, 4), dks = strides_at(st, 5),
                dvs = strides_at(st, 6);

  const int dkv_smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool dkv_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<T, D>), dkv_smem,
      dkv_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BK = kWarps * kKeysPerWarp<D>;
  const dim3 dkv_grid((Lk + BK - 1) / BK, Hkv, B);
  flash_bwd_dkdv_kernel<T, D><<<dkv_grid, kThreads, dkv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, group, qs, ks, vs,
      dos, dks, dvs, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int dq_smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool dq_set[kMaxDevices] = {};
  err = allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, D>),
                   dq_smem, dq_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dq_grid((Lq + kDqBlockQ - 1) / kDqBlockQ, H, B);
  flash_bwd_dq_kernel<T, D><<<dq_grid, kThreads, dq_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), Lq, Lk, group, qs, ks, vs, dos, dqs, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the dK/dV kernel, then the dQ kernel, on `stream`. Returns 0 on
// success, a cudaError_t value if a launch failed, and a negative code for
// arguments the kernels do not take: -1 dtype, -2 head dim, -3 shapes.
// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dout and the gradients.
// lse and di: fp32 [B, H, Lq] contiguous. strides: 21 values, (batch, seq,
// head) for q, k, v, dout, dq, dk and dv in that order, in elements.
extern "C" int ray_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* di, void* dq, void* dk, void* dv,
                             int dtype, int B, int Lq, int Lk, int H, int Hkv,
                             int D, const long long* strides, float scale,
                             int causal, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv != 0 ||
      (causal && Lq != Lk) || B > 65535 || H > 65535)
    return -3;
  if (D != 64 && D != 128) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64
               ? launch<float, 64>(q, k, v, dout, lse, di, dq, dk, dv, B, Lq,
                                   Lk, H, Hkv, strides, scale, causal, s)
               : launch<float, 128>(q, k, v, dout, lse, di, dq, dk, dv, B, Lq,
                                    Lk, H, Hkv, strides, scale, causal, s);
  if (dtype == 1)
    return D == 64 ? launch<__nv_bfloat16, 64>(q, k, v, dout, lse, di, dq, dk,
                                               dv, B, Lq, Lk, H, Hkv, strides,
                                               scale, causal, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, dout, lse, di, dq,
                                                dk, dv, B, Lq, Lk, H, Hkv,
                                                strides, scale, causal, s);
  return -1;
}
