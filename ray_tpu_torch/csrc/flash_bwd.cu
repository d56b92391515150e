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
// Two kernels, so that neither needs atomics and the same inputs give the
// same bits:
//   * dK/dV: one block per (batch, kv head, tile of keys). It loops over
//     the G query heads of its kv head's group and over the query tiles
//     that can see its keys (under the causal mask only those at or below
//     the diagonal) and sums dK and dV over all of them in registers. So
//     GQA needs no repeated K/V, and the sum over a group, which Mosaic
//     leaves to the VJP of its caller's jnp.repeat, is taken in one fixed
//     order.
//   * dQ: one block per (batch, head, tile of queries), looping over the
//     key tiles its rows can see, like the forward kernel.
// Both read [B, L, H, D] tensors through strides (no transpose copies) and
// take any L (the tile edges are masked) and D in {64, 128}. Each kernel
// recomputes S and dP: seven products where one pass would do five.
//
// What bounds it. The backward needs five products of the forward's size
// (S, dP, dV, dK, dQ): 10 B H D (visible pairs) operations, about 2.5
// times the forward's, over the same bytes plus dO, dQ, dK and dV, so on
// the card's bf16 tensor cores (989 TFLOP/s) it is bound by operations
// past L ~ 300, and by far at the training shapes (L of 2048 and 8192).
//
// Two routes, by dtype:
//   * bf16 (every main path): flash_bwd_dkdv_tc_kernel and
//     flash_bwd_dq_tc_kernel. Their products are wgmma with fp32 sums, on
//     tiles that cp.async copies into 128-byte-swizzled shared memory
//     through a ring of two stages (flash_tc.cuh, flash_tc_bwd.cuh), so
//     a tile's copies are in flight while the previous one is multiplied.
//     Blocks of two warpgroups (256 threads).
//     - dK/dV: query tiles of BQ rows (64 at D = 64; 32 at D = 128, where
//       the dK and dV sums alone take 128 registers a thread) stream
//       through the ring with their lse and di. The products are taken
//       transposed, so nothing is transposed in registers: S^T = K Q^T
//       and dP^T = V dO^T (A the warpgroup's K or V rows, B the Q or dO
//       tile, both K-major), then P^T and dS^T in fp32 on the accumulator
//       fragment (lse and di per column), then dV += P^T dO and
//       dK += dS^T Q, A = P^T or dS^T from registers as bf16 and B the
//       same dO or Q tile read MN-major. A block owns 128 keys, 64 per
//       warpgroup, both on the same query tile; where that grid would give
//       fewer than two blocks a multiprocessor (one [1, 8192] sequence
//       over 2 kv heads, as a Ulysses rank has it: 128 blocks, the first
//       of them twice the average), a block owns 64 keys and its warpgroups
//       take turns over the query tiles, adding their sums at the end in
//       a fixed order. Key tile 0 is launched first: under the causal mask
//       the first keys are seen by every query row.
//     - dQ: each warpgroup owns 64 of block_at's 128 query rows (the
//       heaviest causal tiles first); K and V tiles stream through the
//       ring, 32 keys at D = 64 (111 registers, two blocks a
//       multiprocessor) and 64 at D = 128. S = Q K^T and dP = dO V^T
//       (K-major), dS in registers, dQ += dS K with B the K tile read
//       MN-major.
//     P and dS enter their products as bf16 hi + lo, two products each
//     (tc::mma_rs): one bf16 part (FlashAttention 2 and 3's choice) puts
//     an error of 2^-9 on every term and fails the rule that holds the
//     gradients to the fp32 plain version (dq at 1.38 and dk at 1.19 of
//     it at the training shape on an H100, 23% faster), while with two
//     they differ from it only by their final rounding to bf16. That is
//     10 products where 7 would do: 6 in the dK/dV kernel, 4 in dQ.
//     What holds it back: a warpgroup waits for its S and dP products
//     before the exponentials and for its gradient products before the
//     next tile, so the CUDA-core work between them overlaps the tensor
//     cores only across warpgroups. One pass with atomic dQ sums, TMA
//     copies and a producer warp are the next step.
//     Rows need 16-byte aligned starts (the wrapper checks).
//   * fp32: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, the first
//     version's CUDA-core code, kept because fp32 models on the card are
//     held to the CPU at 1e-4, which TF32 products would not meet.
//     dK/dV block: 4 warps, each owning KPW keys (16 at D = 64, 8 at
//     D = 128, so the dK and dV sums take 64 registers a lane either way).
//     A query tile holds 32 rows, one per lane: a lane computes its row's
//     score and dP for each of its warp's keys, then each lane accumulates
//     D/32 columns of dK and dV (d = lane + 32 e) while p and dS are
//     broadcast row by row. dQ block: 4 warps of 16 query rows; each K/V
//     tile holds 32 keys, one per lane, as in the forward kernel.

#include "flash_common.cuh"
#include "flash_tc_bwd.cuh"

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


// ---------------------------------------------------------------- bf16 route

// KEYS = 128: warpgroup w owns keys k0 + 64 w.. and both take every
// (query head, query tile) item. KEYS = 64: both own the block's keys and
// warpgroup w takes item 2 j + w at step j (tc::DkdvSmem's note).
template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1)
flash_bwd_dkdv_tc_kernel(const tc::bf16* __restrict__ q,
                         const tc::bf16* __restrict__ k,
                         const tc::bf16* __restrict__ v,
                         const tc::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv,
                         int B, int H, int Hkv, int Lq, int Lk, Strides qs,
                         Strides ks, Strides vs, Strides dos, Strides dks,
                         Strides dvs, float scale, int causal) {
  using S = tc::DkdvSmem<D, KEYS>;
  constexpr int BQ = S::BQ;
  constexpr bool kTurns = KEYS == 64;  // warpgroups take turns over items
  constexpr int kPerStep = kTurns ? tc::kWarpgroups : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - tc::smem_u32(smem_raw));

  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128;
  const int t = lane % 4;
  // The grid is key tiles x B x Hkv with the key tile outermost, tile 0
  // (under the causal mask the heaviest) first.
  const int heads = B * Hkv;
  const int k0 = static_cast<int>(blockIdx.x) / heads * KEYS;
  const int b = static_cast<int>(blockIdx.x) % heads / Hkv;
  const int hk = static_cast<int>(blockIdx.x) % Hkv;
  const int group = H / Hkv;
  // This warpgroup's first key and this thread's two keys: the rows of
  // the transposed products' accumulator fragments.
  const int key_wg = kTurns ? k0 : k0 + 64 * wg;
  int key[2];
  key[0] = key_wg + ((tid / 32) % 4) * 16 + lane / 4;
  key[1] = key[0] + 8;

  // Item i is query head hk * group + i / n_qt and the query tile at
  // q_first + (i % n_qt) BQ; under the causal mask the rows before k0 see
  // none of the block's keys (k0 is a multiple of BQ).
  const int q_first = causal ? k0 : 0;
  const int n_qt = (Lq - q_first + BQ - 1) / BQ;
  const int n_items = group * n_qt;
  const int n_steps = (n_items + kPerStep - 1) / kPerStep;

  auto load_step = [&](int j, int stage) {
#pragma unroll
    for (int w = 0; w < kPerStep; ++w) {
      const int i = kPerStep * j + w;
      if (i >= n_items) break;
      const int h = hk * group + i / n_qt, q0 = q_first + (i % n_qt) * BQ;
      tc::load_tile<D, BQ>(base + S::q_tile(stage, w),
                           q + b * qs.b + h * qs.h, qs.l, q0, Lq, tid);
      tc::load_tile<D, BQ>(base + S::do_tile(stage, w),
                           dout + b * dos.b + h * dos.h, dos.l, q0, Lq, tid);
    }
    // the items' lse and di: one float a thread
    const int w = tid / (2 * BQ), r = tid % BQ, i = kPerStep * j + w;
    if (tid < kPerStep * 2 * BQ && i < n_items) {
      const bool of_lse = tid % (2 * BQ) < BQ;
      const int h = hk * group + i / n_qt, q0 = q_first + (i % n_qt) * BQ;
      const float* src = (of_lse ? lse : di) +
                         (static_cast<long long>(b) * H + h) * Lq + q0 + r;
      tc::cp_async4(
          base + (of_lse ? S::lse(stage, w) : S::di(stage, w)) + 4 * r,
          q0 + r < Lq ? src : lse, q0 + r < Lq);
    }
  };

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  tc::load_tile<D, KEYS>(base + S::kK, k + b * ks.b + hk * ks.h, ks.l, k0,
                         Lk, tid);
  tc::load_tile<D, KEYS>(base + S::kV, v + b * vs.b + hk * vs.h, vs.l, k0,
                         Lk, tid);
  load_step(0, 0);
  tc::cp_async_commit();

  const float scale_log2 = scale * tc::kLog2e;
  float st[BQ / 2] = {}, dpt[BQ / 2] = {};
  const int slot = kTurns ? wg : 0;  // this warpgroup's tile in a stage
  for (int j = 0; j < n_steps; ++j) {
    const int stage = j % tc::kStages;
    tc::cp_async_wait_all();  // step j (and K, V) has landed for this thread
    tc::fence_async_proxy();
    __syncthreads();  // ... for every thread; step j - 1 is consumed
    if (j + 1 < n_steps) {
      load_step(j + 1, (j + 1) % tc::kStages);
      tc::cp_async_commit();
    }
    const int item = kPerStep * j + slot;
    if (item >= n_items) continue;
    const int q0 = q_first + (item % n_qt) * BQ;
    // Under the causal mask a tile of rows wholly before this warpgroup's
    // keys adds nothing to them.
    if (causal && q0 + BQ <= key_wg) continue;

    const uint32_t q_t = base + S::q_tile(stage, slot);
    const uint32_t do_t = base + S::do_tile(stage, slot);
    // S^T = K Q^T and dP^T = V dO^T: rows are this warpgroup's keys,
    // columns the tile's query rows.
    tc::mma_ss<BQ, D, KEYS>(st, base + S::kK, key_wg - k0, q_t);
    tc::mma_ss<BQ, D, KEYS>(dpt, base + S::kV, key_wg - k0, do_t);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(st);
    tc::fence_regs(dpt);

    // P^T = exp(scale s - lse) and dS^T = P^T (dP^T - di), lse and di per
    // column. A pair is masked where the query row is past Lq or, under
    // the causal mask, before the key; a tile wholly inside both needs no
    // test.
    const float* lse_s =
        reinterpret_cast<const float*>(base_ptr + S::lse(stage, slot));
    const float* di_s =
        reinterpret_cast<const float*>(base_ptr + S::di(stage, slot));
    const bool edge = q0 + BQ > Lq || (causal && q0 < key_wg + 63);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * i + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(di_s + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q0 + 8 * i + 2 * t + e;
        const float neg_lse = -(e ? l2.y : l2.x) * tc::kLog2e;
        const float dii = e ? d2.y : d2.x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& s = st[4 * i + 2 * h + e];
          float& dp = dpt[4 * i + 2 * h + e];
          float p = tc::exp2_approx(fmaf(s, scale_log2, neg_lse));
          if (edge && (row >= Lq || (causal && row < key[h]))) p = 0.f;
          s = p;
          dp = p * (dp - dii);
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: the depth is the tile's query rows,
    // B the dO and Q tiles read MN-major.
    tc::mma_rs<BQ, D>(dv_acc, st, do_t);
    tc::mma_rs<BQ, D>(dk_acc, dpt, q_t);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(dv_acc);
    tc::fence_regs(dk_acc);
  }

  // With 64 keys the second warpgroup hands its sums over in shared memory
  // (nothing is in flight: the last step's copies were waited for), and
  // the first adds them to its own, always in this order.
  float* sums = reinterpret_cast<float*>(base_ptr + S::kSums);
  const int me = tid % 128;
  if (kTurns) {
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        sums[i * 128 + me] = dk_acc[i];
        sums[(D / 2 + i) * 128 + me] = dv_acc[i];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_acc[i] += sums[i * 128 + me];
      dv_acc[i] += sums[(D / 2 + i) * 128 + me];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= Lk) continue;
    tc::bf16* dkr = dk + b * dks.b + key[h] * dks.l + hk * dks.h + 2 * t;
    tc::bf16* dvr = dv + b * dvs.b + key[h] * dvs.l + hk * dvs.h + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * c) = __floats2bfloat162_rn(
          dk_acc[4 * c + 2 * h] * scale, dk_acc[4 * c + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * c) = __floats2bfloat162_rn(
          dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads, tc::dq_blocks_per_sm<D>)
flash_bwd_dq_tc_kernel(const tc::bf16* __restrict__ q,
                       const tc::bf16* __restrict__ k,
                       const tc::bf16* __restrict__ v,
                       const tc::bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di,
                       tc::bf16* __restrict__ dq, int Lq, int Lk, int H,
                       int group, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dqs, float scale, int causal) {
  constexpr int BK = tc::dq_block_k<D>;
  using S = tc::DqSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;

  const tc::BlockAt at = tc::block_at(Lq, H);
  const int b = at.b, h = at.h, hk = h / group, q0 = at.q0;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 4;
  int rows[2];
  tc::thread_rows(q0, rows);
  const long long stat0 = (static_cast<long long>(b) * H + h) * Lq;
  float neg_lse[2], dii[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < Lq;
    neg_lse[i] = in ? -lse[stat0 + rows[i]] * tc::kLog2e : 0.f;
    dii[i] = in ? di[stat0 + rows[i]] : 0.f;
  }
  // The keys the block visits, and this warpgroup's: under the causal mask
  // up to the last row's key.
  const int row_wg = q0 + 64 * wg;
  const int block_end = causal ? min(Lk, q0 + tc::kBlockQ) : Lk;
  const int wg_end = row_wg >= Lq ? 0 : causal ? min(Lk, row_wg + 64) : Lk;
  const int n_tiles = (block_end + BK - 1) / BK;

  const tc::bf16* kb = k + b * ks.b + hk * ks.h;
  const tc::bf16* vb = v + b * vs.b + hk * vs.h;
  tc::load_tile<D, tc::kBlockQ>(base + S::kQt, q + b * qs.b + h * qs.h, qs.l,
                                q0, Lq, tid);
  tc::load_tile<D, tc::kBlockQ>(base + S::kDo, dout + b * dos.b + h * dos.h,
                                dos.l, q0, Lq, tid);
  tc::load_tile<D, BK>(base + S::k_tile(0), kb, ks.l, 0, Lk, tid);
  tc::load_tile<D, BK>(base + S::v_tile(0), vb, vs.l, 0, Lk, tid);
  tc::cp_async_commit();

  const float scale_log2 = scale * tc::kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2] = {}, dp[BK / 2] = {};
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % tc::kStages, k0 = j * BK;
    tc::cp_async_wait_all();  // tile j (and Q, dO) has landed
    tc::fence_async_proxy();
    __syncthreads();  // ... for every thread; tile j - 1 is consumed
    if (j + 1 < n_tiles) {
      const int next = (j + 1) % tc::kStages;
      tc::load_tile<D, BK>(base + S::k_tile(next), kb, ks.l, k0 + BK, Lk, tid);
      tc::load_tile<D, BK>(base + S::v_tile(next), vb, vs.l, k0 + BK, Lk, tid);
      tc::cp_async_commit();
    }
    if (k0 >= wg_end) continue;  // no row of this warpgroup sees the tile

    const uint32_t k_t = base + S::k_tile(stage);
    // S = Q K^T and dP = dO V^T over this warpgroup's 64 rows.
    tc::mma_ss<BK, D, tc::kBlockQ>(s, base + S::kQt, 64 * wg, k_t);
    tc::mma_ss<BK, D, tc::kBlockQ>(dp, base + S::kDo, 64 * wg,
                                   base + S::v_tile(stage));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // dS = P (dP - di), masked past Lk and, under the causal mask, past
    // the row; a tile wholly inside both needs no test.
    const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > row_wg);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * i + 2 * t + e;
          const int at_i = 4 * i + 2 * hh + e;
          float p = tc::exp2_approx(fmaf(s[at_i], scale_log2, neg_lse[hh]));
          if (edge && (col >= Lk || (causal && col > rows[hh]))) p = 0.f;
          dp[at_i] = p * (dp[at_i] - dii[hh]);
        }

    // dQ += dS K: the depth is the tile's keys, B the K tile read MN-major.
    tc::mma_rs<BK, D>(acc, dp, k_t);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Lq) continue;
    tc::bf16* out = dq + b * dqs.b + rows[i] * dqs.l + h * dqs.h + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * i] * scale, acc[4 * c + 2 * i + 1] * scale);
  }
}

template <int D, int KEYS>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dk, void* dv, int B,
                int Lq, int Lk, int H, int Hkv, const long long* st,
                float scale, int causal, cudaStream_t stream) {
  using bf16 = tc::bf16;
  const long long blocks =
      static_cast<long long>((Lk + KEYS - 1) / KEYS) * B * Hkv;
  if (blocks > 0x7fffffff) return -3;
  constexpr int smem = tc::DkdvSmem<D, KEYS>::kBytes;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_tc_kernel<D, KEYS>), smem,
      smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_tc_kernel<D, KEYS><<<static_cast<unsigned>(blocks),
                                      tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, Hkv, Lq, Lk,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 5), strides_at(st, 6), scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* di, void* dq, void* dk, void* dv,
              int B, int Lq, int Lk, int H, int Hkv, const long long* st,
              float scale, int causal, cudaStream_t stream) {
  using bf16 = tc::bf16;
  // Blocks of 128 keys unless they would be fewer than two a
  // multiprocessor, where the longest blocks would end long after the rest
  // (one [1, 8192] sequence over 2 kv heads: 128 blocks); then 64.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wide = static_cast<long long>((Lk + 127) / 128) * B * Hkv;
  err = static_cast<cudaError_t>(
      wide >= 2LL * sms
          ? launch_dkdv<D, 128>(q, k, v, dout, lse, di, dk, dv, B, Lq, Lk, H,
                                Hkv, st, scale, causal, stream)
          : launch_dkdv<D, 64>(q, k, v, dout, lse, di, dk, dv, B, Lq, Lk, H,
                               Hkv, st, scale, causal, stream));
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long dq_blocks = tc::grid_blocks(B, Lq, H);
  if (dq_blocks > 0x7fffffff) return -3;
  constexpr int dq_smem = tc::DqSmem<D>::kBytes;
  static bool dq_set[kMaxDevices] = {};
  err = allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_tc_kernel<D>),
                   dq_smem, dq_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_tc_kernel<D><<<static_cast<unsigned>(dq_blocks), tc::kThreads,
                              dq_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dq), Lq, Lk, H, H / Hkv, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), scale, causal);
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
    return D == 64 ? launch_tc<64>(q, k, v, dout, lse, di, dq, dk, dv, B, Lq,
                                   Lk, H, Hkv, strides, scale, causal, s)
                   : launch_tc<128>(q, k, v, dout, lse, di, dq, dk, dv, B, Lq,
                                    Lk, H, Hkv, strides, scale, causal, s);
  return -1;
}
