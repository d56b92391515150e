// Helpers shared by flash_fwd.cu, flash_bwd.cu and flash_stats.cu: element
// conversion, the stride record the kernels read [B, L, H, D] tensors
// through, and the shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ray_flash {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, l, h;  // in elements; the D axis has stride 1
};

// The i-th (batch, seq, head) triple of a flat stride array.
inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

constexpr int kMaxDevices = 64;

// Above 48 KB of shared memory a kernel needs an opt-in, once per kernel
// and device; `done` is the caller's flag array for this kernel (setting it
// again from a racing thread is harmless).
inline cudaError_t allow_smem(const void* kernel, int bytes,
                              bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace ray_flash
