// The CUDA names the flash kernels use, emulated on the host (see
// __init__.py): one std::thread per CUDA thread, blocks one after another,
// shared memory one static buffer, warp shuffles through a per-warp
// exchange.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
extern thread_local uint3 threadIdx, blockIdx;
extern dim3 gridDim, blockDim;
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }

typedef int cudaError_t;
constexpr int cudaSuccess = 0;
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// The multiprocessor count the launchers see: 132 (an H100 SXM) unless
// emu_set_multiprocessors was called.
extern int emu_multiprocessors;
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu_multiprocessors;
  return cudaSuccess;
}
cudaError_t cudaFuncSetAttribute(const void*, int, int bytes);
cudaError_t cudaGetLastError();

extern unsigned char emu_smem[];  // the running block's shared memory
void __syncthreads();
struct Words {
  uint32_t w[4];
};
// Every lane of the warp passes its words; returns those of `src_lane`.
Words emu_warp_exchange(const Words& mine, int src_lane);
inline float __shfl_sync(unsigned, float x, int src) {
  Words m{};
  std::memcpy(&m.w[0], &x, 4);
  const Words o = emu_warp_exchange(m, src);
  float y;
  std::memcpy(&y, &o.w[0], 4);
  return y;
}
inline float __shfl_xor_sync(unsigned, float x, int mask) {
  return __shfl_sync(0, x, static_cast<int>(threadIdx.x % 32) ^ mask);
}
int __reduce_max_sync(unsigned, int);
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const unsigned char*>(p) - emu_smem;
}
void emu_launch(dim3 grid, dim3 block, int smem,
                const std::function<void()>& body);
