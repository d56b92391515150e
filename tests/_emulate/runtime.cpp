// The emulated runtime: launches, barriers and warp exchanges.
#include "cuda_runtime.h"

thread_local uint3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
alignas(1024) unsigned char emu_smem[232448 + 1024];
int emu_multiprocessors = 132;

extern "C" void emu_set_multiprocessors(int n) { emu_multiprocessors = n; }

namespace {
std::barrier<>* block_barrier;
std::vector<std::barrier<>*> warp_barriers;
Words exchange[1024];
int reduce_buf[1024];
void warp_sync() { warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }
}  // namespace

cudaError_t cudaFuncSetAttribute(const void*, int, int bytes) {
  return bytes <= 232448 ? cudaSuccess : 1;  // the H100's limit a block
}
cudaError_t cudaGetLastError() { return cudaSuccess; }
void __syncthreads() { block_barrier->arrive_and_wait(); }

Words emu_warp_exchange(const Words& mine, int src_lane) {
  const int warp = threadIdx.x / 32;
  exchange[threadIdx.x] = mine;
  warp_sync();
  const Words got = exchange[warp * 32 + src_lane];
  warp_sync();
  return got;
}

int __reduce_max_sync(unsigned, int x) {
  const int warp = threadIdx.x / 32;
  reduce_buf[threadIdx.x] = x;
  warp_sync();
  int m = x;
  for (int i = 0; i < 32; ++i) m = std::max(m, reduce_buf[warp * 32 + i]);
  warp_sync();
  return m;
}

void emu_launch(dim3 grid, dim3 block, int smem,
                const std::function<void()>& body) {
  if (smem + 1024 > static_cast<int>(sizeof(emu_smem)) || block.x > 1024)
    abort();
  gridDim = grid;
  blockDim = block;
  const int n = block.x;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        // stale bytes (bf16 -4.3e8): a read before a write shows
        std::memset(emu_smem, 0xcd, sizeof(emu_smem));
        std::barrier<> bb(n);
        block_barrier = &bb;
        warp_barriers.clear();
        for (int w = 0; w < (n + 31) / 32; ++w)
          warp_barriers.push_back(new std::barrier<>(32));
        std::vector<std::thread> threads;
        for (int t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            threadIdx = {static_cast<unsigned>(t), 0, 0};
            blockIdx = {x, y, z};
            body();
          });
        for (auto& th : threads) th.join();
        for (auto* b : warp_barriers) delete b;
      }
}
