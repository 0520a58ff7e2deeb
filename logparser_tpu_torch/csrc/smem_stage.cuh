// TMA bulk copies (global -> shared) onto mbarriers, and the persistent
// grid, for the kernels that stage data in shared memory.
//
// The barrier primitives (bar_init, bar_expect_tx / bar_arrive,
// bulk_g2s, bar_wait) leave the phase to the caller: a barrier that is
// used again (split.cu's per-warp double buffer) waits on parity 0, then
// 1, then 0, ... of its uses.  proxy_fence orders a thread's earlier
// generic accesses to shared memory before a later bulk copy into it.
//
// stage_issue / stage_wait serve the persistent lookup kernels
// (zone_lookup.cu, geo_lookup.cu), which stage their tables once per
// block: thread 0 initialises a barrier, announces the bytes to come and
// issues the copies; the block may then load its first inputs from device
// memory while the copies fly; stage_wait waits on the barrier's first
// phase (parity 0: one use), and every thread must reach it before the
// block exits.  The source and size must be multiples of 16 bytes (the
// tables pad their regions on the host; the launchers check).  The grid is
// persistent: the SMs times the blocks of this size that fit on one,
// never more blocks than the batch needs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lp {

// One bulk copy's bytes (a multiple of 16).
constexpr int STAGE_CHUNK = 32768;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: a barrier expecting one arrival a phase.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: arrive, announcing `bytes` of bulk copies onto this phase.
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One thread: arrive with no bytes to come.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One thread: a 1-D bulk copy; dst, src and bytes multiples of 16.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, int bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Every thread that reads the copied bytes: wait for the phase of the
// given parity to complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void stage_issue(void* dst, const void* src, int bytes,
                                            uint64_t* bar) {
  if (threadIdx.x == 0) bar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect_tx(bar, bytes);
    const char* s = static_cast<const char*>(src);
    char* d = static_cast<char*>(dst);
    for (int off = 0; off < bytes; off += STAGE_CHUNK) {
      const int n = bytes - off < STAGE_CHUNK ? bytes - off : STAGE_CHUNK;
      bulk_g2s(d + off, s + off, n, bar);
    }
  }
}

__device__ __forceinline__ void stage_wait(uint64_t* bar) { bar_wait(bar, 0); }

inline bool aligned16(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && (bytes & 15) == 0;
}

// The persistent grid of `kernel` at `threads` a block and `smem` bytes of
// dynamic shared memory, capped at `needed` blocks.  Raises the kernel's
// dynamic shared-memory limit to the card's opt-in maximum once per
// device; `cache` (one per kernel) keeps the blocks an SM holds per
// (device, threads, smem), up to 16 shapes.
struct GridCache {
  int raised[64] = {0};
  int sms[64] = {0};
  int shape[16][4] = {};   // device, threads, smem, blocks per SM
  int n = 0;
};

template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem, long long needed,
                            GridCache& cache, int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cache.raised[dev]) {
    int optin = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaDeviceGetAttribute(&cache.sms[dev], cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaFuncGetAttributes(&attr, kernel)) ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    optin - static_cast<int>(attr.sharedSizeBytes))))
      return err;
    cache.raised[dev] = 1;
  }
  int per_sm = 0;
  for (int i = 0; i < cache.n && !per_sm; ++i) {
    const int* e = cache.shape[i];
    if (e[0] == dev && e[1] == threads && e[2] == smem) per_sm = e[3];
  }
  if (!per_sm) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    int* e = cache.shape[cache.n < 16 ? cache.n++ : 15];
    e[0] = dev;
    e[1] = threads;
    e[2] = smem;
    e[3] = per_sm;
  }
  const long long cap = static_cast<long long>(cache.sms[dev]) * per_sm;
  grid = static_cast<int>(needed < 1 ? 1 : (needed < cap ? needed : cap));
  return cudaSuccess;
}

}  // namespace lp
