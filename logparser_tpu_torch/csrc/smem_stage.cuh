// Tables staged once per block into dynamic shared memory, for the
// persistent lookup kernels (zone_lookup.cu, geo_lookup.cu).
//
// stage_issue: thread 0 initialises an mbarrier, announces the bytes to
// come and issues TMA 1-D bulk copies (cp.async.bulk, global -> shared,
// completion on the barrier).  The block may then load its first inputs
// from device memory while the copies fly; stage_wait waits on the
// barrier's first phase, and every thread must reach it before the block
// exits.  The source and size must be multiples of 16 bytes (the tables
// pad their regions on the host; the launchers check).  The grid is
// persistent: the SMs times the blocks of this size that fit on one,
// never more blocks than the batch needs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lp {

// One bulk copy's bytes (a multiple of 16).
constexpr int STAGE_CHUNK = 32768;

__device__ __forceinline__ void stage_issue(void* dst, const void* src, int bytes,
                                            uint64_t* bar) {
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(bytes)
                 : "memory");
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const char* s = static_cast<const char*>(src);
    for (int off = 0; off < bytes; off += STAGE_CHUNK) {
      const int n = bytes - off < STAGE_CHUNK ? bytes - off : STAGE_CHUNK;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(d + off),
          "l"(s + off), "r"(n), "r"(b)
          : "memory");
    }
  }
}

__device__ __forceinline__ void stage_wait(uint64_t* bar) {
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

inline bool aligned16(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && (bytes & 15) == 0;
}

// The persistent grid of `kernel` at `threads` a block and `smem` bytes of
// dynamic shared memory, capped at `needed` blocks.  Raises the kernel's
// dynamic shared-memory limit to the card's opt-in maximum once per
// device; `cache` holds, per device, that flag and the last (smem, blocks
// per SM) pair.
struct GridCache {
  int raised[64] = {0};
  int smem[64] = {0};
  int per_sm[64] = {0};
  int sms[64] = {0};
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
    cache.per_sm[dev] = 0;
  }
  if (cache.per_sm[dev] == 0 || cache.smem[dev] != smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.smem[dev] = smem;
    cache.per_sm[dev] = per_sm;
  }
  const long long cap = static_cast<long long>(cache.sms[dev]) * cache.per_sm[dev];
  grid = static_cast<int>(needed < 1 ? 1 : (needed < cap ? needed : cap));
  return cudaSuccess;
}

}  // namespace lp
