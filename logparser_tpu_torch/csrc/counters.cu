// Kernel 18: the data-parallel good / bad line counters.
//
// Replaces logparser_tpu/parallel/mesh.py aggregate_counters (:243): the
// sums of the [B] good and bad masks (the reference's Hadoop counters), the
// one cross-device reduction of its data-parallel loop.  The runner
// (parallel/mesh.py) launches this on each data shard's rows on that
// shard's device and adds the shards' two counters on the home device.
//
// A grid-stride loop (a few blocks per SM), a warp shuffle sum, then one
// atomicAdd a warp and counter into out [2] int32, which is zeroed here
// first.  Integer sums, so the order of the atomics does not change them;
// they wrap at 32 bits as jnp.sum of int32 does without x64.  A mask is
// bool (1 byte a row, 0 or 1) or int32 (4 bytes a row).
//
// Bound: bytes -- each mask read once; 8 bytes written.

#include "lp_common.cuh"

namespace {

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(lp::FULL, v, o);
  return v;
}

template <typename T>
__global__ void counters_kernel(const T* __restrict__ good, const T* __restrict__ bad,
                                int B, unsigned* __restrict__ out) {
  unsigned g = 0u, b = 0u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B;
       i += gridDim.x * blockDim.x) {
    g += static_cast<unsigned>(good[i]);
    b += static_cast<unsigned>(bad[i]);
  }
  g = warp_sum(g);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    if (g) atomicAdd(out, g);
    if (b) atomicAdd(out + 1, b);
  }
}

}  // namespace

LP_EXPORT int lp_counters(const void* good, const void* bad, int B, int elem_size,
                          void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  const int threads = 256;
  int blocks = lp::grid_for(B, threads);
  if (blocks > 132 * 8) blocks = 132 * 8;
  unsigned* o = static_cast<unsigned*>(out);
  if (elem_size == 1) {
    counters_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(good), static_cast<const uint8_t*>(bad), B, o);
  } else if (elem_size == 4) {
    counters_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(good), static_cast<const int32_t*>(bad), B, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_counters_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
