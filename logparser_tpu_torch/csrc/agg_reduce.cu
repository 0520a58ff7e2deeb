// Kernel 11: the aggregate pushdown's reductions over the class plane and
// the lanes -- n_device, the sum tiles and the histogram bins.
//
// Replaces, from logparser_tpu/analytics/device.py build_aggregate_fn: the
// n_device sum, _sum_tiles (per 4096-row tile and limb, the sums of the
// low and high 16 bits of the selected rows' base-10^6 limbs: exact int32,
// 4096 * 0xFFFF < 2^31) and the histogram's _limb_ge edge compares and
// per-bin counts.
//
// One block per 4096-row tile (the TPU's sequential grid becomes blocks
// that each own a tile).  Each thread strides over the tile; per
// accumulator a warp shuffle sum, then one shared-memory atomic per warp
// (a histogram bin: one shared atomic per selected row).  The tile sums go
// straight to their tile's slot of tiles [n_sums, ntiles, 3, 2]; n_device
// and the bins, which span tiles, are added into counts [1 + n_bins] with
// one global atomic per block and value (integer, so the order does not
// change the result).  counts is zeroed here first.
//
// Bound: bytes -- the class byte and each limbs lane's 12 bytes a row
// read once (a sum and a histogram over one field share its lane); the
// outputs are a few hundred bytes.

#include "lp_common.cuh"

namespace {

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(lp::FULL, v, o);
  return v;
}

__global__ void agg_reduce_kernel(int B, const uint8_t* __restrict__ cls,
                                  const int32_t* __restrict__ lanes,
                                  const int32_t* __restrict__ sums, int n_sums,
                                  const int32_t* __restrict__ hists, int n_hists,
                                  const int32_t* __restrict__ edges, int n_counts,
                                  int32_t* __restrict__ counts,
                                  int32_t* __restrict__ tiles, int tile, int ntiles) {
  extern __shared__ int32_t acc[];   // [n_counts] counts, then [6 * n_sums] sums
  const int t = blockIdx.x;
  const int r0 = t * tile;
  const int r1 = r0 + tile < B ? r0 + tile : B;
  const int n_acc = n_counts + 6 * n_sums;
  const bool lead = (threadIdx.x & 31) == 0;
  for (int j = threadIdx.x; j < n_acc; j += blockDim.x) acc[j] = 0;
  __syncthreads();

  int c = 0;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) c += cls[r] == 0;
  c = warp_sum(c);
  if (lead && c) atomicAdd(&acc[0], c);

  for (int s = 0; s < n_sums; ++s) {
    const int32_t* a = lanes + static_cast<size_t>(sums[s]) * B;
    int v[6] = {0, 0, 0, 0, 0, 0};
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      if (a[r] == -1) continue;   // not selected
      for (int j = 0; j < 3; ++j) {
        const int32_t x = a[static_cast<size_t>(j) * B + r];
        v[2 * j] += x & 0xFFFF;
        v[2 * j + 1] += x >> 16;
      }
    }
    for (int k = 0; k < 6; ++k) {
      const int w = warp_sum(v[k]);
      if (lead && w) atomicAdd(&acc[n_counts + 6 * s + k], w);
    }
  }

  for (int h = 0; h < n_hists; ++h) {
    const int32_t* hd = hists + 4 * h;
    const int32_t* a = lanes + static_cast<size_t>(hd[0]) * B;
    const int32_t* e = edges + 4 * hd[1];
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      const int32_t va = a[r];
      if (va == -1) continue;
      const int32_t vb = a[B + r], vc = a[2 * static_cast<size_t>(B) + r];
      int bin = 0;
      for (int k = 0; k < hd[2]; ++k) {
        const int32_t* ek = e + 4 * k;
        bin += ek[0] || va > ek[1] ||
               (va == ek[1] && (vb > ek[2] || (vb == ek[2] && vc >= ek[3])));
      }
      atomicAdd(&acc[1 + hd[3] + bin], 1);
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n_counts; j += blockDim.x) {
    if (acc[j]) atomicAdd(&counts[j], acc[j]);
  }
  for (int j = threadIdx.x; j < 6 * n_sums; j += blockDim.x) {
    const int s = j / 6, k = j % 6;
    tiles[(static_cast<size_t>(s) * ntiles + t) * 6 + k] = acc[n_counts + j];
  }
}

}  // namespace

LP_EXPORT int lp_agg_reduce(int B, const void* cls, const void* lanes, const void* sums,
                            int n_sums, const void* hists, int n_hists,
                            const void* edges, int n_counts, void* counts,
                            void* tiles, int tile, int ntiles, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_counts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || ntiles <= 0) return 0;
  const size_t shmem = sizeof(int32_t) * (n_counts + 6 * n_sums);
  agg_reduce_kernel<<<ntiles, 256, shmem, st>>>(
      B, static_cast<const uint8_t*>(cls), static_cast<const int32_t*>(lanes),
      static_cast<const int32_t*>(sums), n_sums, static_cast<const int32_t*>(hists),
      n_hists, static_cast<const int32_t*>(edges), n_counts,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(tiles), tile, ntiles);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_agg_reduce_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
