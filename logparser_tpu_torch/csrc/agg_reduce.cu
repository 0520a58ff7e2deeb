// Kernel 11: the aggregate pushdown's reductions over the class plane and
// the lanes -- n_device, the sum tiles and the histogram bins.
//
// Replaces, from logparser_tpu/analytics/device.py build_aggregate_fn: the
// n_device sum, _sum_tiles (per 4096-row tile and limb, the sums of the
// low and high 16 bits of the selected rows' base-10^6 limbs: exact int32,
// 4096 * 0xFFFF < 2^31) and the histogram's _limb_ge edge compares and
// per-bin counts.
//
// Bound: bytes -- the class byte and each limbs lane's 12 bytes a row
// read once (a sum and a histogram over one field share its lane); the
// outputs are a few hundred bytes.  At the dashboard batch (B = 65,547)
// that is 0.85 MB, 0.25 us of HBM time: the kernel's time is latency --
// the table reads, then the lanes' round trip, then the reductions.
//
// Design: a thread-block cluster of 8 blocks a 4,096-row tile (so the
// dashboard batch runs 136 blocks, not 17), 512 rows a block, 4 rows a
// thread whose 12 limb loads are all in flight together.  Each sum's six
// 16-bit half sums reduce per warp (__reduce_add_sync) into the block's
// shared accumulators; each histogram row's bin is counted per warp with
// one __ballot_sync per bin between the warp's least and greatest bin,
// one shared atomic per warp and bin.  The cluster's leader then sums
// the 8 blocks' accumulators through distributed shared memory
// (map_shared_rank), writes the tile's slot of tiles [n_sums, ntiles, 3,
// 2] and adds n_device and the bins into counts [1 + n_bins] with one
// global atomic per tile and value (integers: the order does not change
// the result).  A tile's sums stay int32 over <= 4,096 rows, so the
// 16-bit split keeps its exactness.  counts is zeroed first by a
// cudaMemsetAsync on the same stream: a second operation in the caller's
// timed window, kept because nothing orders a zeroing inside the kernel
// before other clusters' adds.

#include <cooperative_groups.h>

#include "lp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;                   // blocks a tile
constexpr int THREADS = 128;
constexpr int ROWS = 4;                      // rows a thread, loaded together
constexpr int BLOCK_ROWS = THREADS * ROWS;   // CLUSTER * BLOCK_ROWS = SUM_TILE

// The three limbs of ROWS rows of lane `a` (row 0 reads -1 past rb1: not
// selected).
__device__ __forceinline__ void load_limbs(const int32_t* __restrict__ a, int B, int r,
                                           int rb1, int32_t (&x)[ROWS][3]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int ri = r + i * THREADS;
    const bool in = ri < rb1;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      x[i][j] = in ? __ldg(a + static_cast<size_t>(j) * B + ri) : -1;
  }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    agg_reduce_kernel(int B, const uint8_t* __restrict__ cls,
                      const int32_t* __restrict__ lanes,
                      const int32_t* __restrict__ sums, int n_sums,
                      const int32_t* __restrict__ hists, int n_hists,
                      const int32_t* __restrict__ edges, int n_counts,
                      int32_t* __restrict__ counts, int32_t* __restrict__ tiles,
                      int tile, int ntiles) {
  extern __shared__ int32_t sm[];   // [n_counts + 6 * n_sums] accumulators, the tables
  const int n_acc = n_counts + 6 * n_sums;
  int32_t* acc = sm;
  int32_t* sum_rows = acc + n_acc;
  int32_t* hdesc = sum_rows + n_sums;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = blockIdx.x / CLUSTER;
  const int lane = threadIdx.x & 31;
  const int r0 = t * tile;
  const int r1 = min(r0 + tile, B);
  const int rb0 = r0 + rank * BLOCK_ROWS;
  const int rb1 = min(rb0 + BLOCK_ROWS, r1);
  const int r = rb0 + threadIdx.x;

  int c = 0;   // class bytes: they wait on no table
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int ri = r + i * THREADS;
    if (ri < rb1) c += cls[ri] == 0;
  }
  for (int j = threadIdx.x; j < n_acc; j += THREADS) acc[j] = 0;
  for (int j = threadIdx.x; j < n_sums; j += THREADS) sum_rows[j] = sums[j];
  for (int j = threadIdx.x; j < 4 * n_hists; j += THREADS) hdesc[j] = hists[j];
  __syncthreads();

  c = __reduce_add_sync(lp::FULL, c);
  if (lane == 0 && c) atomicAdd(&acc[0], c);

  for (int s = 0; s < n_sums; ++s) {
    int32_t x[ROWS][3];
    load_limbs(lanes + static_cast<size_t>(sum_rows[s]) * B, B, r, rb1, x);
    int v[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (x[i][0] == -1) continue;   // not selected
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v[2 * j] += x[i][j] & 0xFFFF;
        v[2 * j + 1] += x[i][j] >> 16;
      }
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int w = __reduce_add_sync(lp::FULL, v[k]);
      if (lane == 0 && w) atomicAdd(&acc[n_counts + 6 * s + k], w);
    }
  }

  for (int h = 0; h < n_hists; ++h) {
    const int e0 = hdesc[4 * h + 1], ne = hdesc[4 * h + 2], b0 = hdesc[4 * h + 3];
    int32_t x[ROWS][3];
    load_limbs(lanes + static_cast<size_t>(hdesc[4 * h]) * B, B, r, rb1, x);
    int bin[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) bin[i] = 0;
    for (int k = 0; k < ne; ++k) {
      const int32_t* ek = edges + 4 * (e0 + k);
      const int32_t always = __ldg(ek), ea = __ldg(ek + 1), eb = __ldg(ek + 2),
                    ec = __ldg(ek + 3);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int32_t va = x[i][0], vb = x[i][1], vc = x[i][2];
        bin[i] += always || va > ea ||
                  (va == ea && (vb > eb || (vb == eb && vc >= ec)));
      }
    }
    int lo = 0x7FFFFFFF, hi = -1;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (x[i][0] == -1) bin[i] = -1;   // not selected: no bin
      else { lo = min(lo, bin[i]); hi = max(hi, bin[i]); }
    }
    lo = __reduce_min_sync(lp::FULL, lo);
    hi = __reduce_max_sync(lp::FULL, hi);
    for (int k = lo; k <= hi; ++k) {
      int n = 0;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) n += __popc(__ballot_sync(lp::FULL, bin[i] == k));
      if (lane == 0 && n) atomicAdd(&acc[1 + b0 + k], n);
    }
  }

  cluster.sync();   // every block's accumulators are final
  if (rank == 0) {
    for (int j = threadIdx.x; j < n_acc; j += THREADS) {
      int v = 0;
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) v += cluster.map_shared_rank(acc, q)[j];
      if (j < n_counts) {
        if (v) atomicAdd(&counts[j], v);
      } else {
        const int s = (j - n_counts) / 6, k = (j - n_counts) % 6;
        tiles[(static_cast<size_t>(s) * ntiles + t) * 6 + k] = v;
      }
    }
  }
  cluster.sync();   // the leader has read them before any block exits
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
  if (tile < 1 || tile > CLUSTER * BLOCK_ROWS || static_cast<long long>(tile) * ntiles < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = sizeof(int32_t) * (n_counts + 7 * n_sums + 4 * n_hists);
  agg_reduce_kernel<<<ntiles * CLUSTER, THREADS, shmem, st>>>(
      B, static_cast<const uint8_t*>(cls), static_cast<const int32_t*>(lanes),
      static_cast<const int32_t*>(sums), n_sums, static_cast<const int32_t*>(hists),
      n_hists, static_cast<const int32_t*>(edges), n_counts,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(tiles), tile, ntiles);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_agg_reduce_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
