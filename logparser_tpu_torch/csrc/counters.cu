// Kernel 18: the data-parallel good / bad line counters.
//
// Replaces logparser_tpu/parallel/mesh.py aggregate_counters (:243): the
// sums of the [B] good and bad masks (the reference's Hadoop counters), the
// one cross-device reduction of its data-parallel loop.  The runner
// (parallel/mesh.py) launches this once over the rows of every stretch of
// data shards that share a device, on the masks in place, and adds the
// stretches' counters on the home device only where there are several.
//
// Design: one launch that writes out [2] int32 itself (no memset, no
// atomics).  Each mask is read as aligned 16-byte words, 4 words of each a
// thread in flight -- good and bad may start at different alignments
// (slices of larger masks), so each has its own scalar head and tail -- a
// bool word's 16 bytes (0 or 1 each) summed with four __dp4a, an int32
// word's four lanes added, in unsigned 32 bits, so the sums wrap as
// jnp.sum of int32 does without x64.  A warp shuffle and a shared-memory
// sum give each block its two counts.  Masks of up to ONE_BLOCK_WORDS
// words take one block of as many warps as their words need (fewer threads
// start sooner), which writes out; larger ones one thread-block cluster of
// CLUSTER blocks (Hopper's distributed shared memory, as agg_reduce.cu),
// whose leader adds the blocks' counts through DSMEM after a cluster
// barrier.  A cluster starts later than one block: on an H100 a batch's
// masks (2 x 65,549 bytes) took 0.0088 ms as an 8-block cluster against
// 0.0076 as one block, 100,003 int32 rows 0.0093 against 0.0124 as one
// block (tools/counters_variants.json, PERF.md).
//
// Bound: bytes -- each mask read once; 8 bytes written.

#include <cooperative_groups.h>

#include "lp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                 // words of each mask a thread has in flight
constexpr int ONE_BLOCK_WORDS = 16384;    // both masks' 16-byte words one block takes

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(lp::FULL, v, o);
  return v;
}

__device__ __forceinline__ unsigned word_sum(uint4 w, unsigned acc, bool bytes) {
  if (bytes) {
    acc = __dp4a(w.x, 0x01010101u, acc);
    acc = __dp4a(w.y, 0x01010101u, acc);
    acc = __dp4a(w.z, 0x01010101u, acc);
    return __dp4a(w.w, 0x01010101u, acc);
  }
  return acc + w.x + w.y + w.z + w.w;
}

// A mask of n elements of es bytes (1 or 4) at p: its unaligned head,
// its aligned body of 16-byte words, and its tail (after the body).
struct Mask {
  const uint8_t* p;
  const uint4* body;
  long long head, words, body_end;

  __device__ Mask(const uint8_t* p_, int n, int es) : p(p_) {
    head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / es;
    if (head > n) head = n;
    words = (static_cast<long long>(n) - head) * es / 16;
    body_end = head + words * 16 / es;
    body = reinterpret_cast<const uint4*>(p + head * es);
  }
  __device__ uint4 word(long long i) const {
    return i < words ? __ldg(body + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  // The head and tail element e (< 30 of them) of thread t, or 0.
  __device__ unsigned edge(int t, int n, int es) const {
    if (t >= head + (n - body_end)) return 0u;
    const long long e = t < head ? t : body_end + (t - head);
    return es == 1 ? static_cast<unsigned>(__ldg(p + e))
                   : static_cast<unsigned>(__ldg(reinterpret_cast<const int32_t*>(p) + e));
  }
};

__global__ void __launch_bounds__(THREADS)
counters_kernel(const uint8_t* __restrict__ good, const uint8_t* __restrict__ bad, int n,
                int es, unsigned* __restrict__ out) {
  __shared__ unsigned part[WARPS][2];
  __shared__ unsigned acc[2];
  const bool bytes = es == 1;
  const Mask mg(good, n, es), mb(bad, n, es);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long words = max(mg.words, mb.words);
  unsigned g = mg.edge(tid, n, es), b = mb.edge(tid, n, es);
  for (long long i = tid; i < words; i += UNROLL * stride) {
    uint4 wg[UNROLL], wb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      wg[u] = mg.word(i + u * stride);
      wb[u] = mb.word(i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      g = word_sum(wg[u], g, bytes);
      b = word_sum(wb[u], b, bytes);
    }
  }
  g = warp_sum(g);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[warp][0] = g;
    part[warp][1] = b;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool live = threadIdx.x < blockDim.x / 32;
    g = warp_sum(live ? part[threadIdx.x][0] : 0u);
    b = warp_sum(live ? part[threadIdx.x][1] : 0u);
    if (threadIdx.x == 0) {
      acc[0] = g;
      acc[1] = b;
    }
  }
  if (gridDim.x == 1) {   // one block: its counts are the sums
    if (threadIdx.x == 0) {
      out[0] = g;
      out[1] = b;
    }
    return;
  }
  // One cluster of gridDim.x blocks: the leader adds their counts.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's counts are final
  if (cluster.block_rank() == 0 && threadIdx.x < 2) {
    unsigned v = 0u;
    for (unsigned q = 0; q < gridDim.x; ++q) v += cluster.map_shared_rank(acc, q)[threadIdx.x];
    out[threadIdx.x] = v;
  }
  cluster.sync();   // the leader has read them before any block exits
}

}  // namespace

LP_EXPORT int lp_counters(const void* good, const void* bad, int B, int elem_size,
                          void* out, void* stream) {
  if (B < 0 || (elem_size != 1 && elem_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* g = static_cast<const uint8_t*>(good);
  const uint8_t* b = static_cast<const uint8_t*>(bad);
  unsigned* o = static_cast<unsigned*>(out);
  const long long words = static_cast<long long>(B) * elem_size / 16 + 1;   // a mask's
  if (2 * words <= ONE_BLOCK_WORDS) {
    // One block of the warps that hold each mask's words UNROLL a thread
    // (at least one warp: the heads and tails take up to 30 threads).
    const long long warps = (words + 32 * UNROLL - 1) / (32 * UNROLL);
    const int threads = 32 * static_cast<int>(warps < WARPS ? warps : WARPS);
    counters_kernel<<<1, threads, 0, s>>>(g, b, B, elem_size, o);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, counters_kernel, g, b, B, elem_size, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_counters_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
