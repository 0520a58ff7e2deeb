// Kernel 12: distinct-value grouping of one aggregate lane -- (count,
// representative row, start, len) per distinct span key, or (bucket,
// count) per distinct epoch bucket, plus the group count.
//
// Replaces logparser_tpu/analytics/device.py _group_spans and _group_ints
// (with _scatter_groups).  The reference sorts by (len, 12-byte prefix
// words, row), compares tied neighbours byte by byte and scatters at the
// boundaries, because the TPU has no atomics; it can split one value into
// two groups when prefix-tied values interleave, and the host merges them
// by full key.  Here a global open-addressing hash table of cap slots (a
// power of two >= 2B, so it never fills) takes one insert per selected
// row: the key's hash (FNV-1a over len and bytes, or the bucket) picks a
// slot, linear probing; an empty slot (-1) is claimed with atomicCAS on
// the row number, an occupied one compares the full key against its
// representative row's span, read from the lane that agg_lanes already
// wrote (no half-written key is ever read), and a match adds one to the
// slot's count.  A second kernel compacts the occupied slots through an
// atomic counter.  So n_groups is exactly the number of distinct keys;
// the group order is arbitrary.  Low-cardinality lanes (four statuses
// over 65k rows) contend on a few counters: simple and correct first.
//
// Bound: bytes -- the lane (4 bytes a row), the key bytes of the selected
// rows, the table (8 bytes a slot, initialised, probed, compacted) and 16
// or 8 bytes a group written.

#include "lp_common.cuh"

namespace {

constexpr int SPAN_BITS = 13, SPAN_MASK = (1 << SPAN_BITS) - 1;
constexpr int32_t I32_MAX = 2147483647;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ int clamp_at(int p, int L) { return p < L - 1 ? p : L - 1; }

__global__ void agg_group_insert(int B, int L, const int32_t* __restrict__ lane,
                                 const uint8_t* __restrict__ buf, int spans, int cap,
                                 int32_t* __restrict__ table,
                                 int32_t* __restrict__ counts) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < B;
       r += gridDim.x * blockDim.x) {
    const int32_t w = lane[r];
    if (spans ? w == -1 : w == I32_MAX) continue;
    const uint8_t* row = buf + static_cast<size_t>(r) * L;
    const int s = w & SPAN_MASK, n = (w >> SPAN_BITS) & SPAN_MASK;
    uint32_t h;
    if (spans) {
      h = 2166136261u ^ static_cast<uint32_t>(n);
      for (int j = 0; j < n; ++j) h = (h ^ row[clamp_at(s + j, L)]) * 16777619u;
    } else {
      h = static_cast<uint32_t>(w);
    }
    uint32_t slot = mix32(h) & static_cast<uint32_t>(cap - 1);
    while (true) {
      int32_t rep = __ldcg(&table[slot]);
      if (rep == -1) {
        rep = atomicCAS(&table[slot], -1, r);
        if (rep == -1) {   // claimed: r represents this key
          atomicAdd(&counts[slot], 1);
          break;
        }
      }
      const int32_t wr = lane[rep];
      bool same;
      if (!spans) {
        same = wr == w;
      } else {
        const int sr = wr & SPAN_MASK, nr = (wr >> SPAN_BITS) & SPAN_MASK;
        same = nr == n;
        const uint8_t* other = buf + static_cast<size_t>(rep) * L;
        for (int j = 0; j < n && same; ++j) {
          same = row[clamp_at(s + j, L)] == other[clamp_at(sr + j, L)];
        }
      }
      if (same) {
        atomicAdd(&counts[slot], 1);
        break;
      }
      slot = (slot + 1) & static_cast<uint32_t>(cap - 1);
    }
  }
}

__global__ void agg_group_compact(int cap, const int32_t* __restrict__ lane, int spans,
                                  const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ counts,
                                  int32_t* __restrict__ groups,
                                  int32_t* __restrict__ n_groups) {
  for (int slot = blockIdx.x * blockDim.x + threadIdx.x; slot < cap;
       slot += gridDim.x * blockDim.x) {
    const int32_t rep = table[slot];
    if (rep == -1) continue;
    const int g = atomicAdd(n_groups, 1);
    const int32_t w = lane[rep];
    if (spans) {
      int32_t* o = groups + 4 * static_cast<size_t>(g);
      o[0] = counts[slot];
      o[1] = rep;
      o[2] = w & SPAN_MASK;
      o[3] = (w >> SPAN_BITS) & SPAN_MASK;
    } else {
      int32_t* o = groups + 2 * static_cast<size_t>(g);
      o[0] = w;
      o[1] = counts[slot];
    }
  }
}

}  // namespace

LP_EXPORT int lp_agg_group(int B, int L, const void* lane, const void* buf, int spans,
                           int cap, void* table, void* counts, void* groups,
                           void* n_groups, void* stream) {
  if (cap < 2 * B || (cap & (cap - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(table, 0xFF, sizeof(int32_t) * cap, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * cap, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(n_groups, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  const int threads = 256;
  agg_group_insert<<<lp::grid_for(B, threads), threads, 0, st>>>(
      B, L, static_cast<const int32_t*>(lane), static_cast<const uint8_t*>(buf), spans,
      cap, static_cast<int32_t*>(table), static_cast<int32_t*>(counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  agg_group_compact<<<lp::grid_for(cap, threads), threads, 0, st>>>(
      cap, static_cast<const int32_t*>(lane), spans, static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(groups),
      static_cast<int32_t*>(n_groups));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_agg_group_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
