// Kernel 17: one shard-local step of the sequence-parallel split.
//
// Replaces logparser_tpu/parallel/mesh.py sequence_parallel_runner (:224)
// and its shard_map body (_sp_find_literal, _sp_byte_at, _sp_charset_ok,
// _sp_program_body, :122-222).  With the line axis L sharded over the
// mesh's seq axis, each op of the split program needs one value a line from
// every seq shard, which the runner (parallel/mesh.py) combines across the
// shards where the reference calls lax.pmin / lax.psum.  This kernel
// computes one shard's value, in one of three modes:
//
//   0 find     the least global position g >= cursor at which the literal
//              starts in this shard's slice, its bytes read from the slice
//              and then from the halo (the next shard's first H bytes; the
//              last shard's halo is shard 0's, as ppermute's ring gives),
//              with g + len(lit) <= length; l_total where there is none.
//              out [B] int32; the runner takes the minimum over shards.
//   1 bytes    for k < len(lit), the byte at global position cursor + k
//              where this shard owns it, else 0.  out [n_lit, B] int32;
//              the runner sums over shards (each position has one owner,
//              so the sum is the byte, or 0 past the buffer).
//   2 charset  the number of bytes at global positions in [start, end)
//              that this shard owns and whose charset-table entry is 0.
//              out [B] int32; the runner sums over shards.
//
// find and charset take one block a line: the threads walk the slice's
// usable range in chunks of blockDim bytes, neighbouring threads on
// neighbouring bytes; find stops after the first chunk that holds a match
// (that chunk holds the least one) and takes the block's minimum.  bytes
// takes one thread a line.  No escape parity: the reference's SP body has
// none (its run_program does).
//
// Bound: bytes -- find reads a line's slice from the cursor to the first
// match (plus at most len(lit) - 1 halo bytes), charset the span's bytes in
// the slice, bytes len(lit) bytes a line; each writes 4 bytes a line per
// output row.

#include <climits>

#include "lp_common.cuh"

namespace {

constexpr int MODE_FIND = 0;
constexpr int MODE_BYTES = 1;
constexpr int MODE_CHARSET = 2;

// The block's minimum (take_min) or sum of v, valid in thread 0.
// blockDim.x is a multiple of 32 (at most 1024); scratch holds 32 ints.
__device__ __forceinline__ int block_reduce(int v, bool take_min, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    const int w = __shfl_down_sync(lp::FULL, v, o);
    v = take_min ? min(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? scratch[lane] : (take_min ? INT_MAX : 0);
    for (int o = 16; o > 0; o >>= 1) {
      const int w = __shfl_down_sync(lp::FULL, v, o);
      v = take_min ? min(v, w) : v + w;
    }
  }
  __syncthreads();   // scratch is free again
  return v;
}

__global__ void sp_find_kernel(const uint8_t* __restrict__ buf, int B, int Lc,
                               int offset, const int32_t* __restrict__ cursor,
                               const int32_t* __restrict__ lengths,
                               const int32_t* __restrict__ lit, int n_lit,
                               const uint8_t* __restrict__ halo, int H,
                               int l_total, int32_t* __restrict__ out) {
  __shared__ int scratch[32];
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint8_t* p = buf + static_cast<size_t>(row) * Lc;
    const uint8_t* h = halo + static_cast<size_t>(row) * H;
    // Local j is usable when offset + j >= cursor and
    // offset + j + n_lit <= length.
    long long lo = static_cast<long long>(cursor[row]) - offset;
    long long hi = static_cast<long long>(lengths[row]) - n_lit - offset + 1;
    lo = lo < 0 ? 0 : lo;
    hi = hi > Lc ? Lc : hi;
    int best = l_total;
    for (long long base = lo; base < hi; base += blockDim.x) {
      const long long j = base + threadIdx.x;
      int cand = l_total;
      if (j < hi) {
        bool m = true;
        for (int k = 0; k < n_lit && m; ++k) {
          const long long idx = j + k;
          const int b = idx < Lc ? p[idx] : h[idx - Lc];
          m = b == lit[k];
        }
        if (m) cand = offset + static_cast<int>(j);
      }
      if (__syncthreads_or(cand < l_total)) {   // uniform over the block
        best = block_reduce(cand, true, scratch);
        break;
      }
    }
    if (threadIdx.x == 0) out[row] = best;
  }
}

__global__ void sp_bytes_kernel(const uint8_t* __restrict__ buf, int B, int Lc,
                                int offset, const int32_t* __restrict__ cursor,
                                int n_lit, int32_t* __restrict__ out) {
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < B;
       row += gridDim.x * blockDim.x) {
    const uint8_t* p = buf + static_cast<size_t>(row) * Lc;
    const long long c = static_cast<long long>(cursor[row]) - offset;
    for (int k = 0; k < n_lit; ++k) {
      const long long j = c + k;
      out[static_cast<size_t>(k) * B + row] = (j >= 0 && j < Lc) ? p[j] : 0;
    }
  }
}

__global__ void sp_charset_kernel(const uint8_t* __restrict__ buf, int B, int Lc,
                                  int offset, const int32_t* __restrict__ start,
                                  const int32_t* __restrict__ end,
                                  const int32_t* __restrict__ table,
                                  int32_t* __restrict__ out) {
  __shared__ int scratch[32];
  __shared__ int allowed[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) allowed[i] = table[i] != 0;
  __syncthreads();
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint8_t* p = buf + static_cast<size_t>(row) * Lc;
    long long lo = static_cast<long long>(start[row]) - offset;
    long long hi = static_cast<long long>(end[row]) - offset;
    lo = lo < 0 ? 0 : lo;
    hi = hi > Lc ? Lc : hi;
    int bad = 0;
    for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) bad += !allowed[p[j]];
    bad = block_reduce(bad, false, scratch);
    if (threadIdx.x == 0) out[row] = bad;
  }
}

}  // namespace

// mode: 0 find, 1 bytes, 2 charset.  buf [B, Lc] uint8 (this shard's
// slice, global columns offset .. offset + Lc - 1).  lo: cursor (find,
// bytes) or start (charset) [B] int32; hi: lengths (find) or end (charset)
// [B] int32.  lit [n_lit] int32 (find, bytes); halo [B, H] uint8 (find, H >=
// n_lit - 1, may be null when H == 0); table [256] int32 (charset).
LP_EXPORT int lp_sp_split(int mode, const void* buf, int B, int Lc, int offset,
                          const void* lo, const void* hi, const void* lit,
                          int n_lit, const void* halo, int H, int l_total,
                          const void* table, void* out, void* stream) {
  if (B <= 0) return 0;
  if (mode == MODE_FIND && n_lit - 1 > H) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const int32_t* l = static_cast<const int32_t*>(lo);
  const int32_t* h = static_cast<const int32_t*>(hi);
  int32_t* o = static_cast<int32_t*>(out);
  int threads = 32;   // one block a line: up to 256 threads, by the slice width
  while (threads < Lc && threads < 256) threads <<= 1;
  const int rows = B < (1 << 20) ? B : (1 << 20);
  switch (mode) {
    case MODE_FIND:
      sp_find_kernel<<<rows, threads, 0, s>>>(
          b, B, Lc, offset, l, h, static_cast<const int32_t*>(lit), n_lit,
          static_cast<const uint8_t*>(halo), H, l_total, o);
      break;
    case MODE_BYTES:
      sp_bytes_kernel<<<lp::grid_for(B, 256), 256, 0, s>>>(
          b, B, Lc, offset, l, n_lit, o);
      break;
    case MODE_CHARSET:
      sp_charset_kernel<<<rows, threads, 0, s>>>(
          b, B, Lc, offset, l, h, static_cast<const int32_t*>(table), o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_sp_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
