// Kernel 9: the GeoIP range join -- each IPv4 key's row in the flattened
// .mmdb table.
//
// Replaces logparser_tpu/geoip/device.py GeoDeviceTable.lookup_rows (the
// searchsorted + compare that XLA fuses into the geo stage of
// pipeline.py compute_rows).  Row = the upper-bound position of the key
// among the sorted starts[K] (the number of starts at or below it, as
// searchsorted(side="right")), a hit when the key is at most
// ends[pos - 1]; 0 = miss.  Keys, starts and ends are uint32 bit patterns
// and compare unsigned (an address at 128.0.0.0 or above is negative as
// int32).  K = 0 reads no table entry: every key misses.  With a gate
// row, a key whose gate is 0 gets row 0 (the reference's
// where(ip_ok & chain_ok, rows, 0)).
//
// Bound: bytes -- 8 per key (the key, the row) plus the 32-byte sectors of
// starts the search must touch and the ends word of each hit.  A binary
// search over starts in device memory is ceil(log2(K + 1)) dependent
// loads a key (22 at 4M ranges), so latency and the L2 traffic of the
// shared top levels bound it.  Here the search has two levels.  A
// persistent grid (the SMs times the blocks that fit) stages
// GeoTables.image into each block's shared memory once, with TMA bulk
// copies, while each thread loads its first keys: the splitters, every
// S-th start (at most 8,192, 32 KB), and with S = 1 (K <= 8,192) the ends
// as well, so that the whole lookup reads shared memory.  A key's search
// over the splitters (<= 14 steps) leaves the S starts from its splitter
// on; those are searched in device memory by halving steps down to a
// window of WINDOW starts (64 bytes, aligned, two sectors), which one
// vector load brings for a final count in registers: 1 dependent load at
// S = 16 (131,072 ranges), 6 at S = 512 (4M).  Each thread advances
// `lockstep` keys' searches side by side (the keys b, b + stride, ...:
// inputs and outputs stay coalesced), every step issuing all their loads
// before any compare, so that many independent loads are in flight.

#include "lp_common.cuh"
#include "smem_stage.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WINDOW = 16;

template <int G>
__global__ void __launch_bounds__(THREADS)
    geo_lookup_kernel(int B, const uint32_t* __restrict__ keys,
                      const int32_t* __restrict__ gate,
                      const uint32_t* __restrict__ starts,
                      const uint32_t* __restrict__ ends, int K,
                      const uint32_t* __restrict__ image, int n_split, int split_shift,
                      int ends_at, int smem_bytes, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint64_t bar;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (K == 0) {
    for (int b = first; b < B; b += stride) out[b] = 0;
    return;
  }
  lp::stage_issue(smem, image, smem_bytes, &bar);
  const uint32_t* spl = smem;
  const uint32_t* end_row = ends_at >= 0 ? smem + ends_at : ends;
  int top = 1;
  while ((top << 1) <= n_split) top <<= 1;
  const int S = 1 << split_shift;
  const int win = S < WINDOW ? S : WINDOW;
  bool staged = false;
  for (long long b0 = first; b0 < B; b0 += static_cast<long long>(stride) * G) {
    uint32_t key[G];
    bool live[G];
    int pos[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long b = b0 + static_cast<long long>(g) * stride;
      live[g] = b < B && (gate == nullptr || gate[b] != 0);
      key[g] = live[g] ? keys[b] : 0u;
      pos[g] = 0;
    }
    if (!staged) {
      lp::stage_wait(&bar);
      staged = true;
    }
    // Level 1, shared memory: pos = the splitters at or below the key.
    for (int step = top; step > 0; step >>= 1) {
      uint32_t v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int at = pos[g] + step;
        v[g] = spl[(at <= n_split ? at : n_split) - 1];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (pos[g] + step <= n_split && v[g] <= key[g]) pos[g] += step;
    }
    if (split_shift > 0) {
      // Level 2, device memory: starts[base] <= key for base = (pos - 1) S,
      // and the row is base + the starts at or below the key among the n
      // = min(S, K - base) from base on (at least 1).
      int base[G], n[G], p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        base[g] = pos[g] > 0 ? (pos[g] - 1) << split_shift : 0;
        n[g] = pos[g] > 0 ? (K - base[g] < S ? K - base[g] : S) : 0;
        p[g] = 0;
      }
      for (int step = S >> 1; step >= WINDOW; step >>= 1) {
        uint32_t v[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int at = p[g] + step;
          v[g] = __ldg(starts + base[g] + (at <= n[g] ? at - 1 : 0));
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (p[g] + step <= n[g] && v[g] <= key[g]) p[g] += step;
      }
      // The window [base + p, base + p + win): aligned to its own size,
      // one vector load where it lies wholly inside the table.
      uint32_t w[G][WINDOW];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t* src = starts + base[g] + p[g];
        if (win == WINDOW && p[g] + WINDOW <= n[g]) {
          const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
          for (int q = 0; q < WINDOW / 4; ++q) {
            const uint4 x = __ldg(s4 + q);
            w[g][4 * q] = x.x;
            w[g][4 * q + 1] = x.y;
            w[g][4 * q + 2] = x.z;
            w[g][4 * q + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < WINDOW; ++i)
            w[g][i] = i < win && p[g] + i < n[g] ? __ldg(src + i) : 0u;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        int c = 0;
#pragma unroll
        for (int i = 0; i < WINDOW; ++i) c += i < win && p[g] + i < n[g] && w[g][i] <= key[g];
        pos[g] = pos[g] > 0 ? base[g] + p[g] + c : 0;
      }
    }
    uint32_t e[G];
#pragma unroll
    for (int g = 0; g < G; ++g) e[g] = live[g] && pos[g] > 0 ? end_row[pos[g] - 1] : 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long b = b0 + static_cast<long long>(g) * stride;
      if (b < B) out[b] = live[g] && pos[g] > 0 && key[g] <= e[g] ? pos[g] : 0;
    }
  }
  if (!staged) lp::stage_wait(&bar);
}

lp::GridCache grid_cache[3];   // lockstep 1, 2, 4

template <int G>
cudaError_t launch(int B, const uint32_t* keys, const int32_t* gate, const uint32_t* starts,
                   const uint32_t* ends, int K, const uint32_t* image, int n_split,
                   int split_shift, int ends_at, int smem_bytes, int32_t* out,
                   cudaStream_t stream) {
  int grid = 0;
  const long long per_block = static_cast<long long>(THREADS) * G;
  cudaError_t err = lp::persistent_grid(geo_lookup_kernel<G>, THREADS, smem_bytes,
                                        (B + per_block - 1) / per_block,
                                        grid_cache[G / 2], grid);
  if (err != cudaSuccess) return err;
  geo_lookup_kernel<G><<<grid, THREADS, smem_bytes, stream>>>(
      B, keys, gate, starts, ends, K, image, n_split, split_shift, ends_at, smem_bytes, out);
  return cudaGetLastError();
}

}  // namespace

LP_EXPORT int lp_geo_lookup(int B, const void* keys, const void* gate,
                            const void* starts, const void* ends, int K, const void* image,
                            int n_split, int split_shift, int ends_at, int smem_bytes,
                            int lockstep, void* out, void* stream) {
  if (B <= 0) return 0;
  const long long staged = 4ll * (ends_at >= 0 ? ends_at + K : n_split);
  if (K < 0 || split_shift < 0 || split_shift > 30 ||
      n_split != (K > 0 ? ((K - 1) >> split_shift) + 1 : 0) ||
      (ends_at >= 0 && (split_shift != 0 || ends_at < n_split)) || staged > smem_bytes ||
      !lp::aligned16(image, smem_bytes) || !lp::aligned16(starts, 0) ||
      (lockstep != 1 && lockstep != 2 && lockstep != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* gt = static_cast<const int32_t*>(gate);
  const auto* s = static_cast<const uint32_t*>(starts);
  const auto* e = static_cast<const uint32_t*>(ends);
  const auto* im = static_cast<const uint32_t*>(image);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lockstep) {
    case 1:
      err = launch<1>(B, k, gt, s, e, K, im, n_split, split_shift, ends_at, smem_bytes, o, st);
      break;
    case 2:
      err = launch<2>(B, k, gt, s, e, K, im, n_split, split_shift, ends_at, smem_bytes, o, st);
      break;
    default:
      err = launch<4>(B, k, gt, s, e, K, im, n_split, split_shift, ends_at, smem_bytes, o, st);
      break;
  }
  return static_cast<int>(err);
}

LP_EXPORT const char* lp_geo_lookup_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
