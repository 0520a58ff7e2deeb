// Kernel 9: the GeoIP range join -- each IPv4 key's row in the flattened
// .mmdb table.
//
// Replaces logparser_tpu/geoip/device.py GeoDeviceTable.lookup_rows (the
// searchsorted + compare that XLA fuses into the geo stage of
// pipeline.py compute_rows).  One thread per key: an upper-bound binary
// search over the sorted starts[K] (the first start above the key, as
// searchsorted(side="right")), then a hit when the key is at most
// ends[pos - 1]; row = pos (1-based), 0 = miss.  Keys, starts and ends
// are uint32 bit patterns and compare unsigned (an address at 128.0.0.0
// or above is negative as int32).  K = 0 reads no table entry: every key
// misses.  With a gate row, a key whose gate is 0 gets row 0 without a
// search (the reference's where(ip_ok & chain_ok, rows, 0)).
//
// Bound: bytes -- 8 per key (the key, the row) plus the distinct 32-byte
// sectors of starts that the keys' search paths touch and the ends word
// of each hit.  ceil(log2(K + 1)) dependent loads per key: at 4M ranges
// (33.5 MB of starts and ends) the first levels stay in L2 and the last
// few miss, so latency, not bandwidth, is the likely limit.

#include "lp_common.cuh"

namespace {

__global__ void geo_lookup_kernel(int B, const uint32_t* __restrict__ keys,
                                  const int32_t* __restrict__ gate,
                                  const uint32_t* __restrict__ starts,
                                  const uint32_t* __restrict__ ends, int K,
                                  int32_t* __restrict__ out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    int row = 0;
    if (K > 0 && (gate == nullptr || gate[b] != 0)) {
      const uint32_t key = keys[b];
      int lo = 0, hi = K;
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (starts[mid] <= key) lo = mid + 1;
        else hi = mid;
      }
      if (lo > 0 && key <= ends[lo - 1]) row = lo;
    }
    out[b] = row;
  }
}

}  // namespace

LP_EXPORT int lp_geo_lookup(int B, const void* keys, const void* gate,
                            const void* starts, const void* ends, int K, void* out,
                            void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  geo_lookup_kernel<<<lp::grid_for(B, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      B, static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(gate),
      static_cast<const uint32_t*>(starts), static_cast<const uint32_t*>(ends), K,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_geo_lookup_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
