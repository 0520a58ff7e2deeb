// Kernel 7: zone text -> UTC offset through the tzdata transition tables.
//
// Replaces logparser_tpu/dissectors/tztable.py ZoneDeviceTable.lookup
// (and, with a gate row, the zone-text tail of tpu/timeparse.py
// parse_device_timestamp: ok &= zone window, |offset| < 24 h).
//
// Bound: bytes -- 8 bytes in (zone, minute; 12 with the gate) and 8 out a
// line, plus the table entries the lines touch.  What held a thread-a-line
// gather design back was latency: a gather into a 1 MB bucket table fed a
// dependent gather into the packed table, two chained round trips to L2
// or HBM a line.  Here a persistent grid (the SMs times the blocks that
// fit) stages ZoneTables.image -- the coarse index (uint16, 2^18 minutes
// a bucket: 32,256 bytes for 63 zones), the packed [T, 2] table and the
// windows, about 74 KB -- into each block's shared memory once, with TMA
// bulk copies; each thread loads its first line's inputs while the copies
// fly, then every gather and the <= `chain` forward steps read shared
// memory, and the lines' inputs and outputs stream coalesced.  The staging
// costs L2 bandwidth per block, so blocks are wide (1,024 threads: 80
// blocks stage the image for a batch of 81,394 lines).  In place: the
// outputs may be the minute and gate rows, each line reads its inputs
// before it writes.

#include "lp_common.cuh"
#include "smem_stage.cuh"
#include "tz_lookup.cuh"

namespace {

constexpr int THREADS = 1024;

struct Line {
  int minutes, zone;
  bool pre;
};

__global__ void __launch_bounds__(THREADS)
    zone_lookup_kernel(int B, const int32_t* zone_idx, const int32_t* minutes,
                       const int32_t* gate, const void* image, int smem_bytes,
                       lp::ZoneLayout lay, int32_t* off_out, int32_t* ok_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bar;
  lp::stage_issue(smem, image, smem_bytes, &bar);
  const auto load = [&](int b) {
    return Line{minutes[b], zone_idx[b], gate == nullptr || gate[b] != 0};
  };
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  Line line = b < B ? load(b) : Line{0, 0, false};
  lp::stage_wait(&bar);
  const lp::ZoneSmem z(smem, lay);
  while (b < B) {
    int off;
    bool ok;
    z.lookup(line.zone, line.minutes, off, ok);
    if (gate != nullptr) ok = ok && line.pre && off < 86400 && off > -86400;
    off_out[b] = off;
    ok_out[b] = ok ? 1 : 0;
    b += gridDim.x * blockDim.x;
    if (b < B) line = load(b);
  }
}

lp::GridCache grid_cache;

}  // namespace

LP_EXPORT int lp_zone_lookup(int B, const void* zone_idx, const void* minutes,
                             const void* gate, const void* image, int smem_bytes,
                             int n_zones, int T, int chain, int index_bits,
                             int packed_at, int valid_at, void* off_out, void* ok_out,
                             void* stream) {
  if (B <= 0) return 0;
  const long long index_bytes = 2ll * (static_cast<long long>(n_zones) << (26 - index_bits));
  if (!lp::aligned16(image, smem_bytes) || n_zones < 1 || T < 1 || T > 65535 ||
      chain < 0 || index_bits < 1 || index_bits > 26 || index_bytes > packed_at ||
      packed_at % 16 || valid_at % 16 || packed_at + 8ll * T > valid_at ||
      valid_at + 4ll * n_zones > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err = lp::persistent_grid(zone_lookup_kernel, THREADS, smem_bytes,
                                        (B + THREADS - 1) / THREADS, grid_cache, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const lp::ZoneLayout lay{n_zones, T, chain, index_bits, packed_at, valid_at};
  zone_lookup_kernel<<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      B, static_cast<const int32_t*>(zone_idx), static_cast<const int32_t*>(minutes),
      static_cast<const int32_t*>(gate), image, smem_bytes, lay,
      static_cast<int32_t*>(off_out), static_cast<int32_t*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_zone_lookup_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
