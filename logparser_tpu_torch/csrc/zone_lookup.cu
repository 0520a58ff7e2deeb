// Kernel 7: zone text -> UTC offset through the tzdata transition tables.
//
// Replaces logparser_tpu/dissectors/tztable.py ZoneDeviceTable.lookup
// (and, with a gate row, the zone-text tail of tpu/timeparse.py
// parse_device_timestamp: ok &= zone window, |offset| < 24 h).  One
// thread per line: clip, uint32 key, one bucket gather, `chain` (1 for
// the default 63-zone vocabulary) steps over the packed [T, 2] table.
//
// Bound: bytes -- 8 bytes in (zone, minute; 12 with the gate) and 8 out a
// line, plus about three 4-byte table gathers that hit L2 (the bucket
// table is 1 MB, the packed table 41 KB).  In place: the outputs may be
// the minute and gate rows, each line reads its inputs first.

#include "lp_common.cuh"
#include "tz_lookup.cuh"

namespace {

__global__ void zone_lookup_kernel(int B, const int32_t* zone_idx, const int32_t* minutes,
                                   const int32_t* gate, lp::ZoneTable z,
                                   int32_t* off_out, int32_t* ok_out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const int m = minutes[b];
    const int zone = zone_idx[b];
    const bool pre = gate == nullptr || gate[b] != 0;
    int off;
    bool ok;
    lp::tz_lookup(z, zone, m, off, ok);
    if (gate != nullptr) ok = ok && pre && off < 86400 && off > -86400;
    off_out[b] = off;
    ok_out[b] = ok ? 1 : 0;
  }
}

}  // namespace

LP_EXPORT int lp_zone_lookup(int B, const void* zone_idx, const void* minutes,
                             const void* gate, const void* buckets, const void* packed,
                             const void* valid_until, int T, int chain, void* off_out,
                             void* ok_out, void* stream) {
  if (B <= 0) return 0;
  const lp::ZoneTable z{static_cast<const int32_t*>(buckets),
                        static_cast<const uint32_t*>(packed),
                        static_cast<const int32_t*>(valid_until), T, chain};
  const int threads = 256;
  zone_lookup_kernel<<<lp::grid_for(B, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      B, static_cast<const int32_t*>(zone_idx), static_cast<const int32_t*>(minutes),
      static_cast<const int32_t*>(gate), z, static_cast<int32_t*>(off_out),
      static_cast<int32_t*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_zone_lookup_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
