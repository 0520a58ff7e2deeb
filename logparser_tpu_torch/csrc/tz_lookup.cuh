// The tzdata transition lookup of logparser_tpu/dissectors/tztable.py
// ZoneDeviceTable.lookup, one line at a time: (zone, wall minute) ->
// (UTC offset seconds, ok).
//
// The key zone * 2^26 + clip(minute, 0, 2^26 - 1) is a uint32; the
// bucket table (key >> 14, 2^14 minutes a bucket) gives the last
// transition at or before the bucket start, and at most `chain` steps
// over the packed [T, 2] (key, offset + bias) table finish the search.
// ok is the zone's exact window: 0 <= minute < valid_until[zone].
#pragma once

#include <cstdint>

namespace lp {

constexpr uint32_t TZ_SPAN_MINUTES = 1u << 26;
constexpr int TZ_BUCKET_BITS = 14;
constexpr int TZ_OFFSET_BIAS = 1 << 17;

struct ZoneTable {
  const int32_t* buckets;      // [Z << 12] transition index per bucket
  const uint32_t* packed;      // [T, 2] (key, offset + TZ_OFFSET_BIAS)
  const int32_t* valid_until;  // [Z] exclusive wall-minute bound
  int T;
  int chain;
};

__device__ __forceinline__ void tz_lookup(const ZoneTable& z, int zone, int minutes,
                                          int& offset, bool& ok) {
  const int m = minutes < 0 ? 0 : (minutes > static_cast<int>(TZ_SPAN_MINUTES) - 1
                                       ? static_cast<int>(TZ_SPAN_MINUTES) - 1 : minutes);
  const uint32_t key = static_cast<uint32_t>(zone) * TZ_SPAN_MINUTES + static_cast<uint32_t>(m);
  int idx = __ldg(z.buckets + (key >> TZ_BUCKET_BITS));
  const int last = z.T > 1 ? z.T - 1 : 0;
  for (int c = 0; c < z.chain; ++c) {
    const int nxt = idx + 1 < last ? idx + 1 : last;
    if (__ldg(z.packed + 2 * nxt) <= key) idx = nxt;
  }
  offset = static_cast<int>(__ldg(z.packed + 2 * idx + 1)) - TZ_OFFSET_BIAS;
  ok = minutes >= 0 && minutes < __ldg(z.valid_until + zone);
}

}  // namespace lp
