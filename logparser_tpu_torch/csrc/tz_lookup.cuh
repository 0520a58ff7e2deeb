// The tzdata transition lookup of logparser_tpu/dissectors/tztable.py
// ZoneDeviceTable.lookup, one line at a time, over tables a block has
// staged in shared memory: (zone, wall minute) -> (UTC offset seconds, ok).
//
// The key zone * 2^26 + clip(minute, 0, 2^26 - 1) is a uint32; the coarse
// index (uint16, key >> index_bits, 2^18 minutes a bucket) gives the last
// transition at or before the bucket start, and at most `chain` steps over
// the packed [T, 2] (key, offset + bias) table finish the search.  ok is
// the zone's exact window: 0 <= minute < valid_until[zone].
#pragma once

#include <cstdint>

namespace lp {

constexpr uint32_t TZ_SPAN_MINUTES = 1u << 26;
constexpr int TZ_OFFSET_BIAS = 1 << 17;

// Where the regions of ZoneTables.image lie in the staged copy.
struct ZoneLayout {
  int n_zones;
  int T;
  int chain;
  int index_bits;
  int packed_at;  // byte offsets, multiples of 16
  int valid_at;
};

struct ZoneSmem {
  const uint16_t* index;       // [n_zones << (26 - index_bits)]
  const uint32_t* packed;      // [T, 2]
  const int32_t* valid_until;  // [n_zones]
  ZoneLayout lay;

  __device__ __forceinline__ ZoneSmem(const uint8_t* smem, const ZoneLayout& l)
      : index(reinterpret_cast<const uint16_t*>(smem)),
        packed(reinterpret_cast<const uint32_t*>(smem + l.packed_at)),
        valid_until(reinterpret_cast<const int32_t*>(smem + l.valid_at)),
        lay(l) {}

  // A zone outside [0, n_zones) is no valid input (the plain version
  // raises on it); it is clamped so the reads stay inside the tables.
  __device__ __forceinline__ void lookup(int zone, int minutes, int& offset,
                                         bool& ok) const {
    const int m = minutes < 0 ? 0 : (minutes > static_cast<int>(TZ_SPAN_MINUTES) - 1
                                         ? static_cast<int>(TZ_SPAN_MINUTES) - 1 : minutes);
    const int z = zone < 0 ? 0 : (zone >= lay.n_zones ? lay.n_zones - 1 : zone);
    const uint32_t key = static_cast<uint32_t>(z) * TZ_SPAN_MINUTES + static_cast<uint32_t>(m);
    int idx = index[key >> lay.index_bits];
    const int last = lay.T > 1 ? lay.T - 1 : 0;
    for (int c = 0; c < lay.chain; ++c) {
      const int nxt = idx + 1 < last ? idx + 1 : last;
      if (packed[2 * nxt] <= key) idx = nxt;
    }
    offset = static_cast<int>(packed[2 * idx + 1]) - TZ_OFFSET_BIAS;
    ok = minutes >= 0 && minutes < valid_until[z];
  }
};

}  // namespace lp
