// Shared helpers of the logparser_tpu_torch kernels (sm_90a, plain C ABI).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lp {

constexpr unsigned FULL = 0xFFFFFFFFu;

// One line of the [B, L] byte buffer, read the way the reference's
// gather_span_bytes reads it: the start's bits above bit_length(L - 1)
// are ignored (its log-shift alignment only consumes those bits) and
// bytes at or past L read as 0, never the next line.
struct Row {
  const uint8_t* p;
  int L;
  int mask;
  __device__ __forceinline__ int at(int start, int i) const {
    int idx = (start & mask) + i;
    return idx < L ? p[idx] : 0;
  }
};

inline int gather_mask(int L) {
  int v = L - 1, nb = 0;
  while (v > 0) { ++nb; v >>= 1; }
  if (nb < 1) nb = 1;
  return (1 << nb) - 1;
}

__device__ __forceinline__ bool is_digit(int c) { return c >= '0' && c <= '9'; }
__device__ __forceinline__ bool is_alpha(int c) {
  return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z');
}
__device__ __forceinline__ bool is_hex(int c) {
  return is_digit(c) || (c >= 'a' && c <= 'f') || (c >= 'A' && c <= 'F');
}

// The reference's parse_long_spans frame over n bytes from s: hi / lo are
// frame columns 0..8 / 9..17 as base-10 numbers (uint32 sums wrap like
// its int32), d18 the 19th digit; bytes past the span count as 0.
struct LongFrame {
  uint32_t hi, lo, d18;
  bool digits_ok;
};

__device__ __forceinline__ LongFrame long_frame(const Row& row, int s, int n) {
  LongFrame f{0u, 0u, 0u, true};
  for (int i = 0; i < 19; ++i) {
    const uint32_t d = static_cast<uint32_t>(row.at(s, i) - '0') & 0xFFu;
    const bool in_span = i < n;
    if (in_span && d > 9) f.digits_ok = false;
    const uint32_t dd = in_span ? d : 0u;
    if (i < 9) f.hi = f.hi * 10u + dd;
    else if (i < 18) f.lo = f.lo * 10u + dd;
    else f.d18 = dd;
  }
  return f;
}

// The reference's span_prefix_words: word w holds bytes 4w..4w+3 of the
// span (little-endian), bytes at or past n zeroed, all zero unless live;
// with amp a leading '?' renders as '&'.
__device__ __forceinline__ uint32_t prefix_word(const Row& row, int s, int n,
                                                bool live, bool amp, int w) {
  uint32_t word = 0;
  if (!live) return 0;
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * w + j;
    if (i >= n) break;
    int c = row.at(s, i);
    if (i == 0 && amp && c == '?') c = '&';
    word |= static_cast<uint32_t>(c) << (8 * j);
  }
  return word;
}

inline int grid_for(int n, int threads) {
  long long blocks = (static_cast<long long>(n) + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

}  // namespace lp

#define LP_EXPORT extern "C" __attribute__((visibility("default")))
