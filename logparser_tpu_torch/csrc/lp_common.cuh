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

inline int grid_for(int n, int threads) {
  long long blocks = (static_cast<long long>(n) + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

}  // namespace lp

#define LP_EXPORT extern "C" __attribute__((visibility("default")))
