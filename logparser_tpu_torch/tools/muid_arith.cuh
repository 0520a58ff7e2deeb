// muid's sextets by packed-range arithmetic on the four bytes of a word
// at once, in place of the shared-memory table (a design variant of
// csrc/muid.cu for tools/kernel_variants.py: muid_variants.json "arith").
#pragma once

#include <cstdint>

namespace arith {

// Bit 7 of each byte of t (bytes below 0x80) set where lo <= byte <= hi.
__device__ __forceinline__ uint32_t in_range(uint32_t t, uint32_t lo, uint32_t hi) {
  const uint32_t ge = t + 0x01010101u * (0x80u - lo);
  const uint32_t gt = t + 0x01010101u * (0x7Fu - hi);
  return ge & ~gt & 0x80808080u;
}

// Bit 7 of each byte to the whole byte.
__device__ __forceinline__ uint32_t widen(uint32_t m) { return (m >> 7) * 0xFFu; }

// The 24-bit group of the four bytes of x (the first in its low byte), as
// muid.cu's group(); bad gets the 0x40 bit where a byte is outside the
// alphabet.
__device__ __forceinline__ uint32_t group(uint32_t x, uint32_t& bad) {
  const uint32_t high = x & 0x80808080u;
  const uint32_t t = x & 0x7F7F7F7Fu;
  const uint32_t up = in_range(t, 'A', 'Z') & ~high;
  const uint32_t lo = in_range(t, 'a', 'z') & ~high;
  const uint32_t dg = in_range(t, '0', '9') & ~high;
  const uint32_t dash = in_range(t, '-', '-') & ~high;
  const uint32_t under = in_range(t, '_', '_') & ~high;
  if (~(up | lo | dg | dash | under) & 0x80808080u) bad |= 0x40u;
  const uint32_t known = widen(up | lo | dg | dash);
  // Per byte: (byte | 0x80) - sub, its low 6 bits the sextet: 'A' -> 0,
  // 'a' -> 26, '0' -> 52, '-' -> 62; every other byte 63.
  const uint32_t sub = (widen(up) & 0x41414141u) | (widen(lo) & 0x47474747u) |
                       (widen(dg) & 0x7C7C7C7Cu) | (widen(dash) & 0x6F6F6F6Fu);
  const uint32_t v = ((((t | 0x80808080u) - sub) & known) | ~known) & 0x3F3F3F3Fu;
  return ((v & 63u) << 18) | (((v >> 8) & 63u) << 12) | (((v >> 16) & 63u) << 6) | (v >> 24);
}

}  // namespace arith
