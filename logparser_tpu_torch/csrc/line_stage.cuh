// A warp's 32 lines staged into shared memory, a thread a line afterwards
// (uri_split.cu, setcookie_split.cu), the guarded 16-byte load they and
// csr_split.cu share (load16_in), and a short window realigned into
// registers from such loads (load_window: muid.cu, ipv4_spans.cu).
//
// stage_lines: lane l names a run of its own line's bytes as up to 8
// aligned 16-byte chunks (its first chunk's address and the count); the
// warp loads every lane's chunks, 4 lines a step, the 8 chunks of a line on
// 8 consecutive lanes (128 consecutive bytes), and stores them into row l
// of a [32][32] word tile.  Word w of line l lands at word w ^ l of its row,
// so 32 lanes that read the same word of their own lines hit 32 banks, and
// the stores of one step hit 32 banks too.  A chunk that reaches past
// either end of the buffer loads its bytes inside the buffer alone (the
// others read 0): no load leaves the allocation.  fetch_lines and
// store_lines split a staging, so that the next one's loads can be in
// flight while the warp works on the staged bytes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lp {

constexpr int STAGE_CHUNKS = 8;                     // 16-byte chunks a line
constexpr int STAGE_BYTES = 16 * STAGE_CHUNKS;      // 128
constexpr int STAGE_WORDS = STAGE_BYTES / 4;        // 32

using StageRows = uint32_t[32][STAGE_WORDS];

__device__ __forceinline__ const uint8_t* align_down16(const uint8_t* p) {
  return reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(p) &
                                          ~static_cast<uintptr_t>(15));
}

// The aligned 16-byte chunk at c0, its bytes outside [buf, buf_end) read
// as 0: one load where the chunk lies inside, else a byte at a time, so no
// load leaves the allocation.
__device__ __forceinline__ uint4 load16_in(const uint8_t* c0, const uint8_t* buf,
                                           const uint8_t* buf_end) {
  if (c0 >= buf && c0 + 16 <= buf_end) return __ldg(reinterpret_cast<const uint4*>(c0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16; ++i) {
    if (c0 + i >= buf && c0 + i < buf_end) w[i >> 2] |= static_cast<uint32_t>(c0[i]) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The N bytes from p, every one inside [buf, buf_end), as (N + 3) / 4
// little-endian words: the aligned 16-byte chunks that cover them (a chunk
// past the last of them is not loaded), realigned with funnel shifts.
// Bytes of the last word past N are undefined.
template <int N>
__device__ __forceinline__ void load_window(const uint8_t* p, const uint8_t* buf,
                                            const uint8_t* buf_end,
                                            uint32_t (&w)[(N + 3) / 4]) {
  constexpr int NW = (N + 3) / 4;
  constexpr int NC = (N + 30) / 16;   // chunks at the worst offset (15)
  constexpr int NR = 4 * NC;
  static_assert(NR >= NW + 4, "a word past the window after a 3-word shift");
  const uint8_t* c0 = align_down16(p);
  const int off = static_cast<int>(p - c0);
  uint32_t raw[NR];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (16 * c < off + N) v = load16_in(c0 + 16 * c, buf, buf_end);
    raw[4 * c] = v.x;
    raw[4 * c + 1] = v.y;
    raw[4 * c + 2] = v.z;
    raw[4 * c + 3] = v.w;
  }
  if (off & 8) {
#pragma unroll
    for (int i = 0; i + 2 < NR; ++i) raw[i] = raw[i + 2];
  }
  if (off & 4) {
#pragma unroll
    for (int i = 0; i + 1 < NR; ++i) raw[i] = raw[i + 1];
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = __funnelshift_r(raw[i], raw[i + 1], 8 * (off & 3));
}

// The warp's loads of one staging, held in registers until stored (so a
// staging's loads can fly while the warp works on the last one): step j
// holds chunk (lane & 7) of line 4 j + (lane >> 3), if that line has it.
struct StageLoads {
  uint4 v[32 / 4];
  unsigned valid;   // bit j: step j holds a chunk
};

// Every lane: `from` (16-byte aligned) and `n` (0 to 8) of its line.
__device__ __forceinline__ void fetch_lines(StageLoads& ld, const uint8_t* from, int n,
                                            const uint8_t* buf, const uint8_t* buf_end,
                                            int lane) {
  const unsigned long long f = reinterpret_cast<uintptr_t>(from);
  ld.valid = 0u;
#pragma unroll
  for (int j = 0; j < 32 / 4; ++j) {
    const int l = 4 * j + (lane >> 3), ch = lane & 7;
    const unsigned long long fl = __shfl_sync(0xFFFFFFFFu, f, l);
    const int nl = __shfl_sync(0xFFFFFFFFu, n, l);
    ld.v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (ch < nl) {
      ld.valid |= 1u << j;
      ld.v[j] = load16_in(reinterpret_cast<const uint8_t*>(fl) + 16 * ch, buf, buf_end);
    }
  }
}

__device__ __forceinline__ void store_lines(StageRows& rows, const StageLoads& ld, int lane) {
#pragma unroll
  for (int j = 0; j < 32 / 4; ++j) {
    if (ld.valid >> j & 1u) {
      const int l = 4 * j + (lane >> 3), ch = lane & 7;
      rows[l][(4 * ch) ^ l] = ld.v[j].x;
      rows[l][(4 * ch + 1) ^ l] = ld.v[j].y;
      rows[l][(4 * ch + 2) ^ l] = ld.v[j].z;
      rows[l][(4 * ch + 3) ^ l] = ld.v[j].w;
    }
  }
}

__device__ __forceinline__ void stage_lines(StageRows& rows, const uint8_t* from, int n,
                                            const uint8_t* buf, const uint8_t* buf_end,
                                            int lane) {
  StageLoads ld;
  fetch_lines(ld, from, n, buf, buf_end, lane);
  store_lines(rows, ld, lane);
}

// Byte `off` (0 to 127) of lane `lane`'s staged run.
__device__ __forceinline__ int staged_byte(const StageRows& rows, int lane, int off) {
  return (rows[lane][(off >> 2) ^ lane] >> (8 * (off & 3))) & 0xFF;
}

// Word `w` (0 to 31) of lane `lane`'s staged run.
__device__ __forceinline__ uint32_t staged_word(const StageRows& rows, int lane, int w) {
  return rows[lane][w ^ lane];
}

// The 4 bytes from byte `off` (0 to 124) of lane `lane`'s staged run.
__device__ __forceinline__ uint32_t staged_bytes4(const StageRows& rows, int lane, int off) {
  const uint32_t lo = staged_word(rows, lane, off >> 2);
  const uint32_t hi = (off & 3) ? staged_word(rows, lane, (off >> 2) + 1) : 0u;
  return __funnelshift_r(lo, hi, 8 * (off & 3));
}

// The 8 x 8 bit transpose: bit c of byte i becomes bit i of byte c.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// The class words (a 256-entry table, up to 16 classes) of the 8 bytes of
// v0, v1, transposed: byte c of lo (classes 0-7) and of hi (classes 8-15)
// holds class c's bits of the 8 bytes.
template <typename Cls>
__device__ __forceinline__ void classify8(uint32_t v0, uint32_t v1, const Cls* cls,
                                          uint64_t& lo, uint64_t& hi) {
  const uint32_t v[2] = {v0, v1};
  uint32_t l[2] = {0u, 0u}, h[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t k = cls[(v[i >> 2] >> (8 * (i & 3))) & 0xFFu];
    l[i >> 2] |= (k & 0xFFu) << (8 * (i & 3));
    h[i >> 2] |= ((k >> 8) & 0xFFu) << (8 * (i & 3));
  }
  lo = transpose8(l[0] | static_cast<uint64_t>(l[1]) << 32);
  hi = sizeof(Cls) > 1 ? transpose8(h[0] | static_cast<uint64_t>(h[1]) << 32) : 0ull;
}

}  // namespace lp
