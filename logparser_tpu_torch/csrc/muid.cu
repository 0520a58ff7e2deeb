// Kernel 14: mod_unique_id tokens of one muid group.
//
// Replaces, from logparser_tpu/tpu: postproc.py parse_mod_unique_id and
// the muid branch of pipeline.py compute_rows.
//
// A thread a line.  The token's first 24 bytes, read the way lp::Row::at
// reads them (the start's bits above the gather mask ignored, zeros at or
// past L), become six little-endian words in registers: where they lie
// inside the line ((start & mask) + 24 <= L, every line of a parse path but
// a token at the very end of its line) as the 2 or 3 aligned 16-byte
// chunks that cover them (lp::load_window), elsewhere a byte at a time
// through Row::at.  Each byte maps to its sextet through a 256-byte table
// staged in shared memory (bits 0-5 the value, bit 6 set outside
// [A-Za-z0-9-_], which decodes as 63); the six 24-bit groups give the 18
// bytes: time, ip, pid and thread as u32 words bit-cast to int32, the
// 16-bit counter as int32, and ok = width 24 and every byte in the
// alphabet.  A token it cannot decode only clears ok: it never fails the
// line.  Outputs are 6 int32 rows (time, ip, pid, thread, counter, ok) of
// the unit block, coalesced across threads.  Packed-range arithmetic
// (tools/muid_arith.cuh) tied with the table within 2.2% and lost on the
// cookie batch; two lines a thread (tools/muid_lines_2.cuh) lost 13% at
// L = 64 (PERF.md §6).
//
// Bound: bytes -- 24 token bytes and the two cursors read, 6 rows written
// per line.  Lines lie L bytes apart, so every load of a warp touches 32
// lines of memory: the design's aim is the fewest load instructions (2 or
// 3 of 16 bytes, where the byte loop issued 24) between the cursors'
// round trip and the window's.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TOKEN = 24;         // bytes a token decodes
constexpr uint32_t BAD = 0x40u;   // a table entry's "outside the alphabet" bit

__device__ __forceinline__ uint32_t sextet_entry(int c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '-') return 62;
  return c == '_' ? 63u : (BAD | 63u);
}

// The 24-bit group of the four bytes of x (the first in its low byte);
// bad collects the entries' BAD bits.
__device__ __forceinline__ uint32_t group(uint32_t x, const uint8_t* table, uint32_t& bad) {
  const uint32_t t0 = table[x & 0xFFu], t1 = table[(x >> 8) & 0xFFu];
  const uint32_t t2 = table[(x >> 16) & 0xFFu], t3 = table[x >> 24];
  bad |= t0 | t1 | t2 | t3;
  return ((t0 & 63u) << 18) | ((t1 & 63u) << 12) | ((t2 & 63u) << 6) | (t3 & 63u);
}

__global__ void __launch_bounds__(THREADS) muid_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ tok_s, const int32_t* __restrict__ tok_e,
    int32_t* __restrict__ out) {
  __shared__ uint8_t table[256];
  for (int c = threadIdx.x; c < 256; c += THREADS) table[c] = static_cast<uint8_t>(sextet_entry(c));
  const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
  __syncthreads();
  for (int b = blockIdx.x * THREADS + threadIdx.x; b < B; b += gridDim.x * THREADS) {
    const uint8_t* line = buf + static_cast<size_t>(b) * L;
    const int s = tok_s[b];
    const int w = tok_e[b] - s;
    const int q = s & mask;
    uint32_t x[6];
    if (q + TOKEN <= L) {
      lp::load_window<TOKEN>(line + q, buf, buf_end, x);
    } else {
      const lp::Row row{line, L, mask};
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        x[i] = static_cast<uint32_t>(row.at(s, 4 * i)) |
               static_cast<uint32_t>(row.at(s, 4 * i + 1)) << 8 |
               static_cast<uint32_t>(row.at(s, 4 * i + 2)) << 16 |
               static_cast<uint32_t>(row.at(s, 4 * i + 3)) << 24;
      }
    }
    uint32_t bad = 0u, g[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) g[i] = group(x[i], table, bad);
    const uint32_t words[6] = {
        (g[0] << 8) | (g[1] >> 16),                  // time
        ((g[1] & 0xFFFFu) << 16) | (g[2] >> 8),      // ip
        ((g[2] & 0xFFu) << 24) | g[3],               // pid
        ((g[4] & 0xFFu) << 24) | g[5],               // thread
        g[4] >> 8,                                   // counter
        (w == TOKEN && !(bad & BAD)) ? 1u : 0u,      // ok
    };
#pragma unroll
    for (int r = 0; r < 6; ++r) out[static_cast<size_t>(r) * B + b] = static_cast<int>(words[r]);
  }
}

}  // namespace

LP_EXPORT int lp_muid(const void* buf, int B, int L, const void* tok_s,
                      const void* tok_e, void* out, void* stream) {
  if (B <= 0) return 0;
  muid_kernel<<<lp::grid_for(B, THREADS), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(tok_s), static_cast<const int32_t*>(tok_e),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_muid_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
