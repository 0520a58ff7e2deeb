// Kernel 8: strict dotted-quad parse of one IP token per line.
//
// Replaces logparser_tpu/tpu/postproc.py parse_ipv4_spans (the parse half
// of the geo stage of pipeline.py compute_rows).  The reference parses a
// token once per GeoIP group inside one jitted function; the port launches
// this kernel once per IP token, and every geo group over the token reads
// its rows (pipeline.unit_components' ip_groups).
//
// A thread a line.  The token's first 15 bytes, read the way lp::Row::at
// reads them (the start's bits above the gather mask ignored, zeros at or
// past L), become four little-endian words in registers: where they lie
// inside the line ((start & mask) + 15 <= L) as the 1 or 2 aligned 16-byte
// chunks that cover them (lp::load_window), elsewhere a byte at a time
// through Row::at.  The state machine then runs over the register bytes,
// unrolled, and writes four int32 rows [4, B]: the address (uint32 bit
// pattern), ok (ipaddress-strict: four octets 0-255, no leading zeros,
// width 7..15), has_colon (a ':' in the first min(width, 15) bytes: an
// IPv6 literal) and chain_ok (1: a token's own span).  Octets accumulate
// in uint32 (the reference's int32 wraparound) and the octet bound
// compares signed, so a rejected span's value equals the reference's too.
//
// Bound: bytes -- at most 15 span bytes and 8 cursor bytes in, 16 bytes
// out per line.  Lines lie L bytes apart: a warp's load touches 32 lines
// of memory, so the design issues 1 or 2 loads of 16 bytes a line where
// the byte loop issued 15.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_IP = 15;

__global__ void __launch_bounds__(THREADS) ipv4_spans_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    int32_t* __restrict__ out) {
  const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
  for (int b = blockIdx.x * THREADS + threadIdx.x; b < B; b += gridDim.x * THREADS) {
    const uint8_t* line = buf + static_cast<size_t>(b) * L;
    const int s = starts[b];
    const int w = ends[b] - s;
    const int q = s & mask;
    uint32_t x[4];
    if (q + MAX_IP <= L) {
      lp::load_window<MAX_IP>(line + q, buf, buf_end, x);
    } else {
      const lp::Row row{line, L, mask};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * i + j < MAX_IP) x[i] |= static_cast<uint32_t>(row.at(s, 4 * i + j)) << (8 * j);
        }
      }
    }
    uint32_t octet = 0, value = 0;
    int ndig = 0, ndots = 0;
    bool lead0 = false, good = true, colon = false;
#pragma unroll
    for (int i = 0; i < MAX_IP; ++i) {
      const bool in_span = i < w;
      const uint32_t c = (x[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      colon = colon || (in_span && c == ':');
      const uint32_t d = (c - '0') & 0xFFu;
      const bool digit = d <= 9u;
      const bool dot = c == '.';
      lead0 = lead0 || (in_span && digit && ndig == 1 && octet == 0u);
      if (in_span && digit) {
        octet = octet * 10u + d;
        ++ndig;
      }
      good = good && (!in_span || digit || dot);
      good = good && !(in_span && static_cast<int32_t>(octet) > 255);
      const bool close = in_span && dot;
      good = good && !(close && ndig == 0);
      if (close) {
        value = (value << 8) | octet;
        ++ndots;
        octet = 0u;
        ndig = 0;
      }
    }
    value = (value << 8) | octet;
    const bool ok = good && w >= 7 && w <= MAX_IP && ndots == 3 && ndig > 0 && !lead0;
    out[b] = static_cast<int32_t>(value);
    out[static_cast<size_t>(B) + b] = ok ? 1 : 0;
    out[2 * static_cast<size_t>(B) + b] = colon ? 1 : 0;
    out[3 * static_cast<size_t>(B) + b] = 1;
  }
}

}  // namespace

LP_EXPORT int lp_ipv4_spans(const void* buf, int B, int L, const void* starts,
                            const void* ends, void* out, void* stream) {
  if (B <= 0) return 0;
  ipv4_spans_kernel<<<lp::grid_for(B, THREADS), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_ipv4_spans_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
