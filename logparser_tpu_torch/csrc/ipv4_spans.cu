// Kernel 8: strict dotted-quad parse of one IP token per line.
//
// Replaces logparser_tpu/tpu/postproc.py parse_ipv4_spans (the parse half
// of the geo stage of pipeline.py compute_rows).  One thread per line
// reads the token's first 15 bytes through lp::Row::at (the reference's
// gather_span_bytes: start wrapped, zeros past L) and writes four int32
// rows [4, B]: the address (uint32 bit pattern), ok (ipaddress-strict:
// four octets 0-255, no leading zeros, width 7..15), has_colon (a ':' in
// the first 15 bytes: an IPv6 literal) and chain_ok (1: a token's own
// span).  Octets accumulate in uint32 (the reference's int32 wraparound)
// and the octet bound compares signed, so a rejected span's value equals
// the reference's too.
//
// Bound: bytes -- at most 15 span bytes and 8 cursor bytes in, 16 bytes
// out per line; the byte reads of one thread sit in one or two 128-byte
// lines.

#include "lp_common.cuh"

namespace {

constexpr int MAX_IP = 15;

__global__ void ipv4_spans_kernel(const uint8_t* __restrict__ buf, int B, int L, int mask,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ ends,
                                  int32_t* __restrict__ out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const lp::Row row{buf + static_cast<size_t>(b) * L, L, mask};
    const int s = starts[b];
    const int w = ends[b] - s;
    uint32_t octet = 0, value = 0;
    int ndig = 0, ndots = 0;
    bool lead0 = false, good = true, colon = false;
    for (int i = 0; i < MAX_IP; ++i) {
      const bool in_span = i < w;
      const int c = row.at(s, i);
      colon = colon || (in_span && c == ':');
      const uint32_t d = static_cast<uint32_t>(c - '0') & 0xFFu;
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
  const int threads = 256;
  ipv4_spans_kernel<<<lp::grid_for(B, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_ipv4_spans_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
