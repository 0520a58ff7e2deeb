// Kernel 15: the byte-dropping unescape of quoted-field spans -- the
// device inverse of Apache's ap_escape_logitem for \" and \\.
//
// Replaces logparser_tpu/tpu/postproc.py unescape_compact_spans (a
// [B, width] window, a running max for the backslash-run offsets, and a
// stable argsort for the compaction, all fused by XLA).  One thread per
// row walks its window left to right, keeping the length of the current
// backslash run, and decides each byte with one byte of lookahead, in the
// reference's terms:
//   - a backslash at an odd offset in its run is kept (the escaped byte
//     of a \\ pair);
//   - one at an even offset is dropped, unless it is the run's last byte
//     (an odd run's tail) and the next byte is no quote: then it is kept
//     (an unknown escape keeps both bytes), and the row is inexact when
//     that next byte is a substituting C-escape (b n r t v x) or lies
//     past the span;
//   - every other byte of the span is kept.
// Kept bytes are written compacted to out[b, 0..k), zeros after; a span
// wider than the window is inexact.  The window is read through
// lp::Row::at, so start bits above bit_length(L - 1) are ignored and bytes
// at or past L read 0, as gather_span_bytes reads them; the lookahead of
// the window's last column reads 0 (the reference's shift_zero).  No sort.
//
// Bound: bytes -- each row's span bytes inside the window read once, the
// start and end in, the [B, width] window, out_len and exact out.  One
// thread a row with a serial walk and byte stores strided by width: far
// from that bound (uncoalesced), simple and exact first.

#include "lp_common.cuh"

namespace {

__device__ __forceinline__ bool substitutes(int c) {
  return c == 'b' || c == 'n' || c == 'r' || c == 't' || c == 'v' || c == 'x';
}

__global__ void unescape_kernel(const uint8_t* __restrict__ buf, int B, int L,
                                int mask, const int32_t* __restrict__ start,
                                const int32_t* __restrict__ end, int width,
                                uint8_t* __restrict__ out,
                                int32_t* __restrict__ out_len,
                                bool* __restrict__ exact) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const lp::Row row{buf + static_cast<long long>(b) * L, L, mask};
    const int s = start[b];
    const int n = max(end[b] - s, 0);
    const int m = min(n, width);
    uint8_t* o = out + static_cast<long long>(b) * width;
    bool ok = n <= width;
    int k = 0, run = 0;
    int c = m > 0 ? row.at(s, 0) : 0;
    for (int i = 0; i < m; ++i) {
      const bool next_in_span = i + 1 < n;
      const int nxt = i + 1 < width ? row.at(s, i + 1) : 0;
      bool keep = true;
      if (c == '\\') {
        const bool even = (run & 1) == 0;
        ++run;
        const bool last = !(next_in_span && nxt == '\\');
        if (even) {
          if (!last) {
            keep = false;
          } else if (next_in_span && nxt == '"') {
            keep = false;
          } else if (!next_in_span || substitutes(nxt)) {
            ok = false;
          }
        }
      } else {
        run = 0;
      }
      if (keep) o[k++] = static_cast<uint8_t>(c);
      c = nxt;
    }
    for (int i = k; i < width; ++i) o[i] = 0;
    out_len[b] = k;
    exact[b] = ok;
  }
}

}  // namespace

LP_EXPORT int lp_unescape(const void* buf, int B, int L, const void* start,
                          const void* end, int width, void* out, void* out_len,
                          void* exact, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  unescape_kernel<<<lp::grid_for(B, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(end), width,
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len),
      static_cast<bool*>(exact));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_unescape_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
