// Kernel 2: the span post-stages of one format unit.
//
// Replaces, from logparser_tpu/tpu: pipeline.py compute_rows.clf_dash,
// postproc.py gather_span_bytes (as a plain gather), split_firstline,
// split_protocol_version, parse_long_spans (CLF mode) and
// parse_secmillis_spans (NGINX $msec / $request_time), and pipeline.py
// span_prefix_words.
//
// One thread per line runs the unit's task table.  Task rows (TASKW
// ints): kind (0 span, 1 long, 2 secmillis), token, part (span: 0 direct, 1 method,
// 2 uri, 3 protocol, 4 / 5 the protocol / version halves of the
// protocol split at its first '/', 6 / 7 an NGINX upstream list's
// element 0 (the span, not ok on a CLF dash) / a higher, absent element;
// long: 0 plain, 1 the number -> CLF conversion of pipeline.py
// compute_rows' zero_null mode -- no >19-digit patch, ok false there,
// and a leading-zero row), clf (long), then output rows --
// span: start, len, ok, null, -, -, -, prefix row (3 words, or -1);
// long: hi, lo, d18, ndig, ok, null, big, leading-zero row (part 1);
// secmillis: the same seven for the seconds part, then the millis row.
// Outputs are int32 rows [n_out, B], coalesced across threads.
//
// Bound: the bytes it must read are the spans it scans (the request
// line, 19 bytes of the byte count, 12 bytes per view prefix) plus the
// token cursors, and it writes n_out * 4 bytes per line.  The byte reads
// are per-thread sequential within a line, one line per thread; L1
// carries the rest of each 128-byte line a load touches.

#include "lp_common.cuh"

namespace {

constexpr int TASKW = 12;

struct FirstLine {
  int ms, me, us, ue, ps, pe;
  bool ok, has_protocol;
};

// "METHOD URI PROTO" -> sub-spans (the reference's split_firstline).
__device__ FirstLine firstline(const lp::Row& row, int start, int end) {
  const int L = row.L;
  int first = L, last = -1;
  for (int p = max(start, 0), hi = min(end, L); p < hi; ++p) {
    if (row.p[p] == ' ') {
      if (first == L) first = p;
      last = p;
    }
  }
  const bool has_space = first < L;
  const int proto_start = has_space ? last + 1 : end;
  const bool head_ok = row.at(proto_start, 0) == 'H' &&
                       row.at(proto_start, 1) == 'T' &&
                       row.at(proto_start, 2) == 'T' &&
                       row.at(proto_start, 3) == 'P' &&
                       row.at(proto_start, 4) == '/';
  bool chars_ok = true;
  int dots = 0;
  for (int p = max(proto_start + 5, 0), hi = min(end, L); p < hi; ++p) {
    const int c = row.p[p];
    if (c == '.') ++dots;
    else if (!lp::is_digit(c)) chars_ok = false;
  }
  const bool ver_ok = (end - proto_start) >= 8 && chars_ok && dots == 1 &&
                      lp::is_digit(row.at(proto_start + 5, 0)) &&
                      lp::is_digit(row.at(max(end - 1, 0), 0));
  const bool has_protocol = has_space && last > first && head_ok && ver_ok;
  FirstLine f;
  f.ms = start;
  f.me = has_space ? first : start;
  f.us = has_space ? first + 1 : end;
  f.ue = has_protocol ? last : end;
  f.ps = has_protocol ? proto_start : end;
  f.pe = end;
  f.ok = has_space;
  f.has_protocol = has_protocol;
  return f;
}

__global__ void span_stages_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ tasks, int n_tasks,
    int32_t* __restrict__ out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const lp::Row row{buf + static_cast<size_t>(b) * L, L, mask};
    int fl_tok = -1;
    FirstLine fl{};
    auto put = [&](int r, int v) { out[static_cast<size_t>(r) * B + b] = v; };
    for (int t = 0; t < n_tasks; ++t) {
      const int32_t* task = tasks + t * TASKW;
      const int tok = task[1], part = task[2];
      const int s = starts[static_cast<size_t>(tok) * B + b];
      const int e = ends[static_cast<size_t>(tok) * B + b];
      if (task[0] == 0) {
        int start = s, end = e;
        bool ok = true, null = false;
        if (part == 0) {
          // Token-level CLF null: the span is a lone '-'.
          null = (e - s) == 1 && row.at(s, 0) == '-';
        } else if (part == 6) {
          ok = !((e - s) == 1 && row.at(s, 0) == '-');
        } else if (part == 7) {
          end = s;
          ok = false;
        } else {
          if (fl_tok != tok) {
            fl = firstline(row, s, e);
            fl_tok = tok;
          }
          ok = fl.ok;
          if (part == 1) { start = fl.ms; end = fl.me; }
          else if (part == 2) { start = fl.us; end = fl.ue; }
          else { start = fl.ps; end = fl.pe; ok = ok && fl.has_protocol; }
          if (part >= 4) {
            // "HTTP/1.1" -> protocol + version at the first '/'; null
            // when the span is empty or holds no '/'.
            int slash = L;
            for (int p = max(start, 0), hi = min(end, L); p < hi; ++p) {
              if (row.p[p] == '/') { slash = p; break; }
            }
            null = start >= end || slash >= L;
            if (part == 4) end = min(slash, end);
            else start = min(slash + 1, end);
          }
        }
        put(task[4], start);
        put(task[5], end - start);
        put(task[6], ok ? 1 : 0);
        put(task[7], null ? 1 : 0);
        if (task[11] >= 0) {
          for (int w = 0; w < 3; ++w) {
            put(task[11] + w, static_cast<int>(
                lp::prefix_word(row, start, end - start, ok && !null, false, w)));
          }
        }
      } else if (task[0] == 2) {
        // "<seconds>.<3 digits>": the seconds frame over the span before
        // the last four bytes, the dot and millis from one width-4 window
        // at max(end - 4, 0); millis from whatever bytes are there.
        const int w = e - s;
        const int n = max(e - 4, s) - s;
        const lp::LongFrame lf = lp::long_frame(row, s, n);
        const int ws = max(e - 4, 0);
        int millis = 0;
        bool m_ok = true;
        for (int k = 1; k <= 3; ++k) {
          const int d = (row.at(ws, k) - '0') & 0xFF;
          m_ok = m_ok && d <= 9;
          millis = millis * 10 + d;
        }
        const bool ok = w >= 5 && w <= 19 && n > 0 && lf.digits_ok && n <= 19 &&
                        m_ok && row.at(ws, 0) == '.';
        put(task[4], static_cast<int>(lf.hi));
        put(task[5], static_cast<int>(lf.lo));
        put(task[6], static_cast<int>(lf.d18));
        put(task[7], min(max(n, 0), 19));
        put(task[8], ok ? 1 : 0);
        put(task[9], 0);
        put(task[10], 0);
        put(task[11], millis);
      } else {
        // 19-digit left-aligned limb frame (the reference's
        // parse_long_spans); int32 sums wrap, as there.
        const int n = e - s;
        const lp::LongFrame lf = lp::long_frame(row, s, n);
        uint32_t hi = lf.hi, lo = lf.lo, d18 = lf.d18;
        const bool window_digits = lf.digits_ok;
        const bool clf = task[3] != 0;
        const bool is_dash = n == 1 && row.at(s, 0) == '-';
        const bool zero_null = part == 1;
        bool big = n > 19;
        bool ok = (n > 0 && window_digits) || (clf && is_dash);
        if (zero_null) {
          put(task[11], (n > 1 && row.at(s, 0) == '0') ? 1 : 0);
          ok = ok && !big;
          big = false;
        }
        if (big) {
          // >19 digits: the hi row carries start | len<<13 for the host.
          hi = static_cast<uint32_t>(s | (min(n, 8191) << 13));
          lo = 0;
          d18 = 0;
        }
        put(task[4], static_cast<int>(hi));
        put(task[5], static_cast<int>(lo));
        put(task[6], static_cast<int>(d18));
        put(task[7], min(max(n, 0), 19));
        put(task[8], ok ? 1 : 0);
        put(task[9], (is_dash && clf) ? 1 : 0);
        put(task[10], big ? 1 : 0);
      }
    }
  }
}

}  // namespace

LP_EXPORT int lp_span_stages(const void* buf, int B, int L, const void* starts,
                             const void* ends, const void* tasks, int n_tasks,
                             void* out, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  span_stages_kernel<<<lp::grid_for(B, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(tasks), n_tasks,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_span_stages_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
