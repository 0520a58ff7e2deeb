// The byte-at-a-time span_stages kernel of the first design, for
// tools/kernel_variants.py (span_stages_variants.json, variant
// "byte_loop"): a thread a line, every byte of a span a load of its own
// (the request line's spaces, then its version; the protocol split's '/';
// 4 loads a prefix word, 19 a long).
#pragma once

#include "lp_common.cuh"

namespace byte_loop {

__device__ __forceinline__ lp::LongFrame long_frame(const lp::Row& row, int s, int n) {
  lp::LongFrame f{0u, 0u, 0u, true};
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
__device__ __forceinline__ uint32_t prefix_word(const lp::Row& row, int s, int n,
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
                prefix_word(row, start, end - start, ok && !null, false, w)));
          }
        }
      } else if (task[0] == 2) {
        // "<seconds>.<3 digits>": the seconds frame over the span before
        // the last four bytes, the dot and millis from one width-4 window
        // at max(end - 4, 0); millis from whatever bytes are there.
        const int w = e - s;
        const int n = max(e - 4, s) - s;
        const lp::LongFrame lf = long_frame(row, s, n);
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
        const lp::LongFrame lf = long_frame(row, s, n);
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

}  // namespace byte_loop
