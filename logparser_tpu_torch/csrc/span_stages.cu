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
// token cursors, and it writes n_out * 4 bytes per line.  A thread a line
// over spans this short (request lines of ~30-90 bytes, 12-byte prefixes,
// 19-byte longs) keeps every lane busy, but a load of one byte a lane
// touches 32 lines for one byte each.  So no span is read a byte at a
// time: every span is read as aligned 16-byte chunks (lp::load16_in,
// through L1), funnel-shifted into place, and the first and last space
// and the version's digits and dots are found 8 bytes a step with exact
// byte-equality masks; the protocol split's first '/' follows from the
// first-line split (see firstline).  Staging each request line's first
// 128 bytes into shared memory by the warp first (line_stage.cuh)
// measured slower on every case: a line's chunks stay in L1 between its
// tasks.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int TASKW = 12;
constexpr uint64_t ONES = 0x0101010101010101ull;
constexpr uint64_t HIGH = 0x8080808080808080ull;
constexpr uint64_t LOW7 = 0x7F7F7F7F7F7F7F7Full;

// 0x80 in each byte of x equal to c, else 0 (exact: no carries between bytes).
__device__ __forceinline__ uint64_t eq_mask(uint64_t x, unsigned c) {
  const uint64_t y = x ^ (ONES * c);
  return ~(((y & LOW7) + LOW7) | y | LOW7);
}

// 0x80 in each byte of x that is an ASCII digit.
__device__ __forceinline__ uint64_t digit_mask(uint64_t x) {
  const uint64_t lo7 = x & LOW7;
  return (lo7 + ONES * 0x50) & ~(lo7 + ONES * 0x46) & ~x & HIGH;
}

// 0x80 in each byte j of a word at line position pos0 with lo <= pos0 + j < hi.
__device__ __forceinline__ uint64_t range_mask(int pos0, int lo, int hi) {
  const int a = lo - pos0, z = hi - pos0;
  if (a >= 8 || z <= 0 || a >= z) return 0;
  uint64_t m = HIGH;
  if (a > 0) m <<= 8 * a;
  if (z < 8) m &= HIGH >> (8 * (8 - z));
  return m;
}

__device__ __forceinline__ int first_byte(uint64_t m) { return (__ffsll(m) - 1) >> 3; }
__device__ __forceinline__ int last_byte(uint64_t m) { return (63 - __clzll(m)) >> 3; }

// One thread's line, read the way lp::Row reads it, through aligned
// 16-byte chunks of the buffer (lp::load16_in: never outside it).
struct Line {
  const uint8_t* p;
  int L, mask;
  const uint8_t* buf;
  const uint8_t* buf_end;

  // Row::at(p, 0) for p >= 0 already masked.
  __device__ __forceinline__ int byte(int q) const { return q < L ? p[q] : 0; }

  // Bytes [q, q + 4 NW) of the line (q >= 0, already masked) as NW
  // little-endian words, those at or past L zero.
  template <int NW>
  __device__ __forceinline__ void window(int q, uint32_t (&w)[NW]) const {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
    if (q >= L) return;
    const uint8_t* a = p + q;
    const uint8_t* c0 = lp::align_down16(a);
    const int off = static_cast<int>(a - c0);
    constexpr int NC = (4 * NW + 15) / 16 + 1;
    constexpr int NR = 4 * NC + 4;
    uint32_t raw[NR];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + 16 * c < p + L) v = lp::load16_in(c0 + 16 * c, buf, buf_end);
      raw[4 * c] = v.x;
      raw[4 * c + 1] = v.y;
      raw[4 * c + 2] = v.z;
      raw[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int i = 4 * NC; i < NR; ++i) raw[i] = 0u;
    if (off & 8) {
#pragma unroll
      for (int i = 0; i + 2 < NR; ++i) raw[i] = raw[i + 2];
    }
    if (off & 4) {
#pragma unroll
      for (int i = 0; i + 1 < NR; ++i) raw[i] = raw[i + 1];
    }
    const int lim = L - q;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      w[i] = __funnelshift_r(raw[i], raw[i + 1], 8 * (off & 3));
      const int keep = lim - 4 * i;
      if (keep <= 0) w[i] = 0u;
      else if (keep < 4) w[i] &= (1u << (8 * keep)) - 1u;
    }
  }
};

constexpr int SCAN_CHUNKS = 2;   // 16-byte chunks a scan step has in flight

// The 8-byte words of the line over positions [lo, hi) (lo >= 0, hi <= L),
// each with its position: fn(x, pos0).
template <typename Fn>
__device__ __forceinline__ void scan_words(const Line& ln, int lo, int hi, Fn fn) {
  if (lo >= hi) return;
  const uint8_t* c = lp::align_down16(ln.p + lo);
  for (int q = static_cast<int>(c - ln.p); q < hi; q += 16 * SCAN_CHUNKS) {
    uint4 v[SCAN_CHUNKS];
#pragma unroll
    for (int k = 0; k < SCAN_CHUNKS; ++k) {
      v[k] = q + 16 * k < hi ? lp::load16_in(ln.p + q + 16 * k, ln.buf, ln.buf_end)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < SCAN_CHUNKS; ++k) {
      const int at = q + 16 * k;
      if (at < hi) fn(v[k].x | static_cast<uint64_t>(v[k].y) << 32, at);
      if (at + 8 < hi) fn(v[k].z | static_cast<uint64_t>(v[k].w) << 32, at + 8);
    }
  }
}

struct FirstLine {
  int ms, me, us, ue, ps, pe;
  bool ok, has_protocol;
};

// "METHOD URI PROTO" -> sub-spans (the reference's split_firstline).  The
// scans read the line unmasked over [max(start, 0), min(end, L)), the head
// and version digits through Row::at (masked at the start).
__device__ FirstLine firstline(const Line& ln, int start, int end) {
  const int L = ln.L;
  const int lo = max(start, 0), hi = min(end, L);
  FirstLine f{};
  int first = L, last = -1;
  scan_words(ln, lo, hi, [&](uint64_t x, int pos0) {
    const uint64_t m = eq_mask(x, ' ') & range_mask(pos0, lo, hi);
    if (m) {
      if (first == L) first = pos0 + first_byte(m);
      last = pos0 + last_byte(m);
    }
  });
  const bool has_space = first < L;
  const int proto_start = has_space ? last + 1 : end;
  bool has_protocol = false;
  if (has_space && last > first && end - proto_start >= 8) {
    uint32_t head[2];
    ln.window<2>(proto_start & ln.mask, head);
    if (head[0] == 0x50545448u && (head[1] & 0xFFu) == '/') {   // "HTTP/"
      // The version: digits and exactly one dot over [proto_start + 5,
      // min(end, L)), a digit first (not the dot) and last.
      const int vlo = proto_start + 5;
      int dots = 0, dot_at = -1;
      bool chars_ok = true;
      scan_words(ln, vlo, hi, [&](uint64_t x, int pos0) {
        const uint64_t r = range_mask(pos0, vlo, hi);
        const uint64_t dm = eq_mask(x, '.') & r;
        if (r & ~(dm | digit_mask(x))) chars_ok = false;
        if (dm) {
          dots += __popcll(dm);
          dot_at = pos0 + first_byte(dm);
        }
      });
      // With dots == 1 the range is not empty, so proto_start + 5 < L and
      // Row::at(proto_start + 5) is the range's first byte; Row::at(end -
      // 1) its last where end <= L.
      const bool last_digit = end <= L ? dot_at != end - 1
                                       : lp::is_digit(ln.byte((end - 1) & ln.mask));
      has_protocol = chars_ok && dots == 1 && dot_at != vlo && last_digit;
    }
  }
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

// The reference's span_prefix_words: word w holds bytes 4w..4w+3 of the
// span at Row::at(s, .), bytes at or past n zeroed, all zero unless live.
__device__ __forceinline__ void prefix_words(const Line& ln, int s, int n, bool live,
                                             uint32_t (&w)[3]) {
  w[0] = w[1] = w[2] = 0u;
  if (!live || n <= 0) return;
  ln.window<3>(s & ln.mask, w);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int keep = n - 4 * i;
    if (keep <= 0) w[i] = 0u;
    else if (keep < 4) w[i] &= (1u << (8 * keep)) - 1u;
  }
}

// lp::long_frame over the bytes of one window: the reference's
// parse_long_spans frame over n bytes from s.
__device__ __forceinline__ lp::LongFrame long_frame(const Line& ln, int s, int n) {
  lp::LongFrame f{0u, 0u, 0u, true};
  if (n <= 0) return f;
  uint32_t w[5];
  ln.window<5>(s & ln.mask, w);
#pragma unroll
  for (int i = 0; i < 19; ++i) {
    const uint32_t d = ((w[i >> 2] >> (8 * (i & 3))) - '0') & 0xFFu;
    const bool in_span = i < n;
    if (in_span && d > 9) f.digits_ok = false;
    const uint32_t dd = in_span ? d : 0u;
    if (i < 9) f.hi = f.hi * 10u + dd;
    else if (i < 18) f.lo = f.lo * 10u + dd;
    else f.d18 = dd;
  }
  return f;
}

__global__ void span_stages_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ tasks, int n_tasks,
    int32_t* __restrict__ out) {
  const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const Line ln{buf + static_cast<size_t>(b) * L, L, mask, buf, buf_end};
    int fl_tok = -1;
    FirstLine fl{};
    auto put = [&](int r, int v) { out[static_cast<size_t>(r) * B + b] = v; };
    for (int t = 0; t < n_tasks; ++t) {
      const int32_t* task = tasks + t * TASKW;
      const int kind = task[0], tok = task[1], part = task[2];
      const int s = starts[static_cast<size_t>(tok) * B + b];
      const int e = ends[static_cast<size_t>(tok) * B + b];
      if (kind == 0 && part >= 1 && part <= 5 && fl_tok != tok) {
        fl = firstline(ln, s, e);
        fl_tok = tok;
      }
      if (kind == 0) {
        int start = s, end = e;
        bool ok = true, null = false;
        if (part == 0) {
          // Token-level CLF null: the span is a lone '-'.
          null = (e - s) == 1 && ln.byte(s & mask) == '-';
        } else if (part == 6) {
          ok = !((e - s) == 1 && ln.byte(s & mask) == '-');
        } else if (part == 7) {
          end = s;
          ok = false;
        } else {
          ok = fl.ok;
          if (part == 1) { start = fl.ms; end = fl.me; }
          else if (part == 2) { start = fl.us; end = fl.ue; }
          else { start = fl.ps; end = fl.pe; ok = ok && fl.has_protocol; }
          if (part >= 4) {
            // "HTTP/1.1" -> protocol + version at the first '/'; null
            // when the span is empty or holds no '/'.  With a protocol
            // the span starts with "HTTP/" inside the line, so its first
            // '/' is start + 4; without one the span is empty and the
            // slash reads L, as a slash not found does.
            const int slash = fl.has_protocol ? start + 4 : L;
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
          uint32_t w[3];
          prefix_words(ln, start, end - start, ok && !null, w);
          for (int k = 0; k < 3; ++k) put(task[11] + k, static_cast<int>(w[k]));
        }
      } else if (kind == 2) {
        // "<seconds>.<3 digits>": the seconds frame over the span before
        // the last four bytes, the dot and millis from one width-4 window
        // at max(end - 4, 0); millis from whatever bytes are there.
        const int w = e - s;
        const int n = max(e - 4, s) - s;
        const lp::LongFrame lf = long_frame(ln, s, n);
        uint32_t tail[1];
        ln.window<1>(max(e - 4, 0) & mask, tail);
        int millis = 0;
        bool m_ok = true;
        for (int k = 1; k <= 3; ++k) {
          const int d = ((tail[0] >> (8 * k)) - '0') & 0xFF;
          m_ok = m_ok && d <= 9;
          millis = millis * 10 + d;
        }
        const bool ok = w >= 5 && w <= 19 && n > 0 && lf.digits_ok && n <= 19 &&
                        m_ok && (tail[0] & 0xFFu) == '.';
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
        const lp::LongFrame lf = long_frame(ln, s, n);
        uint32_t hi = lf.hi, lo = lf.lo, d18 = lf.d18;
        const bool clf = task[3] != 0;
        const int first = n > 0 ? ln.byte(s & mask) : 0;
        const bool is_dash = n == 1 && first == '-';
        bool big = n > 19;
        bool ok = (n > 0 && lf.digits_ok) || (clf && is_dash);
        if (part == 1) {   // zero_null
          put(task[11], (n > 1 && first == '0') ? 1 : 0);
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
      static_cast<const int32_t*>(tasks), n_tasks, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_span_stages_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
