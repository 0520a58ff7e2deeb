// Kernel 5: the URI split of one URI group (one (token, steps) prefix).
//
// Replaces, from logparser_tpu/tpu: postproc.py split_uri_fast (windowed
// and unwindowed, with and without the authority parts) and the uri step,
// the chained port long and the uri-part view prefixes of pipeline.py
// compute_rows.
//
// The input span is the token's cursors or three component rows (start,
// len, ok) of the first-line split.  Like the reference, the split runs in
// a frame: the whole line when the window W is at least L, else W bytes
// gathered from the span start with clip(start + i, 0, L - 1), the span
// cut to W bytes, and every output position rebased by the start.
// Outputs are int32 component rows of the unit block: the two
// line-constraint rows (ok | ~ok_in, overflow & ok_in) and per part (table
// rows of URIW ints: part, clf, out0..out6, prefix row) the span's start,
// len, ok, null, amp, fix (+ 3 prefix words), or for the port the
// 19-digit long frame hi, lo, d18, ndig, ok, null, big.
//
// Design: a warp a tile of 32 lines, a thread a line.
// - Stage (line_stage.cuh): each line's frame bytes, when they fit 256
//   bytes with their 16-byte alignment, come into two word-swizzled
//   shared-memory tiles of 128 bytes a line, aligned 16-byte loads, 8
//   consecutive lanes on a line's 128 consecutive bytes.  Where the
//   window's clamp bites (a span past L), the bytes past the line's end
//   are overwritten with its last.
// - Staged frames (walk_groups): 8 bytes a step, in order, a class table
//   in shared memory and an 8 x 8 bit transpose give each byte class
//   ('?' / '&', '?', the oracle-only bytes, ':', '/', '@', '%', the
//   encode set, non-hex, non-digit, non-scheme, non-host) as 8 bits, and
//   the reference's firsts, lasts, counts and range tests move by bit
//   operations on them: the scheme before the first ':', "//" after it,
//   the authority (from the first ':' + 3 to the first '/' there or the
//   first separator: its last '@', the last ':' past it, the port's
//   digits, the host's charset, '%' before the '@'), the path's '%' from
//   each of its starts, and the query's encode set and '%XX' check (a '%'
//   with a non-hex byte one or two past it, or within two bytes of the
//   end, carried into the next 8 bytes).  Every range starts at a first
//   the walk has already passed, so a pass in order answers it.
// - Other frames (walk_bytes: longer than the staged runs, or starting
//   before the line) are read from the line a byte at a time, the same
//   state in registers.  The seeded cases hold both paths to the plain
//   version.
// - Parts: the prefix words (4 bytes at a time) and the port's long frame
//   read the staged bytes (the line's bytes, 0 past L, as
//   gather_span_bytes reads them).
// Output rows are written a component row at a time for the warp's 32
// consecutive lines (128 bytes a store).
//
// Bound: bytes -- the URI span (at most W bytes a line) read once, the
// input and output rows once.  Spans this short leave the kernel bound by
// instruction issue and latency, not bytes.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int URIW = 10;
constexpr int URI_PATH = 0, URI_QUERY = 1, URI_PROTOCOL = 2, URI_USERINFO = 3,
              URI_HOST = 4, URI_REF = 5, URI_PORT = 6;
constexpr int WARPS = 4;
constexpr int RUNS = 2;                          // staged runs of 128 bytes a line

// Byte classes of the walks (bits of the class table).
constexpr unsigned C_SEP = 1u, C_Q = 2u, C_BAD = 4u, C_COLON = 8u, C_SLASH = 16u,
                   C_AT = 32u, C_PCT = 64u, C_ENC = 128u, C_NONHEX = 256u,
                   C_NONDIGIT = 512u, C_NONSCHEME = 1024u, C_NONHOST = 2048u;

__device__ __forceinline__ bool is_enc(int c) {
  // dissectors/uri.py ENCODE_PRINTABLE: ' {}|\^[]`<>"
  return c == ' ' || c == '{' || c == '}' || c == '|' || c == '\\' ||
         c == '^' || c == '[' || c == ']' || c == '`' || c == '<' ||
         c == '>' || c == '"';
}

__device__ unsigned uri_class(int c) {
  const bool alnum = lp::is_alpha(c) || lp::is_digit(c);
  unsigned k = 0;
  if (c == '?' || c == '&') k |= C_SEP;
  if (c == '?') k |= C_Q;
  if (c < 0x20 || c >= 0x7F || c == '#' || c == ';') k |= C_BAD;
  if (c == ':') k |= C_COLON;
  if (c == '/') k |= C_SLASH;
  if (c == '@') k |= C_AT;
  if (c == '%') k |= C_PCT;
  if (is_enc(c)) k |= C_ENC;
  if (!lp::is_hex(c)) k |= C_NONHEX;
  if (!lp::is_digit(c)) k |= C_NONDIGIT;
  if (!(alnum || c == '+' || c == '.' || c == '-')) k |= C_NONSCHEME;
  if (!(alnum || c == '.' || c == '-')) k |= C_NONHOST;
  return k;
}

struct Args {
  const uint8_t* buf;
  int B, L, mask, wmask;
  const int32_t* tok_s;
  const int32_t* tok_e;
  int32_t* comps;
  int src0, src1, src2;
  bool dash, need_auth;
  int window;
  const int32_t* parts;
  int n_parts, cons, over_row;
};

// A line's bytes, the staged line positions [q0, q1) from shared memory:
// line_at reads the line as gather_span_bytes does ((s & mask) + i, 0 at
// or past L), frame_byte the frame (the window clamped into the line) and
// frame_at the frame as the reference gathers from it.
struct Bytes {
  const uint8_t* line;
  const lp::StageRows* rows;   // two runs of 128 bytes
  int lane, L, W, gbase, q0, q1;
  bool windowed;
  // Word w (0 to 63) of the staged bytes.
  __device__ __forceinline__ uint32_t word(int w) const {
    return lp::staged_word(rows[w >> 5], lane, w & 31);
  }
  __device__ __forceinline__ int staged(int off) const {   // 0 to 255
    return (word(off >> 2) >> (8 * (off & 3))) & 0xFF;
  }
  __device__ __forceinline__ int line_byte(int i) const {
    return (i >= q0 && i < q1) ? staged(i - q0) : line[i];
  }
  __device__ __forceinline__ int line_at(int s, int i, int mask) const {
    const int idx = (s & mask) + i;
    return idx < L ? line_byte(idx) : 0;
  }
  __device__ __forceinline__ int frame_byte(int p) const {
    return line_byte(windowed ? min(max(gbase + p, 0), L - 1) : p);
  }
  __device__ __forceinline__ int frame_at(int s, int i, int fmask) const {
    const int idx = (s & fmask) + i;
    return idx < W ? frame_byte(idx) : 0;
  }
};

struct Uri {
  bool ok, all_null, is_abs_or_opaque, ui_show, show_auth, port_show;
  bool path_fix, query_fix, ui_fix, has_query;
  int first_colon, first_sep, path_begin, auth_start, auth_end, at;
  int rest_start, host_end, port_start;
};

// What split_uri_fast needs from the span's bytes (frame positions; W or
// -1: none): the first '?' / '&', the first '?' and their count, the
// oracle-only bytes, the first ':' and '/', the first non-scheme byte
// past the start, the two bytes after the first ':', the first '/' from
// the first ':' + 3 (the authority's end), in the authority its last '@',
// the last ':' past it, a non-digit past that ':' and the first non-host
// byte past the '@', a '%' before the '@'; a path '%' (before the first
// separator) from the start, past the first ':' and past that '/'; the
// query's encode-set bytes and bad '%XX' escapes.
struct Walk {
  int first_sep, first_q, q_count, fc, first_slash, first_nonscheme, b1, b2, slash_a;
  int at, colon2, first_nonhost;
  bool clean, port_nd, ui_pct, pct_start, pct_fc, pct_slash, query_fix;
};

// The Walk of a frame read from the line (longer than a staged run, or
// clamped by the window): every byte of [lo, hi) once, in order, its class
// from the table; each range the reference tests starts at a first this
// pass has already passed.
__device__ Walk walk_bytes(const Bytes& by, const uint16_t* cls, int start, int lo, int hi,
                           bool need_auth) {
  const int W = by.W;
  Walk r{W, W, 0, W, W, W, 0, 0, W, -1, -1, W, true, false, false, false, false, false, false};
  int hex_need = 0;
  bool pct_auth = false;
  for (int p = lo; p < hi; ++p) {
    const int c = by.frame_byte(p);
    const unsigned k = cls[c];
    const bool sep_before = r.first_sep != W;
    if (hex_need > 0) {   // a byte of a query "%XX"
      if (k & C_NONHEX) r.query_fix = true;
      --hex_need;
    }
    if (sep_before || (k & C_SEP)) {   // the query, from the first separator
      if (k & C_ENC) r.query_fix = true;
      if (k & C_PCT) {
        if (p + 2 >= hi) r.query_fix = true;
        else hex_need = 2;
      }
    } else if (k & C_PCT) {   // a path's '%', from each of its starts
      r.pct_start = true;
      r.pct_fc = r.pct_fc || r.fc < p;
      r.pct_slash = r.pct_slash || r.slash_a < p;
    }
    if ((k & C_SEP) && r.first_sep == W) r.first_sep = p;
    if (k & C_Q) {
      if (r.first_q == W) r.first_q = p;
      ++r.q_count;
    }
    if (k & C_BAD) r.clean = false;
    if (p > start && (k & C_NONSCHEME) && r.first_nonscheme == W) r.first_nonscheme = p;
    if (r.fc < p) {
      if (p == r.fc + 1) {
        r.b1 = c;
      } else if (p == r.fc + 2) {
        r.b2 = c;
      } else {   // at or past auth_start = fc + 3
        if (need_auth && r.slash_a == W && !sep_before && !(k & (C_SLASH | C_SEP))) {
          // inside the authority
          if (k & C_AT) {
            r.at = p;
            r.colon2 = -1;
            r.ui_pct = pct_auth;
            r.first_nonhost = W;
          } else {
            if (k & C_COLON) {
              r.colon2 = p;
              r.port_nd = false;
            } else if (k & C_NONDIGIT) {
              r.port_nd = true;
            }
            if ((k & C_NONHOST) && r.first_nonhost == W) r.first_nonhost = p;
          }
          if (k & C_PCT) pct_auth = true;
        }
        if ((k & C_SLASH) && r.slash_a == W) r.slash_a = p;
      }
    }
    if ((k & C_COLON) && r.fc == W) r.fc = p;
    if ((k & C_SLASH) && r.first_slash == W) r.first_slash = p;
  }
  return r;
}

// Bits [x, 8) / [0, x) of a byte's worth of positions (x clamped to [0, 8]).
__device__ __forceinline__ uint32_t from8(int x) {
  return x <= 0 ? 0xFFu : (x >= 8 ? 0u : (0xFFu << x) & 0xFFu);
}
__device__ __forceinline__ uint32_t below8(int x) { return ~from8(x) & 0xFFu; }

// The Walk of a staged frame, 8 bytes a step in order: the class table
// and an 8 x 8 bit transpose give each class of the 8 bytes as 8 bits,
// and the walk's state moves by bit operations on them (first set bit,
// last set bit, any in a range), as walk_bytes moves it a byte at a time.
// Run offset j is frame position base + j; the span's bytes are offsets
// [d, e).
__device__ Walk walk_groups(const Bytes& by, const uint16_t* cls, int start, int lo, int hi,
                            bool need_auth) {
  const int W = by.W, base = by.q0 - by.gbase, d = lo - base, e = hi - base;
  Walk r{W, W, 0, W, W, W, 0, 0, W, -1, -1, W, true, false, false, false, false, false, false};
  bool pct_auth = false;
  uint32_t pend = 0;   // bits of the next 8 bytes a query '%' needs hex
  for (int g = d >> 3; 8 * g < e; ++g) {
    const int j0 = 8 * g, p0 = base + j0;
    uint64_t lo8, hi8;
    lp::classify8(by.word(2 * g), by.word(2 * g + 1), cls, lo8, hi8);
    const uint32_t vm = below8(e - j0) & from8(d - j0);   // the span's bytes
    auto cl = [&](uint64_t t, int c) { return static_cast<uint32_t>(t >> (8 * c)) & vm; };
    const uint32_t sep = cl(lo8, 0), q = cl(lo8, 1), colon = cl(lo8, 3), slash = cl(lo8, 4),
                   pct = cl(lo8, 6);
    // A byte past the span's end is no hex digit.
    const uint32_t nonhex = cl(hi8, 0) | (~vm & 0xFFu);
    // The query: from the first '?' or '&' on.
    const uint32_t qr = r.first_sep != W ? vm : (sep ? (0x100u - (sep & (0u - sep))) & vm : 0u);
    const uint32_t pq = pct & qr;
    if ((pend & nonhex) || (pq & ((nonhex >> 1) | (nonhex >> 2))) || (cl(lo8, 7) & qr)) {
      r.query_fix = true;
    }
    pend = ((pq >> 6) & 1u) | ((pq >> 7) ? 3u : 0u);
    if (sep && r.first_sep == W) r.first_sep = p0 + __ffs(sep) - 1;
    if (q) {
      if (r.first_q == W) r.first_q = p0 + __ffs(q) - 1;
      r.q_count += __popc(q);
    }
    if (cl(lo8, 2)) r.clean = false;
    const uint32_t ns = cl(hi8, 2) & from8(start + 1 - p0);
    if (ns && r.first_nonscheme == W) r.first_nonscheme = p0 + __ffs(ns) - 1;
    if (colon && r.fc == W) r.fc = p0 + __ffs(colon) - 1;
    if (slash && r.first_slash == W) r.first_slash = p0 + __ffs(slash) - 1;
    const uint32_t sa = slash & from8(r.fc + 3 - p0);
    if (sa && r.fc < W && r.slash_a == W) r.slash_a = p0 + __ffs(sa) - 1;
    // The path's '%' (before the first separator), from each of its starts.
    const uint32_t pp = pct & ~qr;
    if (pp) {
      r.pct_start = true;
      r.pct_fc = r.pct_fc || (pp & from8(r.fc + 1 - p0));
      r.pct_slash = r.pct_slash || (pp & from8(r.slash_a + 1 - p0));
    }
    // The authority: from the first ':' + 3, before the first '/' there
    // and the first separator.
    const uint32_t am = need_auth && r.fc < W
                            ? vm & from8(r.fc + 3 - p0) & below8(r.slash_a - p0) & ~qr : 0u;
    if (am) {
      const uint32_t atm = cl(lo8, 5) & am;
      uint32_t after = am;   // past the last '@'
      if (atm) {
        const int a = 31 - __clz(atm);
        r.at = p0 + a;
        r.colon2 = -1;
        r.first_nonhost = W;
        r.ui_pct = pct_auth || (pct & am & below8(a));
        after = am & from8(a + 1);
      }
      const uint32_t cm = colon & after, nh = cl(hi8, 3) & after;
      if (cm) r.colon2 = p0 + 31 - __clz(cm);
      // A non-digit that is no ':' or '@' past the last ':'.
      const uint32_t ca = colon & am, nd = cl(hi8, 1) & am & ~atm & ~ca;
      if (ca) {
        r.port_nd = (nd & from8(32 - __clz(ca))) != 0;
      } else if (nd) {
        r.port_nd = true;
      }
      if (nh && r.first_nonhost == W) r.first_nonhost = p0 + __ffs(nh) - 1;
      pct_auth = pct_auth || (pct & am);
    }
  }
  if (pend) r.query_fix = true;   // a '%' within two bytes of the end
  const bool two = r.fc + 2 < hi;
  r.b1 = two ? by.frame_byte(r.fc + 1) : 0;
  r.b2 = two ? by.frame_byte(r.fc + 2) : 0;
  return r;
}

// split_uri_fast over [start, end) of the frame (frame-local positions;
// its bytes in the frame [lo, hi)), from the span's Walk.
__device__ Uri split_uri(const Bytes& by, const Walk& r, int start, int end, int lo, int hi,
                         int fmask, bool dash, bool need_auth) {
  const int W = by.W, fc = r.fc;
  Uri u;
  u.all_null = (end - start) == 0 || dash;
  const int first_sep = min(r.first_sep, end);
  const bool clean = r.clean && (r.q_count == 0 || (r.q_count == 1 && r.first_q == first_sep));
  const int lead = (start >= lo && start < hi) ? by.frame_byte(start)
                                               : by.frame_at(start, 0, fmask);
  const bool relative = !u.all_null && lead == '/';
  const int limit = min(min(r.first_slash, first_sep), end);
  const bool has_scheme = fc < limit && fc > start;
  // Each read only where has_scheme: the first ':' lies inside the span.
  const bool scheme_ok = lp::is_alpha(lead) && r.first_nonscheme >= fc;
  const bool dslash =
      fc < W && fc + 3 <= end &&
      (fc + 2 < hi ? (r.b1 == '/' && r.b2 == '/')
                   : (by.frame_at(fc + 1, 0, fmask) == '/' &&
                      by.frame_at(fc + 1, 1, fmask) == '/'));
  const int auth_start = fc + 3;
  const int auth_end = min(min(r.slash_a, first_sep), end);

  bool has_pcolon = false, port_empty = false, registry = true, has_at = false, abs_ok;
  int rest_start = 0, host_end = 0, port_start = 0, at = 0;
  if (need_auth) {
    at = r.at;
    has_at = at >= 0;
    rest_start = has_at ? at + 1 : auth_start;
    has_pcolon = r.colon2 >= 0;
    port_start = r.colon2 + 1;
    const int port_len = auth_end - port_start;
    port_empty = port_len <= 0;
    const bool port_digits = !(has_pcolon && r.port_nd);
    host_end = (has_pcolon && (port_empty || port_digits)) ? r.colon2 : auth_end;
    const bool host_ok_cs = r.first_nonhost >= host_end;
    registry = !host_ok_cs || (has_pcolon && !port_empty && !port_digits);
    abs_ok = has_scheme && scheme_ok && dslash &&
             !(has_pcolon && !port_empty && port_digits && port_len > 19);
  } else {
    abs_ok = has_scheme && scheme_ok && dslash;
  }
  const bool is_abs = has_scheme && abs_ok && !u.all_null;
  const bool opaque = has_scheme && scheme_ok && !dslash && !u.all_null;
  const bool case3 = !has_scheme && !relative && !u.all_null;
  const bool handled = u.all_null || relative || case3 || is_abs || opaque;
  u.ok = clean && handled;
  u.show_auth = is_abs && !registry;
  u.path_begin = is_abs ? auth_end : (opaque ? fc + 1 : start);
  u.path_fix = is_abs ? r.pct_slash : (opaque ? r.pct_fc : r.pct_start);
  u.query_fix = r.query_fix;
  u.has_query = !u.all_null && first_sep < end;
  u.is_abs_or_opaque = is_abs || opaque;
  u.ui_show = u.show_auth && has_at;
  u.port_show = u.show_auth && has_pcolon && !port_empty;
  u.ui_fix = need_auth && r.ui_pct && u.ui_show;
  u.first_colon = fc;
  u.first_sep = first_sep;
  u.auth_start = auth_start;
  u.auth_end = auth_end;
  u.at = at;
  u.rest_start = rest_start;
  u.host_end = host_end;
  u.port_start = port_start;
  return u;
}

__global__ void __launch_bounds__(WARPS * 32) uri_split_kernel(Args a) {
  __shared__ lp::StageRows stage[WARPS][RUNS];
  __shared__ uint16_t cls[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls[i] = static_cast<uint16_t>(uri_class(i));
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  lp::StageRows* rows = stage[warp];
  const int L = a.L, B = a.B;
  const uint8_t* buf_end = a.buf + static_cast<size_t>(B) * L;
  const bool windowed = a.window < L;
  const int W = windowed ? a.window : L;
  const int fmask = windowed ? a.wmask : a.mask;
  const int n_tiles = (B + 31) / 32;
  for (int tile = blockIdx.x * WARPS + warp; tile < n_tiles; tile += gridDim.x * WARPS) {
    const int b = tile * 32 + lane;
    const bool real = b < B;
    auto comp = [&](int r) -> int32_t& { return a.comps[static_cast<size_t>(r) * B + b]; };
    int s = 0, e = 0;
    bool ok_in = true;
    if (real) {
      if (a.src0 < 0) {
        s = a.tok_s[b];
        e = a.tok_e[b];
      } else {
        s = comp(a.src0);
        e = s + comp(a.src1);
        ok_in = comp(a.src2) != 0;
      }
    }
    const uint8_t* line = a.buf + static_cast<size_t>(real ? b : 0) * L;
    // The frame: the span [ls, le) of W bytes read from line position
    // gbase + p; its bytes [lo, hi); outputs rebased by off.
    const int gbase = windowed ? s : 0, ls = windowed ? 0 : s;
    const int le = windowed ? min(e - s, a.window) : e, off = windowed ? s : 0;
    const bool over = windowed && (e - s) > a.window;
    const int lo = max(ls, 0), hi = min(le, W);
    const uint8_t* from = lp::align_down16(line + gbase + lo);
    int n = 0;
    if (real && hi > lo && gbase + lo >= 0) {
      const long long chunks = (line + gbase + hi - from + 15) >> 4;
      if (chunks <= RUNS * lp::STAGE_CHUNKS) n = static_cast<int>(chunks);
    }
    __syncwarp();   // the previous tile's bytes are read
#pragma unroll
    for (int k = 0; k < RUNS; ++k) {
      lp::stage_lines(rows[k], from + lp::STAGE_BYTES * k,
                      min(max(n - lp::STAGE_CHUNKS * k, 0), lp::STAGE_CHUNKS), a.buf, buf_end,
                      lane);
    }
    __syncwarp();
    if (!real) continue;
    const int q0 = static_cast<int>(from - line);
    if (n > 0 && gbase + hi > L) {
      // The window's clamp: frame bytes past the line's end read its last.
      const int jl = L - 1 - q0;
      const uint32_t last =
          jl >= 0 ? (rows[jl >> 7][lane][((jl >> 2) & 31) ^ lane] >> (8 * (jl & 3))) & 0xFFu
                  : line[L - 1];
      for (int j = max(L - q0, 0); j < gbase + hi - q0; ++j) {
        uint32_t& w = rows[j >> 7][lane][((j >> 2) & 31) ^ lane];
        w = (w & ~(0xFFu << (8 * (j & 3)))) | last << (8 * (j & 3));
      }
    }
    const Bytes by{line, rows, lane, L, W, gbase, q0, min(q0 + 16 * n, L), windowed};
    const bool is_dash = a.dash && (e - s) == 1 && by.line_at(s, 0, a.mask) == '-';
    const Walk r = n > 0 ? walk_groups(by, cls, ls, lo, hi, a.need_auth)
                         : walk_bytes(by, cls, ls, lo, hi, a.need_auth);
    const Uri u = split_uri(by, r, ls, le, lo, hi, fmask, is_dash, a.need_auth);
    const bool uri_ok = u.ok || over;
    comp(a.cons) = (uri_ok || !ok_in) ? 1 : 0;
    comp(a.over_row) = (over && ok_in) ? 1 : 0;
    const bool step_ok = ok_in && uri_ok;
    for (int t = 0; t < a.n_parts; ++t) {
      const int32_t* pt = a.parts + t * URIW;
      const int part = pt[0];
      const int32_t* o = pt + 2;
      if (part == URI_PORT) {
        // The reference's parse_long_spans frame over the port's n bytes.
        const int ps = (u.port_show ? u.port_start : ls) + off;
        const int n_port = (u.port_show ? u.auth_end : ls) + off - ps;
        uint32_t hi9 = 0u, lo9 = 0u, d18 = 0u;
        bool digits_ok = true;
        for (int i = 0; i < 19; ++i) {
          const bool in = i < n_port;
          const uint32_t d =
              in ? static_cast<uint32_t>(by.line_at(ps, i, a.mask) - '0') & 0xFFu : 0u;
          if (in && d > 9) digits_ok = false;
          if (i < 9) hi9 = hi9 * 10u + d;
          else if (i < 18) lo9 = lo9 * 10u + d;
          else d18 = d;
        }
        const bool clf = pt[1] != 0;
        const bool is_null = clf && n_port == 1 && by.line_at(ps, 0, a.mask) == '-';
        const bool ok = ((n_port > 0 && digits_ok) || is_null) && n_port <= 19;
        comp(o[0]) = static_cast<int>(hi9);
        comp(o[1]) = static_cast<int>(lo9);
        comp(o[2]) = static_cast<int>(d18);
        comp(o[3]) = min(max(n_port, 0), 19);
        comp(o[4]) = ok ? 1 : 0;
        comp(o[5]) = is_null ? 1 : 0;
        comp(o[6]) = 0;
        continue;
      }
      int start = ls, end = ls;   // hidden parts: the empty span at the start
      bool null = u.all_null, amp = false, fix = false;
      if (part == URI_PATH) {
        if (!u.all_null) { start = u.path_begin; end = max(u.first_sep, u.path_begin); }
        fix = u.path_fix;
      } else if (part == URI_QUERY) {
        if (!u.all_null) { start = u.first_sep; end = le; }
        amp = u.has_query;
        fix = u.query_fix;
      } else if (part == URI_PROTOCOL) {
        if (u.is_abs_or_opaque) end = u.first_colon;
        null = u.all_null || !u.is_abs_or_opaque;
      } else if (part == URI_USERINFO) {
        if (u.ui_show) { start = u.auth_start; end = u.at; }
        null = u.all_null || !u.ui_show;
        fix = u.ui_fix;
      } else if (part == URI_HOST) {
        if (u.show_auth) { start = u.rest_start; end = u.host_end; }
        null = u.all_null || !u.show_auth;
      } else {  // URI_REF: clean rows hold no '#', the fragment is absent
        start = end = s - off;
        null = true;
      }
      start += off;
      end += off;
      comp(o[0]) = start;
      comp(o[1]) = end - start;
      comp(o[2]) = step_ok ? 1 : 0;
      comp(o[3]) = null ? 1 : 0;
      comp(o[4]) = amp ? 1 : 0;
      comp(o[5]) = fix ? 1 : 0;
      if (pt[9] >= 0) {
        // span_prefix_words: bytes 4w..4w+3 of the part, zero past it, all
        // zero unless live; a leading '?' of a query with amp as '&'.
        const bool live = step_ok && !null;
        const int n_part = end - start;
        for (int w = 0; w < 3; ++w) {
          const int i0 = start + 4 * w;   // (start & mask) == start inside the line
          uint32_t word = 0u;
          if (!live || n_part <= 4 * w) {
          } else if (i0 >= by.q0 && i0 + 4 <= min(by.q1, L) && (start & a.mask) == start) {
            const int off4 = i0 - by.q0;
            word = __funnelshift_r(by.word(off4 >> 2), (off4 & 3) ? by.word((off4 >> 2) + 1) : 0u,
                                   8 * (off4 & 3));
            if (n_part < 4 * w + 4) word &= (1u << (8 * (n_part - 4 * w))) - 1u;
          } else {
            for (int j = 0; j < 4 && 4 * w + j < n_part; ++j) {
              word |= static_cast<uint32_t>(by.line_at(start, 4 * w + j, a.mask)) << (8 * j);
            }
          }
          if (w == 0 && part == URI_QUERY && amp && (word & 0xFFu) == '?') word ^= '?' ^ '&';
          comp(pt[9] + w) = static_cast<int>(word);
        }
      }
    }
  }
}

}  // namespace

LP_EXPORT int lp_uri_split(const void* buf, int B, int L, const void* tok_s,
                           const void* tok_e, void* comps, int src0, int src1,
                           int src2, int dash, int need_auth, int window,
                           const void* parts, int n_parts, int cons, int over,
                           void* stream) {
  if (B <= 0) return 0;
  const Args a{static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
               lp::gather_mask(window), static_cast<const int32_t*>(tok_s),
               static_cast<const int32_t*>(tok_e), static_cast<int32_t*>(comps), src0,
               src1, src2, dash != 0, need_auth != 0, window,
               static_cast<const int32_t*>(parts), n_parts, cons, over};
  const int tiles = (B + 31) / 32;
  uri_split_kernel<<<lp::grid_for(tiles, WARPS), WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_uri_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
