// Kernel 5: the URI split of one URI group (one (token, steps) prefix).
//
// Replaces, from logparser_tpu/tpu: postproc.py split_uri_fast (windowed
// and unwindowed, with and without the authority parts) and the uri step,
// the chained port long and the uri-part view prefixes of pipeline.py
// compute_rows.
//
// One thread per line.  The input span is the token's cursors or three
// component rows (start, len, ok) of the first-line split.  Like the
// reference, the split runs in a frame: the whole line when the window W
// is at least L, else W bytes gathered from the span start with
// clip(start + i, 0, L - 1), the span cut to W bytes, and every output
// position rebased by the start.  The reference's [B, L] first / last /
// any reductions become a few walks over the span in that frame: the
// separators, '?' discipline and oracle-only bytes; the scheme; the
// authority's last '@' and ':' and its host / port charsets; the
// '%'-escape and encode-set flags of path, query and userinfo.  Outputs
// are int32 component rows of the unit block, coalesced across threads:
// the two line-constraint rows (ok | ~ok_in, overflow & ok_in) and per
// part (table rows of URIW ints: part, clf, out0..out6, prefix row) the
// span's start, len, ok, null, amp, fix (+ 3 prefix words), or for the
// port the 19-digit long frame hi, lo, d18, ndig, ok, null, big.
//
// Bound: bytes -- the URI span (at most W bytes a line) read once, the
// input and output rows once.  The walks re-read the span from L1; each
// thread reads its own line byte by byte.

#include "lp_common.cuh"

namespace {

constexpr int URIW = 10;
constexpr int URI_PATH = 0, URI_QUERY = 1, URI_PROTOCOL = 2, URI_USERINFO = 3,
              URI_HOST = 4, URI_REF = 5, URI_PORT = 6;

// The line (base < 0) or the W-byte window from base, read the way the
// reference reads its scan buffer; at() is gather_span_bytes on it.
struct Frame {
  const uint8_t* row;
  int L, W, base, mask;
  __device__ __forceinline__ int byte(int p) const {
    if (base < 0) return row[p];
    const int q = min(max(base + p, 0), L - 1);
    return row[q];
  }
  __device__ __forceinline__ int at(int s, int i) const {
    const int idx = (s & mask) + i;
    return idx < W ? byte(idx) : 0;
  }
};

__device__ __forceinline__ bool is_enc(int c) {
  // dissectors/uri.py ENCODE_PRINTABLE: ' {}|\^[]`<>"
  return c == ' ' || c == '{' || c == '}' || c == '|' || c == '\\' ||
         c == '^' || c == '[' || c == ']' || c == '`' || c == '<' ||
         c == '>' || c == '"';
}

struct Uri {
  bool ok, all_null, is_abs_or_opaque, ui_show, show_auth, port_show;
  bool path_fix, query_fix, ui_fix, has_query;
  int first_colon, first_sep, path_begin, auth_start, auth_end, at;
  int rest_start, host_end, port_start;
};

// split_uri_fast over [start, end) of the frame (frame-local positions).
__device__ Uri split_uri(const Frame& f, int start, int end, bool dash,
                         bool need_auth) {
  const int W = f.W;
  const int lo = max(start, 0), hi = min(end, W);
  Uri u;
  u.all_null = (end - start) == 0 || dash;
  int first_sep = W, first_q = W, q_count = 0, first_colon = W, first_slash = W;
  bool clean = true;
  for (int p = lo; p < hi; ++p) {
    const int c = f.byte(p);
    if ((c == '?' || c == '&') && first_sep == W) first_sep = p;
    if (c == '?') {
      if (first_q == W) first_q = p;
      ++q_count;
    }
    if (c < 0x20 || c >= 0x7F || c == '#' || c == ';') clean = false;
    if (c == ':' && first_colon == W) first_colon = p;
    if (c == '/' && first_slash == W) first_slash = p;
  }
  first_sep = min(first_sep, end);
  clean = clean && (q_count == 0 || (q_count == 1 && first_q == first_sep));

  const int lead = f.at(start, 0);
  const bool relative = !u.all_null && lead == '/';
  const int limit = min(min(first_slash, first_sep), end);
  const bool has_scheme = first_colon < limit && first_colon > start;
  bool scheme_ok = lp::is_alpha(lead);
  for (int p = max(start + 1, 0), e = min(first_colon, W); p < e; ++p) {
    const int c = f.byte(p);
    if (!(lp::is_alpha(c) || lp::is_digit(c) || c == '+' || c == '.' || c == '-')) {
      scheme_ok = false;
      break;
    }
  }
  const bool dslash = f.at(first_colon + 1, 0) == '/' &&
                      f.at(first_colon + 1, 1) == '/' && first_colon + 3 <= end;
  const int auth_start = first_colon + 3;
  int slash_a = W;
  for (int p = max(lo, auth_start); p < hi; ++p) {
    if (f.byte(p) == '/') { slash_a = p; break; }
  }
  const int auth_end = min(min(slash_a, first_sep), end);

  bool has_at = false, has_pcolon = false, port_empty = false, registry = true;
  bool abs_ok;
  int at = 0, rest_start = 0, host_end = 0, port_start = 0;
  u.ui_fix = false;
  if (need_auth) {
    at = -1;
    for (int p = max(auth_start, 0), e = min(auth_end, W); p < e; ++p) {
      if (f.byte(p) == '@') at = p;
    }
    has_at = at >= 0;
    rest_start = has_at ? at + 1 : auth_start;
    int colon2 = -1;
    for (int p = max(rest_start, lo), e = min(auth_end, hi); p < e; ++p) {
      if (f.byte(p) == ':') colon2 = p;
    }
    has_pcolon = colon2 >= 0;
    port_start = colon2 + 1;
    const int port_len = auth_end - port_start;
    port_empty = port_len <= 0;
    bool port_digits = true;
    if (has_pcolon) {
      for (int p = max(port_start, 0), e = min(auth_end, W); p < e; ++p) {
        if (!lp::is_digit(f.byte(p))) { port_digits = false; break; }
      }
    }
    host_end = (has_pcolon && (port_empty || port_digits)) ? colon2 : auth_end;
    bool host_ok_cs = true;
    for (int p = max(rest_start, 0), e = min(host_end, W); p < e; ++p) {
      const int c = f.byte(p);
      if (!(lp::is_alpha(c) || lp::is_digit(c) || c == '.' || c == '-')) {
        host_ok_cs = false;
        break;
      }
    }
    registry = !host_ok_cs || (has_pcolon && !port_empty && !port_digits);
    for (int p = max(auth_start, lo), e = min(at, hi); p < e; ++p) {
      if (f.byte(p) == '%') { u.ui_fix = true; break; }
    }
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
  u.path_begin = is_abs ? auth_end : (opaque ? first_colon + 1 : start);
  u.path_fix = false;
  for (int p = max(u.path_begin, lo), e = min(first_sep, hi); p < e; ++p) {
    if (f.byte(p) == '%') { u.path_fix = true; break; }
  }
  u.query_fix = false;
  for (int p = max(first_sep, lo); p < hi; ++p) {
    const int c = f.byte(p);
    bool pct_bad = false;
    if (c == '%') {
      const int n1 = p + 1 < W ? f.byte(p + 1) : 0;
      const int n2 = p + 2 < W ? f.byte(p + 2) : 0;
      pct_bad = !(lp::is_hex(n1) && lp::is_hex(n2) && p + 2 < end);
    }
    if (pct_bad || is_enc(c)) { u.query_fix = true; break; }
  }
  u.has_query = !u.all_null && first_sep < end;
  u.is_abs_or_opaque = is_abs || opaque;
  u.ui_show = u.show_auth && has_at;
  u.port_show = u.show_auth && has_pcolon && !port_empty;
  u.ui_fix = u.ui_fix && u.ui_show;
  u.first_colon = first_colon;
  u.first_sep = first_sep;
  u.auth_start = auth_start;
  u.auth_end = auth_end;
  u.at = at;
  u.rest_start = rest_start;
  u.host_end = host_end;
  u.port_start = port_start;
  return u;
}

__global__ void uri_split_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask, int wmask,
    const int32_t* __restrict__ tok_s, const int32_t* __restrict__ tok_e,
    int32_t* __restrict__ comps, int src0, int src1, int src2, bool dash,
    bool need_auth, int window, const int32_t* __restrict__ parts,
    int n_parts, int cons, int over_row) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    auto comp = [&](int r) -> int32_t& { return comps[static_cast<size_t>(r) * B + b]; };
    const lp::Row row{buf + static_cast<size_t>(b) * L, L, mask};
    int s, e;
    bool ok_in = true;
    if (src0 < 0) {
      s = tok_s[b];
      e = tok_e[b];
    } else {
      s = comp(src0);
      e = s + comp(src1);
      ok_in = comp(src2) != 0;
    }
    const bool is_dash = dash && (e - s) == 1 && row.at(s, 0) == '-';
    Frame f{row.p, L, L, -1, mask};
    int ls = s, le = e, off = 0;
    bool over = false;
    if (window < L) {
      f.W = window;
      f.base = s;
      f.mask = wmask;
      ls = 0;
      le = min(e - s, window);
      off = s;
      over = (e - s) > window;
    }
    const Uri u = split_uri(f, ls, le, is_dash, need_auth);
    const bool uri_ok = u.ok || over;
    comp(cons) = (uri_ok || !ok_in) ? 1 : 0;
    comp(over_row) = (over && ok_in) ? 1 : 0;
    const bool step_ok = ok_in && uri_ok;
    for (int t = 0; t < n_parts; ++t) {
      const int32_t* pt = parts + t * URIW;
      const int part = pt[0];
      const int32_t* o = pt + 2;
      if (part == URI_PORT) {
        const int ps = (u.port_show ? u.port_start : ls) + off;
        const int n = (u.port_show ? u.auth_end : ls) + off - ps;
        const lp::LongFrame lf = lp::long_frame(row, ps, n);
        const bool clf = pt[1] != 0;
        const bool is_null = clf && n == 1 && row.at(ps, 0) == '-';
        const bool ok = ((n > 0 && lf.digits_ok) || is_null) && n <= 19;
        comp(o[0]) = static_cast<int>(lf.hi);
        comp(o[1]) = static_cast<int>(lf.lo);
        comp(o[2]) = static_cast<int>(lf.d18);
        comp(o[3]) = min(max(n, 0), 19);
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
        const bool live = step_ok && !null;
        for (int w = 0; w < 3; ++w) {
          comp(pt[9] + w) = static_cast<int>(lp::prefix_word(
              row, start, end - start, live, part == URI_QUERY && amp, w));
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
  const int threads = 128;
  uri_split_kernel<<<lp::grid_for(B, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      lp::gather_mask(window), static_cast<const int32_t*>(tok_s),
      static_cast<const int32_t*>(tok_e), static_cast<int32_t*>(comps), src0,
      src1, src2, dash != 0, need_auth != 0, window,
      static_cast<const int32_t*>(parts), n_parts, cons, over);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_uri_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
