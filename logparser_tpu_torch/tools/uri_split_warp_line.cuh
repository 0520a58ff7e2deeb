// uri_split a warp a line: the layout that uri_split.cu's thread a line
// is measured against.  Not built into the package: the "warp_line"
// variant of tools/uri_variants.json includes it into uri_split.cu's
// anonymous namespace (after split_uri, which that variant makes a
// template over its byte reader) and launches its kernel instead, for
// `python3 -m logparser_tpu_torch.tools.kernel_variants uri_split
// logparser_tpu_torch/tools/uri_variants.json`.
//
// A block takes a tile of 32 lines, its 8 warps a line at a time (lines
// w, w + 8, ...), as csr_split.cu's warp path does.  The warp stages 512
// bytes of the line's frame in one aligned 16-byte load a lane
// (lp::load16_in), then walks the frame 32 bytes a step, a byte a lane:
// each byte class is one ballot word, and walk_groups' bit operations run
// on 32 positions instead of 8, every lane holding the same state.
// split_uri runs on every lane; each part's outputs are made by one lane
// (part t by lane t) into a shared-memory tile of the block's 32 lines,
// which the block writes out a component row at a time (128 bytes a
// store).

constexpr int WL_WARPS = 8;
constexpr int WL_PARTS = 8;                  // parts of a group at most
constexpr int WL_SLOTS = 2 + 9 * WL_PARTS;   // output words of a line
constexpr int WL_WIN = 512;                  // staged line bytes: a 16-byte chunk a lane

// A line's bytes for split_uri: line positions [A, A + WL_WIN) from the
// warp's staged window, the others from the line; the frame as Bytes
// reads it.
struct WarpBytes {
  const uint8_t* line;
  const uint8_t* win;
  int A, L, W, gbase;
  bool windowed;
  __device__ __forceinline__ int line_byte(int q) const {
    return (q >= A && q < A + WL_WIN) ? win[q - A] : line[q];
  }
  __device__ __forceinline__ int line_at(int s, int i, int mask) const {
    const int idx = (s & mask) + i;
    return idx < L ? line_byte(idx) : 0;
  }
  __device__ __forceinline__ int line_pos(int p) const {
    return windowed ? min(max(gbase + p, 0), L - 1) : p;
  }
  __device__ __forceinline__ int frame_byte(int p) const { return line_byte(line_pos(p)); }
  __device__ __forceinline__ int frame_at(int s, int i, int fmask) const {
    const int idx = (s & fmask) + i;
    return idx < W ? frame_byte(idx) : 0;
  }
};

__device__ __forceinline__ uint32_t from32(int x) {
  return x <= 0 ? ~0u : (x >= 32 ? 0u : ~0u << x);
}

// walk_groups over the frame's bytes [lo, hi), 32 positions a step.
__device__ Walk walk_warp(WarpBytes& by, uint8_t* win, const uint16_t* cls, int start, int lo,
                          int hi, bool need_auth, int lane, const uint8_t* buf,
                          const uint8_t* buf_end) {
  const int W = by.W;
  Walk r{W, W, 0, W, W, W, 0, 0, W, -1, -1, W, true, false, false, false, false, false, false};
  bool pct_auth = false;
  uint32_t pend = 0;   // bits of the next 32 bytes a query '%' needs hex
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int q_first = by.line_pos(p0), q_last = by.line_pos(min(p0 + 31, hi - 1));
    if (q_first < by.A || q_last >= by.A + WL_WIN) {   // the same on every lane
      by.A = static_cast<int>(lp::align_down16(by.line + q_first) - by.line);
      __syncwarp();   // the last window's bytes are read
      reinterpret_cast<uint4*>(win)[lane] = lp::load16_in(by.line + by.A + 16 * lane, buf, buf_end);
      __syncwarp();
    }
    const bool in = p0 + lane < hi;
    const unsigned k = in ? cls[by.frame_byte(p0 + lane)] : 0u;
    auto plane = [&](unsigned bit) { return __ballot_sync(lp::FULL, (k & bit) != 0u); };
    const uint32_t vm = __ballot_sync(lp::FULL, in);
    const uint32_t sep = plane(C_SEP), q = plane(C_Q), colon = plane(C_COLON),
                   slash = plane(C_SLASH), pct = plane(C_PCT), atp = plane(C_AT),
                   nondigit = plane(C_NONDIGIT), nonhost = plane(C_NONHOST);
    const uint32_t bad = plane(C_BAD), enc = plane(C_ENC), nonscheme = plane(C_NONSCHEME);
    // A byte past the span's end is no hex digit.
    const uint32_t nonhex = plane(C_NONHEX) | ~vm;
    const uint32_t qr = r.first_sep != W ? vm : (sep ? (0u - (sep & (0u - sep))) & vm : 0u);
    const uint32_t pq = pct & qr;
    if ((pend & nonhex) || (pq & ((nonhex >> 1) | (nonhex >> 2))) || (enc & qr)) {
      r.query_fix = true;
    }
    pend = ((pq >> 30) & 1u) | ((pq >> 31) ? 3u : 0u);
    if (sep && r.first_sep == W) r.first_sep = p0 + __ffs(sep) - 1;
    if (q) {
      if (r.first_q == W) r.first_q = p0 + __ffs(q) - 1;
      r.q_count += __popc(q);
    }
    if (bad) r.clean = false;
    const uint32_t ns = nonscheme & from32(start + 1 - p0);
    if (ns && r.first_nonscheme == W) r.first_nonscheme = p0 + __ffs(ns) - 1;
    if (colon && r.fc == W) r.fc = p0 + __ffs(colon) - 1;
    if (slash && r.first_slash == W) r.first_slash = p0 + __ffs(slash) - 1;
    const uint32_t sa = slash & from32(r.fc + 3 - p0);
    if (sa && r.fc < W && r.slash_a == W) r.slash_a = p0 + __ffs(sa) - 1;
    const uint32_t pp = pct & ~qr;
    if (pp) {
      r.pct_start = true;
      r.pct_fc = r.pct_fc || (pp & from32(r.fc + 1 - p0));
      r.pct_slash = r.pct_slash || (pp & from32(r.slash_a + 1 - p0));
    }
    const uint32_t am = need_auth && r.fc < W
                            ? vm & from32(r.fc + 3 - p0) & ~from32(r.slash_a - p0) & ~qr : 0u;
    if (am) {
      const uint32_t atm = atp & am;
      uint32_t after = am;   // past the last '@'
      if (atm) {
        const int a = 31 - __clz(atm);
        r.at = p0 + a;
        r.colon2 = -1;
        r.first_nonhost = W;
        r.ui_pct = pct_auth || (pct & am & ~from32(a));
        after = am & from32(a + 1);
      }
      const uint32_t cm = colon & after, nh = nonhost & after;
      if (cm) r.colon2 = p0 + 31 - __clz(cm);
      const uint32_t ca = colon & am, nd = nondigit & am & ~atm & ~ca;
      if (ca) {
        r.port_nd = (nd & from32(32 - __clz(ca))) != 0;
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

__global__ void __launch_bounds__(WL_WARPS * 32) uri_warp_line_kernel(Args a) {
  __shared__ __align__(16) uint8_t wins[WL_WARPS][WL_WIN];
  __shared__ int32_t out[WL_SLOTS][33];
  __shared__ int t_s[32], t_e[32], t_ok[32];
  __shared__ uint16_t cls[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls[i] = static_cast<uint16_t>(uri_class(i));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = a.L, B = a.B;
  const uint8_t* buf_end = a.buf + static_cast<size_t>(B) * L;
  const bool windowed = a.window < L;
  const int W = windowed ? a.window : L;
  const int fmask = windowed ? a.wmask : a.mask;
  const int n_tiles = (B + 31) / 32;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = 32 * tile;
    __syncthreads();   // the class table is built, the last tile's rows written
    if (warp == 0) {
      const int b = b0 + lane;
      int s = 0, e = 0, ok_in = 1;
      if (b < B) {
        if (a.src0 < 0) {
          s = a.tok_s[b];
          e = a.tok_e[b];
        } else {
          s = a.comps[static_cast<size_t>(a.src0) * B + b];
          e = s + a.comps[static_cast<size_t>(a.src1) * B + b];
          ok_in = a.comps[static_cast<size_t>(a.src2) * B + b] != 0;
        }
      }
      t_s[lane] = s;
      t_e[lane] = e;
      t_ok[lane] = ok_in;
    }
    __syncthreads();
    for (int li = warp; li < 32 && b0 + li < B; li += WL_WARPS) {
      const int s = t_s[li], e = t_e[li];
      const bool ok_in = t_ok[li] != 0;
      const uint8_t* line = a.buf + static_cast<size_t>(b0 + li) * L;
      const int gbase = windowed ? s : 0, ls = windowed ? 0 : s;
      const int le = windowed ? min(e - s, a.window) : e, off = windowed ? s : 0;
      const bool over = windowed && (e - s) > a.window;
      const int lo = max(ls, 0), hi = min(le, W);
      WarpBytes by{line, wins[warp], -(1 << 30), L, W, gbase, windowed};
      const bool is_dash = a.dash && (e - s) == 1 && by.line_at(s, 0, a.mask) == '-';
      const Walk r = walk_warp(by, wins[warp], cls, ls, lo, hi, a.need_auth, lane, a.buf, buf_end);
      const Uri u = split_uri(by, r, ls, le, lo, hi, fmask, is_dash, a.need_auth);
      const bool uri_ok = u.ok || over;
      const bool step_ok = ok_in && uri_ok;
      if (lane == 0) {
        out[0][li] = (uri_ok || !ok_in) ? 1 : 0;
        out[1][li] = (over && ok_in) ? 1 : 0;
      }
      for (int t = lane; t < a.n_parts; t += 32) {
        const int32_t* pt = a.parts + t * URIW;
        const int part = pt[0];
        int32_t* o = &out[2 + 9 * t][li];   // output k at o[33 * k]
        if (part == URI_PORT) {
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
          o[0] = static_cast<int>(hi9);
          o[33] = static_cast<int>(lo9);
          o[33 * 2] = static_cast<int>(d18);
          o[33 * 3] = min(max(n_port, 0), 19);
          o[33 * 4] = ok ? 1 : 0;
          o[33 * 5] = is_null ? 1 : 0;
          o[33 * 6] = 0;
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
        } else {
          start = end = s - off;
          null = true;
        }
        start += off;
        end += off;
        o[0] = start;
        o[33] = end - start;
        o[33 * 2] = step_ok ? 1 : 0;
        o[33 * 3] = null ? 1 : 0;
        o[33 * 4] = amp ? 1 : 0;
        o[33 * 5] = fix ? 1 : 0;
        if (pt[9] >= 0) {
          const bool live = step_ok && !null;
          const int n_part = end - start;
          for (int w = 0; w < 3; ++w) {
            uint32_t word = 0u;
            if (live) {
              for (int j = 0; j < 4 && 4 * w + j < n_part; ++j) {
                word |= static_cast<uint32_t>(by.line_at(start, 4 * w + j, a.mask)) << (8 * j);
              }
            }
            if (w == 0 && part == URI_QUERY && amp && (word & 0xFFu) == '?') word ^= '?' ^ '&';
            o[33 * (6 + w)] = static_cast<int>(word);
          }
        }
      }
    }
    __syncthreads();
    // The tile's rows, a row a warp at a time, a line a lane.
    const int b = b0 + lane;
    if (b < B) {
      for (int k = warp; k < 2 + 9 * a.n_parts; k += WL_WARPS) {
        int row = k == 0 ? a.cons : a.over_row;
        if (k >= 2) {
          const int32_t* pt = a.parts + ((k - 2) / 9) * URIW;
          const int j = (k - 2) % 9;
          row = pt[0] == URI_PORT ? (j < 7 ? pt[2 + j] : -1)
                                  : (j < 6 ? pt[2 + j] : (pt[9] >= 0 ? pt[9] + j - 6 : -1));
        }
        if (row >= 0) a.comps[static_cast<size_t>(row) * B + b] = out[k][lane];
      }
    }
  }
}
