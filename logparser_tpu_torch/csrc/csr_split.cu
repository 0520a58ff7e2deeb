// Kernel 6: the CSR split of one query-string or cookie group.
//
// Replaces, from logparser_tpu/tpu: postproc.py split_csr (with its byte
// class table _csr_class_table) and the qscsr branch of pipeline.py
// compute_rows (a URI query part starts past a leading '?', a direct
// token's span takes the CLF-dash guard, each slot packs into its two
// layout words).
//
// The input span is a URI query part (three component rows: start, len,
// ok) or a token's cursors (a Cookie header: the separator is the two
// bytes "; ", both inside the span, and the cursor moves past both; no '?'
// skip, no URI encode set in the class table; ok is "not a lone '-'").  As
// in the reference, the split runs in a frame: the whole line when the
// window W = 8 * slots is at least L, else W bytes gathered from the span
// start (positions clamped to [0, L - 1]), the span cut to W bytes (a
// longer span overflows), every position rebased by the start.  A frame
// holds at most 1,024 bytes (slots <= 128).
//
// One grid of 8-warp blocks, a block a tile of 32 consecutive lines; each
// tile takes one of two paths, by its raw spans (short_tile):
//
// - a thread a line, where the raw spans are all at most 64 bytes (every
//   query string of the URI chain's corpus), a warp a tile, the first
//   eighth of the blocks each taking 8 tiles: the frame's bytes come in
//   as aligned 16-byte loads, each class (SEP, KV, DEC, PCT, HIGH) becomes
//   a 64-bit mask, the slots are bit operations on the masks, and every
//   output row is written straight from the thread (the warp's 32
//   consecutive lines: 128 bytes);
// - else a warp a line, the block's 8 warps on its own tile (most tiles of
//   cookie headers):
//   stage: the span's bytes of the frame, [lo, hi), into the warp's
//   shared memory with 16-byte loads (aligned down; the bytes around the
//   span are loaded and masked off; a chunk that reaches past either end
//   of the buffer byte by byte), or byte by byte where the window's clamp
//   bites;
//   classify: the frame's 32-byte strides, one byte a lane, each class
//   one __ballot_sync a stride; lane w keeps stride w's words, so the
//   warp holds every class as a 1,024-bit mask.  The two-byte separator
//   "; " is the ';' word ANDed with the ' ' word shifted down a bit (bit
//   31 from the next lane's word), both bytes in the span.  No byte is
//   read twice;
//   segments: neither "; " nor '&' overlaps itself, so slot k's segment
//   ends at the k-th separator of the span (the popcount prefix over the
//   lanes' separator words places each one), the cursor after the last
//   separator at the span's end.  A lane a slot: the segment's first '='
//   is the first KV bit at or past its cursor, and its dec / ndec / nhigh
//   flags are "any bit between" tests (the two end words by shuffles, the
//   words between from a ballot of the non-zero ones).  Slots past the
//   one after the last separator are empty, and not computed;
//   write: each line's 2 * slots + 2 words go to a shared-memory tile
//   [32 lines][2 * slots + 2], which the block then writes row by row:
//   32 consecutive lines of a component row, 128 bytes a warp.
//
// Unused slots are written as zero words.
//
// Per slot: start | nlen<<13 | eq<<26 | dec<<27 | ndec<<28 | nhigh<<29 and
// vstart | vlen<<13, then ok (chain_ok) and overflow ("a separator or span
// left after the last slot, or the span longer than the window") & ok.
//
// Bound: bytes -- the query span (at most W bytes a line) read once, the
// input rows read and the 2 * slots + 2 output rows written once.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int DEC = 1, PCT = 2, HIGH = 4, KV = 8, SEP = 16;
constexpr int SPAN_MASK = (1 << 13) - 1;
constexpr int WARPS = 8;
constexpr int TILE = 32;                 // lines a block writes at once
constexpr int MAX_FRAME = 1024;          // one 32-bit mask word a lane
constexpr int FRAME_BYTES = MAX_FRAME + 64;
constexpr int THREAD_FRAME = 64;         // frames a thread splits alone

// Any set bit of a class mask in [a, c): the lane holding word w has
// `word`, and `nonzero` has bit w set when word w is non-zero.
__device__ __forceinline__ bool any_between(unsigned word, unsigned nonzero, int a, int c) {
  a = max(a, 0);
  c = min(c, MAX_FRAME);
  const int wa = min(a >> 5, 31), wc = max(c - 1, 0) >> 5;
  const unsigned first = __shfl_sync(lp::FULL, word, wa) & (~0u << (a & 31));
  const unsigned last = __shfl_sync(lp::FULL, word, wc) & (~0u >> (31 - ((c - 1) & 31)));
  if (a >= c) return false;
  if (wa == wc) return (first & last) != 0;
  const unsigned between = nonzero & ((1u << wc) - 1u) & ~((2u << wa) - 1u);
  return first || last || between;
}

// The first set bit at or past x, else `none`; `nonzero` has bit w set
// when word w is non-zero.
__device__ __forceinline__ int first_from(unsigned word, unsigned nonzero, int x,
                                          int none) {
  x = max(x, 0);
  const bool past = x >= MAX_FRAME;
  const int w = min(x >> 5, 31);
  const unsigned here =
      __shfl_sync(lp::FULL, word, w) & (past ? 0u : (~0u << (x & 31)));
  const unsigned rest = (past || w == 31) ? 0u : (nonzero & (~0u << (w + 1)));
  const int w2 = rest ? __ffs(rest) - 1 : 0;
  const unsigned next = __shfl_sync(lp::FULL, word, w2);
  if (here) return 32 * w + __ffs(here) - 1;
  if (rest) return 32 * w2 + __ffs(next) - 1;
  return none;
}

// The bits at or past x of a 64-bit mask.
__device__ __forceinline__ uint64_t bits_from(int x) {
  return x <= 0 ? ~0ull : (x >= 64 ? 0ull : ~0ull << x);
}

// The bits in [a, c) of a 64-bit mask.
__device__ __forceinline__ uint64_t bits_in(int a, int c) {
  a = max(a, 0);
  c = min(c, 64);
  if (a >= c) return 0ull;
  return (~0ull << a) & (c == 64 ? ~0ull : (1ull << c) - 1ull);
}

// Inclusive sum of v over lanes <= this one.
__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(lp::FULL, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Slot k's two words (the segment [cursor, s_end) of the frame, its first
// '=' at eq, its flags), rebased by off.
__device__ __forceinline__ int2 slot_words(int cursor, int s_end, int eq, bool dec, bool ndec,
                                           bool nhigh, int off) {
  const int seg_s = cursor + off, seg_e = s_end + off, eq_g = eq + off;
  const bool seg_empty = seg_s >= seg_e;
  const int nlen = seg_empty ? 0 : eq_g - seg_s;
  const bool has_eq = !seg_empty && eq_g < seg_e;
  const int vstart = min(eq_g + 1, seg_e);
  const int vlen = has_eq ? seg_e - vstart : 0;
  const uint32_t n_word =
      (static_cast<uint32_t>(seg_empty ? 0 : seg_s) & SPAN_MASK) |
      ((static_cast<uint32_t>(nlen) & SPAN_MASK) << 13) | (has_eq ? 1u << 26 : 0u) |
      (dec ? 1u << 27 : 0u) | (ndec ? 1u << 28 : 0u) | (nhigh ? 1u << 29 : 0u);
  const uint32_t v_word = (static_cast<uint32_t>(has_eq ? vstart : 0) & SPAN_MASK) |
                          ((static_cast<uint32_t>(vlen) & SPAN_MASK) << 13);
  return make_int2(static_cast<int>(n_word), static_cast<int>(v_word));
}

// The kernels' arguments.
struct Args {
  const uint8_t* buf;
  int B, L, mask;
  int32_t* comps;
  const int32_t* tok_s;
  const int32_t* tok_e;
  int src0, src1, src2;
  const int32_t* cls;
  int n_sep, sep0, sep1, slots, window, words, ok_row, over_row;
};

// Line b's raw span [s, e) (a token's cursors, or the query part's rows)
// and its ok from the input rows.
__device__ __forceinline__ void raw_span(const Args& a, int b, int& s, int& e, bool& ok) {
  if (a.src0 < 0) {
    s = a.tok_s[b];
    e = a.tok_e[b];
    ok = true;
  } else {
    s = a.comps[static_cast<size_t>(a.src0) * a.B + b];
    e = s + a.comps[static_cast<size_t>(a.src1) * a.B + b];
    ok = a.comps[static_cast<size_t>(a.src2) * a.B + b] != 0;
  }
}

// The aligned 16-byte chunk at q, its bytes past either end of the [B, L]
// buffer read as 0 (an aligned load around a span may reach past them).
__device__ __forceinline__ uint4 chunk_at(const Args& a, const uint4* q) {
  return lp::load16_in(reinterpret_cast<const uint8_t*>(q), a.buf,
                       a.buf + static_cast<size_t>(a.B) * a.L);
}

// The span as the split takes it: a token's ok is "not a lone '-'", a
// query part starts past a leading '?'.
__device__ __forceinline__ void take_span(const Args& a, const lp::Row& row, int& s, int e,
                                          bool& ok) {
  if (a.src0 < 0) {
    ok = !((e - s) == 1 && row.at(s, 0) == '-');
  } else if (s < e && row.at(s, 0) == '?') {
    ++s;
  }
}

// A line's frame: positions [0, W) read bytes gbase + p of the line (the
// window clamped to [0, L - 1]); the span is [ls, le), its bytes in the
// frame [lo, hi); output positions are rebased by off.
struct Frame {
  int W, gbase, ls, le, off, lo, hi;
  bool over;   // the span is longer than the window
};

__device__ __forceinline__ Frame frame_of(int s, int e, int window, int L) {
  const bool windowed = window < L;
  Frame f;
  f.W = windowed ? window : L;
  f.gbase = windowed ? s : 0;
  f.ls = windowed ? 0 : s;
  f.le = windowed ? min(e - s, window) : e;
  f.off = windowed ? s : 0;
  f.over = windowed && (e - s) > window;
  f.lo = max(f.ls, 0);
  f.hi = min(f.le, f.W);
  return f;
}

// Whether the tile of 32 lines holding line b is split a thread a line:
// every line's raw span is at most THREAD_FRAME bytes (and so is its frame).
__device__ __forceinline__ bool short_tile(int b, int B, int s, int e) {
  return __all_sync(lp::FULL, b >= B || e - s <= THREAD_FRAME);
}

// A thread a line, on a tile whose lines are all short: line b's slots from
// 64-bit class masks, every output row written straight from the thread (a
// warp's 32 consecutive lines, 128 bytes a row).
__device__ __forceinline__ void short_line(const Args& a, const uint8_t* cls, int b, int s,
                                           int e, bool chain_ok) {
  const lp::Row row{a.buf + static_cast<size_t>(b) * a.L, a.L, a.mask};
  take_span(a, row, s, e, chain_ok);
  const Frame f = frame_of(s, e, a.window, a.L);
  const int lo = f.lo, len = f.hi - f.lo;
  // Bit i of a mask: frame position lo + i.
  uint64_t kv = 0, dec = 0, pct = 0, high = 0, sep = 0, nxt = 0;
  auto classify = [&](int c, int i) {
    const int k = cls[c];
    const uint64_t bit = 1ull << i;
    if (k & KV) kv |= bit;
    if (k & DEC) dec |= bit;
    if (k & PCT) pct |= bit;
    if (k & HIGH) high |= bit;
    if (a.n_sep == 1 ? (k & SEP) != 0 : c == a.sep0) sep |= bit;
    if (c == a.sep1) nxt |= bit;
  };
  if (len > 0 && f.gbase + lo >= 0 && f.gbase + f.hi <= a.L) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(row.p + f.gbase + lo);
    const uint4* q = reinterpret_cast<const uint4*>(at & ~static_cast<uintptr_t>(15));
    const int skew = static_cast<int>(at & 15);
    for (int ch = 0; 16 * ch < skew + len; ++ch) {
      const uint4 v = chunk_at(a, q + ch);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 16 * ch + j - skew;
        if (i >= 0 && i < len) classify((w[j >> 2] >> (8 * (j & 3))) & 0xFF, i);
      }
    }
  } else {
    for (int i = 0; i < len; ++i) classify(row.p[min(max(f.gbase + lo + i, 0), a.L - 1)], i);
  }
  if (a.n_sep == 2) sep &= nxt >> 1;
  const int n = __popcll(sep);
  const int E = min(f.W, f.le);   // a segment's end past the last separator
  int cursor = f.ls;
  for (int k = 0; k < a.slots; ++k) {
    int2 pair = make_int2(0, 0);   // past the segment after the last separator
    if (k <= n) {
      const int s_end = k < n ? lo + __ffsll(sep) - 1 : E;
      const uint64_t kv_from = kv & bits_from(max(cursor, lo) - lo);
      const int eq = min(kv_from ? lo + __ffsll(kv_from) - 1 : f.W, s_end);
      const bool d = (dec & bits_in(min(eq + 1, s_end) - lo, s_end - lo)) != 0;
      const bool nd = (pct & bits_in(min(cursor, eq) - lo, eq - lo)) != 0;
      const bool nh = (high & bits_in(min(cursor, eq) - lo, eq - lo)) != 0;
      pair = slot_words(cursor, s_end, eq, d, nd, nh, f.off);
      if (k < n) {
        cursor = s_end + a.n_sep;
        sep &= sep - 1;
      }
    }
    a.comps[static_cast<size_t>(a.words + 2 * k) * a.B + b] = pair.x;
    a.comps[static_cast<size_t>(a.words + 2 * k + 1) * a.B + b] = pair.y;
  }
  // One more separator past the last slot, or span left over.
  const int last = a.slots - 1 < n ? cursor : E + a.n_sep;
  const bool more = n > a.slots || last < f.le;
  a.comps[static_cast<size_t>(a.ok_row) * a.B + b] = chain_ok ? 1 : 0;
  a.comps[static_cast<size_t>(a.over_row) * a.B + b] = ((more || f.over) && chain_ok) ? 1 : 0;
}

// Two passes over the tiles of 32 lines.  A thread a line: warp w of
// block k takes tile 8k + w, if its spans are all short (the first eighth
// of the blocks).  A warp a line: block k takes tile k, if it holds a
// longer span, its 8 warps through a tile of 32 lines in shared memory.
__global__ void __launch_bounds__(WARPS * 32) csr_split_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int slots = a.slots, n_sep = a.n_sep;
  const int P = 2 * slots + 2;                 // words a line
  int32_t* tile_out = reinterpret_cast<int32_t*>(smem);
  int* in_s = tile_out + TILE * P;
  int* in_e = in_s + TILE;
  int* in_ok = in_e + TILE;
  int* used = in_ok + TILE;                    // slots written to tile_out a line
  uint8_t* cls = reinterpret_cast<uint8_t*>(used + TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* frame = cls + 256 + warp * FRAME_BYTES;
  int* seps = reinterpret_cast<int*>(cls + 256 + WARPS * FRAME_BYTES) + warp * slots;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls[i] = static_cast<uint8_t>(a.cls[i]);
  __syncthreads();
  const int n_tiles = (a.B + TILE - 1) / TILE;
  for (int tile = blockIdx.x * WARPS + warp; tile < n_tiles; tile += gridDim.x * WARPS) {
    const int b = tile * TILE + lane;
    int s = 0, e = 0;
    bool ok = false;
    if (b < a.B) raw_span(a, b, s, e, ok);
    if (short_tile(b, a.B, s, e) && b < a.B) short_line(a, cls, b, s, e, ok);
  }
  for (int b0 = blockIdx.x * TILE; b0 < a.B; b0 += gridDim.x * TILE) {
    const int n_lines = min(TILE, a.B - b0);
    bool long_tile = false;
    if (warp == 0) {
      const int b = b0 + lane;
      int s = 0, e = 0;
      bool ok = false;
      if (b < a.B) raw_span(a, b, s, e, ok);
      long_tile = !short_tile(b, a.B, s, e);
      if (long_tile && b < a.B) {
        const lp::Row row{a.buf + static_cast<size_t>(b) * a.L, a.L, a.mask};
        take_span(a, row, s, e, ok);
        in_s[lane] = s;
        in_e[lane] = e;
        in_ok[lane] = ok;
      }
    }
    if (!__syncthreads_or(long_tile)) continue;
    for (int li = warp; li < n_lines; li += WARPS) {
      const lp::Row row{a.buf + static_cast<size_t>(b0 + li) * a.L, a.L, a.mask};
      const bool chain_ok = in_ok[li] != 0;
      const Frame f = frame_of(in_s[li], in_e[li], a.window, a.L);
      const int lo = f.lo, hi = f.hi, gbase = f.gbase, ls = f.ls, le = f.le;
      int32_t* out = tile_out + li * P;

      // stage [lo, hi): frame position p at frame[p + sh].
      int sh = -lo;
      __syncwarp();   // the previous line's frame and separators are read
      if (hi > lo) {
        if (gbase + lo >= 0 && gbase + hi <= a.L) {
          const uintptr_t at = reinterpret_cast<uintptr_t>(row.p + gbase + lo);
          const uintptr_t a0 = at & ~static_cast<uintptr_t>(15);
          const uintptr_t a1 = (reinterpret_cast<uintptr_t>(row.p + gbase + hi) + 15) &
                               ~static_cast<uintptr_t>(15);
          const int n_chunks = static_cast<int>((a1 - a0) >> 4);
          const uint4* src = reinterpret_cast<const uint4*>(a0);
          uint4* dst = reinterpret_cast<uint4*>(frame);
          for (int i = lane; i < n_chunks; i += 32) dst[i] = chunk_at(a, src + i);
          sh = static_cast<int>(at & 15) - lo;
        } else {
          for (int p = lo + lane; p < hi; p += 32) {
            frame[p - lo] = row.p[min(max(gbase + p, 0), a.L - 1)];
          }
        }
      }
      __syncwarp();

      // classify: lane w keeps stride w's class words.
      unsigned m_kv = 0, m_dec = 0, m_pct = 0, m_high = 0, m_sep = 0, m_next = 0;
      if (hi > lo) {
        for (int w = lo >> 5; w <= (hi - 1) >> 5; ++w) {
          const int p = 32 * w + lane;
          const bool in = p >= lo && p < hi;
          const int c = in ? frame[p + sh] : 0;
          const int k = in ? cls[c] : 0;
          const unsigned kv = __ballot_sync(lp::FULL, k & KV);
          const unsigned dec = __ballot_sync(lp::FULL, k & DEC);
          const unsigned pct = __ballot_sync(lp::FULL, k & PCT);
          const unsigned high = __ballot_sync(lp::FULL, k & HIGH);
          const unsigned sp = __ballot_sync(lp::FULL, n_sep == 1 ? (k & SEP) != 0
                                                                 : (in && c == a.sep0));
          const unsigned nx = __ballot_sync(lp::FULL, in && c == a.sep1);
          if (lane == w) {
            m_kv = kv; m_dec = dec; m_pct = pct; m_high = high; m_sep = sp; m_next = nx;
          }
        }
      }
      if (n_sep == 2) {
        const unsigned up = __shfl_down_sync(lp::FULL, m_next, 1);
        m_sep &= (m_next >> 1) | (lane < 31 ? up << 31 : 0u);
      }

      // segments: the separators in order.
      const int n_here = __popc(m_sep);
      const int sep_incl = warp_scan(n_here, lane);
      const int n = __shfl_sync(lp::FULL, sep_incl, 31);
      {
        unsigned m = m_sep;
        for (int idx = sep_incl - n_here; m && idx < slots; ++idx, m &= m - 1) {
          seps[idx] = 32 * lane + __ffs(m) - 1;
        }
      }
      const unsigned nz_kv = __ballot_sync(lp::FULL, m_kv != 0);
      const unsigned nz_dec = __ballot_sync(lp::FULL, m_dec != 0);
      const unsigned nz_pct = __ballot_sync(lp::FULL, m_pct != 0);
      const unsigned nz_high = __ballot_sync(lp::FULL, m_high != 0);
      __syncwarp();

      const int E = min(f.W, le);   // a segment's end past the last separator
      int k0 = 0;
      for (; k0 < slots && k0 <= n; k0 += 32) {
        const int k = k0 + lane;
        const bool act = k < slots;
        const int s_end = (act && k < n) ? seps[k] : E;
        const int cursor = k == 0 ? ls
                           : (act && k - 1 < n) ? seps[k - 1] + n_sep : E + n_sep;
        const int eq = min(first_from(m_kv, nz_kv, max(cursor, lo), f.W), s_end);
        const bool dec = any_between(m_dec, nz_dec, min(eq + 1, s_end), s_end);
        const bool ndec = any_between(m_pct, nz_pct, min(cursor, eq), eq);
        const bool nhigh = any_between(m_high, nz_high, min(cursor, eq), eq);
        if (act) {
          *reinterpret_cast<int2*>(out + 2 * k) =
              slot_words(cursor, s_end, eq, dec, ndec, nhigh, f.off);
        }
      }
      if (lane == 0) {
        // One more separator past the last slot, or span left over.
        const int last = slots - 1 < n ? seps[slots - 1] + n_sep : E + n_sep;
        const bool more = n > slots || last < le;
        out[2 * slots] = chain_ok ? 1 : 0;
        out[2 * slots + 1] = ((more || f.over) && chain_ok) ? 1 : 0;
        used[li] = min(k0, slots);
      }
    }
    __syncthreads();
    // The tile, a component row at a time: 32 consecutive lines a warp.
    for (int i = threadIdx.x; i < P * TILE; i += blockDim.x) {
      const int r = i / TILE, li = i % TILE;
      if (li < n_lines) {
        int32_t v;
        int orow;
        if (r < 2 * slots) {
          orow = a.words + r;
          v = r < 2 * used[li] ? tile_out[li * P + r] : 0;
        } else {
          orow = r == 2 * slots ? a.ok_row : a.over_row;
          v = tile_out[li * P + r];
        }
        a.comps[static_cast<size_t>(orow) * a.B + b0 + li] = v;
      }
    }
    __syncthreads();   // the tile and the inputs are free again
  }
}

}  // namespace

// One grid, a block of 8 warps a tile of 32 lines: a thread a line on the
// tiles of raw spans of at most 64 bytes (8 tiles a block, the first
// eighth of the blocks), a warp a line on the others.
LP_EXPORT int lp_csr_split(const void* buf, int B, int L, void* comps,
                           const void* tok_s, const void* tok_e, int src0,
                           int src1, int src2, const void* cls, int n_sep,
                           int sep0, int sep1, int slots, int window, int words,
                           int ok_row, int over_row, void* stream) {
  if (B <= 0) return 0;
  if (slots < 1 || (window < L ? window : L) > MAX_FRAME || n_sep < 1 || n_sep > 2 ||
      (n_sep == 2 && sep0 == sep1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
               static_cast<int32_t*>(comps), static_cast<const int32_t*>(tok_s),
               static_cast<const int32_t*>(tok_e), src0, src1, src2,
               static_cast<const int32_t*>(cls), n_sep, sep0, sep1, slots, window, words,
               ok_row, over_row};
  const size_t smem = static_cast<size_t>(TILE) * (2 * slots + 2) * 4 + 4 * TILE * 4 + 256 +
                      WARPS * FRAME_BYTES + static_cast<size_t>(WARPS) * slots * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (B + TILE - 1) / TILE;
  csr_split_kernel<<<tiles < (1 << 20) ? tiles : (1 << 20), WARPS * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_csr_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
