// Kernel 6: the CSR split of one query-string or cookie group.
//
// Replaces, from logparser_tpu/tpu: postproc.py split_csr (with its byte
// class table _csr_class_table) and the qscsr branch of pipeline.py
// compute_rows (a URI query part starts past a leading '?', a direct
// token's span takes the CLF-dash guard, each slot packs into its two
// layout words).
//
// One thread per line.  The input span is a URI query part (three
// component rows: start, len, ok) or a token's cursors (a Cookie header:
// the separator is the two bytes "; ", both inside the span, and the
// cursor moves past both; no '?' skip, no URI encode set in the class
// table; ok is "not a lone '-'").  As in the reference, the split runs
// in a frame: the whole line when the window W = 8 * slots is at least
// L, else W bytes gathered from the span start, the span cut to W bytes
// (a longer span overflows), every position rebased by the start.  The
// reference finds each slot's separator and '=' with suffix-min planes
// and its flags with prefix counts (the TPU's way to avoid a sequential
// scan); here one walk from the cursor to the next '&' gives the same
// segment: its first '=', whether the value holds a decode trigger
// (%, +, encode set), and whether the name holds an escape trigger or a
// high byte.  Per slot it writes start | nlen<<13 | eq<<26 | dec<<27 |
// ndec<<28 | nhigh<<29 and vstart | vlen<<13, then ok and overflow & ok:
// 2 * slots + 2 int32 rows of the unit block, coalesced across threads.
// Per-line state is a cursor, so the 128-slot cap (1024-byte window)
// needs no shared memory beyond the 256-entry class table.
//
// Bound: bytes -- the query span (at most W bytes a line) read once, the
// input rows read and the 2 * slots + 2 output rows written once.

#include "lp_common.cuh"

namespace {

constexpr int DEC = 1, PCT = 2, HIGH = 4, KV = 8, SEP = 16;
constexpr int SPAN_MASK = (1 << 13) - 1;

__global__ void csr_split_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    int32_t* __restrict__ comps, const int32_t* __restrict__ tok_s,
    const int32_t* __restrict__ tok_e, int src0, int src1, int src2,
    const int32_t* __restrict__ cls_table, int n_sep, int sep0, int sep1,
    int slots, int window, int words, int ok_row, int over_row) {
  __shared__ uint8_t cls[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    cls[i] = static_cast<uint8_t>(cls_table[i]);
  }
  __syncthreads();
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    auto comp = [&](int r) -> int32_t& { return comps[static_cast<size_t>(r) * B + b]; };
    const lp::Row row{buf + static_cast<size_t>(b) * L, L, mask};
    int s, e;
    bool chain_ok;
    if (src0 < 0) {
      s = tok_s[b];
      e = tok_e[b];
      chain_ok = !((e - s) == 1 && row.at(s, 0) == '-');
    } else {
      s = comp(src0);
      e = s + comp(src1);
      chain_ok = comp(src2) != 0;
      if (s < e && row.at(s, 0) == '?') ++s;   // the query's leading '?'
    }
    // The frame: the line, or the window gathered from s.
    int W = L, base = -1, ls = s, le = e, off = 0;
    bool over = false;
    if (window < L) {
      W = window;
      base = s;
      ls = 0;
      le = min(e - s, window);
      off = s;
      over = (e - s) > window;
    }
    auto byte = [&](int p) -> int {
      if (base < 0) return row.p[p];
      return row.p[min(max(base + p, 0), L - 1)];
    };
    const int lo = max(ls, 0), hi = min(le, W);
    // A separator starts at p (p in [lo, hi)).
    auto is_sep = [&](int p, int c) -> bool {
      if (n_sep == 1) return (c & SEP) != 0;
      return byte(p) == sep0 && p + 2 <= le && byte(p + 1) == sep1;
    };
    // Any byte of class `bit` in [a, c) of the span.
    auto any_in = [&](int a, int c, int bit) -> bool {
      for (int p = max(a, lo), end = min(c, hi); p < end; ++p) {
        if (cls[byte(p)] & bit) return true;
      }
      return false;
    };
    int cursor = ls;
    for (int k = 0; k < slots; ++k) {
      int nxt = W, kv = W;
      if (cursor < W) {
        for (int p = max(cursor, lo); p < hi; ++p) {
          const int c = cls[byte(p)];
          if ((c & KV) && kv == W) kv = p;
          if (is_sep(p, c)) { nxt = p; break; }
        }
      }
      const int s_end = min(nxt, le);
      const int eq = min(kv, s_end);
      const bool dec = any_in(min(eq + 1, s_end), s_end, DEC);
      const bool ndec = any_in(min(cursor, eq), eq, PCT);
      const bool nhigh = any_in(min(cursor, eq), eq, HIGH);
      const int seg_s = cursor + off, seg_e = s_end + off, eq_g = eq + off;
      const bool seg_empty = seg_s >= seg_e;
      const int nlen = seg_empty ? 0 : eq_g - seg_s;
      const bool has_eq = !seg_empty && eq_g < seg_e;
      const int vstart = min(eq_g + 1, seg_e);
      const int vlen = has_eq ? seg_e - vstart : 0;
      const uint32_t n_word =
          (static_cast<uint32_t>(seg_empty ? 0 : seg_s) & SPAN_MASK) |
          ((static_cast<uint32_t>(nlen) & SPAN_MASK) << 13) |
          (has_eq ? 1u << 26 : 0u) | (dec ? 1u << 27 : 0u) |
          (ndec ? 1u << 28 : 0u) | (nhigh ? 1u << 29 : 0u);
      const uint32_t v_word =
          (static_cast<uint32_t>(has_eq ? vstart : 0) & SPAN_MASK) |
          ((static_cast<uint32_t>(vlen) & SPAN_MASK) << 13);
      comp(words + 2 * k) = static_cast<int>(n_word);
      comp(words + 2 * k + 1) = static_cast<int>(v_word);
      cursor = s_end + n_sep;
    }
    // One more separator past the last slot, or span left over.
    bool more = cursor < le;
    if (!more && cursor < W) {
      for (int p = max(cursor, lo); p < hi; ++p) {
        if (is_sep(p, cls[byte(p)])) { more = true; break; }
      }
    }
    comp(ok_row) = chain_ok ? 1 : 0;
    comp(over_row) = ((more || over) && chain_ok) ? 1 : 0;
  }
}

}  // namespace

LP_EXPORT int lp_csr_split(const void* buf, int B, int L, void* comps,
                           const void* tok_s, const void* tok_e, int src0,
                           int src1, int src2, const void* cls, int n_sep,
                           int sep0, int sep1, int slots, int window, int words,
                           int ok_row, int over_row, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  csr_split_kernel<<<lp::grid_for(B, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<int32_t*>(comps), static_cast<const int32_t*>(tok_s),
      static_cast<const int32_t*>(tok_e), src0, src1, src2,
      static_cast<const int32_t*>(cls), n_sep, sep0, sep1, slots, window, words,
      ok_row, over_row);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_csr_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
