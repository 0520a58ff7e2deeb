// Kernel 13: the Set-Cookie split of one Set-Cookie CSR group.
//
// Replaces, from logparser_tpu/tpu: postproc.py split_setcookie_csr (with
// _ci_literal_mask) and the setcookie branch of pipeline.py compute_rows
// (the CLF-dash guard, each slot packed into its two layout words, the
// bad and overflow line constraints).
//
// One thread per line, walking from the cursor as csr_split does; no
// [B, L] planes.  The reference finds every separator, ';', '=' and
// case-insensitive "expires=" with masked first-occurrence reductions
// over [B, L] planes, once per slot; here each is a forward scan from the
// cursor that stops at its first hit, so a line costs a few passes over
// its own header.  Per slot k (the reference's order of decisions):
//   s_end  = first ", " at or after the cursor whose 2 bytes end by the
//            span end (else the end);
//   exp    = first case-insensitive "expires=" at or after the cursor
//            whose 8 bytes end by s_end; hold = exp > s_end - 15;
//   the same two at s_end + 2 give s_end2 / hold2; a held part that is
//   not the last glues to the next (seg_e = s_end2), not checked again,
//   and bad |= hold2 there; a held last part is dropped (emit false);
//   name_end = min(eq, semi, seg_e), '=' searched only before
//   min(semi, seg_e); an emitted part with a case-insensitive
//   "set-cookie" at the cursor (bytes past the span read, 0 past L) sets
//   bad; the cursor moves to seg_e + 2, even past the end.
// Overflow: a separator at or after the final cursor, or the cursor short
// of the end.  Outputs per slot start | nlen<<13 | emit<<26 and
// vstart | vlen<<13 (the whole part as the value), then ok (not a CLF
// dash), bad & ok and overflow & ok: 2 * slots + 3 int32 rows of the unit
// block, coalesced across threads.
//
// Bound: bytes -- the header span read once, the token cursors read and
// the 2 * slots + 3 rows written once.

#include "lp_common.cuh"

namespace {

constexpr int SPAN_MASK = (1 << 13) - 1;
constexpr int MIN_EXPIRES = 15;   // len("expires=XXXXXXX")

struct Line {
  const uint8_t* p;
  int L, s, e;
  __device__ __forceinline__ int at(int i) const { return i < L ? p[i] : 0; }
  // Case-insensitive literal at i (letters by | 0x20), bytes past L as 0.
  __device__ bool ci(int i, const char* lit, int n) const {
    for (int k = 0; k < n; ++k) {
      const int c = at(i + k), want = lit[k];
      const bool letter = want >= 'a' && want <= 'z';
      if ((letter ? (c | 0x20) : c) != want) return false;
    }
    return true;
  }
  // First ", " at or after `from` inside the span; L when none.
  __device__ int sep(int from) const {
    for (int i = max(from, s); i + 2 <= e; ++i) {
      if (p[i] == ',' && p[i + 1] == ' ') return i;
    }
    return L;
  }
  // First "expires=" at or after `from` ending by `lim`; L when none.
  __device__ int expires(int from, int lim) const {
    for (int i = max(from, s); i + 8 <= lim; ++i) {
      if (ci(i, "expires=", 8)) return i;
    }
    return L;
  }
  // First byte c in [from, lim) inside the span; L when none.
  __device__ int find(int from, int lim, int c) const {
    for (int i = max(from, s), hi = min(lim, e); i < hi; ++i) {
      if (p[i] == c) return i;
    }
    return L;
  }
};

__global__ void setcookie_split_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ tok_s, const int32_t* __restrict__ tok_e,
    int32_t* __restrict__ comps, int slots, int words, int ok_row,
    int bad_row, int over_row) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    auto comp = [&](int r) -> int32_t& { return comps[static_cast<size_t>(r) * B + b]; };
    const uint8_t* p = buf + static_cast<size_t>(b) * L;
    const int s = tok_s[b], e = tok_e[b];
    const Line ln{p, L, s, e};
    const lp::Row row{p, L, mask};
    const bool ok = !((e - s) == 1 && row.at(s, 0) == '-');
    bool bad = false;
    int cursor = s;
    for (int k = 0; k < slots; ++k) {
      const int s_end = min(ln.sep(cursor), e);
      const int exp = ln.expires(cursor, s_end);
      const bool hold = exp < L && exp > s_end - MIN_EXPIRES;
      const bool last = s_end >= e;
      const int s_end2 = min(ln.sep(s_end + 2), e);
      const int exp2 = ln.expires(s_end + 2, s_end2);
      const bool hold2 = exp2 < L && exp2 > s_end2 - MIN_EXPIRES;
      const bool merged = hold && !last;
      bad = bad || (merged && hold2);
      const int seg_e = merged ? s_end2 : s_end;
      const int semi = ln.find(cursor, seg_e, ';');
      const int eq = ln.find(cursor, min(semi, seg_e), '=');
      const int name_end = min(min(eq, semi), seg_e);
      const bool emit = cursor < seg_e && !(hold && last);
      const bool prefix = cursor >= s && cursor < e && cursor < L &&
                          ln.ci(cursor, "set-cookie", 10);
      bad = bad || (emit && prefix);
      const uint32_t n_word =
          emit ? ((static_cast<uint32_t>(cursor) & SPAN_MASK) |
                  ((static_cast<uint32_t>(name_end - cursor) & SPAN_MASK) << 13) |
                  (1u << 26))
               : 0u;
      const uint32_t v_word =
          emit ? ((static_cast<uint32_t>(cursor) & SPAN_MASK) |
                  ((static_cast<uint32_t>(seg_e - cursor) & SPAN_MASK) << 13))
               : 0u;
      comp(words + 2 * k) = static_cast<int>(n_word);
      comp(words + 2 * k + 1) = static_cast<int>(v_word);
      cursor = seg_e + 2;
    }
    const bool more = ln.sep(cursor) < L || cursor < e;
    comp(ok_row) = ok ? 1 : 0;
    comp(bad_row) = (bad && ok) ? 1 : 0;
    comp(over_row) = (more && ok) ? 1 : 0;
  }
}

}  // namespace

LP_EXPORT int lp_setcookie_split(const void* buf, int B, int L, const void* tok_s,
                                 const void* tok_e, void* comps, int slots,
                                 int words, int ok_row, int bad_row, int over_row,
                                 void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  setcookie_split_kernel<<<lp::grid_for(B, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(tok_s), static_cast<const int32_t*>(tok_e),
      static_cast<int32_t*>(comps), slots, words, ok_row, bad_row, over_row);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_setcookie_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
