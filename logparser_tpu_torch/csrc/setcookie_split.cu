// Kernel 13: the Set-Cookie split of one Set-Cookie CSR group.
//
// Replaces, from logparser_tpu/tpu: postproc.py split_setcookie_csr (with
// _ci_literal_mask) and the setcookie branch of pipeline.py compute_rows
// (the CLF-dash guard, each slot packed into its two layout words, the
// bad and overflow line constraints).
//
// The reference finds every separator, ';', '=' and case-insensitive
// "expires=" with masked first-occurrence reductions over [B, L] planes,
// once per slot.  Per slot k (its order of decisions):
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
// block.  Spans start at 0 or later; bytes at or past L read 0, and a
// separator not found reads L, so a span past L ends its last part at L
// (not the last: a held one glues to the empty part [L + 2, L)) and every
// later slot moves the cursor to L + 2, short of the end.
//
// Design: a warp a tile of 32 lines, a thread a line, 8 warps a block;
// every header byte is read once from device memory and classified once,
// spans of any length 128 bytes a round.  (A warp a line cost 3x on the
// cookies batch and won only on headers past ~500 bytes, which no measured
// traffic holds: PERF.md section 6, H100 80GB HBM3, 700.00 W.)
// - Stage (line_stage.cuh): the warp stages its lines' spans 128 bytes a
//   round, aligned 16-byte loads, 8 consecutive lanes on a line's 128
//   consecutive bytes, into a word-swizzled shared-memory tile; the next
//   round's loads are issued before the warp works on this one.
// - Classify: each thread turns its round's span bytes into bit sets of
//   the round's offsets, 8 bytes a step (a class table in shared memory
//   and an 8 x 8 bit transpose): ',', ' ', ';', '=' and case-folded 'e'.
//   A ", " is a ' ' whose previous bit is a ',' (the last round's last
//   byte carried); an "expires=" is checked, 8 bytes at once, only at an
//   'e' whose 8 bytes end by the span's end.
// - Parts: the separators of the round, in order, end the raw parts; a
//   part's first ';', '=' and "expires=" are the first bits at or past its
//   start (carried across rounds until seen).  Only an occurrence whose 8
//   bytes lie inside a part can hold it (a ", " breaks the literal), so a
//   part's first occurrence decides its hold.  Where a slot starts, the
//   "set-cookie" prefix reads 10 bytes (shared memory, or the line past
//   the staged bytes).
// - Slots: a slot is decided when its part ends, with one part of
//   look-ahead where the part holds (the glue: the next part's firsts
//   complete the glued segment's, its hold is hold2), so no part is
//   scanned twice; its two words are written then.  Once the cursor has
//   passed the span's end every later slot is two zero words and adds no
//   bad: they are written with no scan, a component row at a time for the
//   warp's 32 consecutive lines, as are ok, bad and overflow.
//
// Bound: bytes -- the header span read once, the token cursors read and
// the 2 * slots + 3 rows written once (at 128 slots the writes are 0.020
// of the 0.0215 ms on the cookies batch, H100 80GB HBM3, 700.00 W).

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int SPAN_MASK = (1 << 13) - 1;
constexpr int MIN_EXPIRES = 15;   // len("expires=XXXXXXX")
constexpr int WARPS = 8;
constexpr int NONE = -1;
constexpr uint32_t EXPI = 0x69707865u, RES_EQ = 0x3D736572u;   // "expi", "res="
constexpr unsigned long long SET_COOK = 0x6B6F6F632D746573ull;  // "set-cook"
constexpr unsigned long long IE = 0x6569ull;                    // "ie"

struct Args {
  const uint8_t* buf;
  int B, L, mask;
  const int32_t* tok_s;
  const int32_t* tok_e;
  int32_t* comps;
  int slots, words, ok_row, bad_row, over_row;
};

// A set of a round's staged offsets (bit j: byte j of the round).
struct Bits {
  uint64_t a, b;   // offsets 0-63, 64-127
};

__device__ __forceinline__ Bits operator&(Bits x, Bits y) { return {x.a & y.a, x.b & y.b}; }
__device__ __forceinline__ Bits operator|(Bits x, Bits y) { return {x.a | y.a, x.b | y.b}; }
__device__ __forceinline__ bool any(Bits x) { return (x.a | x.b) != 0; }

// Offsets at or past x (any int: clamped to [0, 128]).
__device__ __forceinline__ Bits from_bit(int x) {
  x = max(0, min(x, 128));
  return {x >= 64 ? 0ull : ~0ull << x, x <= 64 ? ~0ull : (x >= 128 ? 0ull : ~0ull << (x - 64))};
}

// Offsets in [x, y).
__device__ __forceinline__ Bits bit_range(int x, int y) {
  const Bits f = from_bit(x), t = from_bit(y);
  return {f.a & ~t.a, f.b & ~t.b};
}

// The lowest offset in x, else 128.
__device__ __forceinline__ int first_bit(Bits x) {
  return x.a ? __ffsll(static_cast<long long>(x.a)) - 1
             : (x.b ? 63 + __ffsll(static_cast<long long>(x.b)) : 128);
}

// The low 8 bits of `bits8` into offsets 8g..8g+7.
__device__ __forceinline__ void put_byte(Bits& x, uint64_t bits8, int g) {
  const uint64_t v = (bits8 & 0xFFull) << ((8 * g) & 63);
  x.a |= g < 8 ? v : 0ull;
  x.b |= g < 8 ? 0ull : v;
}

// One raw part [start, end) of a header: its first ';', '=' and
// "expires=" (NONE: none inside), the "set-cookie" prefix at its start
// (looked up where a slot starts), and whether it ends the span.
struct Part {
  int start, end, exp, semi, eq;
  bool prefix, last;
};

// A line's slots so far: k decided, the cursor after the last one, bad,
// and a held part waiting for the next (pending).
struct Slots {
  int k, cursor;
  bool bad, pending, next_start;
  Part held;
};

__device__ __forceinline__ bool holds(const Part& p) {
  return p.exp != NONE && p.exp > p.end - MIN_EXPIRES;
}

// Slot st.k: the segment [cursor, seg_e), its first ';' and '=' (NONE:
// none inside), emitted or not.
__device__ __forceinline__ void put_slot(const Args& a, int b, Slots& st, int cursor,
                                         int seg_e, int semi, int eq, bool emit,
                                         bool prefix) {
  const int semi_v = semi != NONE ? semi : a.L;
  const int eq_v = (eq != NONE && eq < min(semi_v, seg_e)) ? eq : a.L;
  const int name_end = min(min(eq_v, semi_v), seg_e);
  uint32_t n_word = 0u, v_word = 0u;
  if (emit) {
    n_word = (static_cast<uint32_t>(cursor) & SPAN_MASK) |
             ((static_cast<uint32_t>(name_end - cursor) & SPAN_MASK) << 13) | (1u << 26);
    v_word = (static_cast<uint32_t>(cursor) & SPAN_MASK) |
             ((static_cast<uint32_t>(seg_e - cursor) & SPAN_MASK) << 13);
  }
  a.comps[static_cast<size_t>(a.words + 2 * st.k) * a.B + b] = static_cast<int>(n_word);
  a.comps[static_cast<size_t>(a.words + 2 * st.k + 1) * a.B + b] = static_cast<int>(v_word);
  st.bad = st.bad || (emit && prefix);
  st.cursor = seg_e + 2;
  ++st.k;
}

// Raw part r has ended: decide the slot it starts or completes.
__device__ __forceinline__ void end_part(const Args& a, int b, Slots& st, const Part& r) {
  const bool hold = holds(r);
  if (st.pending) {   // the held part glued to r
    const Part& h = st.held;
    put_slot(a, b, st, h.start, r.end, h.semi != NONE ? h.semi : r.semi,
             h.eq != NONE ? h.eq : r.eq, true, h.prefix);
    st.bad = st.bad || hold;
    st.pending = false;
    st.next_start = true;
  } else if (hold && !r.last) {
    st.held = r;
    st.pending = true;
    st.next_start = false;
  } else {
    put_slot(a, b, st, r.start, r.end, r.semi, r.eq, r.start < r.end && !(hold && r.last),
             r.prefix);
    st.next_start = true;
  }
}

__global__ void __launch_bounds__(WARPS * 32) setcookie_split_kernel(Args a) {
  __shared__ lp::StageRows stage[WARPS];
  __shared__ uint8_t cls[256];   // bit 0 ',', 1 ' ', 2 ';', 3 '=', 4 'e' or 'E'
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    cls[c] = static_cast<uint8_t>((c == ',') | (c == ' ') << 1 | (c == ';') << 2 |
                                  (c == '=') << 3 | ((c | 0x20) == 'e') << 4);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  lp::StageRows& rows = stage[warp];
  const uint8_t* buf_end = a.buf + static_cast<size_t>(a.B) * a.L;
  const int n_tiles = (a.B + 31) / 32;
  for (int tile = blockIdx.x * WARPS + warp; tile < n_tiles; tile += gridDim.x * WARPS) {
    const int b = tile * 32 + lane;
    const bool real = b < a.B;
    const int L = a.L;
    int s = 0, e = 0;
    if (real) {
      s = a.tok_s[b];
      e = a.tok_e[b];
    }
    const uint8_t* line = a.buf + static_cast<size_t>(real ? b : 0) * L;
    const int hi = min(e, L);   // the span's bytes: [s, hi)
    Part cur{s, 0, NONE, NONE, NONE, false, false};
    Slots st{0, s, false, false, true, cur};
    bool walking = real && s < hi, carry_comma = false;
    const uint8_t* a0 = lp::align_down16(line + s);
    const int n_rounds =
        walking ? static_cast<int>((line + hi - a0 + lp::STAGE_BYTES - 1) / lp::STAGE_BYTES) : 0;
    const int rounds = __reduce_max_sync(lp::FULL, n_rounds);
    // Round r's chunks of the line (its loads fly during round r - 1).
    auto chunks = [&](int r) {
      return r < n_rounds ? min(lp::STAGE_CHUNKS,
                                static_cast<int>((line + hi - (a0 + lp::STAGE_BYTES * r) + 15) >> 4))
                          : 0;
    };
    lp::StageLoads next;
    if (rounds > 0) lp::fetch_lines(next, a0, chunks(0), a.buf, buf_end, lane);
    for (int r = 0; r < rounds; ++r) {
      const uint8_t* from = a0 + lp::STAGE_BYTES * r;
      const int n = chunks(r);
      __syncwarp();   // the previous round's bytes are read
      lp::store_lines(rows, next, lane);
      __syncwarp();
      if (r + 1 < rounds) {
        lp::fetch_lines(next, from + lp::STAGE_BYTES, chunks(r + 1), a.buf, buf_end, lane);
      }
      const int w0 = static_cast<int>(from - line);   // the line position of staged byte 0
      const int staged_end = w0 + 16 * n;
      // "set-cookie" at p (case-insensitive, bytes past L read 0).
      auto prefix_at = [&](int p) -> bool {
#pragma unroll
        for (int i = 0; i < 10; ++i) {
          const int q = p + i;
          const int c = q >= L ? 0 : (q < staged_end ? lp::staged_byte(rows, lane, q - w0)
                                                     : line[q]);
          const int want = static_cast<int>(
              i < 8 ? (SET_COOK >> (8 * i)) & 0xFF : (IE >> (8 * (i - 8))) & 0xFF);
          if ((want == '-' ? c : (c | 0x20)) != want) return false;
        }
        return true;
      };
      if (!walking || r >= n_rounds) continue;
      // The round's classes of span bytes, 8 bytes a step, as bit sets of
      // the staged offsets (offset j: line position w0 + j).
      const int from_off = max(s - w0, 0), to_off = min(hi - w0, lp::STAGE_BYTES);
      Bits comma{}, space{}, semi{}, eq{}, e_or_E{};
      for (int g = from_off >> 3; 8 * g < to_off; ++g) {
        uint64_t t, unused;
        lp::classify8(lp::staged_word(rows, lane, 2 * g), lp::staged_word(rows, lane, 2 * g + 1),
                      cls, t, unused);
        put_byte(comma, t, g);
        put_byte(space, t >> 8, g);
        put_byte(semi, t >> 16, g);
        put_byte(eq, t >> 24, g);
        put_byte(e_or_E, t >> 32, g);
      }
      const Bits V = bit_range(from_off, to_off);
      comma = comma & V;
      // ", ": a ' ' after a ',' of the span (the last round's last byte too).
      const Bits after_comma{(comma.a << 1) | (carry_comma ? 1ull : 0ull),
                             (comma.b << 1) | (comma.a >> 63)};
      Bits sep_end = space & V & after_comma;
      carry_comma = (comma.b >> 63) != 0;
      // "expires=" from each 'e' whose 8 bytes end by the span's end.
      Bits exps{};
      for (Bits m = e_or_E & V & bit_range(0, hi - w0 - 7); any(m);) {
        const int j = first_bit(m);
        m = m & from_bit(j + 1);
        uint32_t lo4, hi4;
        if (j + 8 <= staged_end - w0) {
          lo4 = lp::staged_bytes4(rows, lane, j);
          hi4 = lp::staged_bytes4(rows, lane, j + 4);
        } else {
          lo4 = hi4 = 0u;
          for (int i = 0; i < 4; ++i) {
            lo4 |= static_cast<uint32_t>(line[w0 + j + i]) << (8 * i);
            hi4 |= static_cast<uint32_t>(line[w0 + j + 4 + i]) << (8 * i);
          }
        }
        if ((lo4 | 0x20202020u) == EXPI && (hi4 | 0x00202020u) == RES_EQ) {
          exps = exps | bit_range(j, j + 1);
        }
      }
      if (r == 0) cur.prefix = prefix_at(s);   // the first part starts a slot
      // The parts that end in this round, in order; a part's firsts are the
      // first bits at or past its start (NONE until one is seen).
      auto firsts = [&](const Bits& R) {
        const int js = first_bit(semi & R), je = first_bit(eq & R),
                  jx = first_bit(exps & R);
        if (cur.semi == NONE && js < 128) cur.semi = w0 + js;
        if (cur.eq == NONE && je < 128) cur.eq = w0 + je;
        if (cur.exp == NONE && jx < 128) cur.exp = w0 + jx;
      };
      while (walking && any(sep_end)) {
        const int js = first_bit(sep_end);
        sep_end = sep_end & from_bit(js + 1);
        const int q = w0 + js - 1;   // the ','
        firsts(V & bit_range(cur.start - w0, js - 1));
        cur.end = q;
        end_part(a, b, st, cur);
        cur = Part{q + 2, 0, NONE, NONE, NONE, false, false};
        walking = st.k < a.slots;
        if (walking && st.next_start && q + 2 < hi) cur.prefix = prefix_at(q + 2);
      }
      if (walking) firsts(V & from_bit(cur.start - w0));
    }
    if (real && st.k < a.slots) {   // the part that ends at the span's end (0 past L)
      cur.end = hi;
      cur.last = hi >= e;
      end_part(a, b, st, cur);
      if (st.pending) end_part(a, b, st, Part{hi + 2, hi, NONE, NONE, NONE, false, false});
    }
    // Past the span's end: zero words, no scan, a row a store for the warp.
    const int k_min = __reduce_min_sync(lp::FULL, real ? st.k : a.slots);
    for (int k = k_min; k < a.slots; ++k) {
      if (real && k >= st.k) {
        a.comps[static_cast<size_t>(a.words + 2 * k) * a.B + b] = 0;
        a.comps[static_cast<size_t>(a.words + 2 * k + 1) * a.B + b] = 0;
      }
    }
    if (real) {
      const lp::Row row{line, L, a.mask};
      const bool ok = !((e - s) == 1 && row.at(s, 0) == '-');
      const bool more = (st.k == a.slots ? st.cursor : hi + 2) < e;
      a.comps[static_cast<size_t>(a.ok_row) * a.B + b] = ok ? 1 : 0;
      a.comps[static_cast<size_t>(a.bad_row) * a.B + b] = (st.bad && ok) ? 1 : 0;
      a.comps[static_cast<size_t>(a.over_row) * a.B + b] = (more && ok) ? 1 : 0;
    }
  }
}

}  // namespace

LP_EXPORT int lp_setcookie_split(const void* buf, int B, int L, const void* tok_s,
                                 const void* tok_e, void* comps, int slots,
                                 int words, int ok_row, int bad_row, int over_row,
                                 void* stream) {
  if (B <= 0) return 0;
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
               static_cast<const int32_t*>(tok_s), static_cast<const int32_t*>(tok_e),
               static_cast<int32_t*>(comps), slots, words, ok_row, bad_row, over_row};
  const int tiles = (B + 31) / 32;
  setcookie_split_kernel<<<lp::grid_for(tiles, WARPS), WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_setcookie_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
