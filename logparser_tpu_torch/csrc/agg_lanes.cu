// Kernel 10: the aggregate pushdown's per-row pass -- the class plane and
// one lane per distinct op field, read from the packed [K, B] rows.
//
// Replaces the per-row body of logparser_tpu/analytics/device.py
// build_aggregate_fn (its lines 387-604 with _slot, _qs_key_lane and
// _frame_value_limbs): the winner / contested merge over each unit's row
// 0, live / host_kill / CSR-overflow force-folds, the escaped-quote fold,
// per lane the span word (or a query key matched in the packed CSR
// segment table: ASCII case fold, last match wins), the long frame as
// base-10^6 limbs with the null modes, or the timestamp as epoch seconds
// floored to a bucket (years 1902-2037 only), the global Long-overflow
// fold, and cls (0 counted, 1 fold, 2 reject, 3 padding).
//
// Every descriptor is an int32 table row (analytics/device.py AggTables):
// lanes (kind, first output row, width_s, first unit row), udesc per unit
// (mode, null code, 7 slot triples (row, shift, bits)), ovf (unit, ok,
// null, big, lo_digits triples).  A lane's rows hold the selected rows'
// values and a sentinel elsewhere: span start | len << 13 or -1; limbs
// A, B, C or -1, 0, 0; bucket or INT32_MAX.
//
// A thread a row, 128 a block, at least 4 blocks an SM.  The block stages
// the descriptor tables in shared memory once, as cp.async copies all in
// flight (then each query key as 16 zero-padded words, one slot per (lane,
// unit)), while every thread's row-0 loads of the U units are in flight
// (`units` is read straight from global memory, one broadcast word a unit,
// so those loads need not wait for the staging).
// A row that is not base-valid (padding, force-folded, invalid or
// contested) never reaches a lane: its class follows from row 0 alone and
// its lanes are sentinels.  A base-valid row walks its winner's
// descriptors, issuing one 4-byte cp.async per packed word they name into
// its own column of a [48][128] shared-memory tile, all in flight at once;
// after one wait it walks them again in the same order, computing
// each lane from the tile and writing it as if the row were counted, with
// a selection bit mask -- no per-thread array, no stack frame.  A row whose
// winner names more than 48 words refills the tile 48 words at a time; a
// row that ends uncounted with a lane selected rewrites its lanes as
// sentinels.
//
// The long frame's limbs come from one 64-bit value (hi mod 10^9 · 10^10
// + lo mod 10^9 · 10, floor modulo as the plain version's digits take it)
// divided by 10^(19 - ndig) through 32-bit divisions and split by constant
// divisors; d18 joins the last limb only when nothing is shifted out (the
// plain version's digit 18 at position 18).  The time bucket's floor
// division takes a per-lane reciprocal staged once a block and one
// correction.  A query key is compared 4 bytes at a time against the
// staged key: the name's bytes as the aligned 16-byte chunks that cover
// them (lp::load16_in) where start + klen <= L, else a byte at a time
// clamped to the line's last byte.  The writes are one coalesced int32 a
// lane row and the class byte.
//
// Bound: bytes -- each unit's row 0 for every row and, for a base-valid
// row, the other packed words its winner's descriptors name (4 bytes each)
// and the key bytes a query lane compares (tools/kernel_ab.py lanes_cost);
// the host_kill and class bytes and 4 bytes a lane row written.  The
// integer work (a few divisions a limbs lane, days-from-civil) is a few
// hundred operations a row, far under the card's rate; the design's aim is
// the fewest dependent round trips to memory (row 0, then one batch of
// lane words) behind the one-time staging.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_UNITS = 8;
constexpr int MAX_LANES = 16;
constexpr int UDW = 23, LANEW = 4, OVFW = 13;
constexpr int LANE_SPAN = 0, LANE_LIMBS = 1;
constexpr int UNIT_FOLD = 0, UNIT_SLOTS = 1, UNIT_QS = 2;
constexpr int NULL_ZERO = 1, NULL_DASH = 2;
constexpr int SPAN_BITS = 13, SPAN_MASK = (1 << SPAN_BITS) - 1;
constexpr int32_t I32_MAX = 2147483647;
constexpr int KCAP = 48;     // packed words a row fetches in one round
constexpr int KEYW = 16;     // words of a staged query key (64 bytes, the longest)
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One (row, shift, bits) slot of a word; bits 0 = the whole word.
__device__ __forceinline__ int32_t slot_of(int32_t w, const int32_t* t) {
  if (t[2] == 0) return w;
  return static_cast<int32_t>((static_cast<uint32_t>(w) >> t[1]) & ((1u << t[2]) - 1u));
}

__device__ __forceinline__ int triples_of(int kind) {
  return kind == LANE_SPAN ? 1 : (kind == LANE_LIMBS ? 7 : 4);
}

// A base-valid row's packed words, in the order its winner's descriptors
// name them (each lane's slots or a query key's ok slot and segment
// words, then the winner's overflow slots), taken one after another from
// the thread's column of the [KCAP][THREADS] tile.  issue(from) starts the
// KCAP words from `from` as 4-byte cp.async copies, all in flight; fill
// issues and waits; need(n) refills from the next word when the next n
// (at most KCAP) are not all in the tile.
struct Words {
  const int32_t* packed;
  int32_t* col;
  const int32_t* s_lanes;
  const int32_t* s_udesc;
  const int32_t* s_ovf;
  int B, i, n_lanes, n_ovf, winner;
  int k = 0, base = 0;

  // Word n of the walk, from packed row `row`, into the tile (n >= from).
  __device__ __forceinline__ void copy(int n, int from, int row) const {
    if (n >= from) cp_async4(col + (n - from) * THREADS, packed + static_cast<size_t>(row) * B + i);
  }
  __device__ __forceinline__ void issue(int from) const {
    const int to = from + KCAP;
    int n = 0;
    for (int ln = 0; ln < n_lanes && n < to; ++ln) {
      const int32_t* d = s_udesc + (s_lanes[LANEW * ln + 3] + winner) * UDW;
      if (d[0] == UNIT_SLOTS) {
        const int nt = triples_of(s_lanes[LANEW * ln]);
        for (int t = 0; t < nt && n < to; ++t, ++n) copy(n, from, d[2 + 3 * t]);
      } else if (d[0] == UNIT_QS) {
        copy(n++, from, d[2]);
        for (int s = 0; s < 2 * d[6] && n < to; ++s, ++n) copy(n, from, d[5] + s);
      }
    }
    for (int e = 0; e < n_ovf && n < to; ++e) {
      const int32_t* o = s_ovf + OVFW * e;
      if (o[0] != winner) continue;
      for (int t = 0; t < 4 && n < to; ++t, ++n) copy(n, from, o[1 + 3 * t]);
    }
  }
  __device__ __forceinline__ void fill(int from) {
    issue(from);
    cp_async_wait_all();
    base = from;
  }
  __device__ __forceinline__ void need(int n) {
    if (k + n > base + KCAP) fill(k);
  }
  __device__ __forceinline__ int32_t take() { return col[(k++ - base) * THREADS]; }
  __device__ __forceinline__ int32_t slot(const int32_t* t) { return slot_of(take(), t); }
};

// floor(a / w) for |a| < 2^34 and 1 <= w < 2^31, from inv within 2^-48
// of 1.0 / w: the product is within 2^-13 of a / w, so one step corrects
// its floor.  (A 64-bit or double division by a runtime divisor is a
// subroutine call, whose saved registers would give the kernel a stack
// frame.)
__device__ __forceinline__ long long floor_div(long long a, int w, double inv) {
  long long q = __double2ll_rd(static_cast<double>(a) * inv);
  const long long r = a - q * w;
  if (r < 0) --q;
  else if (r >= w) ++q;
  return q;
}

__device__ __forceinline__ uint32_t mod_1e9(int32_t x) {   // floor modulo
  int32_t r = x % 1000000000;
  return static_cast<uint32_t>(r < 0 ? r + 1000000000 : r);
}

__constant__ uint32_t POW10[10] = {1u, 10u, 100u, 1000u, 10000u, 100000u, 1000000u,
                                   10000000u, 100000000u, 1000000000u};

// Right-aligned (A, B, C) base-10^6 limbs of the left-aligned 19-digit
// frame (hi = digits 0..8, lo = digits 9..17, d18 = digit 18): value =
// frame // 10^(19 - ndig); dead rows read zero digits.
__device__ __forceinline__ void frame_limbs(int32_t hi, int32_t lo, int32_t d18, int32_t ndig,
                                            bool dead, int32_t& a, int32_t& b, int32_t& c) {
  // frame = h * 10^10 + l * 10 (h, l < 10^9); frame // 10^shift through
  // 32-bit divisions: for shift <= 10, h * 10^(10 - shift) + l //
  // 10^(shift - 1); above, h // 10^(shift - 10) (l's part is below 1).
  const uint32_t h = dead ? 0u : mod_1e9(hi), l = dead ? 0u : mod_1e9(lo);
  const int shift = ndig >= 19 ? 0 : (ndig <= 0 ? 19 : 19 - ndig);
  const unsigned long long v =
      shift == 0 ? static_cast<unsigned long long>(h) * 10000000000ull +
                       static_cast<unsigned long long>(l) * 10ull
      : shift <= 10 ? static_cast<unsigned long long>(h) * POW10[10 - shift] +
                          l / POW10[shift - 1]
                    : h / POW10[shift - 10];
  const unsigned long long va = v / 1000000000000ull;
  const unsigned long long rest = v - va * 1000000000000ull;
  const unsigned long long vb = rest / 1000000ull;
  a = static_cast<int32_t>(va);
  b = static_cast<int32_t>(vb);
  // d18 is the units digit only when nothing is shifted out (int32 wrap).
  c = static_cast<int32_t>(static_cast<uint32_t>(rest - vb * 1000000ull) +
                           (shift == 0 && !dead ? static_cast<uint32_t>(d18) : 0u));
}

// ASCII case fold of 4 bytes: 'A'-'Z' | 0x20.
__device__ __forceinline__ uint32_t fold4(uint32_t x) {
  const uint32_t up = __vcmpgeu4(x, 0x41414141u) & __vcmpleu4(x, 0x5A5A5A5Au);
  return x | (up & 0x20202020u);
}

// Whether the klen (1 to 64) bytes of `row` from st, case-folded, equal the
// staged key (16 words, zero-padded); bytes at min(st + p, L - 1).
__device__ __forceinline__ bool key_equal(const uint8_t* row, int st, int klen, int L,
                                          const uint32_t* key, const uint8_t* buf,
                                          const uint8_t* buf_end) {
  if (st + klen <= L) {
    const uint8_t* p = row + st;
    const uint8_t* c0 = lp::align_down16(p);
    const int off = static_cast<int>(p - c0);
    uint32_t raw[20];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (16 * c < off + klen) v = lp::load16_in(c0 + 16 * c, buf, buf_end);
      raw[4 * c] = v.x;
      raw[4 * c + 1] = v.y;
      raw[4 * c + 2] = v.z;
      raw[4 * c + 3] = v.w;
    }
    if (off & 8) {
#pragma unroll
      for (int j = 0; j + 2 < 20; ++j) raw[j] = raw[j + 2];
    }
    if (off & 4) {
#pragma unroll
      for (int j = 0; j + 1 < 20; ++j) raw[j] = raw[j + 1];
    }
    uint32_t diff = 0u;
#pragma unroll
    for (int j = 0; j < KEYW; ++j) {
      if (4 * j < klen) {
        const uint32_t m = 4 * j + 4 <= klen ? 0xFFFFFFFFu : (1u << (8 * (klen - 4 * j))) - 1u;
        const uint32_t w = __funnelshift_r(raw[j], raw[j + 1], 8 * (off & 3));
        diff |= (fold4(w) ^ key[j]) & m;
      }
    }
    return diff == 0u;
  }
  for (int p = 0; p < klen; ++p) {
    const int at = st + p < L - 1 ? st + p : L - 1;
    int c = row[at];
    if (c >= 'A' && c <= 'Z') c |= 0x20;
    if (c != static_cast<int>((key[p >> 2] >> (8 * (p & 3))) & 0xFFu)) return false;
  }
  return true;
}

// At least 4 blocks an SM (512 threads: 65,536 rows in one wave); without a
// minimum ptxas held the kernel to 72 registers and spilled.
__global__ void __launch_bounds__(THREADS, 4) agg_lanes_kernel(
    int B, int L, int n_rows, const int32_t* __restrict__ packed,
    const uint8_t* __restrict__ buf, const uint8_t* __restrict__ host_kill,
    int U, const int32_t* __restrict__ units, const int32_t* __restrict__ lanes_desc,
    int n_lanes, const int32_t* __restrict__ udesc, const int32_t* __restrict__ ovf,
    int n_ovf, const int32_t* __restrict__ keys, uint8_t* __restrict__ cls,
    int32_t* __restrict__ lanes) {
  extern __shared__ double smem_d[];
  double* s_inv = smem_d;                                   // [MAX_LANES]: 1.0 / width_s
  int32_t* s_lanes = reinterpret_cast<int32_t*>(smem_d + MAX_LANES);   // [n_lanes][LANEW]
  int32_t* s_udesc = s_lanes + LANEW * n_lanes;             // [n_lanes * U][UDW]
  int32_t* s_ovf = s_udesc + UDW * n_lanes * U;             // [n_ovf][OVFW]
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_ovf + OVFW * n_ovf);   // [n_lanes * U][KEYW]
  int32_t* s_fetch = reinterpret_cast<int32_t*>(s_keys + KEYW * n_lanes * U);  // [KCAP][THREADS]

  const int tid = threadIdx.x;
  const int i = blockIdx.x * THREADS + tid;
  const bool in_b = i < B;

  // Row 0 of every unit and the host_kill byte, in flight during the staging.
  int32_t r0[MAX_UNITS];
#pragma unroll
  for (int u = 0; u < MAX_UNITS; ++u) {
    r0[u] = (u < U && in_b) ? __ldg(packed + static_cast<size_t>(__ldg(units + u)) * B + i) : 0;
  }
  const bool killed = in_b && host_kill[i] != 0;

  // The tables as cp.async copies, all in flight at once; then each query
  // key from the staged descriptors.
  for (int j = tid; j < LANEW * n_lanes; j += THREADS) cp_async4(s_lanes + j, lanes_desc + j);
  for (int j = tid; j < UDW * n_lanes * U; j += THREADS) cp_async4(s_udesc + j, udesc + j);
  for (int j = tid; j < OVFW * n_ovf; j += THREADS) cp_async4(s_ovf + j, ovf + j);
  cp_async_wait_all();
  __syncthreads();
  if (tid < n_lanes) {   // 1.0 / width_s: the approximate reciprocal, 3 Newton steps
    const double w = s_lanes[LANEW * tid + 2] > 0 ? s_lanes[LANEW * tid + 2] : 1;
    double inv;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(inv) : "d"(w));
#pragma unroll
    for (int it = 0; it < 3; ++it) inv = fma(inv, fma(-w, inv, 1.0), inv);
    s_inv[tid] = inv;
  }
  for (int j = tid; j < KEYW * n_lanes * U; j += THREADS) {
    const int32_t* d = s_udesc + (j / KEYW) * UDW;
    uint32_t v = 0u;
    if (d[0] == UNIT_QS) {
      const int koff = d[8], klen = d[9];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = 4 * (j % KEYW) + b;
        if (p < klen) v |= (static_cast<uint32_t>(keys[koff + p]) & 0xFFu) << (8 * b);
      }
    }
    s_keys[j] = v;
  }
  __syncthreads();
  if (!in_b) return;
  Words wd{packed, s_fetch + tid, s_lanes, s_udesc, s_ovf, B, i, n_lanes, n_ovf, 0};

  bool valid_any = false, plaus_any = false, csr_over = false;
  int winner = 0, plaus_before = 0, ep = 0;
  int32_t wr0 = 0;
#pragma unroll
  for (int u = 0; u < MAX_UNITS; ++u) {
    if (u < U) {
      const bool p = (r0[u] & 2) != 0;
      if ((r0[u] & 1) && !valid_any) {
        valid_any = true;
        winner = u;
        wr0 = r0[u];
        ep = plaus_before;
      }
      plaus_before += p;
      plaus_any = plaus_any || p;
      csr_over = csr_over || (r0[u] & 4) != 0;
    }
  }
  if (!valid_any) wr0 = r0[0];
  valid_any = valid_any && ep == 0;   // contested: an earlier unit plausible
  const bool live = i < n_rows;
  const bool force_fold = live && (killed || csr_over);
  const bool invalid = live && !valid_any && !force_fold;
  // The class before any lane: 0 for a base-valid row, which a fold makes 1.
  const int c0 = !live ? 3 : (invalid && !plaus_any) ? 2 : (force_fold || invalid) ? 1 : 0;
  const bool base_valid = c0 == 0;
  bool fold = base_valid && (wr0 & 8) != 0;
  uint32_t sel = 0u;

  if (base_valid) {
    wd.winner = winner;
    wd.fill(0);
    const uint8_t* row = buf + static_cast<size_t>(i) * L;
    const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
    for (int ln = 0; ln < n_lanes; ++ln) {
      const int32_t* ld = s_lanes + LANEW * ln;
      const int32_t* d = s_udesc + (ld[3] + winner) * UDW;
      const bool uncovered = d[0] == UNIT_FOLD;
      // The lane's words in the tile (a query key's as far as they fit).
      wd.need(d[0] == UNIT_SLOTS ? triples_of(ld[0])
              : d[0] == UNIT_QS  ? min(1 + 2 * d[6], KCAP)
                                 : 0);
      // Written as if the row is counted; an uncounted row's lanes are
      // rewritten below.
      int32_t* out = lanes + static_cast<size_t>(ld[1]) * B + i;
      bool on = false;
      if (ld[0] == LANE_SPAN) {
        int s = 0, n = 0;
        bool ok = false, nul = false, ampfix = false;
        if (d[0] == UNIT_SLOTS) {
          const uint32_t w = static_cast<uint32_t>(wd.take());
          s = w & SPAN_MASK;
          n = (w >> SPAN_BITS) & SPAN_MASK;
          ok = (w >> (2 * SPAN_BITS)) & 1;
          nul = (w >> (2 * SPAN_BITS + 1)) & 1;
          ampfix = ((w >> (2 * SPAN_BITS + 2)) & 3) != 0;
        } else if (d[0] == UNIT_QS) {
          const int n_slots = d[6], klen = d[9];
          ok = wd.slot(d + 2) != 0;
          const uint32_t* key = s_keys + (ld[3] + winner) * KEYW;
          bool matched = false, bad = false, m_dec = false;
          for (int k = 0; k < n_slots; ++k) {
            wd.need(2);
            const uint32_t nw = static_cast<uint32_t>(wd.take());
            const uint32_t vw = static_cast<uint32_t>(wd.take());
            const int st = nw & SPAN_MASK, nl = (nw >> SPAN_BITS) & SPAN_MASK;
            if (nl == 0) continue;   // not emitted
            bad = bad || ((nw >> 28) & 1) || ((nw >> 29) & 1);
            if (nl != klen) continue;
            if (key_equal(row, st, klen, L, key, buf, buf_end)) {
              matched = true;
              s = vw & SPAN_MASK;
              n = (vw >> SPAN_BITS) & SPAN_MASK;
              m_dec = (nw >> 27) & 1;
            }
          }
          nul = !matched;
          ampfix = bad || (matched && m_dec);
        }
        fold = fold || uncovered || ampfix;
        on = ok && !nul;
        out[0] = on ? (s | (n << SPAN_BITS)) : -1;
      } else if (ld[0] == LANE_LIMBS) {
        int32_t hi = 0, lo = 0, d18 = 0, ndig = 0;
        bool ok = false, nul = false, big = false;
        if (d[0] == UNIT_SLOTS) {
          hi = wd.slot(d + 2);
          lo = wd.slot(d + 5);
          d18 = wd.slot(d + 8);
          ndig = wd.slot(d + 11);
          ok = wd.slot(d + 14) != 0;
          nul = wd.slot(d + 17) != 0;
          big = wd.slot(d + 20) != 0;
        }
        int32_t a, b, c;
        frame_limbs(hi, lo, d18, ndig, !ok || big || nul, a, b, c);
        fold = fold || uncovered;
        const bool is_zero = a == 0 && b == 0 && c == 0;
        const bool excl_zero = !uncovered && d[1] == NULL_ZERO;
        const bool incl_null = !uncovered && d[1] == NULL_DASH;
        on = ok && (nul ? incl_null : !(excl_zero && is_zero));
        out[0] = on ? a : -1;
        out[B] = on ? b : 0;
        out[2 * static_cast<size_t>(B)] = on ? c : 0;
      } else {   // time
        uint32_t c1 = 0, c2 = 0;
        int32_t off = 0;
        bool ok = false;
        if (d[0] == UNIT_SLOTS) {
          c1 = static_cast<uint32_t>(wd.slot(d + 2));
          c2 = static_cast<uint32_t>(wd.slot(d + 5));
          off = wd.slot(d + 8);
          ok = wd.slot(d + 11) != 0;
        }
        const int year = c1 & 0x3FFF, month = (c1 >> 14) & 0xF;
        const int day = (c1 >> 18) & 0x1F, hour = (c1 >> 23) & 0x1F;
        const int minute = c2 & 0x3F, second = (c2 >> 6) & 0x3F;
        const bool in_range = year >= 1902 && year <= 2037;
        fold = fold || uncovered || (ok && !in_range);
        // days from civil (era / year-of-era / day-of-year)
        const int y = (in_range ? year : 2000) - (month <= 2 ? 1 : 0);
        const int era = (y >= 0 ? y : y - 399) / 400;
        const int yoe = y - era * 400;
        const int mp = (month + 9) % 12;
        const int doy = (153 * mp + 2) / 5 + day - 1;
        const int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
        const long long days = static_cast<long long>(era) * 146097 + doe - 719468;
        const long long secs = days * 86400 + hour * 3600 + minute * 60 + second -
                               static_cast<long long>(off);
        on = ok;
        out[0] = on ? static_cast<int32_t>(floor_div(secs, ld[2], s_inv[ln])) : I32_MAX;
      }
      sel |= static_cast<uint32_t>(on) << ln;
    }

    // Global Long-overflow fold over every requested long / secmillis field
    // of the winner: the big bit or a full 19-digit frame.
    for (int e = 0; e < n_ovf; ++e) {
      const int32_t* o = s_ovf + OVFW * e;
      if (o[0] != winner) continue;
      wd.need(4);
      const bool ok = wd.slot(o + 1) != 0, nul = wd.slot(o + 4) != 0;
      const bool big = wd.slot(o + 7) != 0;
      fold = fold || (ok && !nul && (big || wd.slot(o + 10) >= 19));
    }
  }

  const int c = base_valid && fold ? 1 : c0;
  cls[i] = static_cast<uint8_t>(c);
  if (!base_valid || (c != 0 && sel != 0u)) {   // every lane a sentinel
    for (int ln = 0; ln < n_lanes; ++ln) {
      const int32_t* ld = s_lanes + LANEW * ln;
      int32_t* out = lanes + static_cast<size_t>(ld[1]) * B + i;
      if (ld[0] == LANE_SPAN) {
        out[0] = -1;
      } else if (ld[0] == LANE_LIMBS) {
        out[0] = -1;
        out[B] = 0;
        out[2 * static_cast<size_t>(B)] = 0;
      } else {
        out[0] = I32_MAX;
      }
    }
  }
}

}  // namespace

LP_EXPORT int lp_agg_lanes(int B, int L, int n_rows, const void* packed, int R,
                           const void* buf, const void* host_kill, int U,
                           const void* units, const void* lanes_desc, int n_lanes,
                           const void* udesc, const void* ovf, int n_ovf,
                           const void* keys, void* cls, void* lanes, void* stream) {
  if (U < 1 || U > MAX_UNITS || n_lanes < 0 || n_lanes > MAX_LANES || n_ovf < 0 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return 0;
  const size_t words = static_cast<size_t>(LANEW) * n_lanes +
                       static_cast<size_t>(UDW + KEYW) * n_lanes * U +
                       static_cast<size_t>(OVFW) * n_ovf +
                       static_cast<size_t>(KCAP) * THREADS;
  const size_t bytes = 4 * words + sizeof(double) * MAX_LANES;
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        agg_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = static_cast<int>((static_cast<long long>(B) + THREADS - 1) / THREADS);
  agg_lanes_kernel<<<blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      B, L, n_rows, static_cast<const int32_t*>(packed),
      static_cast<const uint8_t*>(buf), static_cast<const uint8_t*>(host_kill), U,
      static_cast<const int32_t*>(units), static_cast<const int32_t*>(lanes_desc),
      n_lanes, static_cast<const int32_t*>(udesc), static_cast<const int32_t*>(ovf),
      n_ovf, static_cast<const int32_t*>(keys), static_cast<uint8_t*>(cls),
      static_cast<int32_t*>(lanes));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_agg_lanes_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
