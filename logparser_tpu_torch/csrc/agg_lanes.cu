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
// One thread per row; every descriptor is an int32 table row (see
// analytics/device.py AggTables): lanes (kind, first output row, width_s,
// first unit row), udesc per unit (mode, null code, 7 slot triples (row,
// shift, bits)), ovf (unit, ok, null, big, lo_digits triples).  A lane's
// rows hold the selected rows' values and a sentinel elsewhere: span
// start | len << 13 or -1; limbs A, B, C or -1, 0, 0; bucket or INT32_MAX.
//
// Bound: bytes -- the packed words the descriptors name (row 0 of each
// unit and each lane's slots, 4 bytes each a row), the key bytes a query
// lane compares, the class byte and 4 bytes a lane row written.  The
// integer work (19 digit moves, days-from-civil) is a few hundred
// operations a row, far under the card's rate.

#include "lp_common.cuh"

namespace {

constexpr int MAX_UNITS = 8;
constexpr int MAX_LANES = 16;
constexpr int UDW = 23, LANEW = 4, OVFW = 13;
constexpr int LANE_SPAN = 0, LANE_LIMBS = 1;
constexpr int UNIT_FOLD = 0, UNIT_SLOTS = 1, UNIT_QS = 2;
constexpr int NULL_ZERO = 1, NULL_DASH = 2;
constexpr int SPAN_BITS = 13, SPAN_MASK = (1 << SPAN_BITS) - 1;
constexpr int32_t I32_MAX = 2147483647;

struct Packed {
  const int32_t* p;
  int B, i;
  __device__ __forceinline__ int32_t word(int row) const {
    return p[static_cast<size_t>(row) * B + i];
  }
  // One (row, shift, bits) slot; bits 0 = the whole word.
  __device__ __forceinline__ int32_t slot(const int32_t* t) const {
    const int32_t w = word(t[0]);
    if (t[2] == 0) return w;
    return static_cast<int32_t>((static_cast<uint32_t>(w) >> t[1]) &
                                ((1u << t[2]) - 1u));
  }
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Right-aligned (A, B, C) base-10^6 limbs of the left-aligned 19-digit
// frame: value = frame // 10^(19 - ndig); dead rows read zero digits.
__device__ void frame_limbs(int32_t hi, int32_t lo, int32_t d18, int ndig,
                            bool dead, int32_t* a, int32_t* b, int32_t* c) {
  int d[19];
  long long h = dead ? 0 : hi, l = dead ? 0 : lo;
  for (int i = 8; i >= 0; --i) { d[i] = static_cast<int>(h % 10); h /= 10; }
  for (int i = 17; i >= 9; --i) { d[i] = static_cast<int>(l % 10); l /= 10; }
  d[18] = dead ? 0 : d18;
  int shift = 19 - ndig;
  shift = shift < 0 ? 0 : (shift > 19 ? 19 : shift);
  int32_t va = 0, vb = 0, vc = 0;
  for (int j = 0; j < 19; ++j) {
    const int dj = j >= shift ? d[j - shift] : 0;
    if (j < 7) va = va * 10 + dj;
    else if (j < 13) vb = vb * 10 + dj;
    else vc = vc * 10 + dj;
  }
  *a = va; *b = vb; *c = vc;
}

__global__ void agg_lanes_kernel(
    int B, int L, int n_rows, const int32_t* __restrict__ packed,
    const uint8_t* __restrict__ buf, const uint8_t* __restrict__ host_kill,
    int U, const int32_t* __restrict__ units, const int32_t* __restrict__ lanes_desc,
    int n_lanes, const int32_t* __restrict__ udesc, const int32_t* __restrict__ ovf,
    int n_ovf, const int32_t* __restrict__ keys, uint8_t* __restrict__ cls,
    int32_t* __restrict__ lanes) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B;
       i += gridDim.x * blockDim.x) {
    const Packed pk{packed, B, i};
    const uint8_t* row = buf + static_cast<size_t>(i) * L;
    const bool live = i < n_rows;
    bool valid_any = false, plaus_any = false, csr_over = false;
    int winner = 0, plaus_before = 0, ep = 0;
    for (int u = 0; u < U; ++u) {
      const int32_t r0 = pk.word(units[u]);
      const bool p = (r0 & 2) != 0;
      if ((r0 & 1) && !valid_any) {
        valid_any = true;
        winner = u;
        ep = plaus_before;
      }
      plaus_before += p;
      plaus_any = plaus_any || p;
      csr_over = csr_over || (r0 & 4) != 0;
    }
    valid_any = valid_any && ep == 0;   // contested: an earlier unit plausible
    const bool force_fold = live && (host_kill[i] != 0 || csr_over);
    const bool base_valid = valid_any && live && !force_fold;
    bool fold = base_valid && (pk.word(units[winner]) & 8) != 0;

    int32_t v0[MAX_LANES], v1[MAX_LANES], v2[MAX_LANES];
    bool sel[MAX_LANES];
    for (int ln = 0; ln < n_lanes; ++ln) {
      const int32_t* ld = lanes_desc + LANEW * ln;
      const int32_t* d = udesc + static_cast<size_t>(ld[3] + winner) * UDW;
      const bool uncovered = d[0] == UNIT_FOLD;
      v1[ln] = 0;
      v2[ln] = 0;
      if (ld[0] == LANE_SPAN) {
        int s = 0, n = 0;
        bool ok = false, nul = false, ampfix = false;
        if (d[0] == UNIT_SLOTS) {
          const uint32_t w = static_cast<uint32_t>(pk.word(d[2]));
          s = w & SPAN_MASK;
          n = (w >> SPAN_BITS) & SPAN_MASK;
          ok = (w >> (2 * SPAN_BITS)) & 1;
          nul = (w >> (2 * SPAN_BITS + 1)) & 1;
          ampfix = ((w >> (2 * SPAN_BITS + 2)) & 3) != 0;
        } else if (d[0] == UNIT_QS) {
          const int first = d[5], n_slots = d[6], koff = d[8], klen = d[9];
          bool matched = false, bad = false, m_dec = false;
          for (int k = 0; k < n_slots; ++k) {
            const uint32_t nw = static_cast<uint32_t>(pk.word(first + 2 * k));
            const uint32_t vw = static_cast<uint32_t>(pk.word(first + 2 * k + 1));
            const int st = nw & SPAN_MASK, nl = (nw >> SPAN_BITS) & SPAN_MASK;
            if (nl == 0) continue;   // not emitted
            bad = bad || ((nw >> 28) & 1) || ((nw >> 29) & 1);
            if (nl != klen) continue;
            bool eq = true;
            for (int p = 0; p < klen && eq; ++p) {
              const int at = st + p < L - 1 ? st + p : L - 1;
              int c = row[at];
              if (c >= 'A' && c <= 'Z') c |= 0x20;
              eq = c == keys[koff + p];
            }
            if (eq) {
              matched = true;
              s = vw & SPAN_MASK;
              n = (vw >> SPAN_BITS) & SPAN_MASK;
              m_dec = (nw >> 27) & 1;
            }
          }
          ok = pk.slot(d + 2) != 0;
          nul = !matched;
          ampfix = bad || (matched && m_dec);
        }
        fold = fold || (base_valid && (uncovered || ampfix));
        v0[ln] = s | (n << SPAN_BITS);
        sel[ln] = ok && !nul;
      } else if (ld[0] == LANE_LIMBS) {
        int32_t hi = 0, lo = 0, d18 = 0;
        int ndig = 0;
        bool ok = false, nul = false, big = false, excl_zero = false, incl_null = false;
        if (d[0] == UNIT_SLOTS) {
          hi = pk.slot(d + 2);
          lo = pk.slot(d + 5);
          d18 = pk.slot(d + 8);
          ndig = pk.slot(d + 11);
          ok = pk.slot(d + 14) != 0;
          nul = pk.slot(d + 17) != 0;
          big = pk.slot(d + 20) != 0;
          excl_zero = d[1] == NULL_ZERO;
          incl_null = d[1] == NULL_DASH;
        }
        frame_limbs(hi, lo, d18, ndig, !ok || big || nul, &v0[ln], &v1[ln], &v2[ln]);
        fold = fold || (base_valid && uncovered);
        const bool is_zero = v0[ln] == 0 && v1[ln] == 0 && v2[ln] == 0;
        sel[ln] = ok && (nul ? incl_null : !(excl_zero && is_zero));
      } else {   // time
        uint32_t c1 = 0, c2 = 0;
        int32_t off = 0;
        bool ok = false;
        if (d[0] == UNIT_SLOTS) {
          c1 = static_cast<uint32_t>(pk.slot(d + 2));
          c2 = static_cast<uint32_t>(pk.slot(d + 5));
          off = pk.slot(d + 8);
          ok = pk.slot(d + 11) != 0;
        }
        const int year = c1 & 0x3FFF, month = (c1 >> 14) & 0xF;
        const int day = (c1 >> 18) & 0x1F, hour = (c1 >> 23) & 0x1F;
        const int minute = c2 & 0x3F, second = (c2 >> 6) & 0x3F;
        const bool in_range = year >= 1902 && year <= 2037;
        fold = fold || (base_valid && (uncovered || (ok && !in_range)));
        // days from civil (era / year-of-era / day-of-year)
        const long long y = (in_range ? year : 2000) - (month <= 2 ? 1 : 0);
        const long long era = floor_div(y >= 0 ? y : y - 399, 400);
        const long long yoe = y - era * 400;
        const long long mp = (month + 9) % 12;
        const long long doy = (153 * mp + 2) / 5 + day - 1;
        const long long doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
        const long long days = era * 146097 + doe - 719468;
        const long long secs = days * 86400 + hour * 3600 + minute * 60 + second -
                               static_cast<long long>(off);
        v0[ln] = static_cast<int32_t>(floor_div(secs, ld[2]));
        sel[ln] = ok;
      }
    }

    // Global Long-overflow fold over every requested long / secmillis field
    // of the winner: the big bit or a full 19-digit frame.
    for (int e = 0; e < n_ovf; ++e) {
      const int32_t* o = ovf + OVFW * e;
      if (o[0] != winner) continue;
      const bool ok = pk.slot(o + 1) != 0, nul = pk.slot(o + 4) != 0;
      const bool big = pk.slot(o + 7) != 0;
      fold = fold || (base_valid && ok && !nul && (big || pk.slot(o + 10) >= 19));
    }

    const bool invalid = live && !valid_any && !force_fold;
    uint8_t c = 0;
    if (!live) c = 3;
    else if (invalid && !plaus_any) c = 2;
    else if (force_fold || invalid || (base_valid && fold)) c = 1;
    cls[i] = c;
    const bool counted = c == 0;
    for (int ln = 0; ln < n_lanes; ++ln) {
      const int32_t* ld = lanes_desc + LANEW * ln;
      const bool on = counted && sel[ln];
      int32_t* out = lanes + static_cast<size_t>(ld[1]) * B + i;
      if (ld[0] == LANE_SPAN) {
        out[0] = on ? v0[ln] : -1;
      } else if (ld[0] == LANE_LIMBS) {
        out[0] = on ? v0[ln] : -1;
        out[B] = on ? v1[ln] : 0;
        out[2 * static_cast<size_t>(B)] = on ? v2[ln] : 0;
      } else {
        out[0] = on ? v0[ln] : I32_MAX;
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
  if (U < 1 || U > MAX_UNITS || n_lanes > MAX_LANES || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return 0;
  const int threads = 256;
  agg_lanes_kernel<<<lp::grid_for(B, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
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
