// Kernel 3: timestamp layouts (strftime %{...}t and Apache's [%t]) over
// [B] spans.
//
// Replaces logparser_tpu/tpu/timeparse.py parse_device_timestamp up to
// its zone lookup (zone_lookup.cu finishes a %Z layout) and the ts branch
// of pipeline.py compute_rows that packs the bundle.
//
// One thread per line walks the layout's segment table at a per-row
// cursor.  A fixed segment reads its items at static offsets from the
// cursor and advances it by its width; a variable segment holds one name
// table (English full month names, %Z zone text) and advances it by the
// matched entry.  Items: literals (ASCII letters compare case-folded),
// fixed-width digit fields, name / am-pm / zone tables (the first match in
// table order wins, an entry must end at or before the span end, a zone
// entry compares exactly unless it is an abbreviation and must not be
// followed by a zone-token byte [A-Za-z0-9_/+-]).  Then the numeric tail
// (+HHMM / +HH:MM, or Z / +HH:MM) at the final cursor, the resolver
// (clock hour 24 = midnight, 12-hour clock with am/pm, two-digit years)
// and the range checks datetime construction enforces.  Every read goes
// through lp::Row::at, the reference's gather_span_bytes: a segment's
// window starts at the cursor (one window from the span start when a
// single fixed segment and the tail fit the line: `one_shot`).
//
// Outputs 4 rows: c1 = year|month<<14|day<<18|hour<<23, c2 =
// minute|second<<6|milli<<12, the offset seconds, ok.  For a %Z layout
// (zone_mode) row 2 is the wall minute since the epoch (-1 outside
// 1970..2096), row 3 the verdict without the zone's, and zone_out the
// zone index.  Digit sums wrap in 32 bits like the reference's int32.
//
// Bound: bytes -- the layout's windows (27 bytes for %d/%b/%Y:%H:%M:%S
// %z, 21 + 31 for the %Z layout) plus the token cursors a line, 16 bytes
// written (20 in zone_mode).

#include "lp_common.cuh"

namespace {

enum { ITEM_LIT = 0, ITEM_NUM, ITEM_MONTH, ITEM_DOW, ITEM_AMPM, ITEM_ZONE };
// timeparse.NUM_FIELDS order.
enum { F_YEAR, F_YEAR2, F_MONTH, F_DAY, F_HOUR, F_CLOCK_HOUR, F_HOUR12, F_MINUTE,
       F_SECOND, F_MILLI, N_FIELDS };
enum { TAIL_NONE = 0, TAIL_OFFSET = 1, TAIL_OFFSET_COLON = 2 };
constexpr int SEGW = 3, ITEMW = 5;

__device__ __forceinline__ bool byte_matches(int c, int want) {
  const int folded = want | 0x20;
  if (folded >= 'a' && folded <= 'z') return (c | 0x20) == folded;
  return c == want;
}

// A byte the host's greedy zone token [A-Za-z0-9_/+-] continues over.
__device__ __forceinline__ bool zone_char(int c) {
  const int lo = c | 0x20;
  return (lo >= 'a' && lo <= 'z') || lp::is_digit(c) || c == '_' || c == '/' ||
         c == '+' || c == '-';
}

// Fixed-width digits at offset off of the window starting at base.
__device__ __forceinline__ int digits(const lp::Row& row, int base, int off, int width,
                                      bool& good) {
  uint32_t v = 0;
  for (int i = 0; i < width; ++i) {
    const uint32_t d = static_cast<uint32_t>(row.at(base, off + i) - '0') & 0xFFu;
    if (d > 9) good = false;
    v = v * 10u + d;
  }
  return static_cast<int>(v);
}

__global__ void timestamp_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ start_row, const int32_t* __restrict__ end_row,
    const int32_t* __restrict__ segs, int n_segs, const int32_t* __restrict__ items,
    const int32_t* __restrict__ text, const int32_t* __restrict__ entries, int entw,
    int tail, bool one_shot, int default_offset, int min_prefix, bool zone_mode,
    int32_t* __restrict__ out, int32_t* __restrict__ zone_out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const lp::Row row{buf + static_cast<size_t>(b) * L, L, mask};
    const int s = start_row[b], e = end_row[b];
    bool ok = (e - s) >= min_prefix;
    int cursor = s;
    int field[N_FIELDS] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    unsigned have = 0;
    int month_from_name = 1, ampm = 0, zone = 0;
    for (int sg = 0; sg < n_segs; ++sg) {
      const int seg_w = segs[SEGW * sg], first = segs[SEGW * sg + 1];
      const int n_items = segs[SEGW * sg + 2];
      for (int it = first; it < first + n_items; ++it) {
        const int* item = items + ITEMW * it;
        const int kind = item[0], off = item[1], width = item[2], arg = item[3];
        if (kind == ITEM_LIT) {
          for (int i = 0; i < width; ++i) {
            if (!byte_matches(row.at(cursor, off + i), text[arg + i])) ok = false;
          }
        } else if (kind == ITEM_NUM) {
          bool good = true;
          field[arg] = digits(row, cursor, off, width, good);
          have |= 1u << arg;
          ok = ok && good;
        } else {
          int value = 0, wsel = 0;
          bool matched = false;
          const int count = item[4];
          for (int n = 0; n < count && !matched; ++n) {
            const int32_t* ent = entries + static_cast<size_t>(arg + n) * entw;
            const int len = ent[0];
            const bool fold = ent[1] != 0;
            bool m = cursor + len <= e;
            for (int i = 0; i < len && m; ++i) {
              const int c = row.at(cursor, off + i);
              m = fold ? byte_matches(c, ent[3 + i]) : c == ent[3 + i];
            }
            if (m && kind == ITEM_ZONE) m = !zone_char(row.at(cursor, off + len));
            if (m) {
              value = n;
              wsel = len;
              matched = true;
            }
          }
          ok = ok && matched;
          if (kind == ITEM_MONTH) {
            month_from_name = value + 1;
          } else if (kind == ITEM_AMPM) {
            ampm = value;
          } else if (kind == ITEM_ZONE) {
            zone = entries[static_cast<size_t>(arg + value) * entw + 2];
          }
          if (seg_w < 0) cursor += wsel;
        }
      }
      if (seg_w >= 0) cursor += seg_w;
    }

    // The tail at the final cursor (in the shared window when one_shot).
    const int tail_w = e - cursor;
    const int tb = one_shot ? s : cursor;
    const int toff = one_shot ? segs[0] : 0;
    int offset = default_offset;
    if (tail == TAIL_NONE) {
      ok = ok && tail_w == 0;
    } else {
      const int sign_b = row.at(tb, toff);
      const int sign = sign_b == '-' ? -1 : 1;
      const bool sign_ok = sign_b == '+' || sign_b == '-';
      bool oh_ok = true, m_c_ok = true;
      const int oh = digits(row, tb, toff + 1, 2, oh_ok);
      const int m_c = digits(row, tb, toff + 4, 2, m_c_ok);
      const bool colon_ok = row.at(tb, toff + 3) == ':';
      if (tail == TAIL_OFFSET) {
        // [+-]HHMM (5 bytes) or [+-]HH:MM (6 bytes).
        bool m_nc_ok = true;
        const int m_nc = digits(row, tb, toff + 3, 2, m_nc_ok);
        const bool colon = tail_w == 6;
        const int om = colon ? m_c : m_nc;
        const bool om_ok = colon ? (m_c_ok && colon_ok) : m_nc_ok;
        ok = ok && (tail_w == 5 || colon) && sign_ok && oh_ok && om_ok;
        offset = sign * (oh * 3600 + om * 60);
      } else {
        // 'Z' (1 byte) or [+-]HH:MM (6 bytes).
        const bool is_z = tail_w == 1 && (row.at(tb, toff) | 0x20) == 'z';
        const bool full_ok = tail_w == 6 && sign_ok && oh_ok && m_c_ok && colon_ok;
        ok = ok && (is_z || full_ok);
        offset = is_z ? 0 : sign * (oh * 3600 + m_c * 60);
      }
    }

    // Resolve (the host's SMART resolver).
    const int year = (have >> F_YEAR) & 1 ? field[F_YEAR] : 2000 + field[F_YEAR2];
    const int month = (have >> F_MONTH) & 1 ? field[F_MONTH] : month_from_name;
    const int day = field[F_DAY];
    int hour = 0;
    if ((have >> F_HOUR) & 1) {
      hour = field[F_HOUR];
    } else if ((have >> F_CLOCK_HOUR) & 1) {
      const int ch = field[F_CLOCK_HOUR];
      ok = ok && ch <= 24;   // 0 and 24 both mean midnight; 25+ is invalid
      hour = ch == 24 ? 0 : ch;
    } else if ((have >> F_HOUR12) & 1) {
      hour = field[F_HOUR12] % 12 + 12 * ampm;
    }
    const int minute = field[F_MINUTE];
    int second = field[F_SECOND];
    const int milli = field[F_MILLI];

    // Range checks = what datetime() construction enforces on the host.
    // Every component is a non-negative digit sum, so C's / and % agree
    // with the reference's floor division.
    const bool leap = (year % 4 == 0 && year % 100 != 0) || year % 400 == 0;
    const bool thirty = month == 4 || month == 6 || month == 9 || month == 11;
    const int dim = thirty ? 30 : (month == 2 ? (leap ? 29 : 28) : 31);
    ok = ok && year >= 1 && month >= 1 && month <= 12 && day >= 1 && day <= dim &&
         hour <= 23 && minute <= 59 && second <= 60 && milli <= 999;
    int row2 = offset;
    if (zone_mode) {
      // Wall minutes since the epoch (days from civil); years outside
      // [1970, 2096] leave the zone tables' window (and would overflow).
      row2 = -1;
      if (year >= 1970 && year <= 2096) {
        const int yy = year - (month <= 2 ? 1 : 0);
        const int era = yy / 400;
        const int yoe = yy - era * 400;
        const int doy = (153 * (month + (month > 2 ? -3 : 9)) + 2) / 5 + day - 1;
        const int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
        const int days = era * 146097 + doe - 719468;
        row2 = days * 1440 + hour * 60 + minute;
      }
      zone_out[b] = zone;
    } else {
      ok = ok && offset < 86400 && offset > -86400;
    }
    if (second > 59) second = 59;   // leap second: SMART clamps 60 -> 59

    const uint32_t c1 = static_cast<uint32_t>(year) |
                        (static_cast<uint32_t>(month) << 14) |
                        (static_cast<uint32_t>(day) << 18) |
                        (static_cast<uint32_t>(hour) << 23);
    const uint32_t c2 = static_cast<uint32_t>(minute) |
                        (static_cast<uint32_t>(second) << 6) |
                        (static_cast<uint32_t>(milli) << 12);
    out[b] = static_cast<int>(c1);
    out[static_cast<size_t>(B) + b] = static_cast<int>(c2);
    out[2 * static_cast<size_t>(B) + b] = row2;
    out[3 * static_cast<size_t>(B) + b] = ok ? 1 : 0;
  }
}

}  // namespace

LP_EXPORT int lp_timestamp(const void* buf, int B, int L, const void* start_row,
                           const void* end_row, const void* segs, int n_segs,
                           const void* items, const void* text, const void* entries,
                           int entw, int tail, int one_shot, int default_offset,
                           int min_prefix, int zone_mode, void* out, void* zone_out,
                           void* stream) {
  if (B <= 0) return 0;
  if (zone_mode && zone_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  timestamp_kernel<<<lp::grid_for(B, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(start_row), static_cast<const int32_t*>(end_row),
      static_cast<const int32_t*>(segs), n_segs, static_cast<const int32_t*>(items),
      static_cast<const int32_t*>(text), static_cast<const int32_t*>(entries), entw,
      tail, one_shot != 0, default_offset, min_prefix, zone_mode != 0,
      static_cast<int32_t*>(out), static_cast<int32_t*>(zone_out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_timestamp_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
