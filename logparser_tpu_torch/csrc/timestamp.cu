// Kernel 3: one fixed-width timestamp layout with a ZZ offset tail, over
// [B] spans.
//
// Replaces logparser_tpu/tpu/timeparse.py parse_device_timestamp (its
// one-segment path: one window gathered at the span start) and the ts
// branch of pipeline.py compute_rows that packs the bundle.
//
// One thread per line walks the layout's item table: literals (ASCII
// letters compare case-folded), fixed-width digit fields and the
// fixed-width month-name table (first matching entry wins), then the
// numeric UTC offset (+HHMM or +HH:MM).  Range checks mirror datetime
// construction (leap years, 60 -> 59 seconds).  Outputs 4 rows: c1 =
// year|month<<14|day<<18|hour<<23, c2 = minute|second<<6 (milli 0), the
// offset seconds, and ok.  Digit sums wrap in 32 bits like the
// reference's int32 arithmetic.
//
// Bound: the layout's window (27 bytes for Apache's [%t]) plus the token
// cursors per line, and 16 bytes written per line.

#include "lp_common.cuh"

namespace {

enum { ITEM_LIT = 0, ITEM_NUM = 1, ITEM_NAME = 2 };
// timeparse.NUM_FIELDS order.
enum { F_YEAR, F_MONTH, F_DAY, F_HOUR, F_MINUTE, F_SECOND, N_FIELDS };
constexpr int TAIL_WIDTH = 6;

__device__ __forceinline__ bool byte_matches(int c, int want) {
  const int folded = want | 0x20;
  if (folded >= 'a' && folded <= 'z') return (c | 0x20) == folded;
  return c == want;
}

// Fixed-width digits at window offset off (the window starts at start).
__device__ __forceinline__ uint32_t digits(const lp::Row& row, int start,
                                           int off, int width, bool& good) {
  uint32_t v = 0;
  for (int i = 0; i < width; ++i) {
    const uint32_t d = static_cast<uint32_t>(row.at(start, off + i) - '0') & 0xFFu;
    if (d > 9) good = false;
    v = v * 10u + d;
  }
  return v;
}

__global__ void timestamp_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ start_row, const int32_t* __restrict__ end_row,
    const int32_t* __restrict__ items, int n_items,
    const int32_t* __restrict__ text, const int32_t* __restrict__ names,
    int n_names, int namew, int seg_w, int min_prefix,
    int32_t* __restrict__ out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const lp::Row row{buf + static_cast<size_t>(b) * L, L, mask};
    const int s = start_row[b], e = end_row[b];
    bool ok = (e - s) >= min_prefix;
    uint32_t field[N_FIELDS] = {0, 0, 0, 0, 0, 0};
    bool have_month = false;
    uint32_t month_from_name = 1;
    for (int it = 0; it < n_items; ++it) {
      const int kind = items[4 * it], off = items[4 * it + 1];
      const int width = items[4 * it + 2], arg = items[4 * it + 3];
      if (kind == ITEM_LIT) {
        for (int i = 0; i < width; ++i) {
          if (!byte_matches(row.at(s, off + i), text[arg + i])) ok = false;
        }
      } else if (kind == ITEM_NUM) {
        bool good = true;
        field[arg] = digits(row, s, off, width, good);
        have_month = have_month || arg == F_MONTH;
        ok = ok && good;
      } else {
        int value = 0;
        bool matched = false;
        for (int n = 0; n < n_names && !matched; ++n) {
          const int32_t* entry = names + n * namew;
          const int len = entry[0];
          bool m = s + len <= e;
          for (int i = 0; i < len && m; ++i) {
            m = byte_matches(row.at(s, off + i), entry[1 + i]);
          }
          if (m) { value = n; matched = true; }
        }
        ok = ok && matched;
        month_from_name = static_cast<uint32_t>(value + 1);
      }
    }

    // ZZ: [+-]HHMM (5 bytes) or [+-]HH:MM (6 bytes).
    const int tail_w = e - (s + seg_w);
    const int sign_b = row.at(s, seg_w);
    const int sign = sign_b == '-' ? -1 : 1;
    bool oh_ok = true, m_nc_ok = true, m_c_ok = true;
    const int oh = static_cast<int>(digits(row, s, seg_w + 1, 2, oh_ok));
    const int m_nc = static_cast<int>(digits(row, s, seg_w + 3, 2, m_nc_ok));
    const int m_c = static_cast<int>(digits(row, s, seg_w + 4, 2, m_c_ok));
    const bool colon = tail_w == 6;
    const int om = colon ? m_c : m_nc;
    const bool om_ok = colon ? (m_c_ok && row.at(s, seg_w + 3) == ':') : m_nc_ok;
    ok = ok && (tail_w == 5 || colon) && (sign_b == '+' || sign_b == '-') &&
         oh_ok && om_ok;
    const int offset = sign * (oh * 3600 + om * 60);

    const int year = static_cast<int>(field[F_YEAR]);
    const int month = static_cast<int>(have_month ? field[F_MONTH] : month_from_name);
    const int day = static_cast<int>(field[F_DAY]);
    const int hour = static_cast<int>(field[F_HOUR]);
    const int minute = static_cast<int>(field[F_MINUTE]);
    int second = static_cast<int>(field[F_SECOND]);
    // Range checks = what datetime() construction enforces on the host
    // (a year below 1 fails before the leap rule matters).
    const bool leap = (year % 4 == 0 && year % 100 != 0) || year % 400 == 0;
    const bool thirty = month == 4 || month == 6 || month == 9 || month == 11;
    const int dim = thirty ? 30 : (month == 2 ? (leap ? 29 : 28) : 31);
    ok = ok && year >= 1 && month >= 1 && month <= 12 && day >= 1 &&
         day <= dim && hour <= 23 && minute <= 59 && second <= 60 &&
         offset < 86400 && offset > -86400;
    if (second > 59) second = 59;

    const uint32_t c1 = static_cast<uint32_t>(year) |
                        (static_cast<uint32_t>(month) << 14) |
                        (static_cast<uint32_t>(day) << 18) |
                        (static_cast<uint32_t>(hour) << 23);
    const uint32_t c2 = static_cast<uint32_t>(minute) |
                        (static_cast<uint32_t>(second) << 6);
    out[b] = static_cast<int>(c1);
    out[static_cast<size_t>(B) + b] = static_cast<int>(c2);
    out[2 * static_cast<size_t>(B) + b] = offset;
    out[3 * static_cast<size_t>(B) + b] = ok ? 1 : 0;
  }
}

}  // namespace

LP_EXPORT int lp_timestamp(const void* buf, int B, int L, const void* start_row,
                           const void* end_row, const void* items, int n_items,
                           const void* text, const void* names, int n_names,
                           int namew, int seg_w, int min_prefix, void* out,
                           void* stream) {
  if (B <= 0) return 0;
  if (seg_w + TAIL_WIDTH > L) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  timestamp_kernel<<<lp::grid_for(B, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(start_row), static_cast<const int32_t*>(end_row),
      static_cast<const int32_t*>(items), n_items,
      static_cast<const int32_t*>(text), static_cast<const int32_t*>(names),
      n_names, namew, seg_w, min_prefix, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_timestamp_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
