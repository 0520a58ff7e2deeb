// Kernel 3: timestamp layouts (strftime %{...}t and Apache's [%t]) over
// [B] spans.
//
// Replaces logparser_tpu/tpu/timeparse.py parse_device_timestamp up to
// its zone lookup (zone_lookup.cu finishes a %Z layout) and the ts branch
// of pipeline.py compute_rows that packs the bundle.
//
// A thread a line, 256 lines a block, on one of two paths the layout picks
// (TsTables.fixed):
// - Apache's dd/MMM/yyyy:HH:mm:ss ZZ and strftime's %d/%b/%Y:%H:%M:%S %z
//   (the headline's and combinedio_strftime's layouts) run from
//   registers: the window's chunks realigned into words, every item at
//   its static byte, the month one packed case-folded word against the
//   twelve, the numeric tail at bytes 21-26;
// - any other layout, %Z's included, is interpreted from `index`, the
//   image TsTables packs (pipeline.py, TsTables.index): the segment and
//   item rows, each literal and name-table entry as packed words (the
//   bytes little-endian, a letter lowered where it compares case-folded,
//   beside a fold mask holding 0x20 at those letters), and for a %Z table
//   a hash index of its entries.  Each block stages the image into shared memory once (about
//   7.5 KB for a %Z layout), so no thread reads a table from device memory
//   inside its loops.
//
// Each line's window -- the bytes every item and the tail can read, from
// the span start's masked position on (`window`: the segments' windows
// plus the 6-byte tail) -- is loaded up front as aligned 16-byte chunks
// (lp::load16_in), bytes at or past L zeroed; the interpreted path stores
// it into the thread's own slot of shared memory, shifted so that window
// byte 0 sits at byte 0..3 of the slot, and reads shared-memory bytes, or
// 4 bytes at once for a packed compare.  This holds where no cursor can
// cross the mask's span ((start & mask) + window <= mask + 1: all but
// spans that start within a window of a power-of-two bucket's end);
// there, and for a layout whose window passes 113 bytes, the thread runs
// the interpreter through lp::Row::at instead (masked start, 0 past L;
// a register-path layout's image read through L1).
//
// Interpreted items: literals and fixed-width name tables compare packed
// words; digits are summed a byte at a time (wrapping in 32 bits like the
// reference's int32).  A month, weekday or am/pm table is walked in table
// order, an entry compared a word at a time (3-byte months: one word);
// the first match that ends at or before the span end wins.  A %Z entry
// matches only where the zone token -- the run of [A-Za-z0-9_/+-] bytes
// at the cursor, which every zone entry is made of -- is exactly as long
// as the entry (an entry followed by a token byte is no match), so a line
// hashes its case-folded token once and compares only the entries of its
// bucket, kept in table order (the first match in table order still
// wins).  Then the numeric tail (+HHMM / +HH:MM, or Z / +HH:MM) at the
// final cursor, the resolver (clock hour 24 = midnight, 12-hour clock
// with am/pm, two-digit years) and the range checks datetime
// construction enforces.
//
// Outputs 4 rows: c1 = year|month<<14|day<<18|hour<<23, c2 =
// minute|second<<6|milli<<12, the offset seconds, ok.  For a %Z layout
// (zone_mode) row 2 is the wall minute since the epoch (-1 outside
// 1970..2096), row 3 the verdict without the zone's, and zone_out the
// zone index.
//
// Bound: bytes -- the layout's windows (27 bytes for %d/%b/%Y:%H:%M:%S
// %z, 21 + 31 for the %Z layout) plus the token cursors a line, 16 bytes
// written (20 in zone_mode).  The design spends one dependent round trip
// on the cursors and one on the window; the rest is registers, or shared
// memory.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

enum { ITEM_LIT = 0, ITEM_NUM, ITEM_MONTH, ITEM_DOW, ITEM_AMPM, ITEM_ZONE };
// timeparse.NUM_FIELDS order.
enum { F_YEAR, F_YEAR2, F_MONTH, F_DAY, F_HOUR, F_CLOCK_HOUR, F_HOUR12, F_MINUTE,
       F_SECOND, F_MILLI, N_FIELDS };
enum { TAIL_NONE = 0, TAIL_OFFSET = 1, TAIL_OFFSET_COLON = 2 };
// TsTables.fixed (0: none): the register path's hour kind.
enum { FIXED_HOUR = 1, FIXED_CLOCK_HOUR = 2 };
// The image (TsTables.index): [n_segs, n_items], the segment rows (width
// or -1, first item, item count), the item rows (kind, offset, width,
// arg, count), then the patterns and tables the items' args point at.
// A literal's arg: its pattern (want words, fold-mask words).  A name
// table's arg: [record words, zone index of entry 0], then count records
// of (len | fold << 8 | entry number << 16, zone index, want words, mask
// words).  A %Z table's arg: the same header and records, the records
// sorted by bucket (table order within one), preceded by [bucket count]
// and the bucket starts (count + 1 words).
constexpr int IX_NSEGS = 0, IX_HEAD = 2;
constexpr int SEGW = 3, ITEMW = 5;
constexpr int THREADS = 256;
constexpr int MAX_CHUNKS = 8;                       // a window's 16-byte chunks
constexpr int FAST_WINDOW = 16 * MAX_CHUNKS - 15;   // any offset in its first chunk

// A byte the host's greedy zone token [A-Za-z0-9_/+-] continues over.
__device__ __forceinline__ bool zone_char(int c) {
  const int lo = c | 0x20;
  return (lo >= 'a' && lo <= 'z') || lp::is_digit(c) || c == '_' || c == '/' ||
         c == '+' || c == '-';
}

// The low `n` bytes of a word (all of it from 4 on).
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n >= 4 ? 0xFFFFFFFFu : (1u << (8 * n)) - 1u;
}

// The zone token's hash (TsTables._token_hash): its length, then its
// words with every byte OR 0x20, the last one cut to the token.
__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

// The window in the thread's shared-memory slot: byte p of the window
// (the line's byte (start & mask) + p) at p[p].
struct SlotReader {
  const uint8_t* p;
  int s;
  __device__ __forceinline__ int at(int base, int i) const { return p[base - s + i]; }
  __device__ __forceinline__ uint32_t get4(int base, int i) const {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p + (base - s + i));
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    return __funnelshift_r(w[0], w[1], 8 * static_cast<int>(a & 3));
  }
};

// The line in device memory, read as the reference's gather_span_bytes.
struct RowReader {
  lp::Row row;
  __device__ __forceinline__ int at(int base, int i) const { return row.at(base, i); }
  __device__ __forceinline__ uint32_t get4(int base, int i) const {
    return static_cast<uint32_t>(row.at(base, i)) |
           static_cast<uint32_t>(row.at(base, i + 1)) << 8 |
           static_cast<uint32_t>(row.at(base, i + 2)) << 16 |
           static_cast<uint32_t>(row.at(base, i + 3)) << 24;
  }
};

// The `len` bytes at (base, off) against a pattern (want words, then
// fold-mask words at `nw`): ((bytes | mask) & cut) == want a word at a time.
template <class R>
__device__ __forceinline__ bool matches(const R& rd, int base, int off,
                                        const int32_t* pat, int nw, int len) {
  for (int k = 0; 4 * k < len; ++k) {
    const uint32_t v = (rd.get4(base, off + 4 * k) | static_cast<uint32_t>(pat[nw + k])) &
                       low_bytes(len - 4 * k);
    if (v != static_cast<uint32_t>(pat[k])) return false;
  }
  return true;
}

// Fixed-width digits at (base, off).
template <class R>
__device__ __forceinline__ int digits(const R& rd, int base, int off, int width, bool& good) {
  uint32_t v = 0;
  for (int i = 0; i < width; ++i) {
    const uint32_t d = static_cast<uint32_t>(rd.at(base, off + i) - '0') & 0xFFu;
    if (d > 9) good = false;
    v = v * 10u + d;
  }
  return static_cast<int>(v);
}

__device__ __forceinline__ void set_field(int* f, int arg, int v) {
  switch (arg) {   // the same field on every thread: no divergence
    case F_YEAR: f[F_YEAR] = v; break;
    case F_YEAR2: f[F_YEAR2] = v; break;
    case F_MONTH: f[F_MONTH] = v; break;
    case F_DAY: f[F_DAY] = v; break;
    case F_HOUR: f[F_HOUR] = v; break;
    case F_CLOCK_HOUR: f[F_CLOCK_HOUR] = v; break;
    case F_HOUR12: f[F_HOUR12] = v; break;
    case F_MINUTE: f[F_MINUTE] = v; break;
    case F_SECOND: f[F_SECOND] = v; break;
    default: f[F_MILLI] = v; break;
  }
}

// One name or zone table at (cursor, off): (entry number, zone index,
// matched length), or (0, entry 0's zone, 0) with matched false.
template <class R>
__device__ __forceinline__ void match_table(const R& rd, const int32_t* img, const int32_t* it,
                                            int cursor, int e, bool& matched, int& value,
                                            int& zone, int& wsel) {
  const int kind = it[0], off = it[1], width = it[2], count = it[4];
  const int32_t* tab = img + it[3];
  const int rw = tab[0], nw = (rw - 2) / 2;
  zone = tab[1];
  value = 0;
  wsel = 0;
  matched = false;
  const int32_t* rec = tab + 2;
  int first = 0, last = count;
  int want_len = -1;
  if (kind == ITEM_ZONE) {
    // The token: its length T (an entry matches only if its length is T)
    // and its case-folded hash, which picks the bucket.
    int T = 0;
    while (T < width && zone_char(rd.at(cursor, off + T))) ++T;
    uint32_t h = static_cast<uint32_t>(T) * 0x9E3779B1u;
    for (int k = 0; 4 * k < T; ++k) {
      h = hash_step(h, (rd.get4(cursor, off + 4 * k) | 0x20202020u) & low_bytes(T - 4 * k));
    }
    h ^= h >> 16;
    const int nb = tab[2];
    const int32_t* starts = tab + 3;
    const int bk = static_cast<int>(h & static_cast<uint32_t>(nb - 1));
    first = starts[bk];
    last = starts[bk + 1];
    rec = tab + 4 + nb;
    want_len = T;
  }
  for (int n = first; n < last; ++n) {
    const int32_t* r = rec + static_cast<size_t>(n) * rw;
    const int len = r[0] & 0xFF;
    if (want_len >= 0 && len != want_len) continue;
    if (cursor + len <= e && matches(rd, cursor, off, r + 2, nw, len)) {
      value = static_cast<int>(static_cast<uint32_t>(r[0]) >> 16);
      zone = r[1];
      wsel = len;
      matched = true;
      break;
    }
  }
}

// Two digits (wrapping like the reference's int32 sums).
__device__ __forceinline__ int digit2(int c0, int c1, bool& good) {
  const uint32_t d0 = static_cast<uint32_t>(c0 - '0') & 0xFFu;
  const uint32_t d1 = static_cast<uint32_t>(c1 - '0') & 0xFFu;
  good = d0 <= 9 && d1 <= 9;
  return static_cast<int>(d0 * 10u + d1);
}

// The numeric tail from its 6 window bytes t (tail_w: the bytes left in
// the span): [+-]HHMM or [+-]HH:MM (TAIL_OFFSET), 'Z' or [+-]HH:MM
// (TAIL_OFFSET_COLON), nothing (TAIL_NONE).
__device__ __forceinline__ void apply_tail(int tail, int tail_w, const int* t, int& offset,
                                           bool& ok) {
  if (tail == TAIL_NONE) {
    ok = ok && tail_w == 0;
    return;
  }
  const int sign = t[0] == '-' ? -1 : 1;
  const bool sign_ok = t[0] == '+' || t[0] == '-';
  bool oh_ok, m_c_ok;
  const int oh = digit2(t[1], t[2], oh_ok);
  const int m_c = digit2(t[4], t[5], m_c_ok);
  const bool colon_ok = t[3] == ':';
  if (tail == TAIL_OFFSET) {
    bool m_nc_ok;
    const int m_nc = digit2(t[3], t[4], m_nc_ok);
    const bool colon = tail_w == 6;
    const int om = colon ? m_c : m_nc;
    const bool om_ok = colon ? (m_c_ok && colon_ok) : m_nc_ok;
    ok = ok && (tail_w == 5 || colon) && sign_ok && oh_ok && om_ok;
    offset = sign * (oh * 3600 + om * 60);
  } else {
    const bool is_z = tail_w == 1 && (t[0] | 0x20) == 'z';
    const bool full_ok = tail_w == 6 && sign_ok && oh_ok && m_c_ok && colon_ok;
    ok = ok && (is_z || full_ok);
    offset = is_z ? 0 : sign * (oh * 3600 + m_c * 60);
  }
}

// The range checks datetime() construction enforces on the host, then the
// bundle.  Every component is a non-negative digit sum, so C's / and %
// agree with the reference's floor division.
__device__ __forceinline__ void finish_line(int b, int B, int year, int month, int day,
                                            int hour, int minute, int second, int milli,
                                            int offset, bool ok, bool zone_mode, int zone,
                                            int32_t* __restrict__ out,
                                            int32_t* __restrict__ zone_out) {
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

template <class R>
__device__ __forceinline__ void parse_line(
    const R& rd, const int32_t* img, int b, int B, int s, int e, int tail, bool one_shot,
    int default_offset, int min_prefix, bool zone_mode, int32_t* __restrict__ out,
    int32_t* __restrict__ zone_out) {
  const int n_segs = img[IX_NSEGS];
  const int32_t* segs = img + IX_HEAD;
  const int32_t* items = segs + SEGW * n_segs;
  bool ok = (e - s) >= min_prefix;
  int cursor = s;
  int field[N_FIELDS] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  unsigned have = 0;
  int month_from_name = 1, ampm = 0, zone = 0;
  for (int sg = 0; sg < n_segs; ++sg) {
    const int seg_w = segs[SEGW * sg], first = segs[SEGW * sg + 1];
    const int n_items = segs[SEGW * sg + 2];
    for (int i = first; i < first + n_items; ++i) {
      const int32_t* it = items + ITEMW * i;
      const int kind = it[0], off = it[1], width = it[2], arg = it[3];
      if (kind == ITEM_LIT) {
        ok = ok && matches(rd, cursor, off, img + arg, (width + 3) / 4, width);
      } else if (kind == ITEM_NUM) {
        bool good = true;
        set_field(field, arg, digits(rd, cursor, off, width, good));
        have |= 1u << arg;
        ok = ok && good;
      } else {
        bool matched;
        int value, zi, wsel;
        match_table(rd, img, it, cursor, e, matched, value, zi, wsel);
        ok = ok && matched;
        if (kind == ITEM_MONTH) {
          month_from_name = value + 1;
        } else if (kind == ITEM_AMPM) {
          ampm = value;
        } else if (kind == ITEM_ZONE) {
          zone = zi;
        }
        if (seg_w < 0) cursor += wsel;
      }
    }
    if (seg_w >= 0) cursor += seg_w;
  }

  // The tail at the final cursor (in the shared window when one_shot).
  const int tb = one_shot ? s : cursor;
  const int toff = one_shot ? segs[0] : 0;
  int offset = default_offset;
  int t[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) t[i] = tail == TAIL_NONE ? 0 : rd.at(tb, toff + i);
  apply_tail(tail, e - cursor, t, offset, ok);

  // Resolve (the host's SMART resolver).
  const int year = (have >> F_YEAR) & 1 ? field[F_YEAR] : 2000 + field[F_YEAR2];
  const int month = (have >> F_MONTH) & 1 ? field[F_MONTH] : month_from_name;
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
  finish_line(b, B, year, month, field[F_DAY], hour, field[F_MINUTE], field[F_SECOND],
              field[F_MILLI], offset, ok, zone_mode, zone, out, zone_out);
}

// Byte i (static) of the window words w.
#define WBYTE(w, i) static_cast<int>(((w)[(i) >> 2] >> (8 * ((i) & 3))) & 0xFFu)

// Apache's dd/MMM/yyyy:HH:mm:ss segment (21 bytes, its ' ' included) in
// English, from the window's words in registers: every item at its static
// byte, the month one packed, case-folded word against the twelve.
// clock: the hour is strftime's %H (24 = midnight, 25 up invalid).
__device__ __forceinline__ void fixed_segment(const uint32_t* w, bool clock, int s, int e,
                                              bool& ok, int& year, int& month, int& day,
                                              int& hour, int& minute, int& second) {
  bool g0, g1, g2, g3, g4, g5;
  day = digit2(WBYTE(w, 0), WBYTE(w, 1), g0);
  year = static_cast<int>(static_cast<uint32_t>(digit2(WBYTE(w, 7), WBYTE(w, 8), g1)) * 100u +
                          static_cast<uint32_t>(digit2(WBYTE(w, 9), WBYTE(w, 10), g2)));
  const int hh = digit2(WBYTE(w, 12), WBYTE(w, 13), g3);
  minute = digit2(WBYTE(w, 15), WBYTE(w, 16), g4);
  second = digit2(WBYTE(w, 18), WBYTE(w, 19), g5);
  ok = ok && g0 && g1 && g2 && g3 && g4 && g5 && WBYTE(w, 2) == '/' && WBYTE(w, 6) == '/' &&
       WBYTE(w, 11) == ':' && WBYTE(w, 14) == ':' && WBYTE(w, 17) == ':' && WBYTE(w, 20) == ' ';
  // The month: the first of Jan..Dec equal to bytes 3-5 folded (the entry
  // must end by the span end).
  const uint32_t folded = (((w[0] >> 24) | (w[1] << 8)) & 0xFFFFFFu) | 0x202020u;
  month = 1;
  bool matched = false;
  if (s + 3 <= e) {
    const uint32_t months[12] = {0x6E616Au, 0x626566u, 0x72616Du, 0x727061u, 0x79616Du,
                                 0x6E756Au, 0x6C756Au, 0x677561u, 0x706573u, 0x74636Fu,
                                 0x766F6Eu, 0x636564u};   // "jan".."dec", little-endian
#pragma unroll
    for (int m = 11; m >= 0; --m) {
      if (folded == months[m]) {
        month = m + 1;
        matched = true;
      }
    }
  }
  ok = ok && matched;
  hour = hh;
  if (clock) {
    ok = ok && hh <= 24;
    hour = hh == 24 ? 0 : hh;
  }
}

// The register path (TsTables.fixed): Apache's segment, then its numeric
// tail (+HHMM / +HH:MM).
__device__ __forceinline__ void parse_fixed(const uint32_t* w, int fixed, int b, int B, int s,
                                            int e, int min_prefix,
                                            int32_t* __restrict__ out) {
  bool ok = (e - s) >= min_prefix;
  int year, month, day, hour, minute, second;
  fixed_segment(w, fixed == FIXED_CLOCK_HOUR, s, e, ok, year, month, day, hour, minute, second);
  int offset = 0;
  const int t[6] = {WBYTE(w, 21), WBYTE(w, 22), WBYTE(w, 23), WBYTE(w, 24), WBYTE(w, 25),
                    WBYTE(w, 26)};
  apply_tail(TAIL_OFFSET, e - (s + 21), t, offset, ok);
  finish_line(b, B, year, month, day, hour, minute, second, 0, offset, ok, false, 0, out,
              nullptr);
}

// The first `keep` bytes of a chunk (keep 0 to 15), the rest 0.
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int keep) {
  v.x &= low_bytes(keep < 0 ? 0 : keep);
  v.y &= low_bytes(keep - 4 < 0 ? 0 : keep - 4);
  v.z &= low_bytes(keep - 8 < 0 ? 0 : keep - 8);
  v.w &= low_bytes(keep - 12 < 0 ? 0 : keep - 12);
  return v;
}

__global__ void __launch_bounds__(THREADS) timestamp_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ start_row, const int32_t* __restrict__ end_row,
    const int32_t* __restrict__ index, int index_words, int window, int slot_words,
    int fixed, int tail, bool one_shot, int default_offset, int min_prefix, bool zone_mode,
    int32_t* __restrict__ out, int32_t* __restrict__ zone_out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int b = blockIdx.x * THREADS + threadIdx.x;
  const bool live = b < B;
  int s = 0, e = 0;
  if (live) {
    s = start_row[b];
    e = end_row[b];
  }
  const uint8_t* line = buf + static_cast<size_t>(b) * L;
  const int base0 = s & mask;
  const bool staged = live && window <= FAST_WINDOW && base0 + window <= mask + 1;

  // The window's chunks, loads issued before the image is staged.
  const uint8_t* w0 = line + base0;
  const uint8_t* a0 = lp::align_down16(w0);
  const int o = static_cast<int>(w0 - a0);
  const int n_chunks = (o + window + 15) >> 4;
  const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
  uint4 v[MAX_CHUNKS];
#pragma unroll
  for (int c = 0; c < MAX_CHUNKS; ++c) {
    v[c] = make_uint4(0u, 0u, 0u, 0u);
    const int lpos = base0 - o + 16 * c;   // the chunk's first byte in the line
    if (staged && c < n_chunks && lpos < L) {
      v[c] = keep_bytes(lp::load16_in(a0 + 16 * c, buf, buf_end), L - lpos);
    }
  }
  const int q = o >> 2;
  if (fixed != 0) {
    // No shared memory: the window's 27 bytes realigned in registers (from
    // the first 3 chunks: o + 27 <= 42 bytes).
    if (!live) return;
    if (!staged) {
      parse_line(RowReader{lp::Row{line, L, mask}}, index, b, B, s, e, tail, one_shot,
                 default_offset, min_prefix, zone_mode, out, zone_out);
      return;
    }
    uint32_t x[12], y[8], w[7];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[4 * c] = v[c].x;
      x[4 * c + 1] = v[c].y;
      x[4 * c + 2] = v[c].z;
      x[4 * c + 3] = v[c].w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      y[i] = q == 0 ? x[i] : q == 1 ? x[i + 1] : q == 2 ? x[i + 2] : x[i + 3];
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) w[i] = __funnelshift_r(y[i], y[i + 1], 8 * (o & 3));
    parse_fixed(w, fixed, b, B, s, e, min_prefix, out);
    return;
  }
  int32_t* img = smem;
  uint32_t* slot = reinterpret_cast<uint32_t*>(smem + ((index_words + 3) & ~3)) +
                   threadIdx.x * slot_words;
  for (int i = threadIdx.x; i < index_words; i += THREADS) img[i] = __ldg(index + i);
  if (staged) {
    // In-word j of the chunks lands at slot word j - o / 4: window byte p
    // at slot byte p + o % 4.
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) {
      const uint32_t wc[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int at = 4 * c + k - q;
        if (c < n_chunks && at >= 0 && at < slot_words) slot[at] = wc[k];
      }
    }
  }
  __syncthreads();
  if (!live) return;
  if (staged) {
    const SlotReader rd{reinterpret_cast<const uint8_t*>(slot) + (o & 3), s};
    parse_line(rd, img, b, B, s, e, tail, one_shot, default_offset, min_prefix, zone_mode,
               out, zone_out);
  } else {
    const RowReader rd{lp::Row{line, L, mask}};
    parse_line(rd, img, b, B, s, e, tail, one_shot, default_offset, min_prefix, zone_mode,
               out, zone_out);
  }
}

}  // namespace

// index: TsTables.index, the layout's image (index_words words); window:
// the bytes a line's items and tail can read from its span start
// (TsTables.window); fixed: TsTables.fixed, the register path's layout
// (Apache's, or strftime's %d/%b/%Y:%H:%M:%S %z), else 0.
LP_EXPORT int lp_timestamp(const void* buf, int B, int L, const void* start_row,
                           const void* end_row, const void* index, int index_words,
                           int window, int fixed, int tail, int one_shot, int default_offset,
                           int min_prefix, int zone_mode, void* out, void* zone_out,
                           void* stream) {
  if (B <= 0) return 0;
  if (zone_mode && zone_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (index_words < IX_HEAD || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (fixed != 0 && ((fixed != FIXED_HOUR && fixed != FIXED_CLOCK_HOUR) || zone_mode ||
                     tail != TAIL_OFFSET || window != 27)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A slot holds the window from byte 0..3 on, and the word after its last.
  const int slot_words = (((window + 2) >> 2) + 2) | 1;   // odd: fewer bank conflicts
  const size_t smem =
      fixed != 0 ? 0
                 : 4 * (static_cast<size_t>((index_words + 3) & ~3) +
                        static_cast<size_t>(THREADS) * (window <= FAST_WINDOW ? slot_words : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        timestamp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (static_cast<long long>(B) + THREADS - 1) / THREADS;
  timestamp_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(start_row), static_cast<const int32_t*>(end_row),
      static_cast<const int32_t*>(index), index_words, window, slot_words, fixed, tail,
      one_shot != 0, default_offset, min_prefix, zone_mode != 0,
      static_cast<int32_t*>(out), static_cast<int32_t*>(zone_out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_timestamp_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
