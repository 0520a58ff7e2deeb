// Kernel 4: bit-packing of every component into the [K + 4V, B] int32
// output, the row-0 verdict of each format unit, and the winner-merged
// Arrow view rows.
//
// Replaces, from logparser_tpu/tpu/pipeline.py: the put / put_span
// packing and row-0 assembly of compute_rows, the row stacking of
// _units_rows_and_prefixes, and compute_view_rows.
//
// Per unit the line constraints apply in plan order, as (component, kind)
// rows: kind 0 requires the component, kind 1 (a query-string overflow)
// fails the line and raises bit 2 only where the line is still valid at
// that point, kind 2 (a URI over its window) fails it and raises bit 2
// unmasked, kind 3 fails the line where the component is set (a geo token
// holding a ':', a Set-Cookie quirk, a leading zero under the number ->
// CLF conversion), kind 4 fails it always (a plausibility-only unit);
// row 0 = valid | plausible<<1 | overflow<<2 | (esc_hit & valid)<<3.  Per
// output row: OR of its slots, (comp & (2^bits - 1)) << shift (bits 0 =
// the full word).  Views: the winner is the first unit whose row 0 is
// valid (0 when none), un-claimed when an earlier unit is still
// plausible; each view field takes the winner's span word (start|len,
// live bit 26) and 3 prefix words when ok and not null.
//
// Bound: reads the components once (n_comp * 4 bytes per line) and
// writes (K + 4V) * 4 bytes per line.  The one-thread-a-line loop made K
// dependent steps a thread, so a warp had about one load in flight.  Here
// a block takes tiles of 32 * LPT lines (a thread LPT lines 32 apart, so
// every component load and row store is one 128-byte row segment a line
// group) and spreads the tile's plan over its WARPS warps in two phases:
//   1. each warp streams a contiguous run of output rows, balanced by slot
//      count, 8 slots a step: the 8 slots' loads (times LPT) in flight
//      together, then ORed into the rows they close, a row stored as the
//      stream passes its end (rows of no slot included); a unit's row 0
//      goes to shared memory instead, and unit u's line constraints run on
//      warp u % WARPS beside its stream;
//   2. after one barrier, each unit's row 0 (its slots | its verdict) and
//      each view field: the winner (the first unit valid, un-claimed when
//      an earlier unit is still plausible), its span word recomputed from
//      the span row's slots (no read-back of `out`) with the 3 prefix
//      loads in flight beside it, the entry found through the host's
//      [V, U] index (`view_of`) instead of a walk over every entry.
// The plan tables are read through L1 (warp-uniform loads; staging them
// in shared memory measured slower); a persistent grid strides over the
// tiles; verdicts and row-0 partials are double-buffered by tile, so one
// barrier a tile suffices.

#include "lp_common.cuh"

namespace {

constexpr int MAX_UNITS = 8;
constexpr int WARPS = 4;
constexpr int LPT = 2;                 // lines a thread
constexpr int LINES = 32 * LPT;        // lines a tile
constexpr int STEP = 8;                // slots a stream step

struct Tables {
  const int32_t* units;   // [U, 3] row offset, first constraint, count
  const int32_t* cons;    // [n_cons, 2] component, kind
  const int32_t* rows;    // [K, 3] unit or -1, first slot, count (slots in row order)
  const int32_t* slots;   // [n_slots, 3] component, shift, bits
  const int32_t* views;   // [n_views, 4] field, unit, span row, first prefix
  const int32_t* view_of; // [V, U] entry of (field, unit) or -1
};

struct PackArgs {
  int B, U, K, V, n_slots;
  const int32_t* flags;
  const int32_t* comps;
  Tables g;
  int32_t* out;
};

__device__ __forceinline__ uint32_t shaped(uint32_t v, int shift, int bits) {
  return bits ? (v & ((1u << bits) - 1u)) << shift : v;
}

__device__ __forceinline__ uint32_t comp_at(const int32_t* comps, size_t B, int c, int b) {
  return static_cast<uint32_t>(__ldg(comps + c * B + b));
}

// OR of row r's slots for line b, the slot loads of each group of 4 in
// flight together.
__device__ __forceinline__ uint32_t slots_word(const Tables& t, const int32_t* comps, size_t B,
                                               int r, int b) {
  uint32_t acc = 0u;
  const int first = t.rows[3 * r + 1], end = first + t.rows[3 * r + 2];
  for (int i = first; i < end; i += 4) {
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < end ? comp_at(comps, B, t.slots[3 * (i + k)], b) : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < end) acc |= shaped(v[k], t.slots[3 * (i + k) + 1], t.slots[3 * (i + k) + 2]);
    }
  }
  return acc;
}

// Unit u's verdict bits for line b: the constraints in plan order.  The
// flags and the first 8 constraints' components are loaded together.
__device__ __forceinline__ uint32_t unit_verdict(const Tables& t, const int32_t* flags,
                                                 const int32_t* comps, size_t B, int u, int b) {
  const int f = __ldg(flags + u * B + b);
  bool valid = true, over = false;
  const int first = t.units[3 * u + 1], end = first + t.units[3 * u + 2];
  for (int i = first; i < end || i == first; i += 8) {
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = i + k < end && t.cons[2 * (i + k) + 1] != 4
                 ? comp_at(comps, B, t.cons[2 * (i + k)], b) : 0u;
    }
    if (i == first) valid = (f & 1) != 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (i + k >= end) break;
      const int kind = t.cons[2 * (i + k) + 1];
      bool h = v[k] != 0u;
      if (kind == 4) {          // never (a plausibility-only probe unit)
        valid = false;
      } else if (kind == 0) {   // require
        valid = valid && h;
      } else if (kind == 3) {   // forbid (an IPv6 literal on a geo token, ...)
        valid = valid && !h;
      } else {                  // overflow: kind 1 masked by the valid so far
        if (kind == 1) h = h && valid;
        valid = valid && !h;
        over = over || h;
      }
    }
  }
  const bool esc = (f & 4) != 0;
  return (valid ? 1u : 0u) | (f & 2) | (over ? 4u : 0u) | ((esc && valid) ? 8u : 0u);
}

// The first row of warp w's run: rows split where the slots are split
// evenly (rows' first slots never decrease).
__device__ __forceinline__ int run_start(const Tables& t, int K, int n_slots, int w) {
  if (w <= 0) return 0;
  if (w >= WARPS) return K;
  const int target = static_cast<int>(static_cast<long long>(n_slots) * w / WARPS);
  int lo = 0, hi = K;   // the first row whose first slot is >= target
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.rows[3 * mid + 1] < target) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(WARPS * 32) pack_rows_kernel(PackArgs a) {
  // Per tile parity: each unit's verdict bits and row-0 slot partial.
  __shared__ uint32_t verdict_buf[2][MAX_UNITS][LINES];
  __shared__ uint32_t partial_buf[2][MAX_UNITS][LINES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tables& t = a.g;
  const size_t B = static_cast<size_t>(a.B);
  const int n_tiles = (a.B + LINES - 1) / LINES;
  const int r0 = run_start(t, a.K, a.n_slots, warp), r1 = run_start(t, a.K, a.n_slots, warp + 1);
  const int s0 = r0 < a.K ? t.rows[3 * r0 + 1] : a.n_slots;
  const int s1 = r1 < a.K ? t.rows[3 * r1 + 1] : a.n_slots;
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
    int b[LPT];
    bool live[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      b[l] = tile * LINES + 32 * l + lane;
      live[l] = b[l] < a.B;
    }
    uint32_t (*verdict)[LINES] = verdict_buf[parity];
    uint32_t (*partial)[LINES] = partial_buf[parity];

    // Phase 1: the unit verdicts, then this warp's run of rows.
    for (int u = warp; u < a.U; u += WARPS) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        verdict[u][32 * l + lane] = live[l] ? unit_verdict(t, a.flags, a.comps, B, u, b[l]) : 0u;
      }
    }
    int cur = r0;
    int cur_end = cur < r1 ? t.rows[3 * cur + 1] + t.rows[3 * cur + 2] : s1;
    uint32_t acc[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) acc[l] = 0u;
    // Row `cur` is complete: store it (a unit's row 0 to shared memory).
    auto close_row = [&]() {
      const int unit = t.rows[3 * cur];
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        if (unit >= 0) partial[unit][32 * l + lane] = acc[l];
        else if (live[l]) a.out[cur * B + b[l]] = static_cast<int>(acc[l]);
        acc[l] = 0u;
      }
      ++cur;
      cur_end = cur < r1 ? t.rows[3 * cur + 1] + t.rows[3 * cur + 2] : s1;
    };
    for (int i = s0; i < s1; i += STEP) {
      uint32_t v[STEP][LPT];
#pragma unroll
      for (int k = 0; k < STEP; ++k) {
        const int c = i + k < s1 ? t.slots[3 * (i + k)] : 0;
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
          v[k][l] = i + k < s1 && live[l] ? comp_at(a.comps, B, c, b[l]) : 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < STEP; ++k) {
        if (i + k >= s1) break;
        while (i + k >= cur_end) close_row();   // rows before slot i + k, empty ones too
        const int shift = t.slots[3 * (i + k) + 1], bits = t.slots[3 * (i + k) + 2];
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] |= shaped(v[k][l], shift, bits);
      }
    }
    while (cur < r1) close_row();
    __syncthreads();

    // Phase 2: each unit's row 0, then the view fields.
    for (int it = warp; it < a.U + a.V; it += WARPS) {
      if (it < a.U) {
        const int r = t.units[3 * it];
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
          const int x = 32 * l + lane;
          if (live[l]) a.out[r * B + b[l]] = static_cast<int>(partial[it][x] | verdict[it][x]);
        }
        continue;
      }
      const int v = it - a.U;
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        if (!live[l]) continue;
        const int x = 32 * l + lane;
        int winner = 0, earlier_plausible = 0;
        bool any_valid = false;
        for (int u = 0; u < a.U; ++u) {
          if (verdict[u][x] & 1u) { winner = u; any_valid = true; break; }
        }
        for (int u = 0; u < winner; ++u) earlier_plausible += (verdict[u][x] >> 1) & 1u;
        uint32_t merged = 0, p0 = 0, p1 = 0, p2 = 0;
        const int e = any_valid && earlier_plausible == 0 ? t.view_of[v * a.U + winner] : -1;
        if (e >= 0) {
          const int pc = t.views[4 * e + 3], wrow = t.views[4 * e + 2];
          p0 = comp_at(a.comps, B, pc, b[l]);
          p1 = comp_at(a.comps, B, pc + 1, b[l]);
          p2 = comp_at(a.comps, B, pc + 2, b[l]);
          const int unit = t.rows[3 * wrow];
          const uint32_t w = slots_word(t, a.comps, B, wrow, b[l]) |
                             (unit >= 0 ? verdict[unit][x] : 0u);
          if (((w >> 26) & 1u) && !((w >> 27) & 1u)) {
            merged = (w & ((1u << 26) - 1u)) | (1u << 26);
          } else {
            p0 = p1 = p2 = 0u;
          }
        }
        int32_t* o = a.out + (a.K + 4 * v) * B + b[l];
        o[0] = static_cast<int>(merged);
        o[B] = static_cast<int>(p0);
        o[2 * B] = static_cast<int>(p1);
        o[3 * B] = static_cast<int>(p2);
      }
    }
  }
}

}  // namespace

LP_EXPORT int lp_pack_rows(int B, int U, const void* flags, const void* comps,
                           const void* units, const void* cons,
                           const void* rows, int K, const void* slots,
                           const void* views, int n_views, int V, void* out,
                           int n_slots, const void* view_of, void* stream) {
  if (B <= 0) return 0;
  if (U > MAX_UNITS) return static_cast<int>(cudaErrorInvalidValue);
  (void)n_views;   // the parent's walk over every entry; view_of indexes them here
  PackArgs a;
  a.B = B;
  a.U = U;
  a.K = K;
  a.V = V;
  a.n_slots = n_slots;
  a.flags = static_cast<const int32_t*>(flags);
  a.comps = static_cast<const int32_t*>(comps);
  a.g = Tables{static_cast<const int32_t*>(units), static_cast<const int32_t*>(cons),
               static_cast<const int32_t*>(rows), static_cast<const int32_t*>(slots),
               static_cast<const int32_t*>(views), static_cast<const int32_t*>(view_of)};
  a.out = static_cast<int32_t*>(out);
  // A persistent grid: as many blocks as fit on the card at once, each
  // striding over the tiles.
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_rows_kernel, WARPS * 32, 0);
  }
  const long long n_tiles = (static_cast<long long>(B) + LINES - 1) / LINES;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(n_tiles < fit ? n_tiles : fit);
  pack_rows_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_pack_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
