// Kernel 4: bit-packing of every component into the [K + 4V, B] int32
// output, the row-0 verdict of each format unit, and the winner-merged
// Arrow view rows.
//
// Replaces, from logparser_tpu/tpu/pipeline.py: the put / put_span
// packing and row-0 assembly of compute_rows, the row stacking of
// _units_rows_and_prefixes, and compute_view_rows.
//
// One thread per line.  Per unit: valid = split valid AND every line
// constraint component; row 0 = valid | plausible<<1 | (esc_hit &
// valid)<<3.  Per output row: OR of its slots, (comp & (2^bits - 1)) <<
// shift (bits 0 = the full word).  Views: the winner is the first unit
// whose row 0 is valid (0 when none), un-claimed when an earlier unit is
// still plausible; each view field takes the winner's span word
// (start|len, live bit 26) and 3 prefix words when ok and not null.
// An elementwise pass like this one would serve equally well in Triton;
// it stays CUDA C++ to keep the port on one toolchain.
//
// Bound: reads the components once (n_comp * 4 bytes per line) and
// writes (K + 4V) * 4 bytes per line.

#include "lp_common.cuh"

namespace {

constexpr int MAX_UNITS = 8;

__global__ void pack_rows_kernel(
    int B, int U, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ comps, const int32_t* __restrict__ units,
    const int32_t* __restrict__ cons, const int32_t* __restrict__ rows, int K,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ views,
    int n_views, int V, int32_t* __restrict__ out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    auto comp = [&](int c) { return comps[static_cast<size_t>(c) * B + b]; };
    uint32_t row0[MAX_UNITS];
    for (int u = 0; u < U; ++u) {
      const int f = flags[static_cast<size_t>(u) * B + b];
      bool valid = (f & 1) != 0;
      for (int i = 0; i < units[3 * u + 2]; ++i) {
        if (comp(cons[units[3 * u + 1] + i]) == 0) valid = false;
      }
      const bool esc = (f & 4) != 0;
      row0[u] = (valid ? 1u : 0u) | (f & 2) | ((esc && valid) ? 8u : 0u);
    }
    for (int r = 0; r < K; ++r) {
      const int unit = rows[3 * r];
      uint32_t acc = unit >= 0 ? row0[unit] : 0u;
      for (int i = rows[3 * r + 1], end = i + rows[3 * r + 2]; i < end; ++i) {
        uint32_t v = static_cast<uint32_t>(comp(slots[3 * i]));
        const int shift = slots[3 * i + 1], bits = slots[3 * i + 2];
        if (bits) v = (v & ((1u << bits) - 1u)) << shift;
        acc |= v;
      }
      out[static_cast<size_t>(r) * B + b] = static_cast<int>(acc);
    }
    if (V == 0) continue;

    int winner = 0, earlier_plausible = 0;
    bool any_valid = false;
    for (int u = 0; u < U; ++u) {
      if (row0[u] & 1u) { winner = u; any_valid = true; break; }
    }
    for (int u = 0; u < winner; ++u) earlier_plausible += (row0[u] >> 1) & 1u;
    const bool claimed = any_valid && earlier_plausible == 0;
    for (int v = 0; v < V; ++v) {
      uint32_t merged = 0, p0 = 0, p1 = 0, p2 = 0;
      for (int i = 0; i < n_views; ++i) {
        const int32_t* e = views + 4 * i;
        if (e[0] != v || e[1] != winner || !claimed) continue;
        const uint32_t w = static_cast<uint32_t>(out[static_cast<size_t>(e[2]) * B + b]);
        if (!((w >> 26) & 1u) || ((w >> 27) & 1u)) continue;
        merged = (w & ((1u << 26) - 1u)) | (1u << 26);
        p0 = static_cast<uint32_t>(comp(e[3]));
        p1 = static_cast<uint32_t>(comp(e[3] + 1));
        p2 = static_cast<uint32_t>(comp(e[3] + 2));
      }
      const size_t base = static_cast<size_t>(K + 4 * v) * B + b;
      out[base] = static_cast<int>(merged);
      out[base + static_cast<size_t>(B)] = static_cast<int>(p0);
      out[base + 2 * static_cast<size_t>(B)] = static_cast<int>(p1);
      out[base + 3 * static_cast<size_t>(B)] = static_cast<int>(p2);
    }
  }
}

}  // namespace

LP_EXPORT int lp_pack_rows(int B, int U, const void* flags, const void* comps,
                           const void* units, const void* cons,
                           const void* rows, int K, const void* slots,
                           const void* views, int n_views, int V, void* out,
                           void* stream) {
  if (B <= 0) return 0;
  if (U > MAX_UNITS) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  pack_rows_kernel<<<lp::grid_for(B, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      B, U, static_cast<const int32_t*>(flags),
      static_cast<const int32_t*>(comps), static_cast<const int32_t*>(units),
      static_cast<const int32_t*>(cons), static_cast<const int32_t*>(rows), K,
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(views),
      n_views, V, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_pack_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
