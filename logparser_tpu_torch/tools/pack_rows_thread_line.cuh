// The one-thread-a-line pack_rows loop of the kernel's first design, for
// tools/kernel_variants.py (pack_rows_variants.json, variant
// "thread_line"): one thread walks its line's whole plan -- every unit's
// constraints, then each output row's slots, then each view field over
// every view entry, reading the span word back from `out`.
#pragma once

#include "lp_common.cuh"

namespace thread_line {

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
      bool valid = (f & 1) != 0, over = false;
      for (int i = units[3 * u + 1], end = i + units[3 * u + 2]; i < end; ++i) {
        const int kind = cons[2 * i + 1];
        if (kind == 4) {          // never (a plausibility-only probe unit)
          valid = false;
          continue;
        }
        bool hit = comp(cons[2 * i]) != 0;
        if (kind == 0) {          // require
          valid = valid && hit;
          continue;
        }
        if (kind == 3) {          // forbid (an IPv6 literal on a geo token, ...)
          valid = valid && !hit;
          continue;
        }
        if (kind == 1) hit = hit && valid;   // CSR overflow: masked so far
        valid = valid && !hit;
        over = over || hit;
      }
      const bool esc = (f & 4) != 0;
      row0[u] = (valid ? 1u : 0u) | (f & 2) | (over ? 4u : 0u) |
                ((esc && valid) ? 8u : 0u);
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

}  // namespace thread_line
