// muid with two lines a thread, THREADS apart, both cursor -> window round
// trips in flight before either decodes (a design variant of csrc/muid.cu
// for tools/kernel_variants.py: muid_variants.json "lines_2"; it uses that
// file's sextet table, group() and constants).
#pragma once

namespace lines_2 {

constexpr int LINES = 2;

__global__ void __launch_bounds__(THREADS) muid_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ tok_s, const int32_t* __restrict__ tok_e,
    int32_t* __restrict__ out) {
  __shared__ uint8_t table[256];
  for (int c = threadIdx.x; c < 256; c += THREADS) table[c] = static_cast<uint8_t>(sextet_entry(c));
  const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
  __syncthreads();
  for (int base = blockIdx.x * THREADS * LINES; base < B;
       base += gridDim.x * THREADS * LINES) {
    int s[LINES], w[LINES];
#pragma unroll
    for (int k = 0; k < LINES; ++k) {
      const int b = base + k * THREADS + threadIdx.x;
      s[k] = b < B ? tok_s[b] : 0;
      w[k] = b < B ? tok_e[b] - s[k] : 0;
    }
    uint32_t x[LINES][6];
#pragma unroll
    for (int k = 0; k < LINES; ++k) {
      const int b = base + k * THREADS + threadIdx.x;
      const uint8_t* line = buf + static_cast<size_t>(b) * L;
      const int q = s[k] & mask;
      if (b >= B) {
#pragma unroll
        for (int i = 0; i < 6; ++i) x[k][i] = 0u;
      } else if (q + TOKEN <= L) {
        lp::load_window<TOKEN>(line + q, buf, buf_end, x[k]);
      } else {
        const lp::Row row{line, L, mask};
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          x[k][i] = static_cast<uint32_t>(row.at(s[k], 4 * i)) |
                    static_cast<uint32_t>(row.at(s[k], 4 * i + 1)) << 8 |
                    static_cast<uint32_t>(row.at(s[k], 4 * i + 2)) << 16 |
                    static_cast<uint32_t>(row.at(s[k], 4 * i + 3)) << 24;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < LINES; ++k) {
      const int b = base + k * THREADS + threadIdx.x;
      if (b >= B) continue;
      uint32_t bad = 0u, g[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) g[i] = group(x[k][i], table, bad);
      const uint32_t words[6] = {
          (g[0] << 8) | (g[1] >> 16),
          ((g[1] & 0xFFFFu) << 16) | (g[2] >> 8),
          ((g[2] & 0xFFu) << 24) | g[3],
          ((g[4] & 0xFFu) << 24) | g[5],
          g[4] >> 8,
          (w[k] == TOKEN && !(bad & BAD)) ? 1u : 0u,
      };
#pragma unroll
      for (int r = 0; r < 6; ++r) out[static_cast<size_t>(r) * B + b] = static_cast<int>(words[r]);
    }
  }
}

}  // namespace lines_2
