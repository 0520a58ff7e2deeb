// Kernel 14: mod_unique_id tokens of one muid group.
//
// Replaces, from logparser_tpu/tpu: postproc.py parse_mod_unique_id and
// the muid branch of pipeline.py compute_rows.
//
// One thread per line reads the token's first 24 bytes through
// lp::Row::at (the start wrap and zeros past L of gather_span_bytes),
// maps each through the alphabet [A-Za-z0-9-_] to 6 bits and decodes six
// 24-bit groups into the 18 bytes: time, ip, pid and thread as u32 words
// bit-cast to int32, the 16-bit counter as int32, and ok = width 24 and
// every byte in the alphabet.  A token it cannot decode only clears ok:
// it never fails the line.  Outputs are 6 int32 rows (time,
// ip, pid, thread, counter, ok) of the unit block, coalesced across
// threads.
//
// Bound: bytes -- 24 token bytes and the two cursors read, 6 rows written
// per line.

#include "lp_common.cuh"

namespace {

__device__ __forceinline__ int sextet(int c, bool& ok) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '-') return 62;
  if (c != '_') ok = false;
  return 63;
}

__global__ void muid_kernel(const uint8_t* __restrict__ buf, int B, int L, int mask,
                            const int32_t* __restrict__ tok_s,
                            const int32_t* __restrict__ tok_e,
                            int32_t* __restrict__ out) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const lp::Row row{buf + static_cast<size_t>(b) * L, L, mask};
    const int s = tok_s[b];
    bool ok = tok_e[b] - s == 24;
    uint32_t g[6];
    for (int i = 0; i < 6; ++i) {
      uint32_t v = 0;
      for (int j = 0; j < 4; ++j) {
        v = (v << 6) | static_cast<uint32_t>(sextet(row.at(s, 4 * i + j), ok));
      }
      g[i] = v;
    }
    const uint32_t words[6] = {
        (g[0] << 8) | (g[1] >> 16),                  // time
        ((g[1] & 0xFFFFu) << 16) | (g[2] >> 8),      // ip
        ((g[2] & 0xFFu) << 24) | g[3],               // pid
        ((g[4] & 0xFFu) << 24) | g[5],               // thread
        g[4] >> 8,                                   // counter
        ok ? 1u : 0u,
    };
    for (int r = 0; r < 6; ++r) {
      out[static_cast<size_t>(r) * B + b] = static_cast<int>(words[r]);
    }
  }
}

}  // namespace

LP_EXPORT int lp_muid(const void* buf, int B, int L, const void* tok_s,
                      const void* tok_e, void* out, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  muid_kernel<<<lp::grid_for(B, threads), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), B, L, lp::gather_mask(L),
      static_cast<const int32_t*>(tok_s), static_cast<const int32_t*>(tok_e),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_muid_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
