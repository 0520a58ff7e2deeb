// Kernel 15: the byte-dropping unescape of quoted-field spans -- the
// device inverse of Apache's ap_escape_logitem for \" and \\.
//
// Replaces logparser_tpu/tpu/postproc.py unescape_compact_spans (a
// [B, width] window, a running max for the backslash-run offsets, and a
// stable argsort for the compaction, all fused by XLA).  A thread walks
// its row's window left to right, keeping the parity of the current
// backslash run, and decides each byte with one byte of lookahead, in the
// reference's terms:
//   - a backslash at an odd offset in its run is kept (the escaped byte
//     of a \\ pair);
//   - one at an even offset is dropped, unless it is the run's last byte
//     (an odd run's tail) and the next byte is no quote: then it is kept
//     (an unknown escape keeps both bytes), and the row is inexact when
//     that next byte is a substituting C-escape (b n r t v x) or lies
//     past the span;
//   - every other byte of the span is kept.
// Kept bytes are written compacted to out[b, 0..k), zeros after; a span
// wider than the window is inexact.  Bytes are read as lp::Row::at reads
// them (start bits above bit_length(L - 1) ignored, 0 at or past L), and
// the lookahead of the window's last byte reads 0 (the reference's
// shift_zero; past the span's end the lookahead decides nothing, so the
// walk needs no byte beyond the window).  No sort.
//
// Reads: where the window lies inside the line ((start & mask) +
// min(n, width) <= L) as the aligned 16-byte chunks that cover it
// (lp::load16_in), the next chunk loaded before the current one is
// decided; a chunk whose window bytes hold no backslash is copied whole,
// and only a chunk with one walks its bytes.  Elsewhere a byte at a time
// through Row::at.
//
// Writes: for width <= STAGE_CAP (512) a warp builds its 32 output rows
// in a zero-filled shared-memory tile laid out as out's [32, width]
// region (aligned like it modulo 16), each thread OR-ing its kept bytes
// in as words (an atomic OR on the words it may share with a neighbouring row
// or with its own earlier bytes, plain stores on the others); then the
// warp writes the region with coalesced 16-byte stores, its unaligned head
// and tail a byte a lane.  Four warps a block, 32 x width + 32 bytes of
// shared memory each (at width 512, 65.7 KB a block, 3 blocks an SM; at
// the smoke's 121, 15.6 KB, 14).  Above the cap a thread writes its own
// row directly, a byte at a time, and zero-fills it with 16-byte stores
// (exact at any width up to L = 8,191).  out_len and exact are one
// coalesced store a row.
//
// Bound: bytes -- each row's span bytes inside the window read once, the
// start and end in, the [B, width] window, out_len and exact out.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_CAP = 512;

__device__ __forceinline__ bool substitutes(int c) {
  return c == 'b' || c == 'n' || c == 'r' || c == 't' || c == 'v' || c == 'x';
}

__device__ __forceinline__ int byte_of(const uint32_t (&w)[4], int t) {
  return static_cast<int>((w[t >> 2] >> (8 * (t & 3))) & 0xFFu);
}

// The bytes 4j..4j+3 of a 16-byte chunk that lie in [lo, hi), as a mask.
__device__ __forceinline__ uint32_t range_mask(int j, int lo, int hi) {
  const int a = min(max(lo - 4 * j, 0), 4), b = min(max(hi - 4 * j, 0), 4);
  const uint32_t upto_b = b >= 4 ? 0xFFFFFFFFu : (1u << (8 * b)) - 1u;
  const uint32_t below_a = a >= 4 ? 0xFFFFFFFFu : (1u << (8 * a)) - 1u;
  return upto_b & ~below_a;
}

__device__ __forceinline__ void to_words(uint4 v, uint32_t (&w)[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// *p |= v on a shared-memory word, atomically (no value returned).
__device__ __forceinline__ void or_shared(unsigned* p, unsigned v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("red.shared.or.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// A row's output in the warp's shared-memory tile (zero-filled first):
// kept bytes OR-ed in, so a word shared with a neighbouring row or with
// this row's earlier bytes takes an atomic OR, a word wholly inside the
// new bytes a plain store.
struct TileOut {
  uint8_t* row;
  int k;
  __device__ __forceinline__ void put(int c) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + k);
    or_shared(reinterpret_cast<unsigned*>(a & ~static_cast<uintptr_t>(3)),
              static_cast<unsigned>(c) << (8 * (a & 3)));
    ++k;
  }
  // Bytes [lo, hi) of the chunk w, appended.
  __device__ __forceinline__ void chunk(const uint32_t (&w)[4], int lo, int hi) {
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = w[j] & range_mask(j, lo, hi);
    // Chunk byte t lands at virtual address v + t, v = row + k - lo.
    const uintptr_t v = reinterpret_cast<uintptr_t>(row + k) - lo;
    const int d = static_cast<int>(v & 3);
    unsigned* base = reinterpret_cast<unsigned*>(v - d);
    const uint32_t y[5] = {
        __funnelshift_l(0u, x[0], 8 * d), __funnelshift_l(x[0], x[1], 8 * d),
        __funnelshift_l(x[1], x[2], 8 * d), __funnelshift_l(x[2], x[3], 8 * d),
        __funnelshift_l(x[3], 0u, 8 * d)};
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int first = 4 * j - d;   // chunk byte at the word's first byte
      if (first >= lo && first + 4 <= hi) {
        base[j] = y[j];
      } else if (first + 4 > lo && first < hi && y[j] != 0u) {
        or_shared(base + j, y[j]);
      }
    }
    k += hi - lo;
  }
};

// A row's output written straight to out, a byte at a time.
struct DirectOut {
  uint8_t* row;
  int k;
  __device__ __forceinline__ void put(int c) { row[k++] = static_cast<uint8_t>(c); }
  __device__ __forceinline__ void chunk(const uint32_t (&w)[4], int lo, int hi) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (t >= lo && t < hi) row[k++] = static_cast<uint8_t>(byte_of(w, t));
    }
  }
};

// One byte of the walk: c at window position i, nxt the byte after it (0
// past the window), `odd` the parity of the backslash run so far.
template <class Out>
__device__ __forceinline__ void step(Out& o, int c, int nxt, bool next_in_span, bool& odd,
                                     bool& ok) {
  bool keep = true;
  if (c == '\\') {
    const bool even = !odd;
    odd = !odd;
    const bool last = !(next_in_span && nxt == '\\');
    if (even) {
      if (!last) {
        keep = false;
      } else if (next_in_span && nxt == '"') {
        keep = false;
      } else if (!next_in_span || substitutes(nxt)) {
        ok = false;
      }
    }
  } else {
    odd = false;
  }
  if (keep) o.put(c);
}

// Walk row b's window into o; returns exact.
template <class Out>
__device__ __forceinline__ bool walk_row(Out& o, const uint8_t* buf, const uint8_t* buf_end,
                                         int L, int mask, int s, int n, int width, int b) {
  const uint8_t* line = buf + static_cast<size_t>(b) * L;
  const int m = min(n, width);
  bool ok = n <= width, odd = false;
  const int q = s & mask;
  if (q + m <= L) {
    const uint8_t* c0 = lp::align_down16(line + q);
    const int off = static_cast<int>(line + q - c0);
    const int nch = m > 0 ? (off + m + 15) >> 4 : 0;
    uint32_t cur[4], nxt[4];
    to_words(nch > 0 ? lp::load16_in(c0, buf, buf_end) : make_uint4(0u, 0u, 0u, 0u), cur);
    for (int c = 0; c < nch; ++c) {
      to_words(c + 1 < nch ? lp::load16_in(c0 + 16 * (c + 1), buf, buf_end)
                           : make_uint4(0u, 0u, 0u, 0u), nxt);
      const int lo = c == 0 ? off : 0;
      const int hi = min(16, off + m - 16 * c);
      uint32_t bs = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) bs |= __vcmpeq4(cur[j], 0x5C5C5C5Cu) & range_mask(j, lo, hi);
      if (bs == 0u) {
        o.chunk(cur, lo, hi);
        odd = false;
      } else {
        const int i0 = 16 * c - off;   // window position of chunk byte 0
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          if (t >= lo && t < hi) {
            const int i = i0 + t;
            int nx = t < 15 ? byte_of(cur, t + 1) : byte_of(nxt, 0);
            if (i + 1 >= m) nx = 0;
            step(o, byte_of(cur, t), nx, i + 1 < n, odd, ok);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
    }
  } else {
    const lp::Row row{line, L, mask};
    int c = m > 0 ? row.at(s, 0) : 0;
    for (int i = 0; i < m; ++i) {
      const int nx = i + 1 < m ? row.at(s, i + 1) : 0;
      step(o, c, nx, i + 1 < n, odd, ok);
      c = nx;
    }
  }
  return ok;
}

__global__ void __launch_bounds__(THREADS) unescape_staged_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end, int width,
    int tile_bytes, uint8_t* __restrict__ out, int32_t* __restrict__ out_len,
    bool* __restrict__ exact) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem) + warp * tile_bytes;
  const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
  const int n_tiles = (B + 31) / 32;
  for (int t = blockIdx.x * WARPS + warp; t < n_tiles; t += gridDim.x * WARPS) {
    const int b0 = 32 * t, nrows = min(32, B - b0);
    uint8_t* g0 = out + static_cast<size_t>(b0) * width;
    // The tile's first byte sits 16 + (g0 mod 16) bytes in: a chunk's
    // words may reach 15 bytes below a row's first byte.
    uint8_t* base = tile + 16 + static_cast<int>(reinterpret_cast<uintptr_t>(g0) & 15);
    for (int j = lane; j < tile_bytes / 16; j += 32) {
      reinterpret_cast<uint4*>(tile)[j] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    const int b = b0 + lane;
    if (b < B) {
      const int s = start[b];
      TileOut o{base + lane * width, 0};
      const bool ok = walk_row(o, buf, buf_end, L, mask, s, max(end[b] - s, 0), width, b);
      out_len[b] = o.k;
      exact[b] = ok;
    }
    __syncwarp();
    const int n = nrows * width;
    int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(g0) & 15)) & 15);
    head = min(head, n);
    if (lane < head) g0[lane] = base[lane];
    const int body = (n - head) >> 4;
    for (int j = lane; j < body; j += 32) {
      reinterpret_cast<uint4*>(g0 + head)[j] = reinterpret_cast<const uint4*>(base + head)[j];
    }
    const int tail = head + 16 * body;
    if (tail + lane < n) g0[tail + lane] = base[tail + lane];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS) unescape_direct_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int mask,
    const int32_t* __restrict__ start, const int32_t* __restrict__ end, int width,
    uint8_t* __restrict__ out, int32_t* __restrict__ out_len, bool* __restrict__ exact) {
  const uint8_t* buf_end = buf + static_cast<size_t>(B) * L;
  for (int b = blockIdx.x * THREADS + threadIdx.x; b < B; b += gridDim.x * THREADS) {
    const int s = start[b];
    DirectOut o{out + static_cast<size_t>(b) * width, 0};
    const bool ok = walk_row(o, buf, buf_end, L, mask, s, max(end[b] - s, 0), width, b);
    // Zero-fill [k, width): bytes up to a 16-byte boundary, 16-byte stores, bytes.
    uint8_t* p = o.row + o.k;
    uint8_t* row_end = o.row + width;
    while (p < row_end && (reinterpret_cast<uintptr_t>(p) & 15)) *p++ = 0;
    for (; p + 16 <= row_end; p += 16) *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    while (p < row_end) *p++ = 0;
    out_len[b] = o.k;
    exact[b] = ok;
  }
}

}  // namespace

LP_EXPORT int lp_unescape(const void* buf, int B, int L, const void* start,
                          const void* end, int width, void* out, void* out_len,
                          void* exact, void* stream) {
  if (B <= 0) return 0;
  if (width < 1 || width > L) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mask = lp::gather_mask(L);
  if (width <= STAGE_CAP) {
    const int tile_bytes = (32 * width + 32 + 15) & ~15;
    const int smem = WARPS * tile_bytes;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          unescape_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long tiles = (static_cast<long long>(B) + 31) / 32;
    unescape_staged_kernel<<<lp::grid_for(static_cast<int>((tiles + WARPS - 1) / WARPS), 1),
                             THREADS, smem, st>>>(
        static_cast<const uint8_t*>(buf), B, L, mask, static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(end), width, tile_bytes, static_cast<uint8_t*>(out),
        static_cast<int32_t*>(out_len), static_cast<bool*>(exact));
  } else {
    unescape_direct_kernel<<<lp::grid_for(B, THREADS), THREADS, 0, st>>>(
        static_cast<const uint8_t*>(buf), B, L, mask, static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(end), width, static_cast<uint8_t*>(out),
        static_cast<int32_t*>(out_len), static_cast<bool*>(exact));
  }
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_unescape_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
