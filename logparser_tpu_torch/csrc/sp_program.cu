// Kernel 19: the sequence-parallel split program, one launch a data shard.
//
// Replaces logparser_tpu/parallel/mesh.py _sp_program_body (:173) with its
// collectives (_sp_find_literal :122, _sp_byte_at :152, _sp_charset_ok
// :163), where every seq shard of a data shard lies on one card: the whole
// op program runs per line over the shards' slices, the pmin / psum
// combines and the cursor, valid, starts and ends updates inside the
// kernel (the per-op kernel sp_split.cu serves seq shards on distinct
// cards).
//
// The sharded layout: a data shard's rows are [Bd, n_seq * Lc] bytes with
// a row stride (a view of the batch); shard s's slice is columns
// [s * Lc, (s + 1) * Lc), and its halo is the first H bytes of shard
// (s + 1) mod n_seq -- the bytes that follow the slice in the row, except
// for the last shard, whose halo (as ppermute's ring gives it) is shard
// 0's first bytes.  Semantics, the reference SP body's (no escape parity):
//
//   lit        the byte at global position cursor + k, where some shard
//              owns it (0 past the row), equals lit[k] for every k, and
//              cursor + len(lit) <= length; the cursor moves past it;
//   until_lit  find: the least global position g >= cursor with
//              g + len(lit) <= length whose bytes, read from g's shard and
//              across its end into its halo, are the literal (the minimum
//              over the shards of each shard's first match: the shards
//              taken in offset order, the first with a match holds it);
//              l_total where there is none (the token is invalid and
//              empty).  The span is [cursor, found); the cursor moves past
//              the literal;
//   to_end     the span is [cursor, length); the cursor moves to length;
//
// a token's span is valid when no byte of it that a shard owns is outside
// the op's charset (a psum of per-shard violation counts), and its length
// is within min_len and max_len; the line is valid when every op is and
// the final cursor equals the length.
//
// A warp a line, 8 warps a block, a persistent grid (the blocks that fit
// on the card at once).  The op table, the literals and each charset's
// 256-entry violation table are staged in shared memory once a block.
// Each warp stages a 1,024-byte window of its line (16-byte loads when the
// row is 16-byte aligned), moved forward as the cursor goes (the cursor
// never moves back).  A find walks the window 32 positions a step, a lane
// each: a ballot of the lanes holding a match gives the first, so a short
// token costs one step; each lane counts the charset violations it saw
// before the match, and one __any_sync a token gives the verdict, so a
// token's bytes are read once for both its separator and its charset.
// Lane 0 writes the token cursors; the tokens no op sets are written 0.
//
// Bound: bytes -- the [Bd, L] buffer and the lengths in, the token cursors
// [T, Bd] int32 and valid [Bd] out (chip_smoke.sp_cost).

#include <climits>

#include "lp_common.cuh"

namespace {

constexpr int OP_LIT = 0, OP_UNTIL = 1;   // 2: to_end
constexpr int OP_COLS = 6;     // kind, literal length, charset, token, min_len, max_len
constexpr int WARPS = 8;
constexpr int WIN = 1024;      // a warp's window of its line
constexpr int CHUNK = 128;     // positions a window check covers: 4 steps of 32
constexpr int MAX_LIT = 512;   // CHUNK + MAX_LIT + 15 <= WIN

struct Line {
  const uint8_t* rp;   // the row: shard s's slice at rp + s * Lc
  int l_total;
  bool aligned;
  uint8_t* win;        // the warp's window: global positions [base, base + WIN)
  int base;
  int lane;

  // Stage [p & ~15, + WIN); positions at or past l_total read 0.
  __device__ __forceinline__ void load(int p) {
    __syncwarp();   // every lane is done with the old window
    base = p & ~15;
    if (aligned) {
      for (int i = lane; i < WIN / 16; i += 32) {
        const int pos = base + 16 * i;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (pos + 16 <= l_total) v = __ldg(reinterpret_cast<const uint4*>(rp + pos));
        reinterpret_cast<uint4*>(win)[i] = v;
      }
      // The row's last partial chunk, a byte a lane: no load past its end.
      const int tail = l_total & ~15;
      if (tail < l_total && tail >= base && tail < base + WIN) {
        __syncwarp();
        if (lane < 16 && tail + lane < l_total) win[tail - base + lane] = rp[tail + lane];
      }
    } else {
      for (int i = lane; i < WIN; i += 32) {
        win[i] = base + i < l_total ? rp[base + i] : 0;
      }
    }
    __syncwarp();
  }

  // The window covers [lo, hi) (hi - lo <= WIN - 15; lo >= 0; uniform).
  __device__ __forceinline__ void cover(int lo, int hi) {
    if (lo < base || hi > base + WIN) load(lo);
  }

  // The owned byte at global position q (covered): 0 at or past l_total.
  __device__ __forceinline__ int at(int q) const { return win[q - base]; }

  // Byte k of the literal candidate at g (g < l_total): from g's shard,
  // across its end into its halo; only the last shard's halo wraps to
  // shard 0's first bytes.
  __device__ __forceinline__ int ext(int g, int k) const {
    const int q = g + k;
    return q < l_total ? win[q - base] : rp[q - l_total];
  }
};


__global__ void __launch_bounds__(WARPS * 32) sp_program_kernel(
    const uint8_t* __restrict__ buf, int Bd, int row_stride, int n_seq, int Lc,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ ops_g, int n_ops,
    const int32_t* __restrict__ lits_g, int lit_width,
    const int32_t* __restrict__ charsets_g, int n_charsets, int n_tok,
    int32_t* __restrict__ starts, int32_t* __restrict__ ends, uint8_t* __restrict__ valid_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* windows = smem;                                          // [WARPS][WIN]
  int* ops = reinterpret_cast<int*>(windows + WARPS * WIN);          // [n_ops][OP_COLS]
  uint8_t* bad_tabs = reinterpret_cast<uint8_t*>(ops + OP_COLS * n_ops);     // [n_cs][256]
  uint8_t* cs_any = bad_tabs + 256 * n_charsets;                     // [n_cs]
  uint8_t* tok_set = cs_any + n_charsets;                            // [n_tok]
  uint8_t* lits = tok_set + n_tok;                                   // [n_ops][lit_width]

  for (int i = threadIdx.x; i < OP_COLS * n_ops; i += blockDim.x) ops[i] = ops_g[i];
  for (int i = threadIdx.x; i < n_ops * lit_width; i += blockDim.x) {
    lits[i] = static_cast<uint8_t>(lits_g[i]);
  }
  for (int i = threadIdx.x; i < 256 * n_charsets; i += blockDim.x) {
    bad_tabs[i] = charsets_g[i] == 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tok; t += blockDim.x) {
    bool set = false;
    for (int i = 0; i < n_ops; ++i) {
      set |= ops[OP_COLS * i] != OP_LIT && ops[OP_COLS * i + 3] == t;
    }
    tok_set[t] = set;
  }
  for (int c = threadIdx.x; c < n_charsets; c += blockDim.x) {
    bool any = false;
    for (int j = 0; j < 256; ++j) any |= bad_tabs[256 * c + j] != 0;
    cs_any[c] = !any;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l_total = n_seq * Lc;
  for (int row = blockIdx.x * WARPS + warp; row < Bd; row += gridDim.x * WARPS) {
    const uint8_t* rp = buf + static_cast<size_t>(row) * row_stride;
    Line ln{rp, l_total, (reinterpret_cast<uintptr_t>(rp) & 15) == 0, windows + warp * WIN,
            INT_MIN, lane};
    const int length = lengths[row];
    int cursor = 0;
    bool valid = true;
    for (int i = 0; i < n_ops; ++i) {
      const int* op = ops + OP_COLS * i;
      const int kind = op[0], n = op[1], tok = op[3], min_len = op[4], max_len = op[5];
      const uint8_t* lit = lits + i * lit_width;
      const uint8_t* bad_tab = bad_tabs + 256 * op[2];
      const bool check = !cs_any[op[2]];
      if (kind == OP_LIT) {
        bool ok = cursor + n <= length;
        for (int k0 = 0; k0 < n; k0 += 32) {
          ln.cover(cursor + k0, cursor + min(n, k0 + 32));
          const int k = k0 + lane;
          ok = __all_sync(lp::FULL, k >= n || ln.at(cursor + k) == lit[k]) && ok;
        }
        valid = valid && ok;
        cursor += n;
        continue;
      }
      int start = cursor, end, next;
      int mine = 0;   // this lane's charset violations in the span
      if (kind == OP_UNTIL) {
        // Candidates g in [cursor, gmax]: g + n <= length, g in a shard;
        // a step covers 32 positions, a lane each.
        const int gmax = min(length - n, l_total - 1);
        int found = l_total;
        for (int c = cursor; c <= gmax && found == l_total; c += CHUNK) {
          ln.cover(c, c + CHUNK + n - 1);
#pragma unroll
          for (int j = 0; j < CHUNK / 32; ++j) {
            const int g = c + 32 * j + lane;
            const bool in = g <= gmax;
            const int b = ln.at(g);
            bool m = in && b == lit[0];
            for (int k = 1; k < n && m; ++k) m = ln.ext(g, k) == lit[k];
            const bool v = in && check && bad_tab[b];
            const unsigned hit = __ballot_sync(lp::FULL, m);
            if (hit) {
              const int first = __ffs(hit) - 1;
              mine += v && lane < first;
              found = c + 32 * j + first;
              break;
            }
            mine += v;
          }
        }
        const bool token_valid = found < l_total;
        end = token_valid ? found : cursor;
        if (!token_valid) mine = 0;   // an empty span
        valid = valid && token_valid;
        next = end + n;
      } else {
        end = length;
        next = length;
        const int owned = min(length, l_total);
        if (check) {
          for (int c = cursor; c < owned; c += CHUNK) {
            ln.cover(c, c + CHUNK);
#pragma unroll
            for (int j = 0; j < CHUNK / 32; ++j) {
              const int g = c + 32 * j + lane;
              mine += g < owned && bad_tab[ln.at(g)];
            }
          }
        }
      }
      const bool bad = __any_sync(lp::FULL, mine != 0);
      valid = valid && !bad && (end - start) >= min_len &&
              (max_len == 0 || (end - start) <= max_len);
      if (lane == 0) {
        starts[static_cast<size_t>(tok) * Bd + row] = start;
        ends[static_cast<size_t>(tok) * Bd + row] = end;
      }
      cursor = next;
    }
    for (int t = lane; t < n_tok; t += 32) {
      if (!tok_set[t]) {
        starts[static_cast<size_t>(t) * Bd + row] = 0;
        ends[static_cast<size_t>(t) * Bd + row] = 0;
      }
    }
    if (lane == 0) valid_out[row] = valid && cursor == length;
  }
}

}  // namespace

// buf: a data shard's rows, [Bd, n_seq * Lc] uint8 with row_stride bytes
// from a row to the next; lengths [Bd] int32; ops [n_ops, 6] int32 (kind 0
// lit / 1 until_lit / 2 to_end, literal length, charset, token, min_len,
// max_len); lits [n_ops, lit_width] int32; charsets [n_charsets, 256] int32
// (1 = allowed); out: starts, ends [n_tok, Bd] int32, valid [Bd] uint8.
LP_EXPORT int lp_sp_program(const void* buf, int Bd, int row_stride, int n_seq,
                            int Lc, const void* lengths, const void* ops, int n_ops,
                            const void* lits, int lit_width, const void* charsets,
                            int n_charsets, int n_tok, void* starts, void* ends,
                            void* valid, void* stream) {
  if (Bd <= 0) return 0;
  if (n_seq < 1 || Lc < 1 || lit_width > MAX_LIT || n_charsets < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = WARPS * WIN + 4 * OP_COLS * static_cast<size_t>(n_ops) +
                      257 * static_cast<size_t>(n_charsets) + n_tok +
                      static_cast<size_t>(n_ops) * lit_width;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sp_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // A persistent grid: the blocks that fit on the card at once, each
  // staging the tables once and walking its share of the rows.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sp_program_kernel, WARPS * 32,
                                                        smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (static_cast<long long>(Bd) + WARPS - 1) / WARPS;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  sp_program_kernel<<<static_cast<int>(blocks), WARPS * 32,
                      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), Bd, row_stride, n_seq, Lc,
      static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(ops), n_ops,
      static_cast<const int32_t*>(lits), lit_width, static_cast<const int32_t*>(charsets),
      n_charsets, n_tok, static_cast<int32_t*>(starts), static_cast<int32_t*>(ends),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_sp_program_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
