// Kernel 12: distinct-value grouping of one aggregate lane -- (count,
// representative row, start, len) per distinct span key, or (bucket,
// count) per distinct epoch bucket, plus the group count.
//
// Replaces logparser_tpu/analytics/device.py _group_spans and _group_ints
// (with _scatter_groups).  The reference sorts by (len, 12-byte prefix
// words, row), compares tied neighbours byte by byte and scatters at the
// boundaries, because the TPU has no atomics; it can split one value into
// two groups when prefix-tied values interleave, and the host merges them
// by full key.  Here every key is grouped exactly: n_groups is the number
// of distinct keys and no key is split; the group order is arbitrary.
//
// A block takes a tile of 256 rows, a row a thread, and aggregates it in
// shared memory before it touches device memory:
// - the tile's lane words are staged in shared memory;
// - each selected row inserts its key into the block's table (512 slots,
//   twice the tile: it never fills; 7 KB with the lane words): a key word
//   -- the key's hash and its representative's place in the tile, or the
//   bucket -- claimed with a shared 64-bit atomicCAS, and a count added
//   with a shared atomicAdd; a span key that finds its hash compares in
//   full against the representative's span;
// - the occupied slots are listed, and each makes one insert into the
//   global table, 32 to a warp: `cap` slots (the least power of two >= 2B:
//   linear probing, never full) of 64-bit keys (a span's representative
//   row + 1 beside its lane word, or 1 << 32 | bucket; 0 = empty) claimed
//   by atomicCAS.  A claimed slot's group index comes from one atomicAdd
//   on n_groups a warp (its claims counted by a ballot); the claimer
//   writes the group's row and then publishes the index + 1 in
//   slot_group; a block that finds the key already there waits for that
//   index and adds its count to the group's row.
// So the four statuses over 65k rows cost one global atomic per (block,
// status), not one per row, and nothing walks or compacts the table.  The
// table costs 12 bytes a slot (3 MB at B = 65,547), zeroed by the caller
// with n_groups in one fill.
//
// Span keys are hashed and compared as aligned 16-byte chunks
// (lp::load16_in) realigned to the key's start, 16 bytes a step; a key
// that runs past the line (start + len > L) is read as the reference's
// gather reads it, every position clamped to L - 1 (past it, that byte
// repeats).
//
// Bound: bytes -- the lane (4 bytes a row), the key bytes of the selected
// rows, and 16 or 8 bytes a group written.

#include "line_stage.cuh"
#include "lp_common.cuh"

namespace {

constexpr int SPAN_BITS = 13, SPAN_MASK = (1 << SPAN_BITS) - 1;
constexpr int32_t I32_MAX = 2147483647;
constexpr int THREADS = 256, TILE = THREADS;   // a row a thread
constexpr int SLOTS = 2 * TILE;   // the block's table: never more than half full

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// 16 bytes from byte `sh` (0 to 15) of the 32 bytes a, b.
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, int sh) {
  const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = sh >> 2, r = 8 * (sh & 3);
  uint32_t y[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    y[i] = q == 0 ? x[i] : q == 1 ? x[i + 1] : q == 2 ? x[i + 2] : x[i + 3];
  }
  return make_uint4(__funnelshift_r(y[0], y[1], r), __funnelshift_r(y[1], y[2], r),
                    __funnelshift_r(y[2], y[3], r), __funnelshift_r(y[3], y[4], r));
}

// A span key inside its line, 16 bytes a step as aligned chunks.
struct KeyChunks {
  const uint8_t* c;     // the chunk holding the next step's first byte
  const uint8_t* end;   // the key's end
  const uint8_t *lo, *hi;
  int sh;
  uint4 cur;
  __device__ __forceinline__ KeyChunks(const uint8_t* p, int n, const uint8_t* lo_,
                                       const uint8_t* hi_)
      : c(lp::align_down16(p)), end(p + n), lo(lo_), hi(hi_), sh(static_cast<int>(p - c)) {
    cur = n > 0 ? lp::load16_in(c, lo, hi) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ uint4 next() {
    const uint4 nxt = c + 16 < end ? lp::load16_in(c + 16, lo, hi) : make_uint4(0u, 0u, 0u, 0u);
    const uint4 out = realign(cur, nxt, sh);
    c += 16;
    cur = nxt;
    return out;
  }
};

__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * 0x01000193u;
  return h ^ (h >> 15);
}

// The key's word at byte j as the reference gathers it: every position
// clamped to L - 1 (`last`, that byte), bytes past the key 0.
__device__ __forceinline__ uint32_t clamped_word(const uint8_t* row, int s, int j, int n, int L,
                                                 uint32_t last) {
  uint32_t w = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int p = s + j + t;
    const uint32_t c = j + t >= n ? 0u : p < L - 1 ? row[p] : last;
    w |= c << (8 * t);
  }
  return w;
}

// The key's hash over its length and its words (little-endian, the last
// cut to the key); the same whichever way its bytes are read.
__device__ uint32_t key_hash(const uint8_t* row, int s, int n, int L, const uint8_t* lo,
                             const uint8_t* hi) {
  uint32_t h = 0x811C9DC5u ^ static_cast<uint32_t>(n) * 0x9E3779B1u;
  if (s + n <= L) {
    KeyChunks k(row + s, n, lo, hi);
    for (int j = 0; j < n; j += 16) {
      const uint4 v = k.next();
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (j + 4 * t < n) h = hash_step(h, w[t] & low_bytes(n - j - 4 * t));
      }
    }
  } else {
    const uint32_t last = row[L - 1];
    for (int j = 0; j < n; j += 4) h = hash_step(h, clamped_word(row, s, j, n, L, last));
  }
  return mix32(h);
}

// Two keys of length n, in full.
__device__ bool key_equal(const uint8_t* ra, int sa, const uint8_t* rb, int sb, int n, int L,
                          const uint8_t* lo, const uint8_t* hi) {
  if (sa + n <= L && sb + n <= L) {
    KeyChunks a(ra + sa, n, lo, hi), b(rb + sb, n, lo, hi);
    for (int j = 0; j < n; j += 16) {
      const uint4 x = a.next(), y = b.next();
      const int left = n - j;
      if (((x.x ^ y.x) & low_bytes(left)) | ((x.y ^ y.y) & low_bytes(left - 4)) |
          ((x.z ^ y.z) & low_bytes(left - 8)) | ((x.w ^ y.w) & low_bytes(left - 12))) {
        return false;
      }
    }
    return true;
  }
  const uint32_t la = ra[L - 1], lb = rb[L - 1];
  for (int j = 0; j < n; j += 4) {
    if (clamped_word(ra, sa, j, n, L, la) != clamped_word(rb, sb, j, n, L, lb)) return false;
  }
  return true;
}

template <bool SPANS>
__global__ void __launch_bounds__(THREADS) agg_group_kernel(
    int B, int L, const int32_t* __restrict__ lane, const uint8_t* __restrict__ buf, int cap,
    unsigned long long* __restrict__ table, int32_t* __restrict__ slot_group,
    int32_t* __restrict__ groups, int32_t* __restrict__ n_groups) {
  // A slot's key word: SPANS: hash << 32 | (representative row + 1 - the
  // tile's first row); ints: 1 << 32 | bucket.  0 = empty.
  __shared__ unsigned long long s_key[SLOTS];
  __shared__ int32_t s_count[SLOTS];
  __shared__ int32_t s_word[TILE];   // the tile's lane words
  __shared__ int16_t s_used[SLOTS];  // the occupied slots, compacted
  __shared__ int s_n_used;
  const int lane_id = threadIdx.x & 31;
  const uint8_t* lo = buf;
  const uint8_t* hi = buf + static_cast<size_t>(B) * L;
  const int tile0 = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < SLOTS; i += THREADS) {
    s_key[i] = 0ull;
    s_count[i] = 0;
  }
  if (threadIdx.x == 0) s_n_used = 0;

  // A row a thread.
  const int r = tile0 + threadIdx.x;
  const int32_t w = r < B ? lane[r] : (SPANS ? -1 : I32_MAX);
  s_word[threadIdx.x] = w;
  const bool sel = SPANS ? w != -1 : w != I32_MAX;
  const int s = w & SPAN_MASK, n = (w >> SPAN_BITS) & SPAN_MASK;
  const uint8_t* row = buf + static_cast<size_t>(r) * L;
  uint32_t h = 0;
  unsigned long long key = 0;
  if (sel) {
    h = SPANS ? key_hash(row, s, n, L, lo, hi) : mix32(static_cast<uint32_t>(w));
    key = SPANS ? (static_cast<unsigned long long>(h) << 32 | (threadIdx.x + 1u))
                : (1ull << 32 | static_cast<uint32_t>(w));
  }
  __syncthreads();
  // Each selected row inserts itself.  (Gathering a warp's equal keys
  // first with __match_any_sync, its leader inserting their count, timed
  // no faster on any lane: shared atomics absorb the hot keys.)
  if (sel) {
    uint32_t slot = mix32(h) & (SLOTS - 1);
    while (true) {
      unsigned long long cur = *static_cast<volatile unsigned long long*>(&s_key[slot]);
      if (cur == 0ull) {
        cur = atomicCAS(&s_key[slot], 0ull, key);
        if (cur == 0ull) {
          s_used[atomicAdd(&s_n_used, 1)] = static_cast<int16_t>(slot);
          break;
        }
      }
      bool hit;
      if (SPANS) {
        const int t = static_cast<int>(cur & 0xFFFFFFFFu) - 1;   // the rep's place in the tile
        const int32_t wr = s_word[t];
        hit = (cur >> 32) == h && ((wr >> SPAN_BITS) & SPAN_MASK) == n &&
              key_equal(buf + static_cast<size_t>(tile0 + t) * L, wr & SPAN_MASK, row, s, n,
                        L, lo, hi);
      } else {
        hit = cur == key;
      }
      if (hit) break;
      slot = (slot + 1) & (SLOTS - 1);
    }
    atomicAdd(&s_count[slot], 1);
  }
  __syncthreads();

  // One global insert per occupied slot, 32 to a warp; every lane of a
  // warp takes the same trips, so its ballots see the whole warp.
  const int n_used = s_n_used;
  for (int base = threadIdx.x - lane_id; base < n_used; base += THREADS) {
    const int j = base + lane_id;
    bool claimed = false, live = j < n_used;
    int gslot = 0, cnt = 0, rep = 0, rs = 0, rn = 0;
    unsigned long long want = 0;
    if (live) {
      const int slot = s_used[j];
      const unsigned long long k = s_key[slot];
      cnt = s_count[slot];
      uint32_t g;
      if (SPANS) {
        const int t = static_cast<int>(k & 0xFFFFFFFFu) - 1;
        const int32_t wr = s_word[t];
        rep = tile0 + t;
        rs = wr & SPAN_MASK;
        rn = (wr >> SPAN_BITS) & SPAN_MASK;
        want = static_cast<unsigned long long>(static_cast<uint32_t>(wr)) << 32 |
               static_cast<uint32_t>(rep + 1);
        g = static_cast<uint32_t>(k >> 32);
      } else {
        want = k;
        g = mix32(static_cast<uint32_t>(k));
      }
      const uint8_t* rrow = buf + static_cast<size_t>(rep) * L;
      uint32_t gs = g & static_cast<uint32_t>(cap - 1);
      while (true) {
        unsigned long long cur = __ldcg(&table[gs]);
        if (cur == 0ull) {
          cur = atomicCAS(&table[gs], 0ull, want);
          if (cur == 0ull) {
            claimed = true;
            break;
          }
        }
        bool hit;
        if (SPANS) {
          const int32_t wc = static_cast<int32_t>(cur >> 32);
          hit = ((wc >> SPAN_BITS) & SPAN_MASK) == rn &&
                key_equal(buf + static_cast<size_t>(static_cast<uint32_t>(cur) - 1) * L,
                          wc & SPAN_MASK, rrow, rs, rn, L, lo, hi);
        } else {
          hit = cur == want;
        }
        if (hit) break;
        gs = (gs + 1) & static_cast<uint32_t>(cap - 1);
      }
      gslot = static_cast<int>(gs);
    }
    const unsigned claims = __ballot_sync(lp::FULL, claimed);
    if (claims) {
      const int first = __ffs(claims) - 1;
      int g0 = 0;
      if (lane_id == first) g0 = atomicAdd(n_groups, __popc(claims));
      g0 = __shfl_sync(lp::FULL, g0, first);
      if (claimed) {
        const int g = g0 + __popc(claims & ((1u << lane_id) - 1u));
        if (SPANS) {
          int32_t* o = groups + 4 * static_cast<size_t>(g);
          o[0] = cnt;
          o[1] = rep;
          o[2] = rs;
          o[3] = rn;
        } else {
          int32_t* o = groups + 2 * static_cast<size_t>(g);
          o[0] = static_cast<int32_t>(want & 0xFFFFFFFFu);
          o[1] = cnt;
        }
        __threadfence();   // the row before its index
        atomicExch(&slot_group[gslot], g + 1);
      }
    }
    if (live && !claimed) {
      int g1;
      while ((g1 = *static_cast<volatile int32_t*>(&slot_group[gslot])) == 0) {
      }
      __threadfence();
      atomicAdd(&groups[SPANS ? 4 * static_cast<size_t>(g1 - 1)
                              : 2 * static_cast<size_t>(g1 - 1) + 1], cnt);
    }
  }
}

}  // namespace

// table ([cap] 64-bit words), slot_group ([cap] int32) and n_groups ([1])
// arrive zeroed.
LP_EXPORT int lp_agg_group(int B, int L, const void* lane, const void* buf, int spans,
                           int cap, void* table, void* slot_group, void* groups,
                           void* n_groups, void* stream) {
  if (cap < 2 * B || (cap & (cap - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + TILE - 1) / TILE;
  const auto* ln = static_cast<const int32_t*>(lane);
  const auto* b = static_cast<const uint8_t*>(buf);
  auto* t = static_cast<unsigned long long*>(table);
  auto* sg = static_cast<int32_t*>(slot_group);
  auto* g = static_cast<int32_t*>(groups);
  auto* ng = static_cast<int32_t*>(n_groups);
  if (spans) {
    agg_group_kernel<true><<<blocks, THREADS, 0, st>>>(B, L, ln, b, cap, t, sg, g, ng);
  } else {
    agg_group_kernel<false><<<blocks, THREADS, 0, st>>>(B, L, ln, b, cap, t, sg, g, ng);
  }
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_agg_group_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
