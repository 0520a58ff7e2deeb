// Kernel 1: the split program over a [B, L] uint8 buffer.
//
// Replaces logparser_tpu/tpu/pipeline.py compute_split (bitplane form,
// with escaped_lead_positions and _charset_mask folded in).
//
// One warp per line.  Phase A walks the line in 32-byte strides: lane j
// holds byte 32*s + j (0 past L), and one __ballot_sync per byte class
// gives that stride's 32-bit plane word -- the bitplane the reference
// packs with _plane_pack.  The classes are "byte == separator byte b"
// and "byte violates charset c" (one table lookup per byte), plus the
// escape-parity plane: a running "last non-backslash position" carried
// across strides gives the backslash run before every position.  The
// planes live in shared memory, (P + 1) * ceil(L/32) words per warp.
// Phase B runs the op program on those words, warp-cooperatively: lane i
// owns word base + i, so first-at-or-after is one ballot + __ffs per 32
// words, range-any one ballot, last-set one ballot + __clz.  Multi-byte
// separator planes are ANDs of shifted byte planes, computed per word.
//
// Bound: reads B*L bytes once (phase A) and writes 2*T*4 + 4 bytes per
// line; at B = 65536, L = 512 that is ~10 us of HBM time on an H100.
// The op program's word scans stay in shared memory; their cost is in
// instructions, which the warp-per-line layout keeps uniform (no
// divergence: every lane computes the same cursor).

#include "lp_common.cuh"

namespace {

constexpr int OPW = 9;

struct Planes {
  const uint32_t* pl;    // [P][C] byte-class planes
  const uint32_t* esc;   // [C] escape-parity plane (or null)
  const int32_t* lits;   // [n_lits][litw]: length, plane of each byte
  int litw, C, L, len;

  __device__ __forceinline__ uint32_t word(int plane, int w) const {
    return (w >= 0 && w < C) ? pl[plane * C + w] : 0u;
  }
  __device__ __forceinline__ uint32_t esc_word(int w) const {
    return (w >= 0 && w < C) ? esc[w] : 0u;
  }
};

// Bits at positions < thresh within word w (the reference's _plane_cutoff).
__device__ __forceinline__ uint32_t cutoff_word(int thresh, int w) {
  int rel = thresh - 32 * w;
  if (rel <= 0) return 0u;
  if (rel >= 32) return lp::FULL;
  return (1u << rel) - 1u;
}

// Word w of a separator's occurrence plane: bit j = the separator starts
// at 32w + j and fits inside the line.
__device__ uint32_t lit_word(const Planes& P, int lit, int w) {
  const int32_t* row = P.lits + lit * P.litw;
  int k = row[0];
  uint32_t acc = lp::FULL;
  for (int i = 0; i < k; ++i) {
    int plane = row[1 + i];
    int src = w + (i >> 5), bs = i & 31;
    uint32_t lo = P.word(plane, src);
    acc &= bs ? ((lo >> bs) | (P.word(plane, src + 1) << (32 - bs))) : lo;
  }
  return acc & cutoff_word(P.len - (k - 1), w);
}

// mode 0: all occurrences; 1: even escape parity; 2: odd escape parity.
__device__ __forceinline__ uint32_t search_word(const Planes& P, int lit,
                                                int mode, int w) {
  uint32_t x = lit_word(P, lit, w);
  if (mode == 1) x &= ~P.esc_word(w);
  if (mode == 2) x &= P.esc_word(w);
  return x;
}

// First occurrence at or after cursor; L when none.
__device__ int first_ge(const Planes& P, int lit, int mode, int cursor,
                        int lane) {
  if (cursor < 0) cursor = 0;
  if (cursor >= P.C * 32) return P.L;
  int cw = cursor >> 5, cb = cursor & 31;
  for (int base = cw; base < P.C; base += 32) {
    int w = base + lane;
    uint32_t x = w < P.C ? search_word(P, lit, mode, w) : 0u;
    if (w == cw) x &= lp::FULL << cb;
    unsigned bal = __ballot_sync(lp::FULL, x != 0u);
    if (bal) {
      int f = __ffs(bal) - 1;
      uint32_t xf = __shfl_sync(lp::FULL, x, f);
      return (base + f) * 32 + (__ffs(xf) - 1);
    }
  }
  return P.L;
}

__device__ __forceinline__ bool test_bit(const Planes& P, int lit, int p) {
  if (p < 0 || p >= P.C * 32) return false;
  return (lit_word(P, lit, p >> 5) >> (p & 31)) & 1u;
}

// Any set bit of plane vp at a position in [start, end).
__device__ bool any_in_range(const Planes& P, int vp, int start, int end,
                             int lane) {
  int hi = min(end, P.C * 32);
  if (hi <= start || hi <= 0) return false;
  int lo_w = max(start, 0) >> 5, hi_w = (hi + 31) >> 5;
  for (int base = lo_w; base < hi_w; base += 32) {
    int w = base + lane;
    uint32_t x = w < hi_w
        ? P.word(vp, w) & cutoff_word(end, w) & ~cutoff_word(start, w) : 0u;
    if (__ballot_sync(lp::FULL, x != 0u)) return true;
  }
  return false;
}

// Highest set position of plane vp below thresh; -1 when none.
__device__ int last_set(const Planes& P, int vp, int thresh, int lane) {
  for (int base = ((P.C - 1) >> 5) << 5; base >= 0; base -= 32) {
    int w = base + lane;
    uint32_t x = w < P.C ? P.word(vp, w) & cutoff_word(thresh, w) : 0u;
    unsigned bal = __ballot_sync(lp::FULL, x != 0u);
    if (bal) {
      int h = 31 - __clz(bal);
      uint32_t xh = __shfl_sync(lp::FULL, x, h);
      return (base + h) * 32 + (31 - __clz(xh));
    }
  }
  return -1;
}

__global__ void split_kernel(
    const uint8_t* __restrict__ buf, const int32_t* __restrict__ lengths,
    int B, int L, int C, const uint32_t* __restrict__ cls_g,
    const int32_t* __restrict__ ops, int n_ops,
    const int32_t* __restrict__ lits, int litw, int n_planes, int has_esc,
    int n_tok, int32_t* __restrict__ starts, int32_t* __restrict__ ends,
    int32_t* __restrict__ flags) {
  extern __shared__ uint32_t smem[];
  uint32_t* cls = smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  uint32_t* mine = smem + 256 + warp * (n_planes + has_esc) * C;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls[i] = cls_g[i];
  __syncthreads();

  Planes P;
  P.pl = mine;
  P.esc = has_esc ? mine + n_planes * C : nullptr;
  P.lits = lits;
  P.litw = litw;
  P.C = C;
  P.L = L;

  for (int b = blockIdx.x * wpb + warp; b < B; b += gridDim.x * wpb) {
    const uint8_t* line = buf + static_cast<size_t>(b) * L;
    const int len = lengths[b];
    P.len = len;

    // ---- phase A: byte-class and escape-parity planes ----------------
    int carry = -1;  // last non-backslash position before this stride
    for (int s = 0; s < C; ++s) {
      const int p = s * 32 + lane;
      const uint32_t x = p < L ? line[p] : 0u;
      const uint32_t c = cls[x];
      for (int i = 0; i < n_planes; ++i) {
        unsigned w = __ballot_sync(lp::FULL, (c >> i) & 1u);
        if (lane == 0) mine[i * C + s] = w;
      }
      if (has_esc) {
        unsigned nb = __ballot_sync(lp::FULL, x != 0x5Cu);
        unsigned below = nb & ((1u << lane) - 1u);
        int last_nb = below ? s * 32 + (31 - __clz(below)) : carry;
        unsigned e = __ballot_sync(lp::FULL, (((p - 1) - last_nb) & 1) != 0);
        if (lane == 0) mine[n_planes * C + s] = e;
        if (nb) carry = s * 32 + (31 - __clz(nb));
      }
    }
    __syncwarp();

    // ---- phase B: the op program (warp-uniform state) ----------------
    int tok_start0 = 0, tok_end0 = 0, tok_start1 = 0, tok_end1 = 0;
    int cursor = 0;
    bool valid = true, esc_hit = false;
    for (int oi = 0; oi < n_ops; ++oi) {
      const int32_t* op = ops + oi * OPW;
      const int kind = op[0], lit = op[1], tok = op[2], vp = op[3];
      const int k = lit >= 0 ? lits[lit * litw] : 0;
      if (kind == 0) {
        valid = valid && test_bit(P, lit, cursor);
        cursor += k;
        continue;
      }
      const int start = cursor;
      int end;
      bool ok = valid;
      if (kind == 1) {
        int found;
        if (op[6]) {
          found = first_ge(P, lit, 1, cursor, lane);
          const bool had_skip = first_ge(P, lit, 2, cursor, lane) < found;
          if (op[6] == 1) esc_hit = esc_hit || had_skip;
          else ok = ok && !had_skip;
        } else {
          found = first_ge(P, lit, 0, cursor, lane);
        }
        const bool token_valid = found < L;
        end = token_valid ? found : cursor;
        ok = ok && token_valid;
      } else {
        end = len;
      }
      if (vp >= 0 && any_in_range(P, vp, start, end, lane)) ok = false;
      const int width = end - start;
      ok = ok && width >= op[4];
      if (op[5]) ok = ok && width <= op[5];
      valid = ok;
      if (lane == (tok & 31)) {
        if (tok < 32) { tok_start0 = start; tok_end0 = end; }
        else { tok_start1 = start; tok_end1 = end; }
      }
      cursor = end + k;
    }
    valid = valid && cursor == len;

    bool plausible = true;
    int p_cursor = 0;
    for (int oi = 0; oi < n_ops; ++oi) {
      const int32_t* op = ops + oi * OPW;
      const int pflags = op[7];
      if (!(pflags & 1)) continue;
      const int lit = op[1], k = lits[lit * litw];
      int lower = p_cursor;
      bool has_exact = false;
      int exact = 0;
      if (pflags & 2) has_exact = true;
      if (pflags & 4) {
        const int e2 = len - k;
        if (!has_exact) exact = e2;
        else if (exact != e2) exact = -1;
        has_exact = true;
      } else if (op[8] >= 0) {
        lower = max(lower, last_set(P, op[8], len, lane) - k + 1);
      }
      int found;
      if (has_exact) {
        found = (test_bit(P, lit, exact) && exact >= lower) ? exact : L;
      } else {
        found = first_ge(P, lit, 0, lower, lane);
      }
      plausible = plausible && found < L;
      p_cursor = found + k;
    }

    if (lane < n_tok) {
      starts[static_cast<size_t>(lane) * B + b] = tok_start0;
      ends[static_cast<size_t>(lane) * B + b] = tok_end0;
    }
    if (lane + 32 < n_tok) {
      starts[static_cast<size_t>(lane + 32) * B + b] = tok_start1;
      ends[static_cast<size_t>(lane + 32) * B + b] = tok_end1;
    }
    if (lane == 0) {
      flags[b] = (valid ? 1 : 0) | (plausible ? 2 : 0) | (esc_hit ? 4 : 0);
    }
    __syncwarp();
  }
}

}  // namespace

LP_EXPORT int lp_split(const void* buf, const void* lengths, int B, int L,
                       const void* cls, const void* ops, int n_ops,
                       const void* lits, int litw, int n_planes, int has_esc,
                       int n_tok, void* starts, void* ends, void* flags,
                       void* stream) {
  if (B <= 0) return 0;
  const int C = (L + 31) / 32;
  const size_t per_warp = static_cast<size_t>(n_planes + has_esc) * C * 4;
  int wpb = static_cast<int>((48 * 1024 - 1024) / (per_warp ? per_warp : 1));
  if (wpb > 8) wpb = 8;
  if (wpb < 1) wpb = 1;
  // At most 32 planes of ceil(8191/32) words: one warp's planes always
  // fit the default 48 KB of shared memory.
  const size_t smem = 1024 + per_warp * wpb;
  int blocks = (B + wpb - 1) / wpb;
  if (blocks > 132 * 64) blocks = 132 * 64;
  split_kernel<<<blocks, wpb * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(lengths),
      B, L, C, static_cast<const uint32_t*>(cls),
      static_cast<const int32_t*>(ops), n_ops,
      static_cast<const int32_t*>(lits), litw, n_planes, has_esc, n_tok,
      static_cast<int32_t*>(starts), static_cast<int32_t*>(ends),
      static_cast<int32_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

LP_EXPORT const char* lp_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
