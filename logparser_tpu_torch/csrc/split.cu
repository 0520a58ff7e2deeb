// Kernel 1: the split program over a [B, L] uint8 buffer.
//
// Replaces logparser_tpu/tpu/pipeline.py compute_split (bitplane form,
// with escaped_lead_positions and _charset_mask folded in; the NUL
// literals of compute_split_dense, and run_program, run the same kernel).
//
// Bound: bytes -- B*L bytes and the lengths read once, 2*T*4 + 4 bytes
// written a line (split_cost in chip_smoke.py); at B = 65,549, L = 384
// about 9 us of HBM time on an H100.  The work between is instructions:
// the bit planes of every line, then the op program's scans over them.
//
// Staging: a persistent grid; each warp has a ring of line stages in
// shared memory (4 up to L = 512, else 2).  While it works on one line,
// TMA 1-D bulk copies (cp.async.bulk, completion on each stage's
// mbarrier, each barrier's phase tracked across uses) bring its next
// lines into the other stages.  A line that does not start or end on 16
// bytes (an odd L, such as the 8,191-byte bucket) copies its aligned
// middle by TMA and its < 16-byte head and tail with plain loads.  The
// program (the byte-class table, the ops, the literals) sits in shared
// memory once per block.
//
// Phase A (a warp a line) builds the line's class planes: "byte == a
// separator byte" and "byte violates a charset", and the escape-parity
// plane (an odd run of backslashes just before the position).  Lane j
// holds byte 32s + j of stride s and its class bits; the classes of 4
// strides (8 classes or fewer; 2 strides up to 16, 1 up to 32) are packed
// into one word a lane, and one 32 x 32 bit transpose across the warp (5
// shuffle steps) leaves in lane i the plane word of class i % CB for
// stride s + i / CB -- a ballot per class costs 3 instructions a class
// and stride.  The escape word is the same for every lane: one ballot of
// the backslashes and a carry-and-add over the word (escape_word).  Planes
// are stored word-major with an odd stride.
//
// Phase B runs the op program; its semantics, flag bits and the
// plausibility pass are the reference's, line for line.
// - Lines up to 512 bytes (16 words): a thread a line.  The warp stages
//   and plans a chunk of up to 32 consecutive lines into a bank of plane
//   records (odd record stride: conflict-free when the lanes read the
//   same word of their own lines), each with its planes' word-nonzero
//   masks (one ballot a transpose), then each lane runs the program on
//   its line with per-thread scans that visit only the candidate words a
//   mask names, building a literal's occurrence word (the AND of its
//   bytes' planes, shifted; cut at len - (k - 1)) only for those; its
//   outputs are coalesced stores.  The program's scalar work is spread
//   over the lanes instead of repeated by all 32 of them, and a line
//   without separators (garbage) costs its lane no word scans.
// - Longer lines: a warp a line.  Each literal's occurrence plane is built
//   once a line, a word a lane; first-at-or-after reads the cursor's word
//   first and then ballots over 32 words at a time, range-any and
//   last-set ballot, the escape-aware op asks "an odd-parity occurrence
//   before the even one?" as one range test over [cursor, found).

#include "lp_common.cuh"
#include "smem_stage.cuh"

namespace {

constexpr int OPW = 9;
constexpr int MAX_WARPS = 8;
constexpr int MAX_STAGES = 4;
constexpr int THREAD_MAX_C = 16;      // a thread a line up to 16 words (L <= 512)
constexpr int BANK_BYTES = 8 * 1024;  // a warp's bank of plane records
constexpr uint32_t BACKSLASH = 0x5Cu;

// Bits at positions < thresh within word w (the reference's _plane_cutoff).
__device__ __forceinline__ uint32_t cutoff_word(int thresh, int w) {
  int rel = thresh - 32 * w;
  if (rel <= 0) return 0u;
  if (rel >= 32) return lp::FULL;
  return (1u << rel) - 1u;
}

// Lane i gets bit i of every lane's word: bit j of the result is bit i of
// lane j's x.  Each level swaps the off-diagonal k x k blocks.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t lo_masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u,
                                0x55555555u};
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int k = 16 >> l;
    const uint32_t m = lo_masks[l];
    const uint32_t y = __shfl_xor_sync(lp::FULL, x, k);
    x = (lane & k) ? ((x & ~m) | ((y >> k) & m)) : ((x & m) | ((y << k) & ~m));
  }
  return x;
}

// The escape-parity word of a 32-byte stride from its backslash bits: bit
// j = an odd run of backslashes ends just before j.  `odd` carries "the
// next stride's first byte follows an odd run" (the add's carry out):
// clear the backslashes that are themselves escaped, add each run's start
// to the run so that runs starting on even and odd bits carry apart, and
// keep every other position after a backslash accordingly.
__device__ __forceinline__ uint32_t escape_word(uint32_t bs, uint32_t& odd) {
  constexpr uint32_t EVEN = 0x55555555u;
  bs &= ~odd;
  const uint32_t follows = (bs << 1) | odd;
  const uint32_t odd_starts = bs & ~EVEN & ~follows;
  const uint32_t sum = odd_starts + bs;
  odd = sum < bs ? 1u : 0u;
  return (EVEN ^ (sum << 1)) & follows;
}

// Phase A: the class planes of one staged line into pl [C][stride]
// (n_planes class planes, then the escape plane when has_esc); with
// `summary`, also each plane's word-nonzero mask (bit w: word w has a set
// bit; C <= 32) into summary [n_cls].
template <int CB>
__device__ __forceinline__ void class_planes(const uint8_t* line, int L, int C,
                                             const uint32_t* cls, int n_planes,
                                             int has_esc, uint32_t* pl, int stride,
                                             uint32_t* summary, int lane) {
  constexpr int SPT = 32 / CB;   // strides a transpose
  const int n_cls = n_planes + has_esc;
  const int mine_k = lane / CB, mine_plane = lane % CB;
  uint32_t nonzero = 0;   // lane p < n_cls: plane p's word-nonzero mask
  uint32_t odd = 0;       // the escape carry into the next stride
  for (int s0 = 0; s0 < C; s0 += SPT) {
    uint32_t x[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int p = (s0 + k) * 32 + lane;
      x[k] = p < L ? line[p] : 0u;
    }
    uint32_t row = 0;
#pragma unroll
    for (int k = 0; k < SPT; ++k) row |= cls[x[k]] << (k * CB);
    uint32_t word = transpose32(row, lane);
    if (has_esc) {   // the escape plane's slot takes the stride's word
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const uint32_t e = escape_word(~__ballot_sync(lp::FULL, x[k] != BACKSLASH), odd);
        if (mine_k == k && mine_plane == n_planes) word = e;
      }
    }
    const bool slot = mine_plane < n_cls && s0 + mine_k < C;
    if (slot) pl[(s0 + mine_k) * stride + mine_plane] = word;
    if (summary != nullptr) {
      const unsigned nz = __ballot_sync(lp::FULL, slot && word != 0u);
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        nonzero |= ((nz >> (k * CB + (lane & (CB - 1)))) & 1u) << (s0 + k);
    }
  }
  if (summary != nullptr && lane < n_cls) summary[lane] = nonzero;
}

__device__ __forceinline__ void class_planes_any(int cb, const uint8_t* line, int L, int C,
                                                 const uint32_t* cls, int n_planes,
                                                 int has_esc, uint32_t* pl, int stride,
                                                 uint32_t* summary, int lane) {
  if (cb == 8) class_planes<8>(line, L, C, cls, n_planes, has_esc, pl, stride, summary, lane);
  else if (cb == 16)
    class_planes<16>(line, L, C, cls, n_planes, has_esc, pl, stride, summary, lane);
  else class_planes<32>(line, L, C, cls, n_planes, has_esc, pl, stride, summary, lane);
}

// Bits [lo, hi) of a word mask (0 <= lo, hi <= 32).
__device__ __forceinline__ uint32_t word_range(int lo, int hi) {
  const uint32_t below_hi = hi >= 32 ? lp::FULL : (1u << hi) - 1u;
  return lo >= 32 ? 0u : below_hi & (lp::FULL << lo);
}

// ---- phase B scanners --------------------------------------------------

// A thread's scans over its own line's class planes (C <= 32).  Only the
// words whose plane -- for a literal, its first byte's plane -- has a set
// bit are read (the record's word-nonzero masks), and a literal's words
// are built on demand.
struct ThreadScan {
  const uint32_t* pl;    // this line's record: [C][stride], then [n_cls] masks
  const uint32_t* nonzero;
  const int32_t* lits;
  int litw, stride, esc, C, L, len;

  __device__ __forceinline__ uint32_t word(int plane, int w) const {
    return (w >= 0 && w < C) ? pl[w * stride + plane] : 0u;
  }
  // Word w of a literal's occurrence plane: bit j = it starts at 32w + j
  // and fits inside the line.
  __device__ uint32_t lit_word(const int32_t* row, int w) const {
    const int k = row[0];
    uint32_t acc = lp::FULL;
    for (int i = 0; i < k; ++i) {
      const int plane = row[1 + i];
      const int src = w + (i >> 5), bs = i & 31;
      const uint32_t lo = word(plane, src);
      acc &= bs ? ((lo >> bs) | (word(plane, src + 1) << (32 - bs))) : lo;
    }
    return acc & cutoff_word(len - (k - 1), w);
  }
  // mode 0: all occurrences; 1: even escape parity; 2: odd escape parity.
  __device__ __forceinline__ uint32_t search(const int32_t* row, int mode, int w) const {
    uint32_t x = lit_word(row, w);
    if (mode == 1) x &= ~pl[w * stride + esc];
    if (mode == 2) x &= pl[w * stride + esc];
    return x;
  }
  __device__ int first(int lit, int mode, int cursor) const {
    if (cursor < 0) cursor = 0;
    if (cursor >= C * 32) return L;
    const int32_t* row = lits + lit * litw;
    const int cw = cursor >> 5;
    for (uint32_t cand = nonzero[row[1]] & word_range(cw, 32); cand; cand &= cand - 1) {
      const int w = __ffs(cand) - 1;
      uint32_t x = search(row, mode, w);
      if (w == cw) x &= lp::FULL << (cursor & 31);
      if (x) return w * 32 + (__ffs(x) - 1);
    }
    return L;
  }
  __device__ bool any_lit(int lit, int mode, int start, int end) const {
    const int hi = min(end, C * 32);
    if (hi <= start || hi <= 0) return false;
    const int32_t* row = lits + lit * litw;
    const int lo_w = max(start, 0) >> 5, hi_w = (hi + 31) >> 5;
    for (uint32_t cand = nonzero[row[1]] & word_range(lo_w, hi_w); cand; cand &= cand - 1) {
      const int w = __ffs(cand) - 1;
      if (search(row, mode, w) & cutoff_word(end, w) & ~cutoff_word(start, w)) return true;
    }
    return false;
  }
  __device__ bool any_plane(int vp, int start, int end) const {
    const int hi = min(end, C * 32);
    if (hi <= start || hi <= 0) return false;
    const int lo_w = max(start, 0) >> 5, hi_w = (hi + 31) >> 5;
    for (uint32_t cand = nonzero[vp] & word_range(lo_w, hi_w); cand; cand &= cand - 1) {
      const int w = __ffs(cand) - 1;
      if (pl[w * stride + vp] & cutoff_word(end, w) & ~cutoff_word(start, w)) return true;
    }
    return false;
  }
  __device__ int last_plane(int vp, int thresh) const {
    const int top = min(thresh, C * 32) - 1;
    if (top < 0) return -1;
    for (uint32_t cand = nonzero[vp] & word_range(0, (top >> 5) + 1); cand;) {
      const int w = 31 - __clz(cand);
      const uint32_t x = pl[w * stride + vp] & cutoff_word(thresh, w);
      if (x) return w * 32 + (31 - __clz(x));
      cand &= ~(1u << w);
    }
    return -1;
  }
  __device__ __forceinline__ bool test(int lit, int p) const {
    if (p < 0 || p >= C * 32) return false;
    return (lit_word(lits + lit * litw, p >> 5) >> (p & 31)) & 1u;
  }
};

// A warp's scans over one line: literal occurrence planes built once,
// then 32 words a ballot.
struct WarpScan {
  const uint32_t* pl;    // [C][stride] class planes, then the escape plane
  const uint32_t* occ;   // [n_lits][C] literal occurrence planes (cut at len)
  int stride, esc, C, L, lane;

  __device__ __forceinline__ uint32_t word(int plane, int w) const {
    return (w >= 0 && w < C) ? pl[w * stride + plane] : 0u;
  }
  __device__ __forceinline__ uint32_t search(int lit, int mode, int w) const {
    uint32_t x = occ[lit * C + w];
    if (mode == 1) x &= ~pl[w * stride + esc];
    if (mode == 2) x &= pl[w * stride + esc];
    return x;
  }
  __device__ int first(int lit, int mode, int cursor) const {
    if (cursor < 0) cursor = 0;
    if (cursor >= C * 32) return L;
    const int cw = cursor >> 5;
    const uint32_t x0 = search(lit, mode, cw) & (lp::FULL << (cursor & 31));
    if (x0) return cw * 32 + (__ffs(x0) - 1);
    for (int base = cw + 1; base < C; base += 32) {
      const int w = base + lane;
      const uint32_t x = w < C ? search(lit, mode, w) : 0u;
      const unsigned bal = __ballot_sync(lp::FULL, x != 0u);
      if (bal) {
        const int f = __ffs(bal) - 1;
        const uint32_t xf = __shfl_sync(lp::FULL, x, f);
        return (base + f) * 32 + (__ffs(xf) - 1);
      }
    }
    return L;
  }
  template <class At>
  __device__ bool any(int start, int end, At at) const {
    const int hi = min(end, C * 32);
    if (hi <= start || hi <= 0) return false;
    const int lo_w = max(start, 0) >> 5, hi_w = (hi + 31) >> 5;
    const auto masked = [&](int w) {
      return at(w) & cutoff_word(end, w) & ~cutoff_word(start, w);
    };
    if (hi_w - lo_w == 1) return masked(lo_w) != 0u;
    for (int base = lo_w; base < hi_w; base += 32) {
      const int w = base + lane;
      if (__ballot_sync(lp::FULL, w < hi_w && masked(w) != 0u)) return true;
    }
    return false;
  }
  __device__ bool any_lit(int lit, int mode, int start, int end) const {
    return any(start, end, [&](int w) { return search(lit, mode, w); });
  }
  __device__ bool any_plane(int vp, int start, int end) const {
    return any(start, end, [&](int w) { return pl[w * stride + vp]; });
  }
  __device__ int last_plane(int vp, int thresh) const {
    const int top = min(thresh, C * 32) - 1;
    if (top < 0) return -1;
    for (int base = (top >> 5) & ~31; base >= 0; base -= 32) {
      const int w = base + lane;
      const uint32_t x = w < C ? word(vp, w) & cutoff_word(thresh, w) : 0u;
      const unsigned bal = __ballot_sync(lp::FULL, x != 0u);
      if (bal) {
        const int h = 31 - __clz(bal);
        const uint32_t xh = __shfl_sync(lp::FULL, x, h);
        return (base + h) * 32 + (31 - __clz(xh));
      }
    }
    return -1;
  }
  __device__ __forceinline__ bool test(int lit, int p) const {
    if (p < 0 || p >= C * 32) return false;
    return (occ[lit * C + (p >> 5)] >> (p & 31)) & 1u;
  }
};

// The op program and the plausibility pass on one line; emit(tok, start,
// end) takes each token's cursors.  Returns the flag bits.
template <class Scan, class Emit>
__device__ int run_program(const Scan& sc, const int32_t* ops, int n_ops,
                           const int32_t* lits, int litw, int len, int L, Emit emit) {
  int cursor = 0;
  bool valid = true, esc_hit = false;
  for (int oi = 0; oi < n_ops; ++oi) {
    const int32_t* op = ops + oi * OPW;
    const int kind = op[0], lit = op[1], tok = op[2], vp = op[3];
    const int kl = lit >= 0 ? lits[lit * litw] : 0;
    if (kind == 0) {
      valid = valid && sc.test(lit, cursor);
      cursor += kl;
      continue;
    }
    const int start = cursor;
    int end;
    bool ok = valid;
    if (kind == 1) {
      int found;
      if (op[6]) {
        found = sc.first(lit, 1, cursor);
        // An odd-parity occurrence before the even one.
        const bool had_skip = sc.any_lit(lit, 2, cursor, found);
        if (op[6] == 1) esc_hit = esc_hit || had_skip;
        else ok = ok && !had_skip;
      } else {
        found = sc.first(lit, 0, cursor);
      }
      const bool token_valid = found < L;
      end = token_valid ? found : cursor;
      ok = ok && token_valid;
    } else {
      end = len;
    }
    if (ok && vp >= 0 && sc.any_plane(vp, start, end)) ok = false;
    const int width = end - start;
    ok = ok && width >= op[4];
    if (op[5]) ok = ok && width <= op[5];
    valid = ok;
    emit(tok, start, end);
    cursor = end + kl;
  }
  valid = valid && cursor == len;
  // A valid line is plausible: the pass's cursor never passes the op
  // program's, so each of its searches finds the program's separator or an
  // earlier one, and each anchored test holds where the program found it.
  if (valid) return 1 | 2 | (esc_hit ? 4 : 0);

  bool plausible = true;
  int p_cursor = 0;
  for (int oi = 0; oi < n_ops; ++oi) {
    const int32_t* op = ops + oi * OPW;
    const int pflags = op[7];
    if (!(pflags & 1)) continue;
    const int lit = op[1], kl = lits[lit * litw];
    int lower = p_cursor;
    bool has_exact = false;
    int exact = 0;
    if (pflags & 2) has_exact = true;
    if (pflags & 4) {
      const int e2 = len - kl;
      if (!has_exact) exact = e2;
      else if (exact != e2) exact = -1;
      has_exact = true;
    } else if (op[8] >= 0) {
      lower = max(lower, sc.last_plane(op[8], len) - kl + 1);
    }
    int found;
    if (has_exact) {
      found = (sc.test(lit, exact) && exact >= lower) ? exact : L;
    } else {
      found = sc.first(lit, 0, lower);
    }
    plausible = plausible && found < L;
    p_cursor = found + kl;
  }
  return (valid ? 1 : 0) | (plausible ? 2 : 0) | (esc_hit ? 4 : 0);
}

// Warp-wide: stage line `src` (L bytes) into `dst` (16-byte aligned,
// >= L + 15 bytes).  The aligned middle goes by TMA onto `bar`; the head
// and tail (< 16 bytes each) by plain loads, visible after a __syncwarp.
// The line starts at dst + (src & 15).
__device__ __forceinline__ void stage_line(uint8_t* dst, const uint8_t* src, int L,
                                          uint64_t* bar, int lane) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = s + L;
  const uintptr_t base = s & ~uintptr_t{15};
  const uintptr_t up = (s + 15) & ~uintptr_t{15}, down = e & ~uintptr_t{15};
  const uintptr_t a0 = up < e ? up : e;
  const uintptr_t a1 = down > a0 ? down : a0;
  if (lane == 0) {
    lp::proxy_fence();   // our earlier reads of this stage before the async write
    if (a1 > a0) {
      lp::bar_expect_tx(bar, static_cast<int>(a1 - a0));
      lp::bulk_g2s(dst + (a0 - base), reinterpret_cast<const void*>(a0),
                   static_cast<int>(a1 - a0), bar);
    } else {
      lp::bar_arrive(bar);
    }
  }
  if (lane < static_cast<int>(a0 - s)) dst[s - base + lane] = src[lane];
  const int t = lane - 16;
  if (t >= 0 && t < static_cast<int>(e - a1))
    dst[a1 - base + t] = reinterpret_cast<const uint8_t*>(a1)[t];
}

struct Args {
  const uint8_t* buf;
  const int32_t* lengths;
  const uint32_t* cls;
  const int32_t* ops;
  const int32_t* lits;
  int32_t* starts;
  int32_t* ends;
  int32_t* flags;
  int B, L, C, n_ops, litw, n_lits, n_planes, has_esc, n_tok;
  int cb, stride, stage_bytes, ns_log, prog_words, warp_words, group, rec_words;
};

// THREAD: a thread a line over chunks of `group` lines (C <= THREAD_MAX_C);
// else a warp a line.
template <bool THREAD>
__global__ void __launch_bounds__(MAX_WARPS * 32) split_kernel(const Args a) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ uint64_t bars[MAX_WARPS][MAX_STAGES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int B = a.B, L = a.L, C = a.C;

  // The program, once a block; `written` marks the tokens some op sets.
  uint32_t* cls = smem;
  uint32_t* written = smem + 256;
  int32_t* ops = reinterpret_cast<int32_t*>(smem + 258);
  int32_t* lits = ops + a.n_ops * OPW;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls[i] = a.cls[i];
  for (int i = threadIdx.x; i < a.n_ops * OPW; i += blockDim.x) ops[i] = a.ops[i];
  for (int i = threadIdx.x; i < a.n_lits * a.litw; i += blockDim.x) lits[i] = a.lits[i];
  if (threadIdx.x == 0) {
    uint32_t w0 = 0, w1 = 0;
    for (int i = 0; i < a.n_ops; ++i) {
      const int tok = a.ops[i * OPW + 2];
      if (a.ops[i * OPW] != 0) {
        if (tok < 32) w0 |= 1u << tok;
        else w1 |= 1u << (tok - 32);
      }
    }
    written[0] = w0;
    written[1] = w1;
  }

  // This warp's region: a ring of NS line stages, then its planes.
  const int NS = 1 << a.ns_log, SB = a.stage_bytes;
  uint8_t* stage0 = reinterpret_cast<uint8_t*>(smem + a.prog_words + warp * a.warp_words);
  uint32_t* pl = reinterpret_cast<uint32_t*>(stage0 + NS * SB);
  uint64_t* bar = bars[warp];
  if (lane < NS) lp::bar_init(&bar[lane]);
  __syncthreads();

  // The warp's lines: chunks gw, gw + nw, ... of G consecutive lines (the
  // last chunk of the batch may be short).  Its q-th line sits in stage
  // q % NS (NS a power of two), whose barrier then completes its phase of
  // parity (q / NS) & 1.  Before line q is planned the ring is filled up
  // to line q + NS - 1, whose stage line q - 1 freed.  `pf_*` is the next
  // line to stage.
  const int nw = gridDim.x * wpb;
  const int gw = blockIdx.x * wpb + warp;
  const int G = THREAD ? a.group : 1;
  if (static_cast<long long>(gw) * G >= B) return;
  int pf_chunk = gw, pf_i = 0, issued = 0, q = 0;
  const auto fill = [&](int upto) {
    for (; issued < upto; ++issued) {
      const long long bp = static_cast<long long>(pf_chunk) * G + pf_i;
      if (bp >= B) return;
      const int st = issued & (NS - 1);
      stage_line(stage0 + st * SB, a.buf + static_cast<size_t>(bp) * L, L, &bar[st], lane);
      if (++pf_i == G) {
        pf_i = 0;
        pf_chunk += nw;
      }
    }
  };
  for (int chunk = gw;; chunk += nw) {
    const int lo = chunk * G;
    const int n = min(G, B - lo);
    // A thread's line length, loaded while the warp plans the chunk.
    const int len_mine = THREAD && lane < n ? a.lengths[lo + lane] : 0;
    for (int i = 0; i < n;) {
      const int b = lo + i;
      fill(q + NS);
      __syncwarp();   // the head and tail bytes of the lines just staged
      const int len = THREAD ? 0 : a.lengths[b];
      lp::bar_wait(&bar[q & (NS - 1)], (q >> a.ns_log) & 1);
      const uint8_t* line = stage0 + (q & (NS - 1)) * SB +
          (reinterpret_cast<uintptr_t>(a.buf + static_cast<size_t>(b) * L) & 15);
      uint32_t* rec = THREAD ? pl + i * a.rec_words : pl;
      class_planes_any(a.cb, line, L, C, cls, a.n_planes, a.has_esc, rec, a.stride,
                       THREAD ? rec + C * a.stride : nullptr, lane);
      if (!THREAD) {
        __syncwarp();
        // Each literal's occurrence plane, a word a lane.
        uint32_t* occ = pl + C * a.stride;
        for (int l = 0; l < a.n_lits; ++l) {
          const int32_t* row = lits + l * a.litw;
          const int kl = row[0];
          for (int w = lane; w < C; w += 32) {
            uint32_t acc = lp::FULL;
            for (int j = 0; j < kl; ++j) {
              const int plane = row[1 + j];
              const int src = w + (j >> 5), bs = j & 31;
              const uint32_t lo_w = src < C ? pl[src * a.stride + plane] : 0u;
              const uint32_t hi_w = src + 1 < C ? pl[(src + 1) * a.stride + plane] : 0u;
              acc &= bs ? ((lo_w >> bs) | (hi_w << (32 - bs))) : lo_w;
            }
            occ[l * C + w] = acc & cutoff_word(len - (kl - 1), w);
          }
        }
        __syncwarp();
        const WarpScan sc{pl, occ, a.stride, a.n_planes, C, L, lane};
        int s0 = 0, e0 = 0, s1 = 0, e1 = 0;
        const int f = run_program(sc, ops, a.n_ops, lits, a.litw, len, L,
                                  [&](int tok, int start, int end) {
                                    if (lane == (tok & 31)) {
                                      if (tok < 32) { s0 = start; e0 = end; }
                                      else { s1 = start; e1 = end; }
                                    }
                                  });
        if (lane < a.n_tok) {
          a.starts[static_cast<size_t>(lane) * B + b] = s0;
          a.ends[static_cast<size_t>(lane) * B + b] = e0;
        }
        if (lane + 32 < a.n_tok) {
          a.starts[static_cast<size_t>(lane + 32) * B + b] = s1;
          a.ends[static_cast<size_t>(lane + 32) * B + b] = e1;
        }
        if (lane == 0) a.flags[b] = f;
      }
      __syncwarp();   // every lane is done with this stage before it is refilled
      ++i;
      ++q;
    }
    if (THREAD && lane < n) {
      const int b = lo + lane;
      const int len = len_mine;
      const uint32_t* rec = pl + lane * a.rec_words;
      const ThreadScan sc{rec, rec + C * a.stride, lits, a.litw, a.stride, a.n_planes,
                          C, L, len};
      const int f = run_program(sc, ops, a.n_ops, lits, a.litw, len, L,
                                [&](int tok, int start, int end) {
                                  a.starts[static_cast<size_t>(tok) * B + b] = start;
                                  a.ends[static_cast<size_t>(tok) * B + b] = end;
                                });
      for (int t = 0; t < a.n_tok; ++t) {
        if (!((written[t >> 5] >> (t & 31)) & 1u)) {
          a.starts[static_cast<size_t>(t) * B + b] = 0;
          a.ends[static_cast<size_t>(t) * B + b] = 0;
        }
      }
      a.flags[b] = f;
    }
    if (THREAD) __syncwarp();   // the bank is read before the next chunk refills it
    if (static_cast<long long>(chunk + nw) * G >= B) break;
  }
}

lp::GridCache grid_cache[2];   // per kernel: the warp path, the thread path

template <bool THREAD>
int launch(Args a, cudaStream_t stream) {
  // Up to 8 warps a block while a block takes <= 100 KB (two blocks an
  // SM), then fewer; one warp always fits (< 120 KB at L = 8191).
  int warps = MAX_WARPS;
  while (warps > 1 && 4ll * (a.prog_words + warps * a.warp_words) > 100 * 1024) --warps;
  const int smem = 4 * (a.prog_words + warps * a.warp_words);
  const int group = THREAD ? a.group : 1;
  const long long needed = (static_cast<long long>(a.B) + warps * group - 1) / (warps * group);
  int blocks = 0;
  const cudaError_t err = lp::persistent_grid(split_kernel<THREAD>, warps * 32, smem, needed,
                                              grid_cache[THREAD], blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<THREAD><<<blocks, warps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LP_EXPORT int lp_split(const void* buf, const void* lengths, int B, int L,
                       const void* cls, const void* ops, int n_ops,
                       const void* lits, int litw, int n_lits, int n_planes,
                       int has_esc, int n_tok, void* starts, void* ends, void* flags,
                       void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || n_planes < 0 || n_planes > 31 || n_tok > 64 || n_lits < 0 || litw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.buf = static_cast<const uint8_t*>(buf);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.cls = static_cast<const uint32_t*>(cls);
  a.ops = static_cast<const int32_t*>(ops);
  a.lits = static_cast<const int32_t*>(lits);
  a.starts = static_cast<int32_t*>(starts);
  a.ends = static_cast<int32_t*>(ends);
  a.flags = static_cast<int32_t*>(flags);
  a.B = B;
  a.L = L;
  a.C = (L + 31) / 32;
  a.n_ops = n_ops;
  a.litw = litw;
  a.n_lits = n_lits;
  a.n_planes = n_planes;
  a.has_esc = has_esc;
  a.n_tok = n_tok;
  const int n_cls = n_planes + has_esc;
  a.cb = n_cls <= 8 ? 8 : (n_cls <= 16 ? 16 : 32);
  a.stride = n_cls | 1;
  // Shared memory, in 32-bit words: the program, then per warp its ring
  // of line stages (L + 15 bytes each, rounded to 16) and its planes -- a
  // bank of `group` odd-sized records a thread a line, else one line's
  // class and literal planes.
  a.prog_words = (258 + n_ops * OPW + n_lits * litw + 3) & ~3;
  a.stage_bytes = (L + 15 + 15) & ~15;
  a.ns_log = L <= 512 ? 2 : 1;   // 4 or 2 stages, <= MAX_STAGES
  const bool thread = a.C <= THREAD_MAX_C;
  a.rec_words = (a.C * a.stride + n_cls) | 1;
  a.group = 1;
  int plane_words;
  if (thread) {
    a.group = BANK_BYTES / (4 * a.rec_words);
    if (a.group > 32) a.group = 32;
    if (a.group < 1) a.group = 1;
    plane_words = a.group * a.rec_words;
  } else {
    plane_words = a.C * a.stride + n_lits * a.C;
  }
  a.warp_words = ((a.stage_bytes << a.ns_log) >> 2) + ((plane_words + 3) & ~3);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return thread ? launch<true>(a, st) : launch<false>(a, st);
}

LP_EXPORT const char* lp_split_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
