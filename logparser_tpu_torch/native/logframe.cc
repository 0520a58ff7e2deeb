// Host tier of the PyTorch port, in two halves:
// - framing: newline-delimited log bytes -> a padded [B, L] uint8 buffer
//   + int32 lengths, the input of the split kernel
//   (logparser_tpu_torch/tpu/runtime.py encode_batch, and
//   TorchBatchParser.parse_blob through native.encode_blob);
// - delivery: the span gathers, the Arrow string_view builders and the
//   URI-repair passes the Arrow bridge (tpu/arrow_bridge.py) and
//   BatchResult.span_bytes[_many] run over a fetched batch.
//
// The port's own copy of the reference package's native/logframe.cc (the
// persistent thread pool, lp_run, the framing and the span, view and
// repair functions).  Built with g++ (never nvcc: this file lives outside
// csrc/) at first use and bound with ctypes.
//
// Line semantics: lines split on '\n', one trailing '\r' per line is
// stripped (CRLF tolerance), a final unterminated line counts, a final
// empty segment after a trailing newline does not.  Lines longer than L
// are truncated in the buffer and reported through the per-line lengths
// array as (L | LP_OVERFLOW_BIT): the flag routes the row to the host; the
// stored length is the truncated one.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

// Persistent worker pool: a per-call std::thread spawn costs ~50us, so
// the pool is created on the first parallel call and reused by every
// later one.  One job at a time (outer job mutex); chunks are handed out via
// an atomic cursor so uneven rows balance.
namespace {

class Pool {
 public:
  explicit Pool(int n) : nworkers_(n) {
    for (int i = 0; i < n; ++i) workers_.emplace_back([this] { Loop(); });
  }

  void Run(int64_t total, int64_t chunk,
           const std::function<void(int64_t, int64_t)>& body) {
    std::lock_guard<std::mutex> job(job_m_);
    {
      std::lock_guard<std::mutex> lk(m_);
      body_ = &body;
      total_ = total;
      chunk_ = chunk;
      next_.store(0, std::memory_order_relaxed);
      active_.store(nworkers_, std::memory_order_relaxed);
      ++gen_;
      cv_.notify_all();
    }
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&] { return active_.load() == 0; });
  }

 private:
  void Loop() {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int64_t, int64_t)>* body;
      int64_t total, chunk;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        body = body_;
        total = total_;
        chunk = chunk_;
      }
      for (;;) {
        int64_t lo = next_.fetch_add(chunk, std::memory_order_relaxed);
        if (lo >= total) break;
        (*body)(lo, std::min(total, lo + chunk));
      }
      if (active_.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(m_);
        done_cv_.notify_all();
      }
    }
  }

  int nworkers_;
  std::vector<std::thread> workers_;
  std::mutex job_m_, m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int64_t, int64_t)>* body_ = nullptr;
  int64_t total_ = 0, chunk_ = 0;
  std::atomic<int64_t> next_{0};
  std::atomic<int> active_{0};
  uint64_t gen_ = 0;
};

// Runs body over [0, n) in chunks on the pool; small jobs (under 4096
// units of work) or threads <= 1 run inline on the caller.  `weight` is
// the relative cost of one unit (default 1): a caller whose units do K
// times the work (the row-major view builder, K columns a row) passes it,
// so that the inline cutoff and the chunk size follow the work, not the
// unit count.
void lp_run(int64_t n, int32_t threads,
            const std::function<void(int64_t, int64_t)>& body,
            int64_t weight = 1) {
  if (weight < 1) weight = 1;
  if (threads <= 1 || n * weight < 4096) {
    body(0, n);
    return;
  }
  static Pool* pool = nullptr;
  static pid_t pool_pid = 0;
  static std::mutex create_m;
  {
    std::lock_guard<std::mutex> lk(create_m);
    if (pool == nullptr || pool_pid != getpid()) {
      // Size by the hardware, not the first caller's thread count — the
      // pool is process-wide and a small first request must not cap
      // every later call's parallelism.  A fork() child inherits the
      // pointer but none of the worker threads (waiting on it would
      // deadlock) — detect by pid and build a fresh pool; the stale
      // object is deliberately leaked (its threads do not exist here).
      unsigned hw = std::thread::hardware_concurrency();
      int n = std::max<int>(threads, hw ? static_cast<int>(hw) : threads);
      pool = new Pool(n);
      pool_pid = getpid();
    }
  }
  int64_t chunk = std::max<int64_t>(
      std::max<int64_t>(1, 512 / weight), n / (threads * 4));
  pool->Run(n, chunk, body);
}

}  // namespace

extern "C" {

const int32_t LP_OVERFLOW_BIT = 1 << 30;

// Pass 1: count lines and the maximum line length (bucket selection).
void lp_scan(const uint8_t* data, int64_t size,
             int64_t* n_lines, int64_t* max_len) {
  int64_t lines = 0, maxlen = 0, start = 0;
  for (int64_t i = 0; i <= size; ++i) {
    if (i == size || data[i] == '\n') {
      if (i == size && i == start) break;  // no trailing fragment
      int64_t end = i;
      if (end > start && data[end - 1] == '\r') --end;
      ++lines;
      maxlen = std::max(maxlen, end - start);
      start = i + 1;
    }
  }
  *n_lines = lines;
  *max_len = maxlen;
}

// Frame into offsets (line starts) + lens.  Returns the number of lines.
int64_t lp_frame(const uint8_t* data, int64_t size,
                 int64_t* offsets, int32_t* lens, int64_t max_lines) {
  int64_t n = 0, start = 0;
  for (int64_t i = 0; i <= size && n < max_lines; ++i) {
    if (i == size || data[i] == '\n') {
      if (i == size && i == start) break;
      int64_t end = i;
      if (end > start && data[end - 1] == '\r') --end;
      offsets[n] = start;
      lens[n] = static_cast<int32_t>(end - start);
      ++n;
      start = i + 1;
    }
  }
  return n;
}

// Pack framed lines into a padded [n, L] uint8 buffer (zero-filled) +
// lengths with the overflow bit for truncated lines.  Multi-threaded over
// row ranges.
void lp_pack(const uint8_t* data, const int64_t* offsets,
             const int32_t* lens, int64_t n,
             uint8_t* out, int32_t* lengths, int64_t L, int32_t threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t len = lens[r];
      uint8_t* row = out + r * L;
      if (len > L) {
        std::memcpy(row, data + offsets[r], L);
        lengths[r] = static_cast<int32_t>(L) | LP_OVERFLOW_BIT;
      } else {
        std::memcpy(row, data + offsets[r], len);
        std::memset(row + len, 0, L - len);
        lengths[r] = static_cast<int32_t>(len);
      }
    }
  };
  lp_run(n, threads, work);
}

// Span gather: per-row (start, end) windows of a padded [B, L] buffer ->
// one flat byte stream at precomputed destination offsets.  The inverse of
// lp_pack — it materializes device span columns (string fields) for
// non-Arrow consumers without a per-row Python loop.  Rows with
// offsets[r] == offsets[r+1] (invalid/null/empty) copy nothing.
void lp_gather_spans(const uint8_t* buf, int64_t B, int64_t L,
                     const int32_t* starts, const int64_t* offsets,
                     uint8_t* out, int32_t threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t len = offsets[r + 1] - offsets[r];
      if (len <= 0) continue;
      std::memcpy(out + offsets[r], buf + r * L + starts[r], len);
    }
  };
  lp_run(B, threads, work);
}

// Multi-column span gather: K span columns over the SAME [B, L] buffer in
// one threaded fan-out, amortizing the thread-pool spawn across columns
// (the Arrow bridge materializes every string column of a batch at once).
// `starts` is [K*B] laid out column-major (column k's rows begin at k*B);
// `offsets` is [K*B+1] cumulative over that layout, so each column's bytes
// land contiguously in `out` and Python can slice per-column views
// zero-copy.
void lp_gather_spans_multi(const uint8_t* buf, int64_t B, int64_t L,
                           const int32_t* starts, const int64_t* offsets,
                           uint8_t* out, int64_t K, int32_t threads) {
  if (threads < 1) threads = 1;
  int64_t n = K * B;
  if (n == 0) return;  // the row-tracking modulo below needs B > 0
  auto work = [&](int64_t lo, int64_t hi) {
    int64_t r = lo % B;
    int64_t row_base = r * L;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t len = offsets[i + 1] - offsets[i];
      if (len > 0) {
        std::memcpy(out + offsets[i], buf + row_base + starts[i], len);
      }
      if (++r == B) { r = 0; row_base = 0; } else row_base += L;
    }
  };
  lp_run(n, threads, work);
}

// Flat re-layout: per-row copy from arbitrary source offsets in one flat
// byte buffer to contiguous destination offsets.  The Arrow bridge's
// URI-repair splice uses it to rebuild a column after patching rows
// (numpy's fancy-index gather is per-element; this is memcpy-speed).
void lp_copy_spans(const uint8_t* src, const int64_t* src_off,
                   uint8_t* dst, const int64_t* dst_off,
                   int64_t n, int32_t threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t len = dst_off[r + 1] - dst_off[r];
      if (len <= 0) continue;
      std::memcpy(dst + dst_off[r], src + src_off[r], len);
    }
  };
  lp_run(n, threads, work);
}

// Scatter variant of lp_copy_spans: explicit per-row lengths and a
// caller-provided destination, so subsets of rows can be written into a
// shared side buffer at non-contiguous offsets (the view assembler lays
// clean and repaired rows into ONE allocation instead of copy+concat+
// recopy rounds).
void lp_scatter_spans(const uint8_t* src, const int64_t* src_off,
                      const int64_t* lens, uint8_t* dst,
                      const int64_t* dst_off, int64_t n, int32_t threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t len = lens[r];
      if (len <= 0) continue;
      std::memcpy(dst + dst_off[r], src + src_off[r], len);
    }
  };
  lp_run(n, threads, work);
}

// Arrow BinaryView (string_view) materializer: K span columns over the
// same [B, L] buffer -> packed 16-byte Arrow view structs, NO byte
// gather.  Strings of <= 12 bytes are inlined in the view (the Arrow
// spec requires it); longer ones store (length, 4-byte prefix,
// buffer_index=0, offset into the flattened [B*L] buffer), so the Arrow
// column references the batch buffer zero-copy.  starts/lens are [K*B]
// column-major; lens[i] < 0 marks a null row (zeroed view; the validity
// bitmap is the caller's).  Offsets require B*L < 2^31 (caller-guarded).
void lp_build_views(const uint8_t* buf, int64_t B, int64_t L,
                    const int32_t* starts, const int32_t* lens,
                    uint8_t* views, int64_t K, int32_t threads) {
  if (threads < 1) threads = 1;
  int64_t n = K * B;
  if (n == 0) return;  // the row-tracking modulo below needs B > 0
  int64_t size = B * L;
#if !defined(__SSE2__)
  // Inline masks: keep bytes < len of a constant-size 12-byte load
  // (branch-free tail zeroing; the variable-length memcpy + memset pair
  // was the single-core hot spot).  Scalar build only — the SSE2 path
  // has its own 16-byte mask table.
  static uint64_t mask_a[13];
  static uint32_t mask_b[13];
  static bool masks_init = [] {
    for (int l = 0; l <= 12; ++l) {
      int ka = l < 8 ? l : 8;
      int kb = l < 8 ? 0 : l - 8;
      mask_a[l] = ka == 8 ? ~0ULL : ((1ULL << (8 * ka)) - 1);
      mask_b[l] = kb == 4 ? ~0U : ((1U << (8 * kb)) - 1);
    }
    return true;
  }();
  (void)masks_init;
#endif
  // ROW-major traversal (rows outer, columns inner): all K columns of a
  // row resolve while that row's line bytes sit in L1; a column-major
  // loop would re-stream the whole [B, L] buffer once per column.
  // starts/lens reads and view writes become K strided streams (B
  // elements apart), which prefetch fine.
#if defined(__SSE2__)
  // 16-byte masks for the SSE path: bytes 4..3+l set, bytes 0..3 clear
  // (the length lane is OR'd in separately).
  alignas(16) static uint8_t mask16[13][16];
  static bool mask16_init = [] {
    for (int l = 0; l <= 12; ++l)
      for (int b = 0; b < 16; ++b)
        mask16[l][b] = (b >= 4 && b < 4 + l) ? 0xFF : 0;
    return true;
  }();
  (void)mask16_init;
#endif
  auto work = [&](int64_t rlo, int64_t rhi) {
    for (int64_t r = rlo; r < rhi; ++r) {
      int64_t row_base = r * L;
      for (int64_t k = 0; k < K; ++k) {
        int64_t i = k * B + r;
        uint8_t* v = views + i * 16;
        int32_t len = lens[i];
#if defined(__SSE2__)
        if (len < 0) {
          _mm_storeu_si128(reinterpret_cast<__m128i*>(v),
                           _mm_setzero_si128());
          continue;
        }
        int64_t off = row_base + starts[i];
        const uint8_t* src = buf + off;
        if (len <= 12) {
          __m128i out;
          if (off + 16 <= size) {
            // One 16-byte load — reads up to 16-len bytes past the
            // span, which the off+16<=size guard keeps inside the
            // buffer (do NOT relax it to off+len+4) — then shift the
            // 12 inline bytes into place, mask the tail, OR the
            // length lane.
            __m128i data = _mm_loadu_si128(
                reinterpret_cast<const __m128i*>(src));
            out = _mm_slli_si128(data, 4);
            out = _mm_and_si128(out, *reinterpret_cast<const __m128i*>(
                                         mask16[len]));
            out = _mm_or_si128(out, _mm_cvtsi32_si128(len));
          } else {
            alignas(16) uint8_t tmp[16] = {0};
            std::memcpy(&tmp[0], &len, 4);
            std::memcpy(&tmp[4], src, static_cast<size_t>(len));
            out = _mm_load_si128(reinterpret_cast<const __m128i*>(tmp));
          }
          _mm_storeu_si128(reinterpret_cast<__m128i*>(v), out);
        } else {
          int32_t first4;
          std::memcpy(&first4, src, 4);
          _mm_storeu_si128(
              reinterpret_cast<__m128i*>(v),
              _mm_set_epi32(static_cast<int32_t>(off), 0, first4, len));
        }
#else
        if (len < 0) {
          std::memset(v, 0, 16);
          continue;
        }
        int64_t off = row_base + starts[i];
        const uint8_t* src = buf + off;
        std::memcpy(v, &len, 4);
        if (len <= 12) {
          uint64_t a = 0;
          uint32_t b = 0;
          if (off + 12 <= size) {
            std::memcpy(&a, src, 8);
            std::memcpy(&b, src + 8, 4);
            a &= mask_a[len];
            b &= mask_b[len];
          } else {
            uint8_t tmp[12] = {0};
            std::memcpy(tmp, src, static_cast<size_t>(len));
            std::memcpy(&a, tmp, 8);
            std::memcpy(&b, tmp + 8, 4);
          }
          std::memcpy(v + 4, &a, 8);
          std::memcpy(v + 12, &b, 4);
        } else {
          std::memcpy(v + 4, src, 4);
          int32_t bufi = 0;
          int32_t off32 = static_cast<int32_t>(off);
          std::memcpy(v + 8, &bufi, 4);
          std::memcpy(v + 12, &off32, 4);
        }
#endif
      }
    }
  };
  lp_run(B, threads, work, K);
}

// The Arrow string_view element encoding (one place — lp_patch_views and
// lp_special_write both re-point views at side buffers): <= 12 bytes
// inline zero-padded, longer values as (4-byte prefix, buffer_index,
// offset).
static inline void lp_encode_view(uint8_t* v, const uint8_t* src,
                                  int32_t len, int32_t buffer_index,
                                  int64_t off) {
  std::memcpy(v, &len, 4);
  if (len <= 12) {
    std::memset(v + 4, 0, 12);
    std::memcpy(v + 4, src, static_cast<size_t>(len));
  } else {
    std::memcpy(v + 4, src, 4);
    int32_t off32 = static_cast<int32_t>(off);
    std::memcpy(v + 8, &buffer_index, 4);
    std::memcpy(v + 12, &off32, 4);
  }
}

// Re-point selected rows of a [B, 16] Arrow view array at a side buffer
// (repaired / overridden values).  rows/side_off are per patch entry;
// the same inline-vs-reference encoding as lp_build_views.
void lp_patch_views(const uint8_t* side, const int64_t* side_off,
                    const int64_t* rows, int64_t n_rows,
                    int32_t buffer_index, uint8_t* views) {
  for (int64_t j = 0; j < n_rows; ++j) {
    int64_t off = side_off[j];
    lp_encode_view(views + rows[j] * 16, side + off,
                   static_cast<int32_t>(side_off[j + 1] - off),
                   buffer_index, off);
  }
}

// URI-repair scan (the hot classification of the Arrow bridge's
// _repair_fix_segments, ported 1:1 — see that function's docstring for
// the semantics derivation).  mode 0 = decode (path/userinfo): good %XX
// escapes substitute their byte, bad escapes stay literal; mode 1 =
// escape (query): bad '%' expands to "%25", encode-set bytes to their
// uppercase %XX triple.  Rows with any byte >= 0x80 — or, in decode
// mode, a good escape decoding to >= 0x80 — set py_flags[r] (exact
// UTF-8 semantics stay in Python) and get out_lens[r] = 0.
static inline bool lp_is_hex(uint8_t c) {
  return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'f') ||
         (c >= 'A' && c <= 'F');
}
static inline int lp_hex_val(uint8_t c) {
  if (c <= '9') return c - '0';
  if (c >= 'a') return c - 'a' + 10;
  return c - 'A' + 10;
}

void lp_repair_scan(const uint8_t* seg, const int64_t* seg_off, int64_t n,
                    int32_t mode, const uint8_t* enc_table,
                    int64_t* out_lens, uint8_t* py_flags, int32_t threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* s = seg + seg_off[r];
      int64_t len = seg_off[r + 1] - seg_off[r];
      bool py = false;
      int64_t out = len;
      for (int64_t i = 0; i < len; ++i) {
        uint8_t c = s[i];
        if (c >= 0x80) { py = true; break; }
        if (c == '%' && i + 2 < len && lp_is_hex(s[i + 1]) &&
            lp_is_hex(s[i + 2])) {
          if (mode == 0) {
            int dec = (lp_hex_val(s[i + 1]) << 4) | lp_hex_val(s[i + 2]);
            if (dec >= 0x80) { py = true; break; }
            out -= 2;
            i += 2;  // consume the escape
          }
          // escape mode: well-formed escapes copy verbatim
        } else if (mode == 1 && (c == '%' || enc_table[c])) {
          out += 2;  // %25 insertion / %XX expansion
        }
      }
      py_flags[r] = py ? 1 : 0;
      out_lens[r] = py ? 0 : out;
    }
  };
  lp_run(n, threads, work);
}

void lp_repair_write(const uint8_t* seg, const int64_t* seg_off, int64_t n,
                     int32_t mode, const uint8_t* enc_table,
                     const int64_t* out_off, const uint8_t* py_flags,
                     uint8_t* out, int32_t threads) {
  static const char HEX[] = "0123456789ABCDEF";
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      if (py_flags[r]) continue;
      const uint8_t* s = seg + seg_off[r];
      int64_t len = seg_off[r + 1] - seg_off[r];
      uint8_t* d = out + out_off[r];
      for (int64_t i = 0; i < len; ++i) {
        uint8_t c = s[i];
        bool good = c == '%' && i + 2 < len && lp_is_hex(s[i + 1]) &&
                    lp_is_hex(s[i + 2]);
        if (mode == 0) {
          if (good) {
            *d++ = static_cast<uint8_t>(
                (lp_hex_val(s[i + 1]) << 4) | lp_hex_val(s[i + 2]));
            i += 2;
          } else {
            *d++ = c;
          }
        } else {
          if (c == '%' && !good) {
            *d++ = '%'; *d++ = '2'; *d++ = '5';
          } else if (c != '%' && enc_table[c]) {
            *d++ = '%'; *d++ = HEX[c >> 4]; *d++ = HEX[c & 0x0F];
          } else {
            *d++ = c;
          }
        }
      }
    }
  };
  lp_run(n, threads, work);
}

// Device-emitted Arrow views -> host view structs: the executor's
// pack_rows kernel appends, per span field, 4 int32 rows to its packed
// output — a merged span word (start | len<<13 | live<<26) and the span's first 12 bytes
// LE-packed into 3 words (masked beyond len).  This pass interleaves
// them into [F, B, 16] Arrow string_view structs with streaming stores —
// the host never touches the [B, L] byte buffer (lp_build_views reads
// every span's first bytes from it).
void lp_views_interleave(const int32_t* packed, int64_t stride,
                         const int64_t* field_rows, int64_t F,
                         int64_t B, int64_t L,
                         uint8_t* out, int32_t threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t flo, int64_t fhi) {
    for (int64_t f = flo; f < fhi; ++f) {
      const int32_t* m = packed + field_rows[f] * stride;
      const int32_t* p0 = m + stride;
      const int32_t* p1 = p0 + stride;
      const int32_t* p2 = p1 + stride;
      uint8_t* o = out + f * B * 16;
      for (int64_t r = 0; r < B; ++r) {
        int32_t w = m[r];
        int32_t v0 = 0, v1 = 0, v2 = 0, v3 = 0;
        if (w >> 26) {
          int32_t len = (w >> 13) & 0x1FFF;
          v0 = len;
          v1 = p0[r];
          if (len <= 12) {
            v2 = p1[r];
            v3 = p2[r];
          } else {
            v2 = 0;  // buffer index: the batch buffer
            v3 = static_cast<int32_t>(r * L) + (w & 0x1FFF);
          }
        }
#if defined(__SSE2__)
        // All stores share out's alignment (offsets are 16-multiples);
        // numpy buffers are 16-aligned in practice, but stay safe.
        __m128i v = _mm_set_epi32(v3, v2, v1, v0);
        __m128i* dst = reinterpret_cast<__m128i*>(o + r * 16);
        if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
          _mm_stream_si128(dst, v);  // write-only output: skip the RFO
        } else {
          _mm_storeu_si128(dst, v);
        }
#else
        int32_t* vi = reinterpret_cast<int32_t*>(o + r * 16);
        vi[0] = v0; vi[1] = v1; vi[2] = v2; vi[3] = v3;
#endif
      }
    }
  };
  // weight=B: F is a handful of fields, each B rows of work — without it
  // the small-n cutoff would pin the pass to one thread on any host.
  lp_run(F, threads, work, B);
#if defined(__SSE2__)
  _mm_sfence();
#endif
}

// Fused special-row assembler for the Arrow view materializer: URI-repair
// (`fix`) and ?->& (`amp`) rows in ONE scan+write pair straight from the
// [B, L] batch buffer into the side buffer + patched view structs.
// NOTE: the per-byte repair classification below is a TWIN of
// lp_repair_scan/lp_repair_write (different source addressing + the i==0
// amp substitution).  Any semantics change must be applied to BOTH pairs
// and to arrow_bridge._repair_fix_segments — the port's native tests hold
// the passes to each other and to the reference's.  It replaces the
// Python flow gather segments -> repair -> scatter clean + repaired ->
// patch views, whose numpy indexing and per-call dispatch outweigh the
// byte work.  Per special row j at rows[j]:
//   - amp_flags[j]: the span's first byte reads '&' (query normalization)
//     before any repair sees it;
//   - fix_flags[j]: lp_repair_scan/write semantics apply (mode/enc_table);
//     rows needing exact Python UTF-8 semantics set py_flags[j] and write
//     nothing (out_lens[j] = 0; the caller patches them from its own side
//     buffer);
//   - otherwise the span bytes copy verbatim.
// lp_special_write also patches views[rows[j]] with the
// inline-vs-reference encoding (buffer_index for long values).
void lp_special_scan(const uint8_t* buf, int64_t L, const int32_t* starts,
                     const int64_t* rows, const int64_t* span_lens,
                     const uint8_t* fix_flags, const uint8_t* amp_flags,
                     int64_t n, int32_t mode, const uint8_t* enc_table,
                     int64_t* out_lens, uint8_t* py_flags, int32_t threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
#if defined(__GNUC__)
      // The span reads jump row-to-row through the [B, L] buffer —
      // without prefetch each fix row pays a cold DRAM miss (the pass
      // runs right after a fetch; nothing else streams the buffer).
      if (j + 8 < hi) {
        __builtin_prefetch(buf + rows[j + 8] * L + starts[rows[j + 8]]);
      }
#endif
      int64_t len = span_lens[j];
      if (!fix_flags[j]) {
        py_flags[j] = 0;
        out_lens[j] = len;
        continue;
      }
      const uint8_t* s = buf + rows[j] * L + starts[rows[j]];
      bool amp = amp_flags[j] != 0;
      bool py = false;
      int64_t out = len;
      for (int64_t i = 0; i < len; ++i) {
        uint8_t c = (i == 0 && amp) ? static_cast<uint8_t>('&') : s[i];
        if (c >= 0x80) { py = true; break; }
        if (c == '%' && i + 2 < len && lp_is_hex(s[i + 1]) &&
            lp_is_hex(s[i + 2])) {
          if (mode == 0) {
            int dec = (lp_hex_val(s[i + 1]) << 4) | lp_hex_val(s[i + 2]);
            if (dec >= 0x80) { py = true; break; }
            out -= 2;
            i += 2;
          }
        } else if (mode == 1 && (c == '%' || enc_table[c])) {
          out += 2;
        }
      }
      py_flags[j] = py ? 1 : 0;
      out_lens[j] = py ? 0 : out;
    }
  };
  lp_run(n, threads, work);
}

void lp_special_write(const uint8_t* buf, int64_t L, const int32_t* starts,
                      const int64_t* rows, const int64_t* span_lens,
                      const uint8_t* fix_flags, const uint8_t* amp_flags,
                      int64_t n, int32_t mode, const uint8_t* enc_table,
                      const int64_t* side_off, const uint8_t* py_flags,
                      uint8_t* side, uint8_t* views, int32_t buffer_index,
                      int32_t threads) {
  static const char HEX[] = "0123456789ABCDEF";
  if (threads < 1) threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
#if defined(__GNUC__)
      if (j + 8 < hi) {
        const uint8_t* p = buf + rows[j + 8] * L + starts[rows[j + 8]];
        __builtin_prefetch(p);
        __builtin_prefetch(p + 64);
      }
#endif
      if (py_flags[j]) continue;  // caller patches these rows itself
      const uint8_t* s = buf + rows[j] * L + starts[rows[j]];
      int64_t len = span_lens[j];
      int64_t off = side_off[j];
      uint8_t* d = side + off;
      bool amp = amp_flags[j] != 0;
      if (!fix_flags[j]) {
        if (len > 0) {
          std::memcpy(d, s, static_cast<size_t>(len));
          if (amp) d[0] = '&';
        }
      } else {
        for (int64_t i = 0; i < len; ++i) {
          uint8_t c = (i == 0 && amp) ? static_cast<uint8_t>('&') : s[i];
          bool good = c == '%' && i + 2 < len && lp_is_hex(s[i + 1]) &&
                      lp_is_hex(s[i + 2]);
          if (mode == 0) {
            if (good) {
              *d++ = static_cast<uint8_t>(
                  (lp_hex_val(s[i + 1]) << 4) | lp_hex_val(s[i + 2]));
              i += 2;
            } else {
              *d++ = c;
            }
          } else {
            if (c == '%' && !good) {
              *d++ = '%'; *d++ = '2'; *d++ = '5';
            } else if (c != '%' && enc_table[c]) {
              *d++ = '%'; *d++ = HEX[c >> 4]; *d++ = HEX[c & 0x0F];
            } else {
              *d++ = c;
            }
          }
        }
      }
      lp_encode_view(views + rows[j] * 16, side + off,
                     static_cast<int32_t>(side_off[j + 1] - off),
                     buffer_index, off);
    }
  };
  lp_run(n, threads, work);
}

// One-shot convenience: frame + pack a whole blob.  Returns line count.
int64_t lp_frame_pack(const uint8_t* data, int64_t size,
                      uint8_t* out, int32_t* lengths,
                      int64_t max_lines, int64_t L, int32_t threads) {
  std::vector<int64_t> offsets(max_lines);
  std::vector<int32_t> lens(max_lines);
  int64_t n = lp_frame(data, size, offsets.data(), lens.data(), max_lines);
  lp_pack(data, offsets.data(), lens.data(), n, out, lengths, L, threads);
  return n;
}

}  // extern "C"
