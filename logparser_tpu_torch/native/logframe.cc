// Host framing of the PyTorch port: newline-delimited log bytes -> a
// padded [B, L] uint8 buffer + int32 lengths, the input of the split
// kernel (logparser_tpu_torch/tpu/runtime.py encode_batch, and
// TorchBatchParser.parse_blob through native.encode_blob).
//
// The port's own copy of the framing part of the reference package's
// native/logframe.cc: the persistent thread pool and lp_run, lp_scan,
// lp_frame, lp_pack and lp_frame_pack, unchanged.  Built with g++ (never
// nvcc: this file lives outside csrc/) at first use and bound with ctypes.
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
// rows) or threads <= 1 run inline on the caller.
void lp_run(int64_t n, int32_t threads,
            const std::function<void(int64_t, int64_t)>& body) {
  if (threads <= 1 || n < 4096) {
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
  int64_t chunk = std::max<int64_t>(512, n / (threads * 4));
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
