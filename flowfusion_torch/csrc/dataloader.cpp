// Native data pipeline: mmap-backed shuffled minibatch prefetcher for
// flowfusion_torch.
//
// Host C++ (not a kernel), built with the host compiler at first use by
// kernels/_build.py::build_host into build/flowfusion_torch/.  For large
// tabular datasets (million-row conditional training files):
//
//   * the dataset is a row-major float32 binary file (n_rows x n_cols),
//     memory-mapped read-only — zero copy until batch assembly;
//   * a background thread draws shuffled row indices (xorshift128+ PRNG,
//     Fisher-Yates over an epoch permutation) and gathers minibatches
//     into a bounded ring of reusable host buffers;
//   * the Python side (utils/native_loader.py) pops batches via ctypes as
//     numpy arrays, which the caller turns into torch tensors and moves to
//     the card — host gather overlaps with device compute.
//
// Everything below this header is the JAX package's loader, byte for
// byte, so both packages draw the same batches from the same file and
// seed.
//
// C API (extern "C", stable): ffdl_open / ffdl_next / ffdl_close /
// ffdl_n_rows / ffdl_n_cols / ffdl_last_error.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct XorShift128Plus {
  uint64_t s0, s1;
  explicit XorShift128Plus(uint64_t seed) {
    // splitmix64 expansion of the seed
    auto next = [&seed]() {
      seed += 0x9E3779B97f4A7C15ull;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
  }
  uint64_t operator()() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // multiply-shift bounded draw (bias ~n/2^64 — immaterial at any
  // realistic row count; add Lemire rejection if that ever changes)
  uint64_t bounded(uint64_t n) {
    __uint128_t m = (__uint128_t)(*this)() * (__uint128_t)n;
    return (uint64_t)(m >> 64);
  }
};

struct Loader {
  int fd = -1;
  const float* data = nullptr;  // mmap base
  size_t map_bytes = 0;
  int64_t n_rows = 0;
  int64_t n_cols = 0;
  int64_t batch = 0;
  bool drop_remainder = true;

  std::vector<int64_t> perm;
  size_t perm_pos = 0;
  XorShift128Plus rng{0x1234};

  // ring of ready batches
  std::deque<std::vector<float>> ready;
  std::vector<std::vector<float>> free_bufs;
  size_t depth = 4;

  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::thread worker;
  std::atomic<bool> stop{false};

  ~Loader() { shutdown(); }

  void shutdown() {
    {
      // mutate the wait condition UNDER the mutex: storing + notifying
      // unlocked can race a waiter between its predicate check and its
      // atomic release-and-block (lost wakeup -> join() hangs forever)
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    if (worker.joinable()) worker.join();
    if (data) munmap(const_cast<float*>(data), map_bytes);
    if (fd >= 0) close(fd);
    data = nullptr;
    fd = -1;
  }

  void reshuffle() {
    if (perm.empty()) {
      perm.resize(n_rows);
      for (int64_t i = 0; i < n_rows; ++i) perm[i] = i;
    }
    for (int64_t i = n_rows - 1; i > 0; --i) {
      int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
      std::swap(perm[i], perm[j]);
    }
    perm_pos = 0;
  }

  void fill_batch(std::vector<float>& out) {
    out.resize((size_t)batch * n_cols);
    // batches never span epochs: the epoch remainder is dropped, matching
    // the numpy fallback and the reference DataLoader's per-epoch batching
    // (a spanning batch could contain the same row twice).  batch > n_rows
    // degenerates to sampling with reshuffle-on-exhaustion.
    if (batch <= n_rows && (int64_t)((size_t)n_rows - perm_pos) < batch) {
      reshuffle();
    }
    for (int64_t r = 0; r < batch; ++r) {
      if (perm_pos >= (size_t)n_rows) reshuffle();
      const int64_t row = perm[perm_pos++];
      std::memcpy(out.data() + (size_t)r * n_cols,
                  data + (size_t)row * n_cols,
                  sizeof(float) * (size_t)n_cols);
    }
  }

  void run() {
    while (!stop.load()) {
      std::vector<float> buf;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_bufs.empty(); });
        if (stop.load()) return;
        buf = std::move(free_bufs.back());
        free_bufs.pop_back();
      }
      fill_batch(buf);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(std::move(buf));
      }
      cv_ready.notify_one();
    }
  }
};

thread_local std::string g_error;

void set_error(const std::string& e) { g_error = e; }

}  // namespace

extern "C" {

// Open a loader over a row-major float32 file.  Returns an opaque handle
// or nullptr (see ffdl_last_error).
void* ffdl_open(const char* path, int64_t n_cols, int64_t batch,
                int64_t prefetch_depth, uint64_t seed) {
  if (n_cols <= 0 || batch <= 0) {
    set_error("n_cols and batch must be positive");
    return nullptr;
  }
  auto* L = new Loader();
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) {
    set_error(std::string("cannot open ") + path);
    delete L;
    return nullptr;
  }
  struct stat st;
  if (fstat(L->fd, &st) != 0) {
    set_error("fstat failed");
    delete L;
    return nullptr;
  }
  if (st.st_size <= 0 ||
      st.st_size % (n_cols * (int64_t)sizeof(float)) != 0) {
    set_error("file size is not a positive multiple of n_cols * 4");
    delete L;
    return nullptr;
  }
  L->map_bytes = (size_t)st.st_size;
  void* m = mmap(nullptr, L->map_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (m == MAP_FAILED) {
    set_error("mmap failed");
    delete L;
    return nullptr;
  }
  madvise(m, L->map_bytes, MADV_WILLNEED);
  L->data = static_cast<const float*>(m);
  L->n_cols = n_cols;
  L->n_rows = (int64_t)(st.st_size / (n_cols * sizeof(float)));
  L->batch = batch;
  L->depth = (size_t)(prefetch_depth > 0 ? prefetch_depth : 4);
  L->rng = XorShift128Plus(seed);
  L->reshuffle();
  for (size_t i = 0; i < L->depth; ++i)
    L->free_bufs.emplace_back((size_t)batch * n_cols);
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Copy the next shuffled batch into out (batch * n_cols floats).
// Returns 0 on success, -1 on error/shutdown.
int ffdl_next(void* handle, float* out) {
  if (handle == nullptr) return -1;
  auto* L = static_cast<Loader*>(handle);
  std::vector<float> buf;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return L->stop.load() || !L->ready.empty(); });
    if (L->stop.load()) return -1;
    buf = std::move(L->ready.front());
    L->ready.pop_front();
  }
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_bufs.push_back(std::move(buf));
  }
  L->cv_free.notify_one();
  return 0;
}

int64_t ffdl_n_rows(void* handle) {
  return handle ? static_cast<Loader*>(handle)->n_rows : 0;
}

int64_t ffdl_n_cols(void* handle) {
  return handle ? static_cast<Loader*>(handle)->n_cols : 0;
}

// NB single-consumer contract: ffdl_close must not race a concurrent
// ffdl_next on another thread (the Loader is freed here; a blocked
// consumer would wake on destroyed synchronization primitives).  The
// Python bridge serializes close()/next() on one object.
void ffdl_close(void* handle) {
  if (handle == nullptr) return;
  auto* L = static_cast<Loader*>(handle);
  L->shutdown();
  delete L;
}

const char* ffdl_last_error() { return g_error.c_str(); }

}  // extern "C"
