// Host-side native runtime: worker pool + table generators.
//
// The reference's runtime layer is native C++ (thread pool:
// src/Common/ThreadPool.cpp, generators: src/DataGenerator/*.cpp, RNG:
// src/Common/Random.cpp).  The engine's compute path is JAX/XLA, but the
// host side keeps a native runtime for data ingest: this library generates
// relations in parallel on the host (feeding device transfer or file ingest)
// and doubles as an independent oracle for the device-side Zipf sampler.
//
// Fresh implementation (no code taken from the reference): the thread pool
// is a plain fixed-worker batch executor; the RNG is the textbook
// Park–Miller minimal standard generator with Schrage's factorization (the
// same published algorithm the reference credits via genzipf.c,
// src/Common/Random.hpp:22-24); the Zipf sampler is the standard
// inverse-CDF-proposal rejection method (Zipf.cpp:14-56 implements the same
// published scheme), with the alpha≈1 clamp and closed-range correction
// described in SURVEY.md §2 row 13.
//
// C ABI only — consumed from Python via ctypes (data/host_loader.py).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Worker pool: fixed threads, FIFO queue, batch-completion counting.
// Mirrors the *role* of Common::ThreadPool (Worker/WorkPipe/WorkManager)
// with a minimal design: submit a vector of tasks, wait for all.
// ---------------------------------------------------------------------------
class WorkerPool {
 public:
  explicit WorkerPool(int workers) {
    if (workers <= 0) workers = 1;
    for (int i = 0; i < workers; ++i) {
      threads_.emplace_back([this] { Run(); });
    }
  }

  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void RunBatch(std::vector<std::function<void()>> tasks) {
    std::atomic<size_t> remaining{tasks.size()};
    std::mutex done_mu;
    std::condition_variable done_cv;
    {
      std::lock_guard<std::mutex> lock(mu_);
      for (auto& task : tasks) {
        queue_.push([&remaining, &done_mu, &done_cv, task = std::move(task)] {
          task();
          if (remaining.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> lock(done_mu);
            done_cv.notify_all();
          }
        });
      }
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> lock(done_mu);
    done_cv.wait(lock, [&remaining] { return remaining.load() == 0; });
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_.wait(lock, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        task = std::move(queue_.front());
        queue_.pop();
      }
      task();
    }
  }

  std::vector<std::thread> threads_;
  std::queue<std::function<void()>> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

// ---------------------------------------------------------------------------
// Park–Miller minimal standard RNG (a=16807, m=2^31-1) with Schrage's
// factorization — the same published generator the reference uses
// (src/Common/Random.cpp:9-30 credits genzipf.c).  Returns doubles in (0,1).
// ---------------------------------------------------------------------------
class MinStdRng {
 public:
  explicit MinStdRng(uint64_t seed) {
    state_ = static_cast<int64_t>(seed % 0x7FFFFFFEULL) + 1;  // in [1, m-1]
  }

  double Next() {
    constexpr int64_t a = 16807;
    constexpr int64_t m = 2147483647;  // 2^31 - 1
    constexpr int64_t q = m / a;       // 127773
    constexpr int64_t r = m % a;       // 2836
    int64_t hi = state_ / q;
    int64_t lo = state_ % q;
    int64_t t = a * lo - r * hi;
    state_ = (t > 0) ? t : t + m;
    return static_cast<double>(state_) / static_cast<double>(m);
  }

 private:
  int64_t state_;
};

// Zipf(alpha) sample over [1, cardinality] via rejection from the
// inverse-CDF of the continuous proposal (standard method; the clamp keeps
// the normalization finite near alpha == 1).
struct ZipfParams {
  double alpha;
  double skew_diff;
  double norm;
};

ZipfParams MakeZipfParams(double alpha, int64_t cardinality) {
  constexpr double kErr = 0.01;
  double diff = 1.0 - alpha;
  double skew_diff = 1.001 - alpha;
  if (std::fabs(diff) < kErr) {
    skew_diff = (diff < 0) ? kErr : -kErr;
    alpha = 1.0 - skew_diff;
  }
  double norm =
      (std::pow(static_cast<double>(cardinality), skew_diff) - alpha) /
      skew_diff;
  return {alpha, skew_diff, norm};
}

int64_t ZipfSample(const ZipfParams& p, int64_t cardinality, MinStdRng& rng) {
  for (;;) {
    double u1 = rng.Next();
    double un = u1 * p.norm;
    double icdf;
    if (un <= 1.0) {
      icdf = un;
    } else {
      icdf = std::pow(un * p.skew_diff + p.alpha, 1.0 / p.skew_diff);
    }
    double sample = std::floor(icdf + 1.0);
    if (sample < 1.0) sample = 1.0;
    double max = static_cast<double>(cardinality);
    if (sample > max) sample = max;
    double density_orig = std::pow(sample, -p.alpha);
    double density_prop =
        (sample <= 1.0 ? 1.0 : std::pow(icdf, -p.alpha)) / p.norm;
    double ratio = density_orig / (density_prop * p.norm);
    if (rng.Next() < ratio) {
      return static_cast<int64_t>(sample);
    }
  }
}

}  // namespace

extern "C" {

// Fill keys[i] = start + i, payloads[i] = i (the reference's sequential
// generator semantics, src/DataGenerator/Sequential.cpp:20-25), in parallel
// batches.
void phj_generate_sequential(int64_t start, int32_t* keys, int32_t* payloads,
                             int64_t n, int32_t workers) {
  WorkerPool pool(workers);
  int64_t batch = (n + workers - 1) / workers;
  if (batch < 1) batch = 1;
  std::vector<std::function<void()>> tasks;
  for (int64_t lo = 0; lo < n; lo += batch) {
    int64_t hi = std::min(n, lo + batch);
    tasks.push_back([=] {
      for (int64_t i = lo; i < hi; ++i) {
        keys[i] = static_cast<int32_t>(start + i);
        payloads[i] = static_cast<int32_t>(i);
      }
    });
  }
  pool.RunBatch(std::move(tasks));
}

// Fill keys with Zipf(alpha) ids over the closed range [lo_key, hi_key]
// (cardinality = hi-lo+1, correction lo-1 — Zipf.cpp:81-83 semantics),
// payloads[i] = i.  One independently seeded RNG per worker (Zipf.cpp:86).
void phj_generate_zipf(double alpha, int64_t lo_key, int64_t hi_key,
                       uint64_t seed, int32_t* keys, int32_t* payloads,
                       int64_t n, int32_t workers) {
  WorkerPool pool(workers);
  int64_t cardinality = hi_key - lo_key + 1;
  int64_t correction = lo_key - 1;
  ZipfParams params = MakeZipfParams(alpha, cardinality);
  int64_t batch = (n + workers - 1) / workers;
  if (batch < 1) batch = 1;
  std::vector<std::function<void()>> tasks;
  int worker_idx = 0;
  for (int64_t lo = 0; lo < n; lo += batch, ++worker_idx) {
    int64_t hi = std::min(n, lo + batch);
    uint64_t wseed = seed * 0x9E3779B97F4A7C15ULL + worker_idx + 1;
    tasks.push_back([=] {
      MinStdRng rng(wseed);
      for (int64_t i = lo; i < hi; ++i) {
        keys[i] =
            static_cast<int32_t>(ZipfSample(params, cardinality, rng) +
                                 correction);
        payloads[i] = static_cast<int32_t>(i);
      }
    });
  }
  pool.RunBatch(std::move(tasks));
}

// Build Vose alias tables for Zipf(alpha) over [1, cardinality]: after this,
// sampling is exact with two table lookups (bin = floor(u1*n); emit bin+1 if
// u2 < prob[bin] else alias[bin]+1).  O(n) construction; used to move Zipf
// generation onto the device with an 8-bytes-per-key table instead of
// transferring whole relations.
void phj_build_zipf_alias(double alpha, int64_t cardinality, float* prob,
                          int32_t* alias) {
  // normalized pmf, scaled by n (Vose's algorithm works on n*p_i)
  std::vector<double> scaled(cardinality);
  double z = 0.0;
  for (int64_t k = 1; k <= cardinality; ++k) {
    scaled[k - 1] = std::pow(static_cast<double>(k), -alpha);
    z += scaled[k - 1];
  }
  double n_over_z = static_cast<double>(cardinality) / z;
  std::vector<int32_t> small, large;
  small.reserve(cardinality);
  large.reserve(cardinality);
  for (int64_t i = 0; i < cardinality; ++i) {
    scaled[i] *= n_over_z;
    (scaled[i] < 1.0 ? small : large).push_back(static_cast<int32_t>(i));
  }
  while (!small.empty() && !large.empty()) {
    int32_t s = small.back(); small.pop_back();
    int32_t l = large.back(); large.pop_back();
    prob[s] = static_cast<float>(scaled[s]);
    alias[s] = l;
    scaled[l] = (scaled[l] + scaled[s]) - 1.0;
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  for (int32_t s : small) { prob[s] = 1.0f; alias[s] = s; }
  for (int32_t l : large) { prob[l] = 1.0f; alias[l] = l; }
}

// Host-side exact match count (Get-semantics: one count per probe row whose
// key exists in the build relation).  Single-threaded hash-set oracle used
// by tests to validate device joins at sizes where numpy gets slow.
int64_t phj_host_join_count(const int32_t* build_keys, int64_t n_build,
                            const int32_t* probe_keys, int64_t n_probe,
                            int32_t workers) {
  // open-addressing set, pow2 size >= 2*n_build
  uint64_t size = 16;
  while (size < static_cast<uint64_t>(n_build) * 2) size <<= 1;
  uint64_t mask = size - 1;
  std::vector<int32_t> slots(size, INT32_MIN);
  std::vector<uint8_t> used(size, 0);
  auto hash = [](uint32_t x) {
    x ^= x >> 16; x *= 0x85EBCA6Bu; x ^= x >> 13; x *= 0xC2B2AE35u;
    x ^= x >> 16; return x;
  };
  for (int64_t i = 0; i < n_build; ++i) {
    uint64_t h = hash(static_cast<uint32_t>(build_keys[i])) & mask;
    while (used[h] && slots[h] != build_keys[i]) h = (h + 1) & mask;
    slots[h] = build_keys[i];
    used[h] = 1;
  }
  WorkerPool pool(workers);
  std::atomic<int64_t> total{0};
  int64_t batch = (n_probe + workers - 1) / workers;
  if (batch < 1) batch = 1;
  std::vector<std::function<void()>> tasks;
  for (int64_t lo = 0; lo < n_probe; lo += batch) {
    int64_t hi = std::min(n_probe, lo + batch);
    tasks.push_back([&, lo, hi] {
      int64_t local = 0;
      for (int64_t i = lo; i < hi; ++i) {
        uint64_t h = hash(static_cast<uint32_t>(probe_keys[i])) & mask;
        while (used[h]) {
          if (slots[h] == probe_keys[i]) { ++local; break; }
          h = (h + 1) & mask;
        }
      }
      total.fetch_add(local);
    });
  }
  pool.RunBatch(std::move(tasks));
  return total.load();
}

}  // extern "C"
