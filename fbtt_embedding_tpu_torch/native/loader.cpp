// Native host-side batch loader and index preprocessor of
// fbtt_embedding_tpu_torch: the port's own copy of the JAX package's
// native/loader.cpp, the same arithmetic and the same random streams, so a
// seed gives bitwise the batches the JAX package's library gives.
//
// The reference preprocesses indices on the GPU inside its extension
// (compute_rowidx / preprocess_indices_sync, tt_embeddings_cuda.cu:
// 1338-1496) and synthesises batches in Python (tt_embeddings_benchmark.py:
// 37-91). What stays on the host here (sparse-batch synthesis, mixed-radix
// index decomposition, CSR expansion and the CSR -> fixed-pooling
// re-layout of the multi-GPU steps) has to keep up with sub-millisecond
// device steps, which numpy cannot: a multithreaded C++ library behind a
// plain C interface, loaded with ctypes.
//
// Built with g++ at first use into build/ (fbtt_embedding_tpu_torch/native/
// __init__.py); there is no numpy fallback.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <random>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Rejection-inversion Zipf sampler (Hörmann & Derflinger), matching the
// distribution of numpy.random.zipf: support {1, 2, ...}, pmf ~ k^-a.
class ZipfSampler {
 public:
  ZipfSampler(double a, int64_t max_v)
      : a_(a), max_v_(static_cast<double>(max_v)) {
    hx0_ = h(0.5) - 1.0;
    hxm_ = h(max_v_ + 0.5);
    s_ = 2.0 - hinv(h(1.5) - std::pow(2.0, -a_));
  }

  template <class Rng>
  int64_t operator()(Rng& rng, std::uniform_real_distribution<double>& unif) {
    for (;;) {
      double u = hxm_ + unif(rng) * (hx0_ - hxm_);
      double x = hinv(u);
      double k = std::floor(x + 0.5);
      if (k - x <= s_) return static_cast<int64_t>(k);
      if (u >= h(k + 0.5) - std::pow(k, -a_)) return static_cast<int64_t>(k);
    }
  }

 private:
  double h(double x) const {
    return std::pow(x, 1.0 - a_) / (1.0 - a_);
  }
  double hinv(double x) const {
    return std::pow((1.0 - a_) * x, 1.0 / (1.0 - a_));
  }
  double a_, max_v_, hx0_, hxm_, s_;
};

void parallel_for(int64_t n, int threads,
                  const std::function<void(int64_t, int64_t, int)>& fn) {
  if (threads <= 1 || n < (1 << 12)) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&fn, lo, hi, t] { fn(lo, hi, t); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Generate a table-batched sparse-feature batch: indices [T*B*L] int32 in
// [0, E), offsets [T*B+1] int32 (include_last_offset semantics), optional
// weights [T*B*L] float in [0, 1). alpha <= 1 -> uniform; alpha > 1 ->
// Zipf (mod E). Multithreaded; deterministic for a given seed and thread
// count (hardware_threads()).
void fbtt_generate_batch(uint64_t seed, int64_t num_embeddings, int32_t t,
                         int32_t b, int32_t l, double alpha,
                         int32_t gen_weights, int32_t* indices_out,
                         int32_t* offsets_out, float* weights_out) {
  const int64_t nnz = static_cast<int64_t>(t) * b * l;
  const int threads = hardware_threads();
  const int64_t kChunk = 1 << 14;

  parallel_for(nnz, threads, [&](int64_t lo, int64_t hi, int) {
    // one stream per 2^14-entry chunk, restarted at each thread's range
    // start (the JAX package's streams, so the batch depends on the thread
    // count as the JAX package's does). The next piece starts where this
    // one ended: the JAX package's loader steps c0 by kChunk from a range
    // start inside a chunk and leaves the rest of the range unwritten.
    for (int64_t c0 = lo, c1; c0 < hi; c0 = c1) {
      c1 = std::min(hi, ((c0 / kChunk) + 1) * kChunk);
      std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (c0 / kChunk));
      std::uniform_real_distribution<double> unif(0.0, 1.0);
      if (alpha <= 1.0) {
        for (int64_t i = c0; i < c1; ++i) {
          indices_out[i] = static_cast<int32_t>(
              static_cast<int64_t>(unif(rng) * num_embeddings) %
              num_embeddings);
        }
      } else {
        ZipfSampler zipf(alpha, int64_t{1} << 40);
        for (int64_t i = c0; i < c1; ++i) {
          indices_out[i] =
              static_cast<int32_t>(zipf(rng, unif) % num_embeddings);
        }
      }
      if (gen_weights) {
        for (int64_t i = c0; i < c1; ++i) {
          weights_out[i] = static_cast<float>(unif(rng));
        }
      }
    }
  });

  const int64_t bags = static_cast<int64_t>(t) * b;
  for (int64_t i = 0; i <= bags; ++i) {
    offsets_out[i] = static_cast<int32_t>(i * l);
  }
}

// Mixed-radix decomposition: idx_t = (indices / L[t]) % p_t for each core
// (reference div/mod chains, tt_embeddings_cuda.cu:795-799). out is
// [ndim, nnz] row-major. Multithreaded over nnz.
void fbtt_decompose_indices(const int32_t* indices, int64_t nnz,
                            const int32_t* p_shapes, int32_t ndim,
                            int32_t* out) {
  std::vector<int64_t> strides(ndim, 1);
  for (int t = ndim - 2; t >= 0; --t) {
    strides[t] = strides[t + 1] * p_shapes[t + 1];
  }
  parallel_for(nnz, hardware_threads(), [&](int64_t lo, int64_t hi, int) {
    for (int t = 0; t < ndim; ++t) {
      const int64_t stride = strides[t];
      const int32_t p = p_shapes[t];
      int32_t* row = out + static_cast<int64_t>(t) * nnz;
      for (int64_t i = lo; i < hi; ++i) {
        row[i] = static_cast<int32_t>((indices[i] / stride) % p);
      }
    }
  });
}

// 64-bit row-id variant of the decomposition (reference casts indices to
// int64, tt_embeddings_ops.py:823): supports num_embeddings >= 2^31; the
// per-core outputs still fit int32 because each p_t < 2^31.
void fbtt_decompose_indices64(const int64_t* indices, int64_t nnz,
                              const int32_t* p_shapes, int32_t ndim,
                              int32_t* out) {
  std::vector<int64_t> strides(ndim, 1);
  for (int t = ndim - 2; t >= 0; --t) {
    strides[t] = strides[t + 1] * p_shapes[t + 1];
  }
  parallel_for(nnz, hardware_threads(), [&](int64_t lo, int64_t hi, int) {
    for (int t = 0; t < ndim; ++t) {
      const int64_t stride = strides[t];
      const int64_t p = p_shapes[t];
      int32_t* row = out + static_cast<int64_t>(t) * nnz;
      for (int64_t i = lo; i < hi; ++i) {
        row[i] = static_cast<int32_t>((indices[i] / stride) % p);
      }
    }
  });
}

// CSR offsets -> per-lookup (rowidx, tableidx) expansion (reference
// compute_rowidx_kernel, tt_embeddings_cuda.cu:1338-1354). offsets has
// t*b+1 entries; out arrays are [nnz].
void fbtt_expand_offsets(const int32_t* offsets, int32_t t, int32_t b,
                         int32_t* rowidx_out, int32_t* tableidx_out) {
  const int64_t bags = static_cast<int64_t>(t) * b;
  parallel_for(bags, hardware_threads(), [&](int64_t lo, int64_t hi, int) {
    for (int64_t bag = lo; bag < hi; ++bag) {
      const int32_t row = static_cast<int32_t>(bag % b);
      const int32_t tbl = static_cast<int32_t>(bag / b);
      for (int32_t i = offsets[bag]; i < offsets[bag + 1]; ++i) {
        rowidx_out[i] = row;
        tableidx_out[i] = tbl;
      }
    }
  });
}

// CSR (reference layout: indices [nnz], offsets [t*b+1] table-major,
// optional weights) -> fixed-pooling [t, b, l] padded layout for the
// sharded mesh entries: pad slots get index -1 (the counting-safe
// sentinel) and weight 0 (contributes nothing to forward or backward).
// A bag longer than l is an input error; the function writes the first
// l entries and reports the overflow count in the return value so the
// caller can raise. weights_in may be null (all-ones). Multithreaded
// over bags.
int64_t fbtt_csr_to_padded(const int32_t* indices, const float* weights_in,
                           const int32_t* offsets, int32_t t, int32_t b,
                           int32_t l, int32_t* idx_out, float* w_out) {
  const int64_t bags = static_cast<int64_t>(t) * b;
  std::atomic<int64_t> overflow{0};
  parallel_for(bags, hardware_threads(), [&](int64_t lo, int64_t hi, int) {
    int64_t over = 0;
    for (int64_t bag = lo; bag < hi; ++bag) {
      int32_t* row = idx_out + bag * l;
      float* wrow = w_out + bag * l;
      const int32_t s = offsets[bag];
      const int32_t e = offsets[bag + 1];
      const int32_t n = e - s;
      // negative n (non-monotonic offsets) must not underflow the pad
      // loop below into idx_out[j<0] — clamp and report as overflow so
      // the caller raises
      const int32_t keep = n < 0 ? 0 : (n < l ? n : l);
      if (n > l) over += n - l;
      if (n < 0) over += -n;
      for (int32_t j = 0; j < keep; ++j) {
        row[j] = indices[s + j];
        wrow[j] = weights_in ? weights_in[s + j] : 1.0f;
      }
      for (int32_t j = keep; j < l; ++j) {
        row[j] = -1;
        wrow[j] = 0.0f;
      }
    }
    if (over) overflow.fetch_add(over, std::memory_order_relaxed);
  });
  return overflow.load();
}

int32_t fbtt_version() { return 2; }

}  // extern "C"
