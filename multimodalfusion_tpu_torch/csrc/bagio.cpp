// Host-side batch collation of the PyTorch port: pad B ragged MIL bags
// into one [B, n_pad, D] float32 batch and its [B, n_pad] mask, one
// thread per group of bags.  The port's own copy of mmf_pad_bags_f32 of
// the JAX package's native/bagio.cpp; the output pointers are the
// caller's, so the batch can be written straight into page-locked memory
// that a non_blocking copy then moves to the card.
//
// Built at first use by multimodalfusion_tpu_torch/native.py:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o bagio.so bagio.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// bags[i]: lens[i] x D float32 rows, or null for a missing bag.  out
// [B, n_pad, D] and mask [B, n_pad] need not be zeroed: every element is
// written.  Rows past n_pad are dropped.  n_threads <= 0 takes one thread
// per hardware thread, at most one per bag.
void mmf_pad_bags_f32(const float** bags, const int64_t* lens, int64_t B,
                      int64_t n_pad, int64_t D, float* out, float* mask,
                      int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
    }
    n_threads = (int)std::min<int64_t>(n_threads, B > 0 ? B : 1);
    auto work = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; ++b) {
            float* dst = out + b * n_pad * D;
            float* m = mask + b * n_pad;
            int64_t n = bags[b] ? std::min(lens[b], n_pad) : 0;
            if (n > 0) {
                std::memcpy(dst, bags[b], sizeof(float) * n * D);
            }
            std::memset(dst + n * D, 0, sizeof(float) * (n_pad - n) * D);
            std::fill(m, m + n, 1.0f);
            std::memset(m + n, 0, sizeof(float) * (n_pad - n));
        }
    };
    if (n_threads == 1) {
        work(0, B);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (B + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t b0 = t * chunk;
        int64_t b1 = std::min(B, b0 + chunk);
        if (b0 >= b1) break;
        ts.emplace_back(work, b0, b1);
    }
    for (auto& t : ts) t.join();
}

}  // extern "C"
