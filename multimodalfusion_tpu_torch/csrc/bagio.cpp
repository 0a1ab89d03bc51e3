// Host-side library of the PyTorch port.
//
// mmf_pad_bags_f32: pad B ragged MIL bags into one [B, n_pad, D] float32
// batch and its [B, n_pad] mask, one thread per group of bags.  The
// port's own copy of mmf_pad_bags_f32 of the JAX package's
// native/bagio.cpp; the output pointers are the caller's, so the batch
// can be written straight into page-locked memory that a non_blocking
// copy then moves to the card.
//
// mmf_f32_to_bf16: float32 -> bfloat16, round to nearest even, threaded;
// a NaN becomes its sign | 0x7FC0.  The port's own copy of
// mmf_f32_to_bf16 of the JAX package's native/bagio.cpp:60.
//
// mmf_read_files: whole-file reads into the caller's buffers, one
// contiguous range of files a thread.  The port's own copy of
// mmf_read_files of the JAX package's native/bagio.cpp:102.
//
// Built at first use by multimodalfusion_tpu_torch/native.py:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o bagio.so bagio.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
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

// src, dst: n elements.  A NaN keeps its sign and becomes the quiet NaN
// 0x7FC0: the rounding add would carry a payload-only NaN (0x7F800001)
// into Inf, or one with every bit set (0xFFFFFFFF) into 0.  n_threads <= 0
// takes one thread per hardware thread; each thread converts at least
// 1 << 20 elements, so a small array runs on the calling thread.
void mmf_f32_to_bf16(const float* src, uint16_t* dst, int64_t n,
                     int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
    }
    auto work = [&](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) {
            uint32_t bits;
            std::memcpy(&bits, &src[i], 4);
            if ((bits & 0x7F800000u) == 0x7F800000u &&
                (bits & 0x007FFFFFu) != 0u) {
                dst[i] = (uint16_t)(((bits >> 16) & 0x8000u) | 0x7FC0u);
                continue;
            }
            bits += 0x7FFFu + ((bits >> 16) & 1u);  // round to nearest even
            dst[i] = (uint16_t)(bits >> 16);
        }
    };
    const int64_t min_chunk = 1 << 20;
    int threads = (int)std::min<int64_t>(
        n_threads, std::max<int64_t>(1, n / min_chunk));
    if (threads <= 1) {
        work(0, n);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
        int64_t i0 = t * chunk;
        int64_t i1 = std::min(n, i0 + chunk);
        if (i0 >= i1) break;
        ts.emplace_back(work, i0, i1);
    }
    for (auto& t : ts) t.join();
}

// paths[f]: a file of at least sizes[f] bytes, whose first sizes[f]
// bytes are read into bufs[f].  Returns the number of files read in full
// (a missing or shorter file counts 0).  n_threads <= 0 takes one thread
// per hardware thread, never more than there are files.
int64_t mmf_read_files(const char** paths, const int64_t* sizes,
                       char** bufs, int64_t n_files, int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
    }
    n_threads = (int)std::min<int64_t>(n_threads, n_files ? n_files : 1);
    std::vector<int64_t> ok(n_files, 0);
    auto work = [&](int64_t f0, int64_t f1) {
        for (int64_t f = f0; f < f1; ++f) {
            FILE* fp = std::fopen(paths[f], "rb");
            if (!fp) continue;
            size_t got = std::fread(bufs[f], 1, (size_t)sizes[f], fp);
            std::fclose(fp);
            ok[f] = got == (size_t)sizes[f];
        }
    };
    std::vector<std::thread> ts;
    int64_t chunk = (n_files + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t f0 = t * chunk;
        int64_t f1 = std::min(n_files, f0 + chunk);
        if (f0 >= f1) break;
        ts.emplace_back(work, f0, f1);
    }
    for (auto& t : ts) t.join();
    int64_t total = 0;
    for (auto v : ok) total += v;
    return total;
}

}  // extern "C"
