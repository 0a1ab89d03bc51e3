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
// mmf_jpeg_lossless_decode: the entropy decode of a lossless-JPEG DICOM
// frame (below).
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

// JPEG Lossless (ITU T.81 process 14 — DICOM's SV1 syntax and any
// SV 1..7) entropy decode + predictor reconstruction: the port's own copy
// of mmf_jpeg_lossless_decode of the JAX package's native/bagio.cpp.  The
// Python side (data/dicom.py) parses the markers, strips byte stuffing,
// and hands over the entropy-coded bytes plus the selected DHT's
// BITS/HUFFVAL lists; this routine runs the per-sample Huffman walk and
// prediction.
// counts: 16 bytes (codes per length), symbols: sum(counts) bytes —
// lengths validated by the caller; canonicity is validated HERE
// because a non-canonical DHT would otherwise index past the LUT.
// Returns 0 ok, -1 invalid Huffman table/code, -2 truncated stream,
// -3 unsupported predictor.
int mmf_jpeg_lossless_decode(const uint8_t* entropy, int64_t n_bytes,
                             const uint8_t* counts, const uint8_t* symbols,
                             int rows, int cols, int psv, int default_pred,
                             uint16_t* out) {
    // 16-bit prefix LUT over the canonical code (T.81 Annex C.2): every
    // window whose leading bits spell a code maps to (length, symbol).
    struct Ent { uint8_t len; uint8_t sym; };
    std::vector<Ent> lut(1u << 16, Ent{0, 0});
    uint32_t code = 0;
    int k = 0;
    for (int L = 1; L <= 16; ++L) {
        for (int i = 0; i < counts[L - 1]; ++i) {
            if (code >= (1u << L)) return -1;  // non-canonical DHT: the
            // code space of length L is exhausted; writing would run
            // past the 2^16-entry LUT (heap corruption)
            uint32_t lo = code << (16 - L);
            uint32_t hi = lo + (1u << (16 - L));
            for (uint32_t w = lo; w < hi; ++w) {
                lut[w].len = (uint8_t)L;
                lut[w].sym = symbols[k];
            }
            ++k;
            ++code;
        }
        code <<= 1;
    }
    // MSB-first bit reader; bytes past the end read as 0xFF pad but any
    // CONSUMED bit index >= n_bytes*8 is an error (parity with the
    // Python _BitReader, whose indexing fails there).
    const int64_t total_bits = n_bytes * 8;
    uint64_t acc = 0;
    int acc_bits = 0;
    int64_t bytepos = 0, bitpos = 0;
    auto refill = [&]() {
        while (acc_bits <= 56) {
            acc = (acc << 8) |
                  (bytepos < n_bytes ? (uint64_t)entropy[bytepos] : 0xFFu);
            ++bytepos;
            acc_bits += 8;
        }
    };
    for (int y = 0; y < rows; ++y) {
        uint16_t* cur = out + (int64_t)y * cols;
        const uint16_t* above = y ? cur - cols : nullptr;
        for (int x = 0; x < cols; ++x) {
            refill();
            Ent e = lut[(acc >> (acc_bits - 16)) & 0xFFFFu];
            if (!e.len) return -1;
            acc_bits -= e.len;
            bitpos += e.len;
            if (bitpos > total_bits) return -2;
            int ssss = e.sym;
            if (ssss > 16) return -1;  // SSSS past the 16-bit category
            // table: 1<<ssss / the magnitude shift would be UB
            int diff;
            if (ssss == 0) {
                diff = 0;
            } else if (ssss == 16) {
                diff = 32768;
            } else {
                refill();
                uint32_t v = (uint32_t)(acc >> (acc_bits - ssss)) &
                             ((1u << ssss) - 1u);
                acc_bits -= ssss;
                bitpos += ssss;
                if (bitpos > total_bits) return -2;
                diff = (v >= (1u << (ssss - 1))) ? (int)v
                                                 : (int)v - (1 << ssss) + 1;
            }
            int pred;
            if (y == 0) {                       // T.81 H.1.2 boundaries
                pred = x ? cur[x - 1] : default_pred;
            } else if (x == 0) {
                pred = above[0];
            } else {
                int ra = cur[x - 1], rb = above[x], rc = above[x - 1];
                switch (psv) {
                    case 1: pred = ra; break;
                    case 2: pred = rb; break;
                    case 3: pred = rc; break;
                    case 4: pred = ra + rb - rc; break;
                    case 5: pred = ra + ((rb - rc) >> 1); break;
                    case 6: pred = rb + ((ra - rc) >> 1); break;
                    case 7: pred = (ra + rb) >> 1; break;
                    default: return -3;
                }
            }
            cur[x] = (uint16_t)((pred + diff) & 0xFFFF);
        }
    }
    return 0;
}

}  // extern "C"
