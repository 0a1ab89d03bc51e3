// Image decoders of the PyTorch port: the hot loops of the slide, PNG and
// DICOM readers, which the JAX package leaves to PIL (libtiff, libpng,
// libjpeg-turbo).  Each has a numpy / Python "plain" version of the same
// function beside its wrapper (utils/tiff.py, utils/png.py,
// utils/jpeg.py); the tests and chip_smoke.py hold this code to them bit
// for bit.
//
// mmf_tiff_chunks_decode: TIFF LZW (MSB-first codes, early change) or
// PackBits of many strips or tiles, one chunk at a time per thread.
//
// mmf_png_unfilter: the PNG row filters 0-4 (None, Sub, Up, Average,
// Paeth) of one image or one Adam7 pass; serial along a row.
//
// mmf_jpeg_decode: baseline sequential Huffman JPEG (SOF0/SOF1, 8-bit, 1
// or 3 components, sampling factors 1..4 dividing the largest), from
// the markers that utils/jpeg.py parsed: the entropy decode (restart
// intervals included), libjpeg's accurate integer IDCT (jidctint.c,
// "ISLOW"), libjpeg 6b's triangle ("fancy") upsampling and its
// fixed-point YCbCr -> RGB tables (jdsample.c, jdcolor.c), as PIL's
// libjpeg-turbo decodes by default.  Independent frames (TIFF tiles and
// strips) decode in parallel threads; a single frame runs its
// upsampling and colour conversion in row bands across the threads.
//
// Built at first use by multimodalfusion_tpu_torch/native.py:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o imgcodec.so imgcodec.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int resolve_threads(int n_threads, int64_t n_items) {
    if (n_threads <= 0) {
        n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
    }
    return (int)std::max<int64_t>(1, std::min<int64_t>(n_threads, n_items));
}

// f(i) for i in [0, n), items handed out one at a time to the threads.
template <class F>
void parallel_for(int64_t n, int n_threads, F&& f) {
    int threads = resolve_threads(n_threads, n);
    if (threads <= 1) {
        for (int64_t i = 0; i < n; ++i) f(i);
        return;
    }
    std::atomic<int64_t> next{0};
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
        ts.emplace_back([&]() {
            for (int64_t i; (i = next.fetch_add(1)) < n;) f(i);
        });
    }
    for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------- LZW

// TIFF 6.0 section 13 LZW: 9..12-bit codes MSB first, Clear 256, EOI
// 257, the width growing one code early (libtiff tif_lzw.c).  Writes at
// most cap bytes; returns the bytes written, or -1 on a code that
// names no entry.  A stream that ends without EOI ends the output.
int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                   int64_t cap) {
    std::vector<uint16_t> prefix(4096), length(4096);
    std::vector<uint8_t> suffix(4096), first(4096);
    for (int i = 0; i < 256; ++i) {
        prefix[i] = 0;
        length[i] = 1;
        suffix[i] = first[i] = (uint8_t)i;
    }
    const int64_t total = n * 8;
    int64_t bit = 0, out = 0;
    int width = 9, next = 258, prev = -1;
    while (out < cap) {
        if (bit + width > total) break;
        int64_t byte = bit >> 3;
        uint32_t w = 0;
        for (int k = 0; k < 3; ++k) {
            w = (w << 8) | (byte + k < n ? src[byte + k] : 0u);
        }
        int code = (int)((w >> (24 - (bit & 7) - width)) &
                         ((1u << width) - 1u));
        bit += width;
        if (code == 257) break;
        if (code == 256) {
            width = 9;
            next = 258;
            prev = -1;
            continue;
        }
        if (prev < 0) {
            if (code > 255) return -1;
            dst[out++] = (uint8_t)code;
            prev = code;
            continue;
        }
        if (code > next) return -1;
        if (next < 4096) {
            uint8_t head = code < next ? first[code] : first[prev];
            prefix[next] = (uint16_t)prev;
            suffix[next] = head;
            length[next] = (uint16_t)(length[prev] + 1);
            first[next] = first[prev];
            ++next;
            if (next >= (1 << width) - 1 && width < 12) ++width;
        } else if (code == next) {
            return -1;
        }
        int len = length[code];
        int64_t end = out + len;
        // the string is written from its last byte back; what passes cap
        // is dropped
        int c = code;
        for (int64_t p = end - 1; p >= out; --p) {
            if (p < cap) dst[p] = suffix[c];
            c = prefix[c];
        }
        out = std::min(end, cap);
        prev = code;
    }
    return out;
}

// PackBits (TIFF 6.0 section 9): a header byte n, then n + 1 literal
// bytes (0..127) or one byte repeated 1 - n times (-127..-1); -128 is
// skipped.  Returns the bytes written (at most cap), or -1 when a run
// passes the end of the input.
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
    int64_t i = 0, out = 0;
    while (i < n && out < cap) {
        int h = (int8_t)src[i++];
        if (h >= 0) {
            int64_t cnt = h + 1;
            if (i + cnt > n) return -1;
            int64_t take = std::min(cnt, cap - out);
            std::memcpy(dst + out, src + i, (size_t)take);
            out += take;
            i += cnt;
        } else if (h != -128) {
            if (i >= n) return -1;
            int64_t cnt = 1 - h;
            int64_t take = std::min(cnt, cap - out);
            std::memset(dst + out, src[i++], (size_t)take);
            out += take;
        }
    }
    return out;
}

// ---------------------------------------------------------------- JPEG

// jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995,
                  F3072 = 25172;

// libjpeg's post-IDCT range limit: value x -> table[x & 1023], which is
// x + 128 clamped to 0..255 for |x| < 512 and wraps beyond.
inline uint8_t idct_limit(int64_t x) {
    int i = (int)(x & 1023);
    if (i < 128) return (uint8_t)(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return (uint8_t)(i - 896);
}

// One 8 x 8 block: coefficients in natural order (dequantised here),
// samples to out with row stride `stride`.
void idct_islow(const int32_t* coef, const uint16_t* q, uint8_t* out,
                int64_t stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; ++c) {
        const int32_t* in = coef + c;
        const uint16_t* qc = q + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] &&
            !in[48] && !in[56]) {
            int32_t dc = (int32_t)((int64_t)in[0] * qc[0] * 4);
            for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
            continue;
        }
        int64_t z2 = (int64_t)in[16] * qc[16], z3 = (int64_t)in[48] * qc[48];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 - z3 * F1847, tmp3 = z1 + z2 * F0765;
        z2 = (int64_t)in[0] * qc[0];
        z3 = (int64_t)in[32] * qc[32];
        int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
        int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
        int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = (int64_t)in[56] * qc[56];
        tmp1 = (int64_t)in[40] * qc[40];
        tmp2 = (int64_t)in[24] * qc[24];
        tmp3 = (int64_t)in[8] * qc[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1175;
        tmp0 *= F0298;
        tmp1 *= F2053;
        tmp2 *= F3072;
        tmp3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 = z3 * -F1961 + z5;
        z4 = z4 * -F0390 + z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int64_t h = 1 << 10;
        ws[0 * 8 + c] = (int32_t)((t10 + tmp3 + h) >> 11);
        ws[7 * 8 + c] = (int32_t)((t10 - tmp3 + h) >> 11);
        ws[1 * 8 + c] = (int32_t)((t11 + tmp2 + h) >> 11);
        ws[6 * 8 + c] = (int32_t)((t11 - tmp2 + h) >> 11);
        ws[2 * 8 + c] = (int32_t)((t12 + tmp1 + h) >> 11);
        ws[5 * 8 + c] = (int32_t)((t12 - tmp1 + h) >> 11);
        ws[3 * 8 + c] = (int32_t)((t13 + tmp0 + h) >> 11);
        ws[4 * 8 + c] = (int32_t)((t13 - tmp0 + h) >> 11);
    }
    for (int r = 0; r < 8; ++r) {
        const int32_t* w = ws + r * 8;
        uint8_t* o = out + r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = idct_limit(((int64_t)w[0] + 16) >> 5);
            for (int k = 0; k < 8; ++k) o[k] = v;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 - z3 * F1847, tmp3 = z1 + z2 * F0765;
        int64_t tmp0 = ((int64_t)w[0] + w[4]) * 8192;
        int64_t tmp1 = ((int64_t)w[0] - w[4]) * 8192;
        int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
        int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1175;
        tmp0 *= F0298;
        tmp1 *= F2053;
        tmp2 *= F3072;
        tmp3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 = z3 * -F1961 + z5;
        z4 = z4 * -F0390 + z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int64_t h = 1 << 17;
        o[0] = idct_limit((t10 + tmp3 + h) >> 18);
        o[7] = idct_limit((t10 - tmp3 + h) >> 18);
        o[1] = idct_limit((t11 + tmp2 + h) >> 18);
        o[6] = idct_limit((t11 - tmp2 + h) >> 18);
        o[2] = idct_limit((t12 + tmp1 + h) >> 18);
        o[5] = idct_limit((t12 - tmp1 + h) >> 18);
        o[3] = idct_limit((t13 + tmp0 + h) >> 18);
        o[4] = idct_limit((t13 - tmp0 + h) >> 18);
    }
}

// zigzag position -> natural index
constexpr int ZZ[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jdcolor.c's tables: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
struct ColorTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    ColorTables() {
        for (int i = 0; i < 256; ++i) {
            int64_t x = i - 128;
            cr_r[i] = (int)((91881 * x + 32768) >> 16);
            cb_b[i] = (int)((116130 * x + 32768) >> 16);
            cr_g[i] = -46802 * x;
            cb_g[i] = -22554 * x + 32768;
        }
    }
};

const ColorTables& color_tables() {
    static const ColorTables t;
    return t;
}

inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Huff {
    // 9-bit lookahead: (length << 8 | symbol), 0 when longer
    uint16_t look[512];
    int32_t maxcode[18];  // largest code of each length, -1 when none
    int32_t valptr[17];
    uint8_t vals[256];
    bool build(const uint8_t* bits, const uint8_t* sym) {
        std::memset(look, 0, sizeof(look));
        std::memcpy(vals, sym, 256);
        int32_t code = 0, k = 0;
        for (int L = 1; L <= 16; ++L) {
            valptr[L] = k - code;
            int cnt = bits[L - 1];
            if (cnt && (int64_t)code + cnt > (1 << L)) return false;
            for (int i = 0; i < cnt; ++i, ++code, ++k) {
                if (L <= 9) {
                    int lo = code << (9 - L), hi = (code + 1) << (9 - L);
                    for (int w = lo; w < hi; ++w) {
                        look[w] = (uint16_t)((L << 8) | sym[k]);
                    }
                }
            }
            maxcode[L] = cnt ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7FFFFFFF;
        return k <= 256;
    }
};

// MSB-first reader of one scan: FF 00 is a data byte FF; any other
// marker stops the data (zeros are read past it), and a restart marker
// is consumed by restart().
struct Bits {
    const uint8_t* p;
    int64_t n, pos = 0;
    uint64_t acc = 0;
    int cnt = 0;
    bool marker = false;
    void fill() {
        while (cnt <= 56) {
            uint64_t b = 0;
            if (!marker && pos < n) {
                b = p[pos];
                if (b == 0xFF) {
                    if (pos + 1 < n && p[pos + 1] == 0x00) {
                        pos += 2;
                    } else {
                        marker = true;
                        b = 0;
                    }
                } else {
                    ++pos;
                }
            }
            acc |= b << (56 - cnt);
            cnt += 8;
        }
    }
    int get(int k) {  // k in 1..16
        if (cnt < k) fill();
        int v = (int)(acc >> (64 - k));
        acc <<= k;
        cnt -= k;
        return v;
    }
    int decode(const Huff& h) {
        if (cnt < 16) fill();
        int e = h.look[acc >> 55];
        if (e) {
            int L = e >> 8;
            acc <<= L;
            cnt -= L;
            return e & 0xFF;
        }
        int L = 10;
        int32_t code = (int32_t)(acc >> 54);
        while (L <= 16 && code > h.maxcode[L]) {
            ++L;
            code = (int32_t)(acc >> (64 - L));
        }
        if (L > 16) return -1;
        acc <<= L;
        cnt -= L;
        int idx = h.valptr[L] + code;
        return (idx >= 0 && idx < 256) ? h.vals[idx] : -1;
    }
    // drop what is left of this interval (bits, and bytes a corrupt
    // interval did not use; FF 00 is data, FF FF fill), then read the
    // next RSTn marker
    bool restart() {
        acc = 0;
        cnt = 0;
        while (pos + 1 < n) {
            if (p[pos] != 0xFF || p[pos + 1] == 0x00 || p[pos + 1] == 0xFF) {
                pos += (p[pos] == 0xFF && p[pos + 1] == 0x00) ? 2 : 1;
                continue;
            }
            if (p[pos + 1] < 0xD0 || p[pos + 1] > 0xD7) return false;
            pos += 2;
            marker = false;
            return true;
        }
        return false;
    }
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

}  // namespace

extern "C" {

struct MmfJpegScan {
    const uint8_t* data;   // the entropy-coded data, up to the marker
    int64_t len;           // that ends the scan (RSTn markers inside)
    int32_t ncomp;         // components in the scan
    int32_t restart;       // restart interval in MCUs, 0 for none
    int32_t comp[4];       // frame component index of each
    uint8_t dc_bits[4][16];
    uint8_t dc_vals[4][256];
    uint8_t ac_bits[4][16];
    uint8_t ac_vals[4][256];
};

struct MmfJpegFrame {
    int32_t width, height, ncomp, transform;  // transform: YCbCr -> RGB
    int32_t h[4], v[4];
    uint16_t qt[4][64];  // each component's table, natural order
    int32_t nscans, status;
    MmfJpegScan scans[4];
    uint8_t* out;        // out_rows x out_cols x ncomp, rows out_stride
    int64_t out_stride;  // bytes apart
    int32_t out_rows, out_cols;
};

int64_t mmf_jpeg_frame_size() { return (int64_t)sizeof(MmfJpegFrame); }

}  // extern "C"

namespace {

struct Plane {
    std::vector<uint8_t> px;
    int64_t stride = 0;  // = blocks across * 8
    int dw = 0, dh = 0;  // the component's own width and height
    int rh = 1, rv = 1;  // upsampling ratios
};

int decode_scan(const MmfJpegFrame& f, const MmfJpegScan& s,
                std::vector<Plane>& planes, int hmax, int vmax) {
    Huff dc[4], ac[4];
    for (int k = 0; k < s.ncomp; ++k) {
        if (!dc[k].build(s.dc_bits[k], s.dc_vals[k]) ||
            !ac[k].build(s.ac_bits[k], s.ac_vals[k])) {
            return -2;
        }
    }
    Bits br{s.data, s.len};
    int pred[4] = {0, 0, 0, 0};
    int32_t coef[64];
    auto block = [&](int k, uint8_t* out, int64_t stride) -> bool {
        std::memset(coef, 0, sizeof(coef));
        int t = br.decode(dc[k]);
        if (t < 0 || t > 16) return false;
        int diff = t ? extend(br.get(t), t) : 0;
        pred[k] += diff;
        coef[0] = (int16_t)pred[k];
        for (int i = 1; i < 64;) {
            int rs = br.decode(ac[k]);
            if (rs < 0) return false;
            int r = rs >> 4, z = rs & 15;
            if (z) {
                i += r;
                if (i > 63) return false;
                coef[ZZ[i]] = extend(br.get(z), z);
                ++i;
            } else if (r == 15) {
                i += 16;
            } else {
                break;
            }
        }
        idct_islow(coef, f.qt[s.comp[k]], out, stride);
        return true;
    };
    int64_t units, across;
    if (s.ncomp == 1) {
        const Plane& p = planes[s.comp[0]];
        across = (p.dw + 7) / 8;
        units = across * ((p.dh + 7) / 8);
    } else {
        across = (f.width + 8 * hmax - 1) / (8 * hmax);
        units = across * ((f.height + 8 * vmax - 1) / (8 * vmax));
    }
    int left = s.restart;
    for (int64_t u = 0; u < units; ++u) {
        if (s.restart) {
            if (!left) {
                if (!br.restart()) return -3;
                std::memset(pred, 0, sizeof(pred));
                left = s.restart;
            }
            --left;
        }
        int64_t my = u / across, mx = u % across;
        if (s.ncomp == 1) {
            Plane& p = planes[s.comp[0]];
            if (!block(0, p.px.data() + my * 8 * p.stride + mx * 8,
                       p.stride)) {
                return -3;
            }
            continue;
        }
        for (int k = 0; k < s.ncomp; ++k) {
            int c = s.comp[k];
            Plane& p = planes[c];
            for (int by = 0; by < f.v[c]; ++by) {
                for (int bx = 0; bx < f.h[c]; ++bx) {
                    int64_t y = (my * f.v[c] + by) * 8;
                    int64_t x = (mx * f.h[c] + bx) * 8;
                    if (!block(k, p.px.data() + y * p.stride + x, p.stride)) {
                        return -3;
                    }
                }
            }
        }
    }
    return 0;
}

// The output row y of component plane p, upsampled as jdsample.c does
// (fancy: do_fancy_upsampling, its default), its first `cols` samples.
void upsample_row(const Plane& p, int y, int cols, uint8_t* row,
                  int* sum) {
    const uint8_t* px = p.px.data();
    int dw = p.dw, dh = p.dh;
    if (p.rh == 1 && p.rv == 1) {
        std::memcpy(row, px + (int64_t)y * p.stride, cols);
    } else if (p.rh == 2 && p.rv == 1 && dw > 2) {
        const uint8_t* in = px + (int64_t)y * p.stride;
        for (int x = 0; x < cols; ++x) {
            int j = x >> 1;
            int t = in[j] * 3;
            row[x] = (uint8_t)((x & 1) ? (t + in[std::min(j + 1, dw - 1)] + 2) >> 2
                                       : (t + in[std::max(j - 1, 0)] + 1) >> 2);
        }
    } else if (p.rh == 1 && p.rv == 2) {
        int i = y >> 1;
        int far = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        const uint8_t* a = px + (int64_t)i * p.stride;
        const uint8_t* b = px + (int64_t)far * p.stride;
        for (int x = 0; x < cols; ++x) {
            row[x] = (uint8_t)((a[x] * 3 + b[x] + bias) >> 2);
        }
    } else if (p.rh == 2 && p.rv == 2 && dw > 2) {
        int i = y >> 1;
        int far = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
        const uint8_t* a = px + (int64_t)i * p.stride;
        const uint8_t* b = px + (int64_t)far * p.stride;
        int n = std::min((cols + 2) / 2, dw);
        for (int j = 0; j < n; ++j) sum[j] = a[j] * 3 + b[j];
        for (int x = 0; x < cols; ++x) {
            int j = x >> 1;
            int t = sum[j] * 3;
            row[x] = (uint8_t)((x & 1) ? (t + sum[std::min(j + 1, dw - 1)] + 7) >> 4
                                       : (t + sum[std::max(j - 1, 0)] + 8) >> 4);
        }
    } else {  // box: int_upsample, h2v1_upsample, h2v2_upsample
        const uint8_t* in = px + (int64_t)(y / p.rv) * p.stride;
        for (int x = 0; x < cols; ++x) row[x] = in[x / p.rh];
    }
}

void output_rows(const MmfJpegFrame& f, const std::vector<Plane>& planes,
                 int y0, int y1) {
    int cols = f.out_cols, nc = f.ncomp;
    std::vector<uint8_t> rows((size_t)nc * cols);
    std::vector<int> sum(cols / 2 + 2);
    const ColorTables& ct = color_tables();
    for (int y = y0; y < y1; ++y) {
        for (int c = 0; c < nc; ++c) {
            upsample_row(planes[c], y, cols, rows.data() + (size_t)c * cols,
                         sum.data());
        }
        uint8_t* o = f.out + (int64_t)y * f.out_stride;
        if (nc == 1) {
            std::memcpy(o, rows.data(), cols);
        } else if (f.transform) {
            const uint8_t* Y = rows.data();
            const uint8_t* cb = Y + cols;
            const uint8_t* cr = cb + cols;
            for (int x = 0; x < cols; ++x) {
                int yy = Y[x];
                o[3 * x] = clamp255(yy + ct.cr_r[cr[x]]);
                o[3 * x + 1] = clamp255(
                    yy + (int)((ct.cb_g[cb[x]] + ct.cr_g[cr[x]]) >> 16));
                o[3 * x + 2] = clamp255(yy + ct.cb_b[cb[x]]);
            }
        } else {
            for (int x = 0; x < cols; ++x) {
                for (int c = 0; c < nc; ++c) {
                    o[nc * x + c] = rows[(size_t)c * cols + x];
                }
            }
        }
    }
}

// 0 ok; -1 a frame this decoder does not take, -2 a bad Huffman table,
// -3 corrupt entropy-coded data
int decode_frame(MmfJpegFrame& f, int n_threads) {
    if (f.ncomp != 1 && f.ncomp != 3) return -1;
    if (f.out_rows > f.height || f.out_cols > f.width || f.out_rows < 0 ||
        f.out_cols < 0 || f.nscans < 1 || f.nscans > 4) {
        return -1;
    }
    int hmax = 1, vmax = 1;
    for (int c = 0; c < f.ncomp; ++c) {
        if (f.h[c] < 1 || f.h[c] > 4 || f.v[c] < 1 || f.v[c] > 4) return -1;
        hmax = std::max(hmax, f.h[c]);
        vmax = std::max(vmax, f.v[c]);
    }
    int64_t mx = (f.width + 8 * hmax - 1) / (8 * hmax);
    int64_t my = (f.height + 8 * vmax - 1) / (8 * vmax);
    std::vector<Plane> planes(f.ncomp);
    for (int c = 0; c < f.ncomp; ++c) {
        if (hmax % f.h[c] || vmax % f.v[c]) return -1;
        Plane& p = planes[c];
        p.stride = mx * f.h[c] * 8;
        p.px.assign((size_t)(p.stride * my * f.v[c] * 8), 0);
        p.dw = (int)(((int64_t)f.width * f.h[c] + hmax - 1) / hmax);
        p.dh = (int)(((int64_t)f.height * f.v[c] + vmax - 1) / vmax);
        p.rh = hmax / f.h[c];
        p.rv = vmax / f.v[c];
    }
    for (int s = 0; s < f.nscans; ++s) {
        const MmfJpegScan& sc = f.scans[s];
        if (sc.ncomp < 1 || sc.ncomp > f.ncomp) return -1;
        for (int k = 0; k < sc.ncomp; ++k) {
            if (sc.comp[k] < 0 || sc.comp[k] >= f.ncomp) return -1;
        }
        int rc = decode_scan(f, sc, planes, hmax, vmax);
        if (rc) return rc;
    }
    int threads = resolve_threads(n_threads, f.out_rows / 64 + 1);
    int band = (f.out_rows + threads - 1) / std::max(threads, 1);
    parallel_for(threads, threads, [&](int64_t t) {
        int y0 = (int)(t * band);
        int y1 = std::min(f.out_rows, y0 + band);
        if (y0 < y1) output_rows(f, planes, y0, y1);
    });
    return 0;
}

}  // namespace

extern "C" {

// Decode n frames, in parallel threads (n_threads <= 0: one per
// hardware thread); each frame's status is 0 or a negative code (see
// decode_frame).  Returns the number of frames that failed.
int mmf_jpeg_decode(MmfJpegFrame* frames, int64_t n, int n_threads) {
    std::atomic<int> failed{0};
    int inner = n == 1 ? n_threads : 1;
    parallel_for(n, n_threads, [&](int64_t i) {
        frames[i].status = decode_frame(frames[i], inner);
        if (frames[i].status) failed.fetch_add(1);
    });
    return failed.load();
}

// Decode n TIFF chunks (codec 5: LZW, 32773: PackBits) from srcs[i]
// (lens[i] bytes) into dsts[i] (caps[i] bytes), in parallel threads;
// outs[i] gets the bytes written, or -1 for a malformed chunk.  Returns
// 0, or -2 for an unknown codec.
int mmf_tiff_chunks_decode(int codec, const uint8_t** srcs,
                           const int64_t* lens, uint8_t** dsts,
                           const int64_t* caps, int64_t* outs, int64_t n,
                           int n_threads) {
    if (codec != 5 && codec != 32773) return -2;
    parallel_for(n, n_threads, [&](int64_t i) {
        outs[i] = codec == 5
                      ? lzw_decode(srcs[i], lens[i], dsts[i], caps[i])
                      : packbits_decode(srcs[i], lens[i], dsts[i], caps[i]);
    });
    return 0;
}

// Undo the PNG row filters of `raw` (h rows of 1 + rowbytes bytes, the
// first the filter type) into out (h rows of rowbytes); bpp is the bytes
// of one pixel, at least 1.  Returns 0, or 1 + the row whose filter type
// is not 0..4.
int64_t mmf_png_unfilter(const uint8_t* raw, int64_t h, int64_t rowbytes,
                         int bpp, uint8_t* out) {
    const uint8_t* prior = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* x = raw + y * (rowbytes + 1);
        int type = *x++;
        uint8_t* o = out + y * rowbytes;
        switch (type) {
            case 0:
                std::memcpy(o, x, rowbytes);
                break;
            case 1:
                for (int64_t i = 0; i < rowbytes; ++i) {
                    o[i] = (uint8_t)(x[i] + (i >= bpp ? o[i - bpp] : 0));
                }
                break;
            case 2:
                for (int64_t i = 0; i < rowbytes; ++i) {
                    o[i] = (uint8_t)(x[i] + (prior ? prior[i] : 0));
                }
                break;
            case 3:
                for (int64_t i = 0; i < rowbytes; ++i) {
                    int a = i >= bpp ? o[i - bpp] : 0;
                    int b = prior ? prior[i] : 0;
                    o[i] = (uint8_t)(x[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < rowbytes; ++i) {
                    int a = i >= bpp ? o[i - bpp] : 0;
                    int b = prior ? prior[i] : 0;
                    int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
                    int p = a + b - c;
                    int pa = std::abs(p - a), pb = std::abs(p - b),
                        pc = std::abs(p - c);
                    int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    o[i] = (uint8_t)(x[i] + pred);
                }
                break;
            default:
                return y + 1;
        }
        prior = o;
    }
    return 0;
}

}  // extern "C"
