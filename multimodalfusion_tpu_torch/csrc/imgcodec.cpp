// Image decoders of the PyTorch port: the hot loops of the slide, PNG and
// DICOM readers, which the JAX package leaves to PIL (libtiff, libpng,
// libjpeg-turbo).  Each has a numpy / Python "plain" version of the same
// function beside its wrapper (utils/tiff.py, utils/png.py,
// utils/jpeg.py); the tests and chip_smoke.py hold this code to them bit
// for bit.
//
// mmf_tiff_chunks_decode: TIFF LZW (MSB-first codes, early change),
// PackBits or ZSTD of many strips or tiles, one chunk at a time per
// thread.
//
// mmf_zstd_decode: Zstandard (RFC 8878), the port's own decoder, not
// libzstd: frames with their header (window or single segment, content
// size), raw, RLE and compressed blocks, Huffman literals in 1 or 4
// streams (weights direct or FSE-coded, treeless blocks), the FSE
// sequence tables (predefined, RLE, coded, repeated) and repeat offsets,
// matches over the whole frame, the XXH64 content checksum, skippable
// frames; a dictionary ID and a window over libzstd's default 2^27 are
// refused.  utils/zstd.py holds its plain version.
//
// mmf_lzf_decode: LZF (liblzf's lzf_decompress), the chunks of h5py's lzf
// filter (HDF5 filter 32000): literal runs and back-references copied
// byte by byte; a stream cut inside an instruction, a reference before the
// output's start or output past its size is refused.  utils/lzf.py holds
// its plain version.
//
// mmf_png_unfilter: the PNG row filters 0-4 (None, Sub, Up, Average,
// Paeth) of one image or one Adam7 pass; serial along a row.
//
// mmf_jpeg_decode: sequential and progressive JPEG in Huffman or
// arithmetic coding (SOF0, SOF1, SOF2, SOF9, SOF10) and lossless Huffman
// JPEG (SOF3); 8-bit, 1, 3 or 4 components, sampling factors 1..4
// dividing the largest; from the markers that utils/jpeg.py parsed: the
// entropy decode (restart intervals included; a progressive frame's scans
// into one coefficient array per component, jdphuff.c; T.81 Annex D's
// arithmetic decoder with jdarith.c's statistics bins and contexts;
// a lossless frame's predictor loop, lossless_scan), libjpeg-turbo's block
// smoothing of coefficients the scans left unrefined (jdcoefct.c's
// decompress_smooth_data), libjpeg's accurate integer IDCT (jidctint.c,
// "ISLOW"), libjpeg 6b's triangle ("fancy") upsampling and its
// fixed-point YCbCr -> RGB and YCCK -> CMYK tables (jdsample.c,
// jdcolor.c), as PIL's libjpeg-turbo decodes by default; four components
// come out inverted, as PIL's "CMYK;I" holds them.  Independent frames
// (TIFF tiles and strips) decode in parallel threads; a single frame
// runs its IDCT (a progressive one's smoothing first) in block rows, and
// its upsampling and colour conversion in row bands, across the threads.
//
// mmf_jpeg_lossless_decode: the lossless-JPEG DICOM frames (…1.2.4.57,
// .70) as the JAX package's native decoder reads them, through the same
// predictor loop.
//
// Built at first use by multimodalfusion_tpu_torch/native.py (no codec
// library is linked: not libjpeg, not libzstd):
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o imgcodec.so imgcodec.cpp

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
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

// ----------------------------------------------------------- Zstandard

// RFC 8878 frames, as utils/zstd.py's decompress reads them (its
// docstring says what is read and refused); errors are thrown as ZErr
// and turned into the entry points' negative codes.
namespace zstd {

enum : int { kCorrupt = -1, kDictionary = -2, kWindow = -3 };
constexpr int64_t kBlockMax = 1 << 17;
constexpr int kWindowLogLimit = 27;
constexpr int kHufLogMax = 12;
constexpr int64_t kNcountWindow = 600;  // bytes an FSE description may use

struct ZErr {
    int code;
    int64_t detail;
};

[[noreturn]] inline void corrupt() { throw ZErr{kCorrupt, 0}; }

const uint32_t LL_BASE[36] = {0,    1,    2,     3,     4,     5,    6,
                              7,    8,    9,     10,    11,    12,   13,
                              14,   15,   16,    18,    20,    22,   24,
                              28,   32,   40,    48,    64,    128,  256,
                              512,  1024, 2048,  4096,  8192,  16384,
                              32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,   4,   5,   6,   7,    8,    9,    10,   11,    12,    13,
    14,  15,  16,  17,  18,   19,   20,   21,   22,    23,    24,
    25,  26,  27,  28,  29,   30,   31,   32,   33,    34,    35,
    37,  39,  41,  43,  47,   51,   59,   67,   83,    99,    131,
    259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

inline int bit_length(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

inline uint64_t load_le(const uint8_t* p, int64_t n) {
    uint64_t w = 0;
    if (n >= 8) {
        std::memcpy(&w, p, 8);
    } else {
        for (int64_t k = 0; k < n; ++k) w |= (uint64_t)p[k] << (8 * k);
    }
    return w;
}

// The nb (<= 56) bits from bit `at` up of the LSB-first stream p[0, n),
// zeros past either end.
inline uint64_t bits_at(const uint8_t* p, int64_t n, int64_t at, int nb) {
    if (nb <= 0) return 0;
    if (at < 0) {
        return nb + at > 0 ? bits_at(p, n, 0, (int)(nb + at)) << (-at) : 0;
    }
    int64_t byte = at >> 3;
    if (byte >= n) return 0;
    return (load_le(p + byte, n - byte) >> (at & 7)) & ((1ull << nb) - 1);
}

// A backward bit stream over p[0, n) (see utils/zstd.py's _Back): pos is
// the count of bits left, negative once overread.
struct Back {
    const uint8_t* p;
    int64_t n, pos;
    Back(const uint8_t* p_, int64_t n_) : p(p_), n(n_) {
        if (n < 1 || p[n - 1] == 0) corrupt();
        pos = 8 * (n - 1) + bit_length(p[n - 1]) - 1;
    }
    inline uint64_t read(int nb) {
        pos -= nb;
        return bits_at(p, n, pos, nb);
    }
};

struct Fse {
    int log = 0;
    uint8_t sym[512];
    uint8_t nb[512];
    uint16_t base[512];
};

// The FSE table description at p (n bytes left): the counts, the log,
// and the bytes it takes.
int64_t read_ncount(const uint8_t* p, int64_t n, int max_symbol, int max_log,
                    std::vector<int>& counts, int& log) {
    if (n < 1) corrupt();
    n = std::min(n, kNcountWindow);
    log = (int)bits_at(p, n, 0, 4) + 5;
    if (log > max_log) corrupt();
    int64_t at = 4;
    int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
    counts.clear();
    bool prev0 = false;
    while (remaining > 1 && (int)counts.size() <= max_symbol) {
        if (prev0) {
            while (true) {
                int r = (int)bits_at(p, n, at, 2);
                at += 2;
                counts.insert(counts.end(), r, 0);
                if (r != 3) break;
            }
            if ((int)counts.size() > max_symbol) break;
        }
        int most = 2 * threshold - 1 - remaining;
        int low = (int)bits_at(p, n, at, nb - 1);
        int count;
        if (low < most) {
            count = low;
            at += nb - 1;
        } else {
            count = (int)bits_at(p, n, at, nb);
            if (count >= threshold) count -= most;
            at += nb;
        }
        count -= 1;
        remaining -= std::abs(count);
        counts.push_back(count);
        prev0 = count == 0;
        if (remaining < threshold) {
            if (remaining <= 1) break;
            nb = bit_length((uint64_t)remaining);
            threshold = 1 << (nb - 1);
        }
    }
    int64_t used = (at + 7) >> 3;
    if (remaining != 1 || (int)counts.size() > max_symbol + 1 || used > n) {
        corrupt();
    }
    return used;
}

void build_fse(const int* counts, int n_sym, int log, Fse& t) {
    int size = 1 << log, high = size - 1;
    int nxt[256];
    for (int s = 0; s < n_sym; ++s) {
        if (counts[s] == -1) {
            t.sym[high--] = (uint8_t)s;
            nxt[s] = 1;
        } else {
            nxt[s] = counts[s];
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, p = 0;
    for (int s = 0; s < n_sym; ++s) {
        for (int i = 0; i < counts[s]; ++i) {
            t.sym[p] = (uint8_t)s;
            p = (p + step) & mask;
            while (p > high) p = (p + step) & mask;
        }
    }
    if (p != 0) corrupt();
    for (int u = 0; u < size; ++u) {
        int x = nxt[t.sym[u]]++;
        int nb = log + 1 - bit_length((uint64_t)x);
        t.nb[u] = (uint8_t)nb;
        t.base[u] = (uint16_t)((x << nb) - size);
    }
    t.log = log;
}

void rle_fse(int symbol, Fse& t) {
    t.log = 0;
    t.sym[0] = (uint8_t)symbol;
    t.nb[0] = 0;
    t.base[0] = 0;
}

struct Predefined {
    Fse ll, of, ml;
    Predefined() {
        int c[53];
        for (int i = 0; i < 36; ++i) c[i] = LL_DEFAULT[i];
        build_fse(c, 36, 6, ll);
        for (int i = 0; i < 29; ++i) c[i] = OF_DEFAULT[i];
        build_fse(c, 29, 5, of);
        for (int i = 0; i < 53; ++i) c[i] = ML_DEFAULT[i];
        build_fse(c, 53, 6, ml);
    }
};

const Predefined& predefined() {
    static const Predefined p;
    return p;
}

struct Huffman {
    int log = 0;
    uint8_t sym[1 << kHufLogMax];
    uint8_t nb[1 << kHufLogMax];
};

// The FSE-coded Huffman weights of p[0, n): two interleaved states until
// the stream is overread (utils/zstd.py's _fse_weights).
int fse_weights(const uint8_t* p, int64_t n, uint8_t* w) {
    std::vector<int> counts;
    int log;
    int64_t used = read_ncount(p, n, 255, 6, counts, log);
    Fse t;
    build_fse(counts.data(), (int)counts.size(), log, t);
    Back br(p + used, n - used);
    int s1 = (int)br.read(log), s2 = (int)br.read(log);
    int k = 0;
    while (true) {
        if (k > 253) corrupt();
        w[k++] = t.sym[s1];
        s1 = t.base[s1] + (int)br.read(t.nb[s1]);
        if (br.pos < 0) {
            w[k++] = t.sym[s2];
            return k;
        }
        if (k > 253) corrupt();
        w[k++] = t.sym[s2];
        s2 = t.base[s2] + (int)br.read(t.nb[s2]);
        if (br.pos < 0) {
            w[k++] = t.sym[s1];
            return k;
        }
    }
}

// The Huffman tree description at p (n bytes left) into h; returns the
// bytes it takes.
int64_t read_huffman(const uint8_t* p, int64_t n, Huffman& h) {
    if (n < 1) corrupt();
    int head = p[0];
    uint8_t w[257];
    int k;
    int64_t used;
    if (head >= 128) {
        k = head - 127;
        used = 1 + (k + 1) / 2;
        if (used > n) corrupt();
        for (int i = 0; i < k; ++i) {
            w[i] = i % 2 == 0 ? p[1 + i / 2] >> 4 : p[1 + i / 2] & 15;
        }
    } else {
        used = 1 + head;
        if (used > n) corrupt();
        k = fse_weights(p + 1, head, w);
    }
    int64_t total = 0;
    for (int i = 0; i < k; ++i) {
        if (w[i] > kHufLogMax) corrupt();
        total += (1 << w[i]) >> 1;
    }
    if (total == 0) corrupt();
    int log = bit_length((uint64_t)total);
    if (log > kHufLogMax) corrupt();
    int64_t rest = ((int64_t)1 << log) - total;
    int last = bit_length((uint64_t)rest);
    if (rest != (int64_t)1 << (last - 1)) corrupt();
    w[k++] = (uint8_t)last;
    int ones = 0;
    for (int i = 0; i < k; ++i) ones += w[i] == 1;
    if (ones < 2 || ones % 2) corrupt();
    int at = 0;
    for (int weight = 1; weight <= kHufLogMax; ++weight) {
        for (int s = 0; s < k; ++s) {
            if (w[s] != weight) continue;
            int cnt = 1 << (weight - 1);
            std::memset(h.sym + at, s, cnt);
            std::memset(h.nb + at, log + 1 - weight, cnt);
            at += cnt;
        }
    }
    h.log = log;
    return used;
}

// n literals of the Huffman stream p[0, len), which they use up exactly.
void huffman_stream(const uint8_t* p, int64_t len, const Huffman& h,
                    int64_t n, uint8_t* out) {
    Back br(p, len);
    const int log = h.log;
    const uint64_t mask = (1ull << log) - 1;
    int64_t pos = br.pos;
    for (int64_t i = 0; i < n; ++i) {
        int64_t at = pos - log;
        uint64_t v;
        if (at >= 0) {
            int64_t byte = at >> 3;
            v = (load_le(p + byte, len - byte) >> (at & 7)) & mask;
        } else {
            v = bits_at(p, len, at, log);
        }
        out[i] = h.sym[v];
        pos -= h.nb[v];
    }
    if (pos != 0) corrupt();
}

struct Seq {
    int64_t ll, off, ml;
};

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t xround(uint64_t acc, uint64_t lane) {
    return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
    int64_t at = 0;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        for (; at + 32 <= n; at += 32) {
            v1 = xround(v1, load_le(p + at, 8));
            v2 = xround(v2, load_le(p + at + 8, 8));
            v3 = xround(v3, load_le(p + at + 16, 8));
            v4 = xround(v4, load_le(p + at + 24, 8));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
    } else {
        h = P5;
    }
    h += (uint64_t)n;
    for (; at + 8 <= n; at += 8) {
        h ^= xround(0, load_le(p + at, 8));
        h = rotl(h, 27) * P1 + P4;
    }
    if (at + 4 <= n) {
        h ^= (uint64_t)(uint32_t)load_le(p + at, 4) * P1;
        h = rotl(h, 23) * P2 + P3;
        at += 4;
    }
    for (; at < n; ++at) {
        h ^= p[at] * P5;
        h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// Where the output goes: limit bytes at most (the cap); in growing mode
// the buffer is realloc'ed to hold what comes, and the limit is none.
struct Sink {
    uint8_t* p;
    int64_t alloc, limit, n = 0;
    bool grow;
    void reserve(int64_t need) {
        if (!grow || need <= alloc) return;
        int64_t want = std::max<int64_t>({need, 2 * alloc, 1 << 16});
        auto* q = (uint8_t*)std::realloc(p, (size_t)want);
        if (!q) throw std::bad_alloc();
        p = q;
        alloc = want;
    }
    // copy src[0, len) to the position n, what passes the limit dropped
    inline void put(const uint8_t* src, int64_t len) {
        int64_t take = std::min(len, limit - n);
        if (take > 0) std::memcpy(p + n, src, (size_t)take);
        n += len;
    }
    inline void fill(uint8_t b, int64_t len) {
        int64_t take = std::min(len, limit - n);
        if (take > 0) std::memset(p + n, b, (size_t)take);
        n += len;
    }
    // the match of ml bytes at offset off (checked), byte by byte where
    // it overlaps itself
    inline void match(int64_t off, int64_t ml) {
        int64_t take = std::min(ml, limit - n);
        if (take > 0) {
            uint8_t* d = p + n;
            const uint8_t* s = d - off;
            if (off >= take) {
                std::memcpy(d, s, (size_t)take);
            } else {
                for (int64_t i = 0; i < take; ++i) d[i] = s[i];
            }
        }
        n += ml;
    }
};

class Decoder {
  public:
    // Every frame of src[0, len) into out, or only the first
    // (one_frame; see utils/zstd.py's decompress); throws ZErr.
    void run(const uint8_t* src, int64_t len, Sink& out, bool one_frame) {
        int64_t pos = 0, frames = 0;
        while (pos < len && out.n < out.limit && !(one_frame && frames)) {
            ++frames;
            if (pos + 4 > len) corrupt();
            uint32_t magic = (uint32_t)load_le(src + pos, 4);
            if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
                if (pos + 8 > len) corrupt();
                pos += 8 + (int64_t)(uint32_t)load_le(src + pos + 4, 4);
                if (pos > len) corrupt();
                continue;
            }
            pos = frame(src, len, pos, out);
        }
    }

  private:
    Huffman huf_;
    bool have_huf_ = false;
    Fse tabs_[3];  // ll, of, ml
    bool have_[3] = {false, false, false};
    int64_t rep_[3] = {1, 4, 8};
    std::vector<uint8_t> lits_;
    std::vector<Seq> seqs_;
    std::vector<int> counts_;

    int64_t frame(const uint8_t* src, int64_t len, int64_t pos, Sink& out) {
        if (pos + 5 > len || (uint32_t)load_le(src + pos, 4) != 0xFD2FB528u) {
            corrupt();
        }
        int fhd = src[pos + 4];
        int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
        if (fhd & 8) corrupt();
        static const int kDidSize[4] = {0, 1, 2, 4};
        int did_size = kDidSize[fhd & 3];
        int fcs_size = fcs_flag ? 1 << fcs_flag : single;
        int64_t at = pos + 5;
        if (pos + 5 + !single + did_size + fcs_size > len) corrupt();
        uint64_t window = 0;
        if (!single) {
            int wd = src[at++];
            uint64_t base = 1ull << (10 + (wd >> 3));
            window = base + (base >> 3) * (wd & 7);
        }
        uint64_t dict_id = load_le(src + at, did_size);
        at += did_size;
        bool has_fcs = fcs_size > 0;
        uint64_t fcs = load_le(src + at, fcs_size) + (fcs_size == 2 ? 256 : 0);
        at += fcs_size;
        if (single) window = fcs;
        if (dict_id) throw ZErr{kDictionary, (int64_t)dict_id};
        bool fits = has_fcs &&
                    (out.grow || fcs <= (uint64_t)(out.limit - out.n));
        if (window > (1ull << kWindowLogLimit) && !fits) {
            throw ZErr{kWindow,
                       (int64_t)std::min<uint64_t>(window, INT64_MAX)};
        }
        int64_t limit = (int64_t)std::min<uint64_t>(window, kBlockMax);
        bool checksum = fhd & 4;
        int64_t start = out.n;
        have_huf_ = false;
        have_[0] = have_[1] = have_[2] = false;
        rep_[0] = 1, rep_[1] = 4, rep_[2] = 8;
        pos = at;
        while (true) {
            if (pos + 3 > len) corrupt();
            uint32_t bh = (uint32_t)load_le(src + pos, 3);
            int last = bh & 1, kind = (bh >> 1) & 3;
            int64_t size = bh >> 3;
            pos += 3;
            if (kind == 3 || size > limit) corrupt();
            if (pos + (kind == 1 ? 1 : size) > len) corrupt();
            if (kind == 0) {
                out.reserve(out.n + size);
                out.put(src + pos, size);
                pos += size;
            } else if (kind == 1) {
                out.reserve(out.n + size);
                out.fill(src[pos], size);
                pos += 1;
            } else {
                if (size < 2) corrupt();
                block(src + pos, size, out, start, limit);
                pos += size;
            }
            if (out.n > out.limit) return len;  // stop: past the cap
            if (last) break;
        }
        int64_t got = out.n - start;
        if (has_fcs && (uint64_t)got != fcs) corrupt();
        if (checksum) {
            if (pos + 4 > len) corrupt();
            uint32_t want = (uint32_t)load_le(src + pos, 4);
            if ((uint32_t)xxh64(out.p + start, got) != want) corrupt();
            pos += 4;
        }
        return pos;
    }

    void block(const uint8_t* p, int64_t n, Sink& out, int64_t start,
               int64_t limit) {
        int64_t at = literals(p, n);
        sequences(p + at, n - at);
        int64_t total = (int64_t)lits_.size();
        for (const Seq& s : seqs_) total += s.ml;
        out.reserve(out.n + std::min(total, limit + (int64_t)lits_.size()));
        int64_t li = 0, nl = (int64_t)lits_.size(), first = out.n;
        for (const Seq& s : seqs_) {
            if (li + s.ll > nl) corrupt();
            out.put(lits_.data() + li, s.ll);
            li += s.ll;
            if (s.off < 1 || s.off > out.n - start) corrupt();
            if (out.n - first + s.ml > limit) corrupt();
            out.match(s.off, s.ml);
        }
        out.put(lits_.data() + li, nl - li);
        if (out.n - first > limit) corrupt();
    }

    // The literals section at p (n bytes: the block) into lits_; returns
    // its size.
    int64_t literals(const uint8_t* p, int64_t n) {
        int b0 = p[0], kind = b0 & 3, fmt = (b0 >> 2) & 3;
        if (kind < 2) {
            static const int kRawHead[4] = {1, 2, 1, 3};
            int hl = kRawHead[fmt];
            if (hl > n) corrupt();
            uint32_t v = (uint32_t)load_le(p, hl);
            int64_t size = hl == 1 ? v >> 3 : v >> 4;
            if (kind == 0) {
                if (hl + size > n) corrupt();
                lits_.assign(p + hl, p + hl + size);
                return hl + size;
            }
            if (hl >= n) corrupt();
            if (size > kBlockMax) corrupt();
            lits_.assign((size_t)size, p[hl]);
            return hl + 1;
        }
        if (n < 5) corrupt();
        static const int kHead[4] = {3, 3, 4, 5}, kBits[4] = {10, 10, 14, 18};
        int hl = kHead[fmt], bits = kBits[fmt];
        uint64_t v = load_le(p, hl);
        int64_t regen = (int64_t)((v >> 4) & ((1u << bits) - 1));
        int64_t comp = (int64_t)(v >> (4 + bits));
        if (regen > kBlockMax) corrupt();
        int64_t pos = hl, stop = hl + comp;
        if (stop > n) corrupt();
        if (kind == 2) {
            pos += read_huffman(p + pos, stop - pos, huf_);
            have_huf_ = true;
        } else if (!have_huf_) {
            corrupt();
        }
        lits_.resize((size_t)regen);
        if (fmt == 0) {
            huffman_stream(p + pos, stop - pos, huf_, regen, lits_.data());
            return stop;
        }
        if (regen < 6 || stop - pos < 10) corrupt();
        int64_t sizes[4];
        for (int i = 0; i < 3; ++i) {
            sizes[i] = (int64_t)load_le(p + pos + 2 * i, 2);
        }
        pos += 6;
        sizes[3] = stop - pos - sizes[0] - sizes[1] - sizes[2];
        if (sizes[3] < 1) corrupt();
        int64_t seg = (regen + 3) / 4;
        for (int i = 0; i < 4; ++i) {
            huffman_stream(p + pos, sizes[i], huf_,
                           i < 3 ? seg : regen - 3 * seg,
                           lits_.data() + i * seg);
            pos += sizes[i];
        }
        return stop;
    }

    // The sequences section p[0, n) into seqs_, the repeat offsets
    // resolved.
    void sequences(const uint8_t* p, int64_t n) {
        seqs_.clear();
        if (n < 1) corrupt();
        int b0 = p[0];
        int64_t pos = 1, count;
        if (b0 == 0) {
            if (pos != n) corrupt();
            return;
        }
        if (b0 == 255) {
            if (pos + 2 > n) corrupt();
            count = p[1] + (p[2] << 8) + 0x7F00;
            pos += 2;
        } else if (b0 >= 128) {
            if (pos >= n) corrupt();
            count = ((b0 - 128) << 8) + p[1];
            pos += 1;
        } else {
            count = b0;
        }
        if (pos >= n) corrupt();
        int modes = p[pos++];
        if (modes & 3) corrupt();
        static const int kMaxSym[3] = {35, 31, 52}, kMaxLog[3] = {9, 8, 9};
        const Predefined& pre = predefined();
        const Fse* defaults[3] = {&pre.ll, &pre.of, &pre.ml};
        for (int k = 0; k < 3; ++k) {
            int mode = (modes >> (6 - 2 * k)) & 3;
            if (mode == 0) {
                tabs_[k] = *defaults[k];
            } else if (mode == 1) {
                if (pos >= n) corrupt();
                if (p[pos] > kMaxSym[k]) corrupt();
                rle_fse(p[pos++], tabs_[k]);
            } else if (mode == 2) {
                int log;
                pos += read_ncount(p + pos, n - pos, kMaxSym[k], kMaxLog[k],
                                   counts_, log);
                build_fse(counts_.data(), (int)counts_.size(), log, tabs_[k]);
            } else if (!have_[k]) {
                corrupt();
            }
            have_[k] = true;
        }
        const Fse &llt = tabs_[0], &oft = tabs_[1], &mlt = tabs_[2];
        Back br(p + pos, n - pos);
        int ls = (int)br.read(llt.log), os = (int)br.read(oft.log),
            ms = (int)br.read(mlt.log);
        seqs_.resize((size_t)count);
        for (int64_t i = 0; i < count; ++i) {
            int of_code = oft.sym[os], ll_code = llt.sym[ls],
                ml_code = mlt.sym[ms];
            int64_t ov = ((int64_t)1 << of_code) + (int64_t)br.read(of_code);
            int64_t ml = ML_BASE[ml_code] + (int64_t)br.read(ML_BITS[ml_code]);
            int64_t ll = LL_BASE[ll_code] + (int64_t)br.read(LL_BITS[ll_code]);
            int64_t off;
            if (ov > 3) {
                off = ov - 3;
                rep_[2] = rep_[1];
                rep_[1] = rep_[0];
                rep_[0] = off;
            } else {
                int64_t k = ov - (ll != 0);
                off = k == 3 ? rep_[0] - 1 : rep_[k];
                if (k == 1) {
                    rep_[1] = rep_[0];
                    rep_[0] = off;
                } else if (k > 1) {
                    rep_[2] = rep_[1];
                    rep_[1] = rep_[0];
                    rep_[0] = off;
                }
            }
            seqs_[i] = Seq{ll, off, ml};
            if (i + 1 < count) {
                ls = llt.base[ls] + (int)br.read(llt.nb[ls]);
                ms = mlt.base[ms] + (int)br.read(mlt.nb[ms]);
                os = oft.base[os] + (int)br.read(oft.nb[os]);
            }
        }
        if (br.pos != 0) corrupt();
    }
};

// Decode src[0, len) into out; returns 0 or a negative code (detail: the
// dictionary ID or the window).
int decode(const uint8_t* src, int64_t len, Sink& out, bool one_frame,
           int64_t* detail) {
    try {
        Decoder d;
        d.run(src, len, out, one_frame);
        return 0;
    } catch (const ZErr& e) {
        if (detail) *detail = e.detail;
        return e.code;
    } catch (const std::bad_alloc&) {
        return kCorrupt;
    }
}

}  // namespace zstd

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

// The bytes of one scan: FF 00 is a data byte FF; any other marker stops
// the data (zeros are read past it), and a restart marker is consumed by
// restart().
struct ScanBytes {
    const uint8_t* p;
    int64_t n, pos = 0;
    bool marker = false;
    uint64_t next() {
        if (marker || pos >= n) return 0;
        uint64_t b = p[pos];
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
        return b;
    }
    // skip what is left of this interval (bytes a corrupt interval did
    // not use; FF 00 is data, FF FF fill), then read the next RSTn marker
    bool skip_to_restart() {
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

// Entropy-coded bytes with the stuffing already removed, 0xFF past the
// end (the DICOM lossless route, as the JAX package's decoder reads
// them).
struct PlainBytes {
    const uint8_t* p;
    int64_t n, pos = 0;
    uint64_t next() { return pos < n ? p[pos++] : (++pos, 0xFFu); }
    bool skip_to_restart() { return false; }
};

// MSB-first Huffman bit reader over a byte source; `used` counts the
// bits consumed.
template <class Src>
struct BitReader {
    Src src;
    uint64_t acc = 0;
    int cnt = 0;
    int64_t used = 0;
    void fill() {
        while (cnt <= 56) {
            acc |= src.next() << (56 - cnt);
            cnt += 8;
        }
    }
    int get(int k) {  // k in 1..16
        if (cnt < k) fill();
        int v = (int)(acc >> (64 - k));
        acc <<= k;
        cnt -= k;
        used += k;
        return v;
    }
    int decode(const Huff& h) {
        if (cnt < 16) fill();
        int e = h.look[acc >> 55];
        if (e) {
            int L = e >> 8;
            acc <<= L;
            cnt -= L;
            used += L;
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
        used += L;
        int idx = h.valptr[L] + code;
        return (idx >= 0 && idx < 256) ? h.vals[idx] : -1;
    }
    // drop the bits left of this interval and read the next RSTn
    bool restart() {
        acc = 0;
        cnt = 0;
        return src.skip_to_restart();
    }
};

using Bits = BitReader<ScanBytes>;

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | next state
// after an MPS << 8 | switch << 7 | next state after an LPS.  State 113
// is the fixed probability 0.5 of the sign and refinement bits.
#define Q(qe, nl, nm, sw) \
    (((uint32_t)(qe) << 16) | ((nm) << 8) | ((sw) << 7) | (nl))
constexpr uint32_t ARITAB[114] = {
    Q(0x5A1D, 1, 1, 1),     Q(0x2586, 14, 2, 0),    Q(0x1114, 16, 3, 0),
    Q(0x080B, 18, 4, 0),    Q(0x03D8, 20, 5, 0),    Q(0x01DA, 23, 6, 0),
    Q(0x00E5, 25, 7, 0),    Q(0x006F, 28, 8, 0),    Q(0x0036, 30, 9, 0),
    Q(0x001A, 33, 10, 0),   Q(0x000D, 35, 11, 0),   Q(0x0006, 9, 12, 0),
    Q(0x0003, 10, 13, 0),   Q(0x0001, 12, 13, 0),   Q(0x5A7F, 15, 15, 1),
    Q(0x3F25, 36, 16, 0),   Q(0x2CF2, 38, 17, 0),   Q(0x207C, 39, 18, 0),
    Q(0x17B9, 40, 19, 0),   Q(0x1182, 42, 20, 0),   Q(0x0CEF, 43, 21, 0),
    Q(0x09A1, 45, 22, 0),   Q(0x072F, 46, 23, 0),   Q(0x055C, 48, 24, 0),
    Q(0x0406, 49, 25, 0),   Q(0x0303, 51, 26, 0),   Q(0x0240, 52, 27, 0),
    Q(0x01B1, 54, 28, 0),   Q(0x0144, 56, 29, 0),   Q(0x00F5, 57, 30, 0),
    Q(0x00B7, 59, 31, 0),   Q(0x008A, 60, 32, 0),   Q(0x0068, 62, 33, 0),
    Q(0x004E, 63, 34, 0),   Q(0x003B, 32, 35, 0),   Q(0x002C, 33, 9, 0),
    Q(0x5AE1, 37, 37, 1),   Q(0x484C, 64, 38, 0),   Q(0x3A0D, 65, 39, 0),
    Q(0x2EF1, 67, 40, 0),   Q(0x261F, 68, 41, 0),   Q(0x1F33, 69, 42, 0),
    Q(0x19A8, 70, 43, 0),   Q(0x1518, 72, 44, 0),   Q(0x1177, 73, 45, 0),
    Q(0x0E74, 74, 46, 0),   Q(0x0BFB, 75, 47, 0),   Q(0x09F8, 77, 48, 0),
    Q(0x0861, 78, 49, 0),   Q(0x0706, 79, 50, 0),   Q(0x05CD, 48, 51, 0),
    Q(0x04DE, 50, 52, 0),   Q(0x040F, 50, 53, 0),   Q(0x0363, 51, 54, 0),
    Q(0x02D4, 52, 55, 0),   Q(0x025C, 53, 56, 0),   Q(0x01F8, 54, 57, 0),
    Q(0x01A4, 55, 58, 0),   Q(0x0160, 56, 59, 0),   Q(0x0125, 57, 60, 0),
    Q(0x00F6, 58, 61, 0),   Q(0x00CB, 59, 62, 0),   Q(0x00AB, 61, 63, 0),
    Q(0x008F, 61, 32, 0),   Q(0x5B12, 65, 65, 1),   Q(0x4D04, 80, 66, 0),
    Q(0x412C, 81, 67, 0),   Q(0x37D8, 82, 68, 0),   Q(0x2FE8, 83, 69, 0),
    Q(0x293C, 84, 70, 0),   Q(0x2379, 86, 71, 0),   Q(0x1EDF, 87, 72, 0),
    Q(0x1AA9, 87, 73, 0),   Q(0x174E, 72, 74, 0),   Q(0x1424, 72, 75, 0),
    Q(0x119C, 74, 76, 0),   Q(0x0F6B, 74, 77, 0),   Q(0x0D51, 75, 78, 0),
    Q(0x0BB6, 77, 79, 0),   Q(0x0A40, 77, 48, 0),   Q(0x5832, 80, 81, 1),
    Q(0x4D1C, 88, 82, 0),   Q(0x438E, 89, 83, 0),   Q(0x3BDD, 90, 84, 0),
    Q(0x34EE, 91, 85, 0),   Q(0x2EAE, 92, 86, 0),   Q(0x299A, 93, 87, 0),
    Q(0x2516, 86, 71, 0),   Q(0x5570, 88, 89, 1),   Q(0x4CA9, 95, 90, 0),
    Q(0x44D9, 96, 91, 0),   Q(0x3E22, 97, 92, 0),   Q(0x3824, 99, 93, 0),
    Q(0x32B4, 99, 94, 0),   Q(0x2E17, 93, 86, 0),   Q(0x56A8, 95, 96, 1),
    Q(0x4F46, 101, 97, 0),  Q(0x47E5, 102, 98, 0),  Q(0x41CF, 103, 99, 0),
    Q(0x3C3D, 104, 100, 0), Q(0x375E, 99, 93, 0),   Q(0x5231, 105, 102, 0),
    Q(0x4C0F, 106, 103, 0), Q(0x4639, 107, 104, 0), Q(0x415E, 103, 99, 0),
    Q(0x5627, 105, 106, 1), Q(0x50E7, 108, 107, 0), Q(0x4B85, 109, 103, 0),
    Q(0x5597, 110, 109, 0), Q(0x504F, 111, 107, 0), Q(0x5A10, 110, 111, 1),
    Q(0x5522, 112, 109, 0), Q(0x59EB, 112, 111, 1), Q(0x5A1D, 113, 113, 0)};
#undef Q

// T.81 Annex D's decoder (jdarith.c's arith_decode) over one scan's
// bytes: zeros past a marker, as libjpeg supplies them.
struct Arith {
    ScanBytes src;
    int64_t c = 0, a = 0;
    int ct = -16;
    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                c = (c << 8) | (int64_t)src.next();
                if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        uint32_t e = ARITAB[sv & 0x7F];
        int64_t qe = e >> 16;
        int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
        a -= qe;
        int64_t temp = a << ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
            a = qe;
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
    bool restart() {
        c = 0;
        a = 0;
        ct = -16;
        return src.skip_to_restart();
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
    int32_t ss, se;        // spectral selection (zigzag positions)
    int32_t ah, al;        // successive approximation bit positions
    uint8_t dc_bits[4][16];
    uint8_t dc_vals[4][256];
    uint8_t ac_bits[4][16];
    uint8_t ac_vals[4][256];
    // arithmetic coding: each component's DC and AC table numbers (0..15)
    // and conditioning (L, U of its DC table, Kx of its AC table)
    int32_t dc_tbl[4], ac_tbl[4];
    int32_t cond_l[4], cond_u[4], cond_k[4];
};

struct MmfJpegFrame {
    int32_t width, height, ncomp;
    int32_t transform;   // YCbCr -> RGB (3 components), YCCK -> CMYK (4)
    int32_t h[4], v[4];
    uint16_t qt[4][64];  // each component's table, natural order
    int32_t nscans, status;
    int32_t progressive;
    int32_t coding;      // 0 Huffman, 1 arithmetic, 2 lossless (Huffman)
    const MmfJpegScan* scans;  // nscans of them
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
    bool box = false;    // replicate, never fancy (lossless frames)
};

// A frame's coefficients of one component (natural order, int16 as
// libjpeg's JCOEF) over its MCU-padded block grid.
struct Coefs {
    std::vector<int16_t> c;
    int64_t across = 0, down = 0;  // the padded grid
    int wb = 0, hb = 0;            // the component's own blocks
    int bits[64];                  // last Al of each coefficient, -1 none
    int16_t* block(int64_t y, int64_t x) {
        return c.data() + (y * across + x) * 64;
    }
};

// One scan: of a sequential frame (jdhuff.c: every coefficient of its
// blocks), or of a progressive one (jdphuff.c): DC first (point
// transform Al) or refinement (one bit a block), AC first over Ss..Se
// with EOB runs, AC refinement.  0, or -2 a bad Huffman table, -3
// corrupt data.
int decode_scan(const MmfJpegFrame& f, const MmfJpegScan& s,
                std::vector<Coefs>& cs, int hmax, int vmax) {
    const bool seq = !f.progressive;
    const bool dc_band = s.ss == 0, first = s.ah == 0;
    Huff dc[4], ac[4];
    for (int k = 0; k < s.ncomp; ++k) {
        if (dc_band && first &&
            !dc[k].build(s.dc_bits[k], s.dc_vals[k])) {
            return -2;
        }
        if ((seq || !dc_band) && !ac[k].build(s.ac_bits[k], s.ac_vals[k])) {
            return -2;
        }
    }
    Bits br{s.data, s.len};
    int64_t pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const int ss = seq ? 1 : s.ss, se = s.se, al = s.al;
    const int p1 = 1 << al, m1 = -p1;
    // one block; false on corrupt data
    auto block = [&](int k, int16_t* b) -> bool {
        if (dc_band) {
            if (!first) {
                if (br.get(1)) b[0] = (int16_t)(b[0] | p1);
                return true;
            }
            int t = br.decode(dc[k]);
            if (t < 0 || t > 16) return false;
            pred[k] += t ? extend(br.get(t), t) : 0;
            b[0] = (int16_t)(pred[k] * p1);
            if (!seq) return true;
        }
        if (first) {
            if (eobrun) {
                --eobrun;
                return true;
            }
            for (int i = ss; i <= se; ++i) {
                int rs = br.decode(ac[k]);
                if (rs < 0) return false;
                int r = rs >> 4, z = rs & 15;
                if (z) {
                    i += r;
                    if (i > se) return false;
                    b[ZZ[i]] = (int16_t)(extend(br.get(z), z) * p1);
                } else if (r == 15) {
                    i += 15;
                } else {
                    if (!seq) {  // EOBr: 2^r + r more bits blocks
                        eobrun = 1 << r;
                        if (r) eobrun += br.get(r);
                        --eobrun;
                    }
                    break;
                }
            }
            return true;
        }
        // AC refinement (decode_mcu_AC_refine)
        int i = ss;
        if (!eobrun) {
            for (; i <= se; ++i) {
                int rs = br.decode(ac[k]);
                if (rs < 0) return false;
                int r = rs >> 4, z = rs & 15, v = 0;
                if (z) {
                    if (z != 1) return false;  // a new coefficient is +-1
                    v = br.get(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    break;
                }
                // past r coefficients still zero, a correction bit on
                // each nonzero one on the way
                bool found = false;
                for (; i <= se; ++i) {
                    int16_t& x = b[ZZ[i]];
                    if (x) {
                        if (br.get(1) && !(x & p1)) {
                            x = (int16_t)(x + (x >= 0 ? p1 : m1));
                        }
                    } else if (--r < 0) {
                        found = true;
                        break;
                    }
                }
                if (!found) {
                    if (v) return false;  // no zero left for the new one
                    break;
                }
                if (v) b[ZZ[i]] = (int16_t)v;
            }
        }
        if (eobrun) {
            for (; i <= se; ++i) {
                int16_t& x = b[ZZ[i]];
                if (x && br.get(1) && !(x & p1)) {
                    x = (int16_t)(x + (x >= 0 ? p1 : m1));
                }
            }
            --eobrun;
        }
        return true;
    };
    int64_t units, across;
    if (s.ncomp == 1) {
        const Coefs& c = cs[s.comp[0]];
        across = c.wb;
        units = across * c.hb;
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
                eobrun = 0;
                left = s.restart;
            }
            --left;
        }
        int64_t my = u / across, mx = u % across;
        if (s.ncomp == 1) {
            if (!block(0, cs[s.comp[0]].block(my, mx))) return -3;
            continue;
        }
        for (int k = 0; k < s.ncomp; ++k) {
            int c = s.comp[k];
            for (int by = 0; by < f.v[c]; ++by) {
                for (int bx = 0; bx < f.h[c]; ++bx) {
                    if (!block(k, cs[c].block(my * f.v[c] + by,
                                              mx * f.h[c] + bx))) {
                        return -3;
                    }
                }
            }
        }
    }
    return 0;
}

// One arithmetic-coded scan (jdarith.c): the statistics bins of each
// table number (64 DC, 256 AC) and the fixed bin, reset with the DC
// predictions and contexts at the start and at each restart; a
// sequential scan, or DC first, DC refinement, AC first, AC refinement.
// 0, or -3 corrupt data (a run past the band, a magnitude past 15 bits).
int decode_scan_arith(const MmfJpegFrame& f, const MmfJpegScan& s,
                      std::vector<Coefs>& cs, int hmax, int vmax) {
    const bool seq = !f.progressive;
    const bool dc_band = s.ss == 0, first = s.ah == 0;
    for (int k = 0; k < s.ncomp; ++k) {
        if (s.dc_tbl[k] < 0 || s.dc_tbl[k] > 15 || s.ac_tbl[k] < 0 ||
            s.ac_tbl[k] > 15) {
            return -1;
        }
    }
    Arith ar{ScanBytes{s.data, s.len}};
    static thread_local uint8_t dc_st[16][64], ac_st[16][256];
    uint8_t fixed = 113;
    int pred[4], ctx[4];
    auto reset = [&]() {
        for (int k = 0; k < s.ncomp; ++k) {
            std::memset(dc_st[s.dc_tbl[k]], 0, 64);
            std::memset(ac_st[s.ac_tbl[k]], 0, 256);
            pred[k] = ctx[k] = 0;
        }
    };
    reset();
    const int ss = seq ? 1 : s.ss, se = s.se, al = s.al;
    const int p1 = 1 << al, m1 = -p1;
    // F.23 / F.24: a nonzero magnitude from bin `at` of st (AC: a second
    // decision there, then bins ac_base on; DC, ac_base < 0: bins 20 on);
    // 0 on a magnitude past 15 bits
    auto value = [&](uint8_t* st, int at, int ac_base) -> int {
        int m = ar.decode(st + at);
        if (m) {
            int more;
            if (ac_base < 0) {
                at = 20;
                more = ar.decode(st + at);
            } else {
                more = ar.decode(st + at);
                if (more) {
                    m = 2;
                    at = ac_base;
                    more = ar.decode(st + at);
                }
            }
            while (more) {
                if ((m <<= 1) == 0x8000) return 0;
                more = ar.decode(st + ++at);
            }
        }
        int v = m;
        at += 14;
        while (m >>= 1) {
            if (ar.decode(st + at)) v |= m;
        }
        return v + 1;
    };
    auto block = [&](int k, int16_t* b) -> bool {
        if (dc_band && !first) {
            if (ar.decode(&fixed)) b[0] = (int16_t)(b[0] | p1);
            return true;
        }
        if (dc_band) {
            uint8_t* st = dc_st[s.dc_tbl[k]];
            if (!ar.decode(st + ctx[k])) {
                ctx[k] = 0;
            } else {
                int sign = ar.decode(st + ctx[k] + 1);
                int v = value(st, ctx[k] + 2 + sign, -1);
                if (!v) return false;
                int m = v - 1 ? 1 << (31 - __builtin_clz(v - 1)) : 0;
                ctx[k] = m < (1 << s.cond_l[k]) >> 1   ? 0
                         : m > (1 << s.cond_u[k]) >> 1 ? 12 + 4 * sign
                                                       : 4 + 4 * sign;
                pred[k] = (pred[k] + (sign ? -v : v)) & 0xFFFF;
            }
            b[0] = (int16_t)(pred[k] << al);
            if (!seq) return true;
        }
        uint8_t* st = ac_st[s.ac_tbl[k]];
        if (first) {
            for (int i = ss; i <= se; ++i) {
                int at = 3 * (i - 1);
                if (ar.decode(st + at)) break;  // EOB
                while (!ar.decode(st + at + 1)) {
                    at += 3;
                    if (++i > se) return false;
                }
                int sign = ar.decode(&fixed);
                int v = value(st, at + 2, i <= s.cond_k[k] ? 189 : 217);
                if (!v) return false;
                b[ZZ[i]] = (int16_t)((unsigned)(sign ? -v : v) << al);
            }
            return true;
        }
        // AC refinement (decode_mcu_AC_refine)
        int kex = se;
        while (kex > 0 && !b[ZZ[kex]]) --kex;
        for (int i = ss; i <= se; ++i) {
            int at = 3 * (i - 1);
            if (i > kex && ar.decode(st + at)) break;  // EOB
            for (;;) {
                int16_t& x = b[ZZ[i]];
                if (x) {
                    if (ar.decode(st + at + 2)) {
                        x = (int16_t)(x + (x < 0 ? m1 : p1));
                    }
                    break;
                }
                if (ar.decode(st + at + 1)) {
                    x = (int16_t)(ar.decode(&fixed) ? m1 : p1);
                    break;
                }
                at += 3;
                if (++i > se) return false;
            }
        }
        return true;
    };
    int64_t units, across;
    if (s.ncomp == 1) {
        const Coefs& c = cs[s.comp[0]];
        across = c.wb;
        units = across * c.hb;
    } else {
        across = (f.width + 8 * hmax - 1) / (8 * hmax);
        units = across * ((f.height + 8 * vmax - 1) / (8 * vmax));
    }
    int left = s.restart;
    for (int64_t u = 0; u < units; ++u) {
        if (s.restart) {
            if (!left) {
                if (!ar.restart()) return -3;
                reset();
                left = s.restart;
            }
            --left;
        }
        int64_t my = u / across, mx = u % across;
        if (s.ncomp == 1) {
            if (!block(0, cs[s.comp[0]].block(my, mx))) return -3;
            continue;
        }
        for (int k = 0; k < s.ncomp; ++k) {
            int c = s.comp[k];
            for (int by = 0; by < f.v[c]; ++by) {
                for (int bx = 0; bx < f.h[c]; ++bx) {
                    if (!block(k, cs[c].block(my * f.v[c] + by,
                                              mx * f.h[c] + bx))) {
                        return -3;
                    }
                }
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------- lossless

// A component of a lossless scan: its Huffman table, its samples in an
// MCU (h x v; 1 x 1 in a one-component scan), its own size and its
// output samples (rows x cols, rows `stride` apart).
struct LosslessComp {
    const Huff* huff;
    int h, v;
    int64_t rows, cols;
    uint16_t* out;
    int64_t stride;
};

// One lossless scan (T.81 process 14, Huffman coding; libjpeg-turbo 3.x's
// jdlhuff.c, jddiffct.c and jdlossls.c), the one predictor loop of the
// port: the JPEG frames of mmf_jpeg_decode and the DICOM frames of
// mmf_jpeg_lossless_decode.  The differences of each MCU row in MCU
// order (SSSS 16 is 32768), then each component's rows of that MCU row
// undifferenced over its own width: the first row of the scan and of each
// restart interval (`rows_per` MCU rows, 0 for none) from the left, its
// first sample from `initial`; the first column from above; the rest by
// predictor psv (T.81 Table H.1); modulo 2^16.  MCU padding is decoded
// and dropped.  0, or -1 a bad code, -2 more than `limit` bits used, -3 a
// predictor other than 1..7 met, or a missing restart marker.
template <class Reader>
int lossless_scan(Reader& br, const LosslessComp* comps, int ncomp,
                  int64_t mx, int64_t my, int psv, int initial,
                  int64_t rows_per, int64_t limit) {
    std::vector<std::vector<int32_t>> diff(ncomp);
    for (int k = 0; k < ncomp; ++k) {
        diff[k].assign((size_t)(comps[k].v * mx * comps[k].h), 0);
    }
    for (int64_t r = 0; r < my; ++r) {
        if (r && rows_per && r % rows_per == 0 && !br.restart()) return -3;
        for (int64_t x = 0; x < mx; ++x) {
            for (int k = 0; k < ncomp; ++k) {
                const LosslessComp& c = comps[k];
                int32_t* d = diff[k].data() + x * c.h;
                for (int yy = 0; yy < c.v; ++yy) {
                    for (int xx = 0; xx < c.h; ++xx) {
                        int t = br.decode(*c.huff);
                        if (t < 0 || t > 16) return -1;
                        int v = t == 16 ? 32768 : t ? extend(br.get(t), t) : 0;
                        if (br.used > limit) return -2;
                        d[yy * mx * c.h + xx] = v;
                    }
                }
            }
        }
        for (int k = 0; k < ncomp; ++k) {
            const LosslessComp& c = comps[k];
            for (int yy = 0; yy < c.v; ++yy) {
                int64_t y = r * c.v + yy;
                if (y >= c.rows) break;
                uint16_t* cur = c.out + y * c.stride;
                const uint16_t* prev = cur - c.stride;
                const int32_t* d = diff[k].data() + yy * mx * c.h;
                bool top = rows_per ? y % (rows_per * c.v) == 0 : y == 0;
                for (int64_t x = 0; x < c.cols; ++x) {
                    int pred;
                    if (top) {
                        pred = x ? cur[x - 1] : initial;
                    } else if (x == 0) {
                        pred = prev[0];
                    } else {
                        int ra = cur[x - 1], rb = prev[x], rc = prev[x - 1];
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
                    cur[x] = (uint16_t)((pred + d[x]) & 0xFFFF);
                }
            }
        }
    }
    return 0;
}

// Every scan of a lossless frame into its component's samples: (sample
// << Pt) kept to 8 bits (jdlossls.c's scaler and JSAMPLE), replicated when
// upsampled.  0, or -1 a frame this decoder does not take, -2 a bad
// Huffman table, -3 corrupt data.
int decode_lossless(const MmfJpegFrame& f, std::vector<Plane>& planes,
                    int hmax, int vmax) {
    std::vector<std::vector<uint16_t>> work(f.ncomp);
    std::vector<int> pt(f.ncomp, 0);
    for (int c = 0; c < f.ncomp; ++c) {
        work[c].assign((size_t)planes[c].dw * planes[c].dh, 0);
    }
    for (int si = 0; si < f.nscans; ++si) {
        const MmfJpegScan& s = f.scans[si];
        if (s.al < 0 || s.al > 7) return -1;
        const bool one = s.ncomp == 1;
        Huff huff[4];
        LosslessComp lc[4];
        for (int k = 0; k < s.ncomp; ++k) {
            int c = s.comp[k];
            if (!huff[k].build(s.dc_bits[k], s.dc_vals[k])) return -2;
            lc[k] = LosslessComp{&huff[k], one ? 1 : f.h[c],
                                 one ? 1 : f.v[c], planes[c].dh,
                                 planes[c].dw, work[c].data(),
                                 planes[c].dw};
            pt[c] = s.al;
        }
        int64_t mx = one ? planes[s.comp[0]].dw : (f.width + hmax - 1) / hmax;
        int64_t my =
            one ? planes[s.comp[0]].dh : (f.height + vmax - 1) / vmax;
        if (s.restart % mx) return -1;
        Bits br{ScanBytes{s.data, s.len}};
        int rc = lossless_scan(br, lc, s.ncomp, mx, my, s.ss, 1 << (7 - s.al),
                               s.restart / mx, INT64_MAX);
        if (rc) return -3;
    }
    for (int c = 0; c < f.ncomp; ++c) {
        Plane& p = planes[c];
        p.stride = p.dw;
        p.box = true;
        p.px.resize(work[c].size());
        for (size_t i = 0; i < work[c].size(); ++i) {
            p.px[i] = (uint8_t)(work[c][i] << pt[c]);
        }
    }
    return 0;
}

// zigzag positions 1..9 in natural order: the coefficients block
// smoothing estimates (AC01, AC10, AC20, AC11, AC02, AC03, AC12, AC21,
// AC30)
constexpr int SMOOTH_NAT[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};

// jdcoefct.c's smoothing_ok after the last scan: a progressive frame
// whose every component has its DC scan and nonzero DC and first 9 AC
// quantisers, and a coefficient among zigzag 1..9 of some component is
// not fully refined.
bool smoothing_on(const MmfJpegFrame& f, const std::vector<Coefs>& cs) {
    if (!f.progressive) return false;
    bool useful = false;
    for (int c = 0; c < f.ncomp; ++c) {
        if (!f.qt[c][0] || cs[c].bits[0] < 0) return false;
        for (int k = 0; k < 9; ++k) {
            if (!f.qt[c][SMOOTH_NAT[k]]) return false;
            if (cs[c].bits[k + 1]) useful = true;
        }
    }
    return useful;
}

// An estimate num / (q << 8), rounded half away from zero, clamped below
// 2^Al when Al > 0.
inline int smooth_pred(int64_t num, int64_t q, int al) {
    int64_t p = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
    if (al > 0 && p >= (1 << al)) p = (1 << al) - 1;
    return (int)(num < 0 ? -p : p);
}

// Block row `row` of component c, smoothed as decompress_smooth_data
// (libjpeg-turbo 3.x) smooths it when `smooth`, through the IDCT into
// its plane.  rows5: the 5 block rows read (two above .. two below);
// cols5: the 5 block columns of each block's sliding registers.
void idct_block_row(const MmfJpegFrame& f, int c, Coefs& cf, Plane& p,
                    int64_t row, bool smooth, const int64_t* rows5,
                    const std::vector<int64_t>& cols5) {
    int32_t ws[64];
    const uint16_t* q = f.qt[c];
    const int* bits = cf.bits;
    bool change_dc = true;
    for (int k = 1; k <= 9; ++k) change_dc = change_dc && bits[k] == -1;
    const int64_t Q00 = q[0];
    for (int64_t x = 0; x < cf.across; ++x) {
        const int16_t* b = cf.block(row, x);
        for (int i = 0; i < 64; ++i) ws[i] = b[i];
        if (smooth && row < cf.hb && x < cf.wb) {
            int64_t D[5][5];
            for (int i = 0; i < 5; ++i) {
                for (int j = 0; j < 5; ++j) {
                    D[i][j] = cf.block(rows5[i], cols5[x * 5 + j])[0];
                }
            }
#define DC(n) D[((n) - 1) / 5][((n) - 1) % 5]
            int64_t num[9];
            if (change_dc) {
                num[0] = -DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) +
                         13 * DC(7) - 13 * DC(9) + 3 * DC(10) - 3 * DC(11) +
                         38 * DC(12) - 38 * DC(14) + 3 * DC(15) -
                         3 * DC(16) + 13 * DC(17) - 13 * DC(19) +
                         3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25);
                num[1] = -DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) -
                         DC(5) - DC(6) + 13 * DC(7) + 38 * DC(8) +
                         13 * DC(9) - DC(10) + DC(16) - 13 * DC(17) -
                         38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
                         3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25);
                num[2] = DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) -
                         5 * DC(12) - 14 * DC(13) - 5 * DC(14) +
                         2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23);
                num[3] = -DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) -
                         9 * DC(17) + 9 * DC(19) + DC(21) - DC(25);
                num[4] = 2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) +
                         7 * DC(12) - 14 * DC(13) + 7 * DC(14) + DC(15) +
                         2 * DC(17) - 5 * DC(18) + 2 * DC(19);
                num[5] = DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) -
                         DC(19);
                num[6] = DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) -
                         DC(19);
                num[7] = DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) -
                         DC(19);
                num[8] = DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) -
                         DC(19);
            } else {
                num[0] = -7 * DC(11) + 50 * DC(12) - 50 * DC(14) +
                         7 * DC(15);
                num[1] = -7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23);
                num[2] = -DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) -
                         DC(23);
                num[3] = DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) -
                         DC(2) - DC(20) + DC(22) - DC(24) + DC(4) - DC(6) +
                         10 * DC(7) - 10 * DC(9);
                num[4] = -DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) -
                         DC(15);
            }
            int n_est = change_dc ? 9 : 5;
            for (int k = 0; k < n_est; ++k) {
                int pos = SMOOTH_NAT[k], al = bits[k + 1];
                if (al != 0 && ws[pos] == 0) {
                    ws[pos] = (int16_t)smooth_pred(Q00 * num[k], q[pos], al);
                }
            }
            if (change_dc) {
                int64_t n0 =
                    -2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) -
                    2 * DC(5) - 6 * DC(6) + 6 * DC(7) + 42 * DC(8) +
                    6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12) +
                    152 * DC(13) + 42 * DC(14) - 8 * DC(15) - 6 * DC(16) +
                    6 * DC(17) + 42 * DC(18) + 6 * DC(19) - 6 * DC(20) -
                    2 * DC(21) - 6 * DC(22) - 8 * DC(23) - 6 * DC(24) -
                    2 * DC(25);
                ws[0] = (int16_t)smooth_pred(Q00 * n0, Q00, 0);
            }
#undef DC
        }
        idct_islow(ws, q, p.px.data() + row * 8 * p.stride + x * 8,
                   p.stride);
    }
}

// Every scan into the coefficient arrays, then (a progressive frame's
// smoothing and) the IDCT in block rows across the threads.
int decode_coefficients(const MmfJpegFrame& f, std::vector<Plane>& planes,
                        int hmax, int vmax, int n_threads) {
    std::vector<Coefs> cs(f.ncomp);
    for (int c = 0; c < f.ncomp; ++c) {
        Coefs& cf = cs[c];
        cf.across = planes[c].stride / 8;
        cf.down = (int64_t)(planes[c].px.size() / planes[c].stride) / 8;
        cf.wb = (planes[c].dw + 7) / 8;
        cf.hb = (planes[c].dh + 7) / 8;
        cf.c.assign((size_t)(cf.across * cf.down * 64), 0);
        for (int k = 0; k < 64; ++k) cf.bits[k] = -1;
    }
    for (int si = 0; si < f.nscans; ++si) {
        const MmfJpegScan& s = f.scans[si];
        bool dc_band = s.ss == 0;
        if (f.progressive
                ? (s.se < s.ss || s.se > 63 || (dc_band && s.se != 0) ||
                   (!dc_band && s.ncomp != 1) || s.al < 0 || s.al > 13 ||
                   (s.ah && s.al != s.ah - 1))
                : (s.ss != 0 || s.se != 63 || s.ah != 0 || s.al != 0)) {
            return -1;
        }
        int rc = f.coding == 1 ? decode_scan_arith(f, s, cs, hmax, vmax)
                               : decode_scan(f, s, cs, hmax, vmax);
        if (rc) return rc;
        for (int k = 0; k < s.ncomp; ++k) {
            for (int i = s.ss; i <= s.se; ++i) cs[s.comp[k]].bits[i] = s.al;
        }
    }
    const bool smooth = smoothing_on(f, cs);
    // each component's 5 rows and columns of the smoothing window
    int64_t total = (f.height + 8 * vmax - 1) / (8 * vmax);
    std::vector<std::vector<int64_t>> rows(f.ncomp), cols(f.ncomp);
    std::vector<std::pair<int, int64_t>> tasks;
    for (int c = 0; c < f.ncomp; ++c) {
        const Coefs& cf = cs[c];
        for (int64_t r = 0; r < cf.down; ++r) tasks.emplace_back(c, r);
        if (!smooth) continue;
        int v = f.v[c];
        rows[c].resize((size_t)cf.down * 5);
        for (int64_t r = 0; r < cf.down; ++r) {
            int64_t* o = rows[c].data() + r * 5;
            int64_t i = r / v, br = r % v;
            int64_t nr = i < total - 1 ? v : (cf.hb % v ? cf.hb % v : v);
            int64_t ibr = i * nr + br, ibrs = nr * total;
            o[2] = r;
            o[1] = ibr > 0 ? r - 1 : r;
            o[0] = ibr > 1 ? r - 2 : o[1];
            o[3] = ibr < ibrs - 1 ? r + 1 : r;
            o[4] = ibr < ibrs - 2 ? r + 2 : o[3];
        }
        // the sliding registers of decompress_smooth_data
        cols[c].resize((size_t)cf.across * 5);
        int64_t reg[5] = {0, 0, 0, 0, 0}, last = cf.wb - 1;
        for (int64_t b = 0; b < cf.across; ++b) {
            if (b < cf.wb) {
                if (b == 0 && b < last) reg[3] = reg[4] = 1;
                if (b + 1 < last) reg[4] = b + 2;
                for (int j = 0; j < 5; ++j) cols[c][b * 5 + j] = reg[j];
                for (int j = 0; j < 4; ++j) reg[j] = reg[j + 1];
            } else {
                for (int j = 0; j < 5; ++j) cols[c][b * 5 + j] = b;
            }
        }
    }
    parallel_for((int64_t)tasks.size(), n_threads, [&](int64_t t) {
        int c = tasks[t].first;
        int64_t r = tasks[t].second;
        bool sm = smooth && r < cs[c].hb;
        idct_block_row(f, c, cs[c], planes[c], r, sm,
                       sm ? rows[c].data() + r * 5 : nullptr, cols[c]);
    });
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
    } else if (p.box) {
        const uint8_t* in = px + (int64_t)(y / p.rv) * p.stride;
        for (int x = 0; x < cols; ++x) row[x] = in[x / p.rh];
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
        } else if (nc == 4) {
            // CMYK, or YCCK (ycck_cmyk_convert: 255 - R, G, B, K through);
            // inverted, as PIL's "CMYK;I" holds them
            const uint8_t* a = rows.data();
            for (int x = 0; x < cols; ++x) {
                uint8_t px[4] = {a[x], a[cols + x], a[2 * cols + x],
                                 a[3 * cols + x]};
                if (f.transform) {
                    int yy = px[0], cb = px[1], cr = px[2];
                    px[0] = clamp255(255 - (yy + ct.cr_r[cr]));
                    px[1] = clamp255(
                        255 - (yy + (int)((ct.cb_g[cb] + ct.cr_g[cr]) >> 16)));
                    px[2] = clamp255(255 - (yy + ct.cb_b[cb]));
                }
                for (int c = 0; c < 4; ++c) o[4 * x + c] = (uint8_t)(255 - px[c]);
            }
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
    if (f.ncomp != 1 && f.ncomp != 3 && f.ncomp != 4) return -1;
    if (f.coding < 0 || f.coding > 2 || (f.coding == 2 && f.progressive)) {
        return -1;
    }
    if (f.out_rows > f.height || f.out_cols > f.width || f.out_rows < 0 ||
        f.out_cols < 0 || f.nscans < 1 || !f.scans) {
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
    }
    int rc = f.coding == 2
                 ? decode_lossless(f, planes, hmax, vmax)
                 : decode_coefficients(f, planes, hmax, vmax, n_threads);
    if (rc) return rc;
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

// JPEG Lossless (T.81 process 14: DICOM's …1.2.4.70 SV1 syntax and
// …1.2.4.57 with any SV 1..7) of one one-component frame without restart
// intervals, as the JAX package's native/bagio.cpp decodes it: the
// entropy-coded bytes with the stuffing removed (0xFF past them; more
// bits than they hold is an error), the DHT's 16 code counts and its
// symbols (their lengths checked by the caller), the predictor and the
// first sample's prediction, into out (rows x cols, before the point
// transform), through lossless_scan.  Returns 0, -1 a bad Huffman table
// or code, -2 a truncated stream, -3 a predictor other than 1..7.
int mmf_jpeg_lossless_decode(const uint8_t* entropy, int64_t n_bytes,
                             const uint8_t* counts, const uint8_t* symbols,
                             int rows, int cols, int psv, int default_pred,
                             uint16_t* out) {
    int n = 0;
    for (int i = 0; i < 16; ++i) n += counts[i];
    if (n > 256) return -1;
    uint8_t vals[256] = {0};
    std::memcpy(vals, symbols, (size_t)n);
    Huff h;
    if (!h.build(counts, vals)) return -1;
    BitReader<PlainBytes> br{PlainBytes{entropy, n_bytes}};
    LosslessComp c{&h, 1, 1, rows, cols, out, cols};
    return lossless_scan(br, &c, 1, cols, rows, psv, default_pred, 0,
                         n_bytes * 8);
}

// Decode n TIFF chunks (codec 5: LZW, 32773: PackBits, 50000: ZSTD, the
// first frame of each, as libtiff reads it) from srcs[i] (lens[i] bytes)
// into dsts[i] (caps[i] bytes), in parallel threads; outs[i] gets the
// bytes written, or a negative code for a chunk that fails (-1
// malformed; ZSTD also -2, a frame that names a dictionary, and -3, a
// window over 2^27).  Returns 0, or -2 for an unknown codec.
int mmf_tiff_chunks_decode(int codec, const uint8_t** srcs,
                           const int64_t* lens, uint8_t** dsts,
                           const int64_t* caps, int64_t* outs, int64_t n,
                           int n_threads) {
    if (codec != 5 && codec != 32773 && codec != 50000) return -2;
    parallel_for(n, n_threads, [&](int64_t i) {
        if (codec == 50000) {
            zstd::Sink out{dsts[i], caps[i], caps[i], 0, false};
            int rc = zstd::decode(srcs[i], lens[i], out, true, nullptr);
            outs[i] = rc ? rc : std::min(out.n, caps[i]);
        } else {
            outs[i] = codec == 5 ? lzw_decode(srcs[i], lens[i], dsts[i],
                                              caps[i])
                                 : packbits_decode(srcs[i], lens[i], dsts[i],
                                                   caps[i]);
        }
    });
    return 0;
}

// Every Zstandard frame of src[0, len) (utils/zstd.py's decompress,
// without a cap) into a buffer of its own: *out (free it with
// mmf_zstd_free) and *out_len.  Returns 0, -1 for a corrupt stream, -2
// for a frame that names a dictionary or -3 for a window over 2^27
// (*detail: the ID or the window).
int mmf_zstd_decode(const uint8_t* src, int64_t len, uint8_t** out,
                    int64_t* out_len, int64_t* detail) {
    zstd::Sink sink{nullptr, 0, INT64_MAX, 0, true};
    int rc = zstd::decode(src, len, sink, false, detail);
    if (rc) {
        std::free(sink.p);
        *out = nullptr;
        *out_len = 0;
        return rc;
    }
    *out = sink.p;
    *out_len = sink.n;
    return 0;
}

void mmf_zstd_free(void* p) { std::free(p); }

// Decode the LZF stream src[0, len) into out (at most cap bytes), setting
// *out_len.  Returns 0, -1 when the input ends inside an instruction or a
// reference reaches before the output's start, -2 when the output would
// pass cap.
int mmf_lzf_decode(const uint8_t* src, int64_t len, uint8_t* out,
                   int64_t cap, int64_t* out_len) {
    int64_t i = 0, o = 0;
    *out_len = 0;
    while (i < len) {
        unsigned ctrl = src[i++];
        if (ctrl < 32) {
            int64_t run = (int64_t)ctrl + 1;
            if (o + run > cap) return -2;
            if (i + run > len) return -1;
            std::memcpy(out + o, src + i, (size_t)run);
            i += run;
            o += run;
            continue;
        }
        int64_t n = ctrl >> 5;
        if (i >= len) return -1;
        if (n == 7) {
            n += src[i++];
            if (i >= len) return -1;
        }
        int64_t ref = o - (int64_t)((ctrl & 31) << 8) - 1 - src[i++];
        n += 2;
        if (o + n > cap) return -2;
        if (ref < 0) return -1;
        for (int64_t k = 0; k < n; ++k) out[o + k] = out[ref + k];
        o += n;
    }
    *out_len = o;
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
