// JPEG 2000 hot loops of the PyTorch port (utils/j2k.py holds their plain
// versions; the tests and chip_smoke.py hold this code to them bit for
// bit, corrupt streams included).  The JAX package reads and writes JPEG
// 2000 through PIL's openjpeg; these follow openjpeg 2.5.
//
// mmf_j2k_decode_blocks: tier 1 of many code-blocks (the MQ and raw
// decoders, the significance, refinement and cleanup passes with every
// code-block style bit, the ROI shift), then each block's coefficients
// halved toward zero (5/3) or times its band's half step (9/7) into the
// tile-component; one block at a time per thread.
//
// mmf_j2k_idwt: the inverse 5/3 (integer) or 9/7 (float32, openjpeg's
// lifting order and constants) DWT of one tile-component in place, each
// level's rows, then its columns, split across threads.
//
// mmf_j2k_encode_blocks: tier 1 of many code-blocks for the lossless
// encoder, every pass of every bit-plane, with openjpeg's terminations.
//
// Built at first use by multimodalfusion_tpu_torch/native.py:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o j2k.so j2k.cpp
// The 9/7 lifting must round as the plain float32 numpy version does, so
// no multiply-add is fused there (fp-contract off around it).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
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

// ------------------------------------------------------------ MQ tables

const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
    18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum { CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, N_CTX = 19 };
enum { LAZY = 1, RESET = 2, TERMALL = 4, VSC = 8, PTERM = 16, SEGSYM = 32 };

struct Contexts {
    uint8_t state[N_CTX];
    uint8_t mps[N_CTX];
    void reset() {
        std::memset(state, 0, sizeof state);
        std::memset(mps, 0, sizeof mps);
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[0] = 4;
    }
};

// zero-coding context by orientation and neighbour state h + 3 v + 9 d
uint8_t ZC[4][45];
// sign context and xor bit by (h + 1) * 3 + (v + 1)
const uint8_t SC_CTX[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
const uint8_t SC_XOR[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

struct ZcInit {
    ZcInit() {
        for (int o = 0; o < 4; ++o) {
            for (int s = 0; s < 45; ++s) {
                int h = s % 3, v = (s / 3) % 3, d = s / 9, n;
                if (o == 1) std::swap(h, v);
                if (o == 3) {
                    int hv = h + v;
                    if (d >= 3) n = 8;
                    else if (d == 2) n = hv >= 1 ? 7 : 6;
                    else if (d == 1) n = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
                    else n = hv >= 2 ? 2 : hv;
                } else if (h == 2) {
                    n = 8;
                } else if (h == 1) {
                    n = v ? 7 : (d ? 6 : 5);
                } else if (v) {
                    n = v == 2 ? 4 : 3;
                } else {
                    n = d >= 2 ? 2 : d;
                }
                ZC[o][s] = (uint8_t)n;
            }
        }
    }
} zc_init;

// ------------------------------------------------------------ decoders

struct MQDec {
    const uint8_t* buf;  // the segment, then 0xFF 0xFF
    int64_t bp;
    uint32_t a, c;
    int ct;
    void bytein() {
        if (buf[bp] == 0xFF) {
            if (buf[bp + 1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                ++bp;
                c += (uint32_t)buf[bp] << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += (uint32_t)buf[bp] << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* b, int64_t len) {
        buf = b;
        a = 0x8000;
        if (len == 0) {
            c = 0xFFu << 16;
            bp = 0;
        } else {
            c = (uint32_t)buf[0] << 16;
            bp = 0;
        }
        ct = 0;
        bytein();
        c <<= 7;
        ct -= 7;
    }
    int decode(Contexts& cx, int k) {
        int st = cx.state[k];
        uint32_t qe = QE[st];
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                a = qe;
                d = cx.mps[k];
                cx.state[k] = NMPS[st];
            } else {
                a = qe;
                d = 1 - cx.mps[k];
                if (SWITCH[st]) cx.mps[k] = (uint8_t)d;
                cx.state[k] = NLPS[st];
            }
        } else {
            c -= qe << 16;
            if (a & 0x8000) return cx.mps[k];
            if (a < qe) {
                d = 1 - cx.mps[k];
                if (SWITCH[st]) cx.mps[k] = (uint8_t)d;
                cx.state[k] = NLPS[st];
            } else {
                d = cx.mps[k];
                cx.state[k] = NMPS[st];
            }
        }
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
        return d;
    }
};

struct RawDec {
    const uint8_t* buf;
    int64_t bp;
    uint32_t c;
    int ct;
    void init(const uint8_t* b) {
        buf = b;
        bp = 0;
        c = 0;
        ct = 0;
    }
    int bit() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (buf[bp] > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = buf[bp++];
                    ct = 7;
                }
            } else {
                c = buf[bp++];
                ct = 8;
            }
        }
        --ct;
        return (int)((c >> ct) & 1u);
    }
};

// The significance state of one code-block, padded by one sample.
struct Grid {
    int w, h, W;
    bool vsc;
    std::vector<uint8_t> sig, neg, nbr, vis, refd;
    void init(int w_, int h_, bool vsc_) {
        w = w_;
        h = h_;
        W = w + 2;
        vsc = vsc_;
        size_t n = (size_t)W * (h + 2);
        sig.assign(n, 0);
        neg.assign(n, 0);
        nbr.assign(n, 0);
        vis.assign(n, 0);
        refd.assign(n, 0);
    }
    void make_sig(int64_t i, int y, int s) {
        sig[i] = 1;
        neg[i] = (uint8_t)s;
        nbr[i - 1] += 1;
        nbr[i + 1] += 1;
        nbr[i + W] += 3;
        nbr[i + W - 1] += 9;
        nbr[i + W + 1] += 9;
        if (!(vsc && (y & 3) == 0)) {
            nbr[i - W] += 3;
            nbr[i - W - 1] += 9;
            nbr[i - W + 1] += 9;
        }
    }
    int sign_index(int64_t i, int y) const {
        int hc = sig[i - 1] * (1 - 2 * neg[i - 1]) +
                 sig[i + 1] * (1 - 2 * neg[i + 1]);
        int vc = sig[i - W] * (1 - 2 * neg[i - W]);
        if (!(vsc && (y & 3) == 3)) vc += sig[i + W] * (1 - 2 * neg[i + W]);
        hc = hc > 0 ? 1 : (hc < 0 ? -1 : 0);
        vc = vc > 0 ? 1 : (vc < 0 ? -1 : 0);
        return (hc + 1) * 3 + vc + 1;
    }
};

}  // namespace

extern "C" {

// One code-block to decode (utils/j2k.py _CBlock must match).
struct MmfJ2kBlock {
    const uint8_t* data;
    int64_t len;
    const int32_t* seg_len;
    const int32_t* seg_passes;
    int32_t nsegs;
    int32_t w, h, orient, bpno, numbps, roishift, style, reversible;
    float stepsize;
    void* out;
    int64_t out_stride;  // elements
    int32_t status;
};

int64_t mmf_j2k_block_size() { return (int64_t)sizeof(MmfJ2kBlock); }

}  // extern "C"

namespace {

void decode_block(MmfJ2kBlock& b) {
    const int w = b.w, h = b.h;
    Grid g;
    g.init(w, h, (b.style & VSC) != 0);
    const int W = g.W;
    std::vector<int32_t> val((size_t)W * (h + 2), 0);
    Contexts cx;
    cx.reset();
    const uint8_t* zc = ZC[b.orient & 3];
    int bpno = b.bpno, passtype = 2;
    std::vector<uint8_t> buf;
    int64_t seg_pos = 0;
    MQDec mq;
    RawDec rd;
    for (int s = 0; s < b.nsegs; ++s) {
        int64_t sl = b.seg_len[s];
        int64_t avail = std::max<int64_t>(0, std::min(sl, b.len - seg_pos));
        buf.assign((size_t)avail + 2, 0xFF);
        if (avail) std::memcpy(buf.data(), b.data + seg_pos, (size_t)avail);
        seg_pos += sl;
        bool raw = bpno <= b.numbps - 4 && passtype < 2 && (b.style & LAZY);
        if (raw) {
            rd.init(buf.data());
        } else {
            mq.init(buf.data(), avail);
            if (avail == 0) mq.bp = 0;
        }
        for (int k = 0; k < b.seg_passes[s]; ++k) {
            if (bpno < 1) break;
            const int32_t one = (int32_t)1 << bpno, half = one >> 1,
                          oph = one | half;
            if (passtype == 0) {
                for (int y0 = 0; y0 < h; y0 += 4) {
                    for (int x = 0; x < w; ++x) {
                        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
                            int64_t i = (int64_t)(y + 1) * W + x + 1;
                            if (g.sig[i] || !g.nbr[i]) continue;
                            if (raw) {
                                if (rd.bit()) {
                                    int sg = rd.bit();
                                    val[i] = sg ? -oph : oph;
                                    g.make_sig(i, y, sg);
                                }
                            } else if (mq.decode(cx, zc[g.nbr[i]])) {
                                int si = g.sign_index(i, y);
                                int sg = mq.decode(cx, SC_CTX[si]) ^ SC_XOR[si];
                                val[i] = sg ? -oph : oph;
                                g.make_sig(i, y, sg);
                            }
                            g.vis[i] = 1;
                        }
                    }
                }
            } else if (passtype == 1) {
                for (int y0 = 0; y0 < h; y0 += 4) {
                    for (int x = 0; x < w; ++x) {
                        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
                            int64_t i = (int64_t)(y + 1) * W + x + 1;
                            if (!g.sig[i] || g.vis[i]) continue;
                            int v;
                            if (raw) {
                                v = rd.bit();
                            } else {
                                v = mq.decode(cx, g.refd[i] ? CTX_MAG + 2
                                                  : (g.nbr[i] ? CTX_MAG + 1
                                                              : CTX_MAG));
                            }
                            val[i] += (v ^ (val[i] < 0)) ? half : -half;
                            g.refd[i] = 1;
                        }
                    }
                }
            } else {
                for (int y0 = 0; y0 < h; y0 += 4) {
                    const bool full = y0 + 4 <= h;
                    for (int x = 0; x < w; ++x) {
                        int64_t i0 = (int64_t)(y0 + 1) * W + x + 1;
                        int start = y0;
                        if (full) {
                            int any = 0;
                            for (int r = 0; r < 4; ++r) {
                                int64_t j = i0 + (int64_t)r * W;
                                any |= g.sig[j] | g.vis[j] | g.nbr[j];
                            }
                            if (!any) {
                                if (!mq.decode(cx, CTX_AGG)) continue;
                                int r = mq.decode(cx, CTX_UNI) << 1;
                                r |= mq.decode(cx, CTX_UNI);
                                int y = y0 + r;
                                int64_t i = i0 + (int64_t)r * W;
                                int si = g.sign_index(i, y);
                                int sg = mq.decode(cx, SC_CTX[si]) ^ SC_XOR[si];
                                val[i] = sg ? -oph : oph;
                                g.make_sig(i, y, sg);
                                start = y + 1;
                            }
                        }
                        for (int y = start; y < std::min(y0 + 4, h); ++y) {
                            int64_t i = (int64_t)(y + 1) * W + x + 1;
                            if (g.sig[i] || g.vis[i]) continue;
                            if (mq.decode(cx, zc[g.nbr[i]])) {
                                int si = g.sign_index(i, y);
                                int sg = mq.decode(cx, SC_CTX[si]) ^ SC_XOR[si];
                                val[i] = sg ? -oph : oph;
                                g.make_sig(i, y, sg);
                            }
                        }
                    }
                }
                if (b.style & SEGSYM) {
                    for (int q = 0; q < 4; ++q) mq.decode(cx, CTX_UNI);
                }
                std::fill(g.vis.begin(), g.vis.end(), 0);
            }
            if ((b.style & RESET) && !raw) cx.reset();
            if (++passtype == 3) {
                passtype = 0;
                --bpno;
            }
        }
    }
    const int s = b.roishift;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            int32_t v = val[(size_t)(y + 1) * W + x + 1];
            if (s) {
                if (s >= 31) {
                    v = 0;
                } else {
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= ((int32_t)1 << s)) {
                        mag >>= s;
                        v = v < 0 ? -mag : mag;
                    }
                }
            }
            int64_t o = (int64_t)y * b.out_stride + x;
            if (b.reversible) {
                ((int32_t*)b.out)[o] = (v + (v < 0)) >> 1;
            } else {
                ((float*)b.out)[o] = (float)v * b.stepsize;
            }
        }
    }
    b.status = 0;
}

// ------------------------------------------------------------ wavelets

// inverse 5/3 of one signal: in[0, sn) low, in[sn, n) high -> out
void idwt53(const int64_t* in, int sn, int dn, int cas, int64_t* x,
            int64_t* p) {
    const int n = sn + dn;
    for (int k = 0; k < sn; ++k) x[cas + 2 * k] = in[k];
    for (int k = 0; k < dn; ++k) x[1 - cas + 2 * k] = in[sn + k];
    if (n == 1) {
        if (cas) x[0] = (x[0] + (x[0] < 0)) >> 1;
        return;
    }
    auto mirror = [&]() {
        p[0] = x[1];
        for (int k = 0; k < n; ++k) p[k + 1] = x[k];
        p[n + 1] = x[n - 2];
    };
    mirror();
    for (int k = cas; k < n; k += 2) x[k] -= (p[k] + p[k + 2] + 2) >> 2;
    mirror();
    for (int k = 1 - cas; k < n; k += 2) x[k] += (p[k] + p[k + 2]) >> 1;
}

#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

const float ALPHA = -1.586134342f, BETA = -0.052980118f,
            GAMMA = 0.882911075f, DELTA = 0.443506852f, K = 1.230174105f,
            TWO_INV_K = 1.625732422f;

// openjpeg 2.5 opj_v8dwt_decode_step2 on the interleaved x: samples
// start + 2 i for i < min(n, m), then the edge when m < n
void lift_step(float* x, int start, int n, int m, float c) {
    int imax = std::min(n, m);
    for (int i = 0; i < imax; ++i) {
        int t = start + 2 * i;
        int left = t - 1 < 0 ? t + 1 : t - 1;
        x[t] = x[t] + (x[left] + x[t + 1]) * c;
    }
    if (m < n) {
        int t = start + 2 * m;
        x[t] = x[t] + x[t - 1] * (c + c);
    }
}

void idwt97(const float* in, int sn, int dn, int cas, float* x) {
    for (int k = 0; k < sn; ++k) x[cas + 2 * k] = in[k];
    for (int k = 0; k < dn; ++k) x[1 - cas + 2 * k] = in[sn + k];
    int a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0;
        b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1;
        b = 0;
    }
    for (int i = 0; i < sn; ++i) x[a + 2 * i] *= K;
    for (int i = 0; i < dn; ++i) x[b + 2 * i] *= TWO_INV_K;
    lift_step(x, a, sn, std::min(sn, dn - a), -DELTA);
    lift_step(x, b, dn, std::min(dn, sn - b), -GAMMA);
    lift_step(x, a, sn, std::min(sn, dn - a), -BETA);
    lift_step(x, b, dn, std::min(dn, sn - b), -ALPHA);
}

#pragma GCC pop_options

template <class T>
void idwt_pass(T* data, int64_t stride, int rw, int rh, int sw, int sh,
               int casx, int casy, bool reversible, int n_threads) {
    // rows
    parallel_for(rh, n_threads, [&](int64_t y) {
        T* row = data + y * stride;
        if (reversible) {
            std::vector<int64_t> in(rw), x(rw), p(rw + 2);
            for (int k = 0; k < rw; ++k) in[k] = (int64_t)row[k];
            idwt53(in.data(), sw, rw - sw, casx, x.data(), p.data());
            for (int k = 0; k < rw; ++k) row[k] = (T)(int32_t)x[k];
        } else {
            std::vector<float> in(rw), x(rw);
            for (int k = 0; k < rw; ++k) in[k] = (float)row[k];
            idwt97(in.data(), sw, rw - sw, casx, x.data());
            for (int k = 0; k < rw; ++k) row[k] = (T)x[k];
        }
    });
    // columns
    parallel_for(rw, n_threads, [&](int64_t xcol) {
        T* col = data + xcol;
        if (reversible) {
            std::vector<int64_t> in(rh), x(rh), p(rh + 2);
            for (int k = 0; k < rh; ++k) in[k] = (int64_t)col[k * stride];
            idwt53(in.data(), sh, rh - sh, casy, x.data(), p.data());
            for (int k = 0; k < rh; ++k) col[k * stride] = (T)(int32_t)x[k];
        } else {
            std::vector<float> in(rh), x(rh);
            for (int k = 0; k < rh; ++k) in[k] = (float)col[k * stride];
            idwt97(in.data(), sh, rh - sh, casy, x.data());
            for (int k = 0; k < rh; ++k) col[k * stride] = (T)x[k];
        }
    });
}

// ------------------------------------------------------------ encoders

struct MQEnc {
    std::vector<uint8_t> out;  // out.back() is the byte B; out[0] a dummy
    uint32_t a, c;
    int ct;
    void start() {
        a = 0x8000;
        c = 0;
        ct = 12;
        out.assign(1, 0);
    }
    void byteout() {
        if (out.back() == 0xFF) {
            out.push_back((uint8_t)(c >> 20));
            c &= 0xFFFFF;
            ct = 7;
        } else if (c < 0x8000000) {
            out.push_back((uint8_t)(c >> 19));
            c &= 0x7FFFF;
            ct = 8;
        } else {
            out.back() += 1;
            if (out.back() == 0xFF) {
                c &= 0x7FFFFFF;
                out.push_back((uint8_t)(c >> 20));
                c &= 0xFFFFF;
                ct = 7;
            } else {
                out.push_back((uint8_t)((c >> 19) & 0xFF));
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }
    void encode(Contexts& cx, int k, int d) {
        int st = cx.state[k];
        uint32_t qe = QE[st];
        a -= qe;
        if (d == cx.mps[k]) {
            if (a & 0x8000) {
                c += qe;
                return;
            }
            if (a < qe) a = qe;
            else c += qe;
            cx.state[k] = NMPS[st];
        } else {
            if (a < qe) c += qe;
            else a = qe;
            if (SWITCH[st]) cx.mps[k] = (uint8_t)(1 - cx.mps[k]);
            cx.state[k] = NLPS[st];
        }
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byteout();
        } while (!(a & 0x8000));
    }
    void flush(bool erterm, std::vector<uint8_t>& dst) {
        size_t end;
        if (erterm) {
            int k = 11 - ct + 1;
            while (k > 0) {
                c <<= ct;
                ct = 0;
                byteout();
                k -= ct;
            }
            if (out.back() != 0xFF) byteout();
            end = out.size() - 1;
        } else {
            uint32_t tempc = c + a;
            c |= 0xFFFF;
            if (c >= tempc) c -= 0x8000;
            c <<= ct;
            byteout();
            c <<= ct;
            byteout();
            end = out.back() != 0xFF ? out.size() : out.size() - 1;
        }
        dst.insert(dst.end(), out.begin() + 1, out.begin() + end);
    }
};

struct RawEnc {
    std::vector<uint8_t> out;
    uint32_t c = 0;
    int ct = 8;
    void bit(int d) {
        --ct;
        c |= (uint32_t)d << ct;
        if (ct == 0) {
            out.push_back((uint8_t)c);
            ct = c == 0xFF ? 7 : 8;
            c = 0;
        }
    }
    void flush(bool erterm, std::vector<uint8_t>& dst) {
        int full = (!out.empty() && out.back() == 0xFF) ? 7 : 8;
        if (ct < full || (ct == 7 && erterm)) {
            int b = 0;
            while (ct > 0) {
                --ct;
                c |= (uint32_t)b << ct;
                b = 1 - b;
            }
            out.push_back((uint8_t)c);
        } else if (!out.empty() && out.back() == 0xFF) {
            out.pop_back();
        }
        dst.insert(dst.end(), out.begin(), out.end());
        out.clear();
        c = 0;
        ct = 8;
    }
};

}  // namespace

extern "C" {

// One code-block to encode (utils/j2k.py _CEnc must match).
struct MmfJ2kEnc {
    const int32_t* coef;  // [h, w] C-contiguous, ROI shift applied
    int32_t w, h, orient, style;
    uint8_t* out;         // malloc'd here; mmf_j2k_free releases it
    int64_t len;
    int32_t rates[96];    // bytes at the end of each pass, unclipped
    int32_t npasses, planes, status;
};

int64_t mmf_j2k_enc_size() { return (int64_t)sizeof(MmfJ2kEnc); }

}  // extern "C"

namespace {

void encode_block(MmfJ2kEnc& b) {
    const int w = b.w, h = b.h;
    Grid g;
    g.init(w, h, (b.style & VSC) != 0);
    const int W = g.W;
    std::vector<uint32_t> mag((size_t)W * (h + 2), 0);
    uint32_t mx = 0;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            int32_t v = b.coef[(int64_t)y * w + x];
            size_t i = (size_t)(y + 1) * W + x + 1;
            mag[i] = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
            g.neg[i] = v < 0;
            mx = std::max(mx, mag[i]);
        }
    }
    int planes = 0;
    while (planes < 32 && (mx >> planes)) ++planes;
    b.planes = planes;
    b.npasses = planes ? 3 * planes - 2 : 0;
    b.out = nullptr;
    b.len = 0;
    if (planes == 0) {
        b.status = 0;
        return;
    }
    if (planes >= 31) {
        b.status = 1;
        return;
    }
    const uint8_t* zc = ZC[b.orient & 3];
    const bool erterm = (b.style & PTERM) != 0;
    Contexts cx;
    cx.reset();
    MQEnc mq;
    mq.start();
    RawEnc raw;
    std::vector<uint8_t> data;
    const int npasses = b.npasses;
    auto ends = [&](int k) {
        if (k == npasses - 1) return true;
        if (b.style & TERMALL) return true;
        if (b.style & LAZY) return k == 9 || (k >= 10 && (k - 10) % 3 != 0);
        return false;
    };
    auto code_sign = [&](int64_t i, int y) {
        int si = g.sign_index(i, y);
        mq.encode(cx, SC_CTX[si], g.neg[i] ^ SC_XOR[si]);
    };
    int p = planes, passtype = 2;
    for (int k = 0; k < npasses; ++k) {
        bool is_raw = (b.style & LAZY) && passtype < 2 && p <= planes - 4;
        int bit_no = p - 1;
        if (passtype == 0) {
            for (int y0 = 0; y0 < h; y0 += 4) {
                for (int x = 0; x < w; ++x) {
                    for (int y = y0; y < std::min(y0 + 4, h); ++y) {
                        int64_t i = (int64_t)(y + 1) * W + x + 1;
                        if (g.sig[i] || !g.nbr[i]) continue;
                        int bit = (mag[i] >> bit_no) & 1;
                        if (is_raw) {
                            raw.bit(bit);
                            if (bit) {
                                raw.bit(g.neg[i]);
                                g.make_sig(i, y, g.neg[i]);
                            }
                        } else {
                            mq.encode(cx, zc[g.nbr[i]], bit);
                            if (bit) {
                                code_sign(i, y);
                                g.make_sig(i, y, g.neg[i]);
                            }
                        }
                        g.vis[i] = 1;
                    }
                }
            }
        } else if (passtype == 1) {
            for (int y0 = 0; y0 < h; y0 += 4) {
                for (int x = 0; x < w; ++x) {
                    for (int y = y0; y < std::min(y0 + 4, h); ++y) {
                        int64_t i = (int64_t)(y + 1) * W + x + 1;
                        if (!g.sig[i] || g.vis[i]) continue;
                        int bit = (mag[i] >> bit_no) & 1;
                        if (is_raw) {
                            raw.bit(bit);
                        } else {
                            mq.encode(cx, g.refd[i] ? CTX_MAG + 2
                                          : (g.nbr[i] ? CTX_MAG + 1 : CTX_MAG),
                                      bit);
                        }
                        g.refd[i] = 1;
                    }
                }
            }
        } else {
            for (int y0 = 0; y0 < h; y0 += 4) {
                const bool full = y0 + 4 <= h;
                for (int x = 0; x < w; ++x) {
                    int64_t i0 = (int64_t)(y0 + 1) * W + x + 1;
                    int start = y0;
                    if (full) {
                        int any = 0;
                        for (int r = 0; r < 4; ++r) {
                            int64_t j = i0 + (int64_t)r * W;
                            any |= g.sig[j] | g.vis[j] | g.nbr[j];
                        }
                        if (!any) {
                            int r = -1;
                            for (int q = 0; q < 4 && r < 0; ++q) {
                                if ((mag[i0 + (int64_t)q * W] >> bit_no) & 1) r = q;
                            }
                            if (r < 0) {
                                mq.encode(cx, CTX_AGG, 0);
                                continue;
                            }
                            mq.encode(cx, CTX_AGG, 1);
                            mq.encode(cx, CTX_UNI, r >> 1);
                            mq.encode(cx, CTX_UNI, r & 1);
                            int64_t i = i0 + (int64_t)r * W;
                            code_sign(i, y0 + r);
                            g.make_sig(i, y0 + r, g.neg[i]);
                            start = y0 + r + 1;
                        }
                    }
                    for (int y = start; y < std::min(y0 + 4, h); ++y) {
                        int64_t i = (int64_t)(y + 1) * W + x + 1;
                        if (g.sig[i] || g.vis[i]) continue;
                        int bit = (mag[i] >> bit_no) & 1;
                        mq.encode(cx, zc[g.nbr[i]], bit);
                        if (bit) {
                            code_sign(i, y);
                            g.make_sig(i, y, g.neg[i]);
                        }
                    }
                }
            }
            if (b.style & SEGSYM) {
                const int sym[4] = {1, 0, 1, 0};
                for (int q = 0; q < 4; ++q) mq.encode(cx, CTX_UNI, sym[q]);
            }
            std::fill(g.vis.begin(), g.vis.end(), 0);
        }
        if ((b.style & RESET) && !is_raw) cx.reset();
        if (ends(k)) {
            if (is_raw) {
                raw.flush(erterm, data);
            } else {
                mq.flush(erterm, data);
                mq.start();
            }
            b.rates[k] = (int32_t)data.size();
        } else {
            b.rates[k] = (int32_t)(data.size() +
                                   (is_raw ? raw.out.size() : mq.out.size() + 1));
        }
        if (++passtype == 3) {
            passtype = 0;
            --p;
        }
    }
    b.out = (uint8_t*)std::malloc(data.size() ? data.size() : 1);
    if (!b.out) {
        b.status = 2;
        return;
    }
    if (!data.empty()) std::memcpy(b.out, data.data(), data.size());
    b.len = (int64_t)data.size();
    b.status = 0;
}

}  // namespace

extern "C" {

int mmf_j2k_decode_blocks(MmfJ2kBlock* blocks, int64_t n, int n_threads) {
    parallel_for(n, n_threads, [&](int64_t i) { decode_block(blocks[i]); });
    for (int64_t i = 0; i < n; ++i) {
        if (blocks[i].status) return blocks[i].status;
    }
    return 0;
}

// res: (x0, y0, x1, y1) of each of the nres resolutions, lowest first
int mmf_j2k_idwt(void* data, int64_t stride, int reversible,
                 const int32_t* res, int nres, int n_threads) {
    for (int r = 1; r < nres; ++r) {
        const int32_t* lo = res + 4 * (r - 1);
        const int32_t* cur = res + 4 * r;
        int rw = cur[2] - cur[0], rh = cur[3] - cur[1];
        int sw = lo[2] - lo[0], sh = lo[3] - lo[1];
        if (rw <= 0 || rh <= 0) continue;
        int casx = cur[0] & 1, casy = cur[1] & 1;
        if (reversible) {
            idwt_pass((int32_t*)data, stride, rw, rh, sw, sh, casx, casy,
                      true, n_threads);
        } else {
            idwt_pass((float*)data, stride, rw, rh, sw, sh, casx, casy,
                      false, n_threads);
        }
    }
    return 0;
}

int mmf_j2k_encode_blocks(MmfJ2kEnc* blocks, int64_t n, int n_threads) {
    parallel_for(n, n_threads, [&](int64_t i) { encode_block(blocks[i]); });
    for (int64_t i = 0; i < n; ++i) {
        if (blocks[i].status) return blocks[i].status;
    }
    return 0;
}

void mmf_j2k_free(void* p) { std::free(p); }

}  // extern "C"
