// JPEG decoding on the host, equal byte for byte to libjpeg-turbo's default
// decompression (what cv2.imdecode(buf, IMREAD_UNCHANGED) returns):
// baseline, extended-Huffman and progressive 8-bit files with 1 (gray) or
// 3 components; the integer islow IDCT of jidctint.c; jdsample.c's fancy
// upsampling (h2v1, h1v2, h2v2; box upsampling for h2 components at most 2
// samples wide); jdcolor.c's fixed-point YCbCr -> RGB, written as BGR.
//
// C interface (io/jpeg.py binds it through ops/cuda_lib.py):
//   jpeg_header(data, size, dims[3] = {H, W, components}, err, err_len)
//   jpeg_decode(data, size, out [H, W] or [H, W, 3] uint8, err, err_len)
// Each returns 0, or 1 with a message in err: unsupported coding (arithmetic,
// lossless, hierarchical, 12-bit, CMYK / YCCK, sampling other than 1x1, 2x1,
// 1x2, 2x2 of the largest factors, a progressive file whose low AC
// coefficients stay unrefined) or truncated / corrupt data, where libjpeg
// would warn and fill with zeros.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

constexpr int kLookBits = 9;

struct Huffman {
    bool defined = false;
    int maxcode[18], valptr[17], mincode[17];
    uint8_t values[256];
    // first kLookBits bits -> (code length << 8) | value, or 0 if longer
    uint16_t look[1 << kLookBits];

    void build(const uint8_t* counts, const uint8_t* vals, int nvals) {
        int code = 0, k = 0;
        std::memset(look, 0, sizeof(look));
        for (int len = 1; len <= 16; ++len) {
            const int n = counts[len - 1];
            maxcode[len] = -1;
            if (n) {
                valptr[len] = k;
                mincode[len] = code;
                for (int i = 0; i < n; ++i, ++code, ++k) {
                    if (len <= kLookBits) {
                        const int shift = kLookBits - len;
                        for (int j = 0; j < (1 << shift); ++j)
                            look[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
                    }
                }
                maxcode[len] = code - 1;
                if (code > (1 << len)) throw Error("bad Huffman table");
            }
            code <<= 1;
        }
        if (k != nvals) throw Error("bad Huffman table");
        std::memcpy(values, vals, nvals);
        maxcode[17] = 0x7fffffff;
        defined = true;
    }
};

// the entropy-coded segment of a scan: stuffed 0xFF 0x00 gives 0xFF; a
// marker ends it, and reading past it is an error
struct Bits {
    const uint8_t* d;
    size_t n, pos;
    uint64_t acc = 0;
    int cnt = 0;
    bool stop = false;

    void fill() {
        while (cnt <= 56 && !stop) {
            if (pos >= n) {
                stop = true;
                break;
            }
            uint8_t b = d[pos];
            if (b == 0xFF) {
                if (pos + 1 >= n || d[pos + 1] != 0) {
                    stop = true;
                    break;
                }
                pos += 2;
            } else {
                pos += 1;
            }
            acc = (acc << 8) | b;
            cnt += 8;
        }
    }
    int get(int k) {
        if (k == 0) return 0;
        if (cnt < k) fill();
        if (cnt < k) throw Error(pos >= n ? "truncated data" : "corrupt data (scan data ends early)");
        cnt -= k;
        return (int)((acc >> cnt) & ((1u << k) - 1));
    }
    int bit() { return get(1); }
    int decode(const Huffman& h) {
        if (cnt < 16) fill();
        if (cnt >= kLookBits) {
            const uint16_t e = h.look[(acc >> (cnt - kLookBits)) & ((1 << kLookBits) - 1)];
            if (e) {
                cnt -= e >> 8;
                return e & 255;
            }
        }
        int code = 0;
        for (int len = 1; len <= 16; ++len) {
            code = (code << 1) | bit();
            if (code <= h.maxcode[len]) return h.values[h.valptr[len] + code - h.mincode[len]];
        }
        throw Error("corrupt data (bad Huffman code)");
    }
    void restart(int expect) {
        if (cnt >= 8) throw Error("corrupt data (bytes before an RST marker)");
        cnt = 0;
        acc = 0;
        stop = false;
        while (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] == 0xFF) ++pos;
        if (pos + 1 >= n || d[pos] != 0xFF || d[pos + 1] != 0xD0 + expect) {
            char msg[64];
            std::snprintf(msg, sizeof(msg), "corrupt data (RST%d marker missing)", expect);
            throw Error(msg);
        }
        pos += 2;
    }
};

inline int extend(int v, int s) { return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v; }

struct Component {
    int id, h, v, tq;
    int bw, bh;          // blocks per row / column, padded to whole MCUs
    int cw, ch;          // real (downsampled) width and height
    std::vector<int32_t> coef;  // [bh][bw][64], natural order
    int qt[64];
    bool latched = false;
    int coef_bits[64];
};

struct Decoder {
    const uint8_t* d;
    size_t n;
    bool have_frame = false, progressive = false, jfif = false;
    int adobe = -1;
    int height = 0, width = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    std::vector<Component> comps;
    Huffman dc[4], ac[4];
    int qtab[4][64];
    bool qdef[4] = {false, false, false, false};
    int restart = 0;

    Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

    void frame(const uint8_t* b, int len, bool prog) {
        if (have_frame) throw Error("corrupt data (a second SOF marker)");
        if (len < 6) throw Error("corrupt SOF segment");
        if (b[0] != 8) {
            char msg[80];
            std::snprintf(msg, sizeof(msg), "%d-bit precision is not supported (8-bit only)", b[0]);
            throw Error(msg);
        }
        height = (b[1] << 8) | b[2];
        width = (b[3] << 8) | b[4];
        const int nc = b[5];
        if (!height || !width) throw Error("image size 0 (DNL markers are not supported)");
        if (nc != 1 && nc != 3) {
            char msg[96];
            std::snprintf(msg, sizeof(msg), "%d components (CMYK/YCCK or other) are not supported", nc);
            throw Error(msg);
        }
        if (len < 6 + 3 * nc) throw Error("corrupt SOF segment");
        progressive = prog;
        comps.resize(nc);
        for (int c = 0; c < nc; ++c) {
            Component& k = comps[c];
            k.id = b[6 + 3 * c];
            k.h = b[7 + 3 * c] >> 4;
            k.v = b[7 + 3 * c] & 15;
            k.tq = b[8 + 3 * c];
            if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) throw Error("corrupt SOF segment");
            hmax = std::max(hmax, k.h);
            vmax = std::max(vmax, k.v);
        }
        if (nc > 1) {
            for (auto& k : comps) {
                const int fx = hmax / k.h, fy = vmax / k.v;
                if (hmax % k.h || vmax % k.v || fx > 2 || fy > 2)
                    throw Error("sampling factors are not supported (1x1, 2x1, 1x2, 2x2 of the largest only)");
            }
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (auto& k : comps) {
            k.bw = mcux * k.h;
            k.bh = mcuy * k.v;
            k.cw = (width * k.h + hmax - 1) / hmax;
            k.ch = (height * k.v + vmax - 1) / vmax;
            for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
        }
        have_frame = true;
    }

    void alloc() {
        for (auto& k : comps) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    }

    void dht(const uint8_t* b, int len) {
        int p = 0;
        while (p < len) {
            const int tc = b[p] >> 4, th = b[p] & 15;
            if (tc > 1 || th > 3 || p + 17 > len) throw Error("corrupt DHT segment");
            int nv = 0;
            for (int i = 0; i < 16; ++i) nv += b[p + 1 + i];
            if (p + 17 + nv > len || nv > 256) throw Error("corrupt DHT segment");
            (tc ? ac : dc)[th].build(b + p + 1, b + p + 17, nv);
            p += 17 + nv;
        }
    }

    void dqt(const uint8_t* b, int len) {
        int p = 0;
        while (p < len) {
            const int pq = b[p] >> 4, tq = b[p] & 15, size = pq ? 128 : 64;
            if (pq > 1 || tq > 3 || p + 1 + size > len) throw Error("corrupt DQT segment");
            for (int k = 0; k < 64; ++k)
                qtab[tq][kNatural[k]] = pq ? (b[p + 1 + 2 * k] << 8) | b[p + 2 + 2 * k] : b[p + 1 + k];
            qdef[tq] = true;
            p += 1 + size;
        }
    }

    void block_sequential(Bits& bits, int32_t* blk, const Huffman& hd, const Huffman& ha, int& pred) {
        int s = bits.decode(hd);
        if (s > 11) throw Error("corrupt data (bad DC size)");
        pred += extend(bits.get(s), s);
        blk[0] = pred;
        for (int k = 1; k < 64; ++k) {
            const int rs = bits.decode(ha), r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) throw Error("corrupt data (coefficient index past 63)");
                blk[kNatural[k]] = extend(bits.get(s), s);
            } else if (r != 15) {
                break;
            } else {
                k += 15;
            }
        }
    }

    void ac_first(Bits& bits, int32_t* blk, const Huffman& ha, int ss, int se, int al, int& eobrun) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        for (int k = ss; k <= se; ++k) {
            const int rs = bits.decode(ha), r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                if (k > se) throw Error("corrupt data (coefficient index past the band)");
                blk[kNatural[k]] = extend(bits.get(s), s) * (1 << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = (1 << r) + (r ? bits.get(r) : 0) - 1;
                break;
            }
        }
    }

    static void refine(Bits& bits, int32_t* blk, int pos, int p1) {
        if (bits.bit() && (blk[pos] & p1) == 0) blk[pos] += blk[pos] >= 0 ? p1 : -p1;
    }

    void ac_refine(Bits& bits, int32_t* blk, const Huffman& ha, int ss, int se, int al, int& eobrun) {
        const int p1 = 1 << al;
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                const int rs = bits.decode(ha);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    if (s != 1) throw Error("corrupt data (bad refinement size)");
                    s = bits.bit() ? p1 : -p1;
                } else if (r != 15) {
                    eobrun = (1 << r) + (r ? bits.get(r) : 0);
                    break;
                }
                for (; k <= se; ++k) {
                    const int pos = kNatural[k];
                    if (blk[pos] != 0) {
                        refine(bits, blk, pos, p1);
                    } else if (--r < 0) {
                        break;
                    }
                }
                if (s) {
                    if (k > se) throw Error("corrupt data (coefficient index past the band)");
                    blk[kNatural[k]] = s;
                }
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                const int pos = kNatural[k];
                if (blk[pos] != 0) refine(bits, blk, pos, p1);
            }
            --eobrun;
        }
    }

    // one scan's header and entropy-coded data at pos; returns the position after it
    size_t scan(const uint8_t* b, int len, size_t pos) {
        if (!have_frame) throw Error("corrupt data (SOS before SOF)");
        const int ns = len > 0 ? b[0] : 0;
        if (ns < 1 || ns > 4 || len < 4 + 2 * ns) throw Error("corrupt SOS segment");
        int ci[4], td[4], ta[4];
        for (int i = 0; i < ns; ++i) {
            ci[i] = -1;
            for (size_t c = 0; c < comps.size(); ++c)
                if (comps[c].id == b[1 + 2 * i]) ci[i] = (int)c;
            if (ci[i] < 0) throw Error("corrupt SOS segment (unknown component)");
            td[i] = b[2 + 2 * i] >> 4;
            ta[i] = b[2 + 2 * i] & 15;
            if (td[i] > 3 || ta[i] > 3) throw Error("corrupt SOS segment");
        }
        const int ss = b[1 + 2 * ns], se = b[2 + 2 * ns], ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
        if (progressive) {
            if ((ss == 0 && se != 0) || (ss > 0 && (se < ss || se > 63 || ns != 1)) || al > 13)
                throw Error("corrupt progressive scan parameters");
        } else if (ss != 0 || se != 63 || ah || al) {
            throw Error("corrupt sequential scan parameters");
        }
        for (int i = 0; i < ns; ++i) {
            Component& k = comps[ci[i]];
            if (!k.latched) {
                if (!qdef[k.tq]) throw Error("a component's quantization table is missing");
                std::memcpy(k.qt, qtab[k.tq], sizeof(k.qt));
                k.latched = true;
            }
            if (ss == 0 && ah == 0 && !dc[td[i]].defined) throw Error("a scan's DC Huffman table is missing");
            if ((se > 0 || !progressive) && !ac[ta[i]].defined)
                throw Error("a scan's AC Huffman table is missing");
            for (int c = ss; c <= se; ++c) {
                if (progressive && ah != 0 && k.coef_bits[c] != ah)
                    throw Error("corrupt progressive scan (refinement out of order)");
                k.coef_bits[c] = progressive ? al : 0;
            }
        }
        Bits bits{d, n, pos};
        int pred[4] = {0, 0, 0, 0}, eobrun = 0;
        auto unit = [&](int i, int by, int bx) {
            Component& k = comps[ci[i]];
            int32_t* blk = &k.coef[((size_t)by * k.bw + bx) * 64];
            if (!progressive) {
                block_sequential(bits, blk, dc[td[i]], ac[ta[i]], pred[i]);
            } else if (ss == 0 && ah == 0) {
                const int s = bits.decode(dc[td[i]]);
                if (s > 11) throw Error("corrupt data (bad DC size)");
                pred[i] += extend(bits.get(s), s);
                blk[0] = pred[i] * (1 << al);
            } else if (ss == 0) {
                if (bits.bit()) blk[0] |= 1 << al;
            } else if (ah == 0) {
                ac_first(bits, blk, ac[ta[i]], ss, se, al, eobrun);
            } else {
                ac_refine(bits, blk, ac[ta[i]], ss, se, al, eobrun);
            }
        };
        auto restart_at = [&](long m) {
            if (restart && m && m % restart == 0) {
                bits.restart((int)((m / restart - 1) % 8));
                for (int i = 0; i < 4; ++i) pred[i] = 0;
                eobrun = 0;
            }
        };
        if (ns == 1) {  // non-interleaved: one block per MCU, over the component's own blocks
            const Component& k = comps[ci[0]];
            const int nby = (k.ch + 7) / 8, nbx = (k.cw + 7) / 8;
            long m = 0;
            for (int by = 0; by < nby; ++by)
                for (int bx = 0; bx < nbx; ++bx, ++m) {
                    restart_at(m);
                    unit(0, by, bx);
                }
        } else {
            long m = 0;
            for (int my = 0; my < mcuy; ++my)
                for (int mx = 0; mx < mcux; ++mx, ++m) {
                    restart_at(m);
                    for (int i = 0; i < ns; ++i) {
                        const Component& k = comps[ci[i]];
                        for (int y = 0; y < k.v; ++y)
                            for (int x = 0; x < k.h; ++x) unit(i, my * k.v + y, mx * k.h + x);
                    }
                }
        }
        return bits.pos;
    }

    // parse up to the frame header (header_only) or the whole file
    void run(bool header_only) {
        if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) throw Error("not a JPEG file");
        size_t pos = 2;
        bool allocated = false;
        for (;;) {
            while (pos < n && d[pos] != 0xFF) ++pos;  // bytes before a marker (libjpeg skips them)
            while (pos < n && d[pos] == 0xFF) ++pos;
            if (pos >= n) throw Error("truncated data (no EOI marker)");
            const int marker = d[pos++];
            if (marker == 0xD9) break;
            if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
            if (pos + 2 > n) throw Error("truncated data");
            const int ln = (d[pos] << 8) | d[pos + 1];
            if (ln < 2 || pos + ln > n) throw Error("truncated data");
            const uint8_t* body = d + pos + 2;
            const int len = ln - 2;
            pos += ln;
            if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
                frame(body, len, marker == 0xC2);
                if (header_only) return;
            } else if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF) {
                throw Error("lossless JPEG is not supported");
            } else if (marker >= 0xC9 && marker <= 0xCE) {
                throw Error("arithmetic-coded JPEG is not supported");
            } else if (marker == 0xC5 || marker == 0xC6 || marker == 0xDE || marker == 0xDF) {
                throw Error("hierarchical JPEG is not supported");
            } else if (marker == 0xC4) {
                dht(body, len);
            } else if (marker == 0xDB) {
                dqt(body, len);
            } else if (marker == 0xDD) {
                if (len < 2) throw Error("corrupt DRI segment");
                restart = (body[0] << 8) | body[1];
            } else if (marker == 0xDA) {
                if (!allocated && have_frame) {
                    alloc();
                    allocated = true;
                }
                pos = scan(body, len, pos);
            } else if (marker == 0xE0) {
                jfif = jfif || (len >= 5 && std::memcmp(body, "JFIF\0", 5) == 0);
            } else if (marker == 0xEE) {
                if (len >= 12 && std::memcmp(body, "Adobe", 5) == 0) adobe = body[11];
            } else if ((marker >= 0xE1 && marker <= 0xEF) || marker == 0xFE) {
            } else {
                char msg[64];
                std::snprintf(msg, sizeof(msg), "unsupported marker 0xFF%02X", marker);
                throw Error(msg);
            }
        }
        if (!have_frame) throw Error("no image (no SOF marker)");
        for (auto& k : comps) {
            if (k.coef_bits[0] < 0) throw Error("truncated data (a component was never coded)");
            if (progressive)
                for (int i = 1; i < 10; ++i)
                    if (k.coef_bits[i] != 0)
                        throw Error("progressive file with unrefined low AC coefficients (libjpeg "
                                    "would smooth its blocks) is not supported");
        }
    }
};

// jidctint.c (CONST_BITS 13, PASS1_BITS 2)
constexpr long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
               FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
               FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
               FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

uint8_t kRange[1024];  // the post-IDCT range limit, indexed by x & 1023
int kCrR[256], kCbB[256], kCrG[256], kCbG[256];  // jdcolor.c's tables

struct Tables {
    Tables() {
        for (int j = 0; j < 1024; ++j)
            kRange[j] = (uint8_t)(j < 128 ? j + 128 : j < 512 ? 255 : j < 896 ? 0 : j - 896);
        for (int i = 0; i < 256; ++i) {
            const long x = i - 128;
            kCrR[i] = (int)((91881 * x + (1L << 15)) >> 16);
            kCbB[i] = (int)((116130 * x + (1L << 15)) >> 16);
            kCrG[i] = (int)(-46802 * x);
            kCbG[i] = (int)(-22554 * x + (1L << 15));
        }
    }
} kTables;

template <int SHIFT>
inline void idct_1d(const long* in, int step, long* out, int ostep) {
    long z2 = in[2 * step], z3 = in[6 * step];
    long z1 = (z2 + z3) * FIX_0_541196100;
    const long tmp2 = z1 - z3 * FIX_1_847759065;
    const long tmp3 = z1 + z2 * FIX_0_765366865;
    const long tmp0 = (in[0] + in[4 * step]) * (1L << 13);
    const long tmp1 = (in[0] - in[4 * step]) * (1L << 13);
    const long t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    long o0 = in[7 * step], o1 = in[5 * step], o2 = in[3 * step], o3 = in[1 * step];
    z1 = o0 + o3;
    z2 = o1 + o2;
    z3 = o0 + o2;
    long z4 = o1 + o3;
    const long z5 = (z3 + z4) * FIX_1_175875602;
    o0 *= FIX_0_298631336;
    o1 *= FIX_2_053119869;
    o2 *= FIX_3_072711026;
    o3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    o0 += z1 + z3;
    o1 += z2 + z4;
    o2 += z2 + z3;
    o3 += z1 + z4;
    constexpr long R = 1L << (SHIFT - 1);
    out[0] = (t10 + o3 + R) >> SHIFT;
    out[7 * ostep] = (t10 - o3 + R) >> SHIFT;
    out[1 * ostep] = (t11 + o2 + R) >> SHIFT;
    out[6 * ostep] = (t11 - o2 + R) >> SHIFT;
    out[2 * ostep] = (t12 + o1 + R) >> SHIFT;
    out[5 * ostep] = (t12 - o1 + R) >> SHIFT;
    out[3 * ostep] = (t13 + o0 + R) >> SHIFT;
    out[4 * ostep] = (t13 - o0 + R) >> SHIFT;
}

// jpeg_idct_islow of one block into 8 rows of `out` (row stride `stride`)
void idct_islow(const int32_t* coef, const int* q, uint8_t* out, int stride) {
    long in[64], ws[64], res[8];
    for (int i = 0; i < 64; ++i) in[i] = (long)coef[i] * q[i];
    for (int c = 0; c < 8; ++c) idct_1d<13 - 2>(in + c, 8, ws + c, 8);  // columns
    for (int r = 0; r < 8; ++r) {
        idct_1d<13 + 2 + 3>(ws + 8 * r, 1, res, 1);
        for (int c = 0; c < 8; ++c) out[(size_t)r * stride + c] = kRange[res[c] & 1023];
    }
}

// a component's real samples [ch][cw] upsampled by (fx, fy) into [ch*fy][cw*fx]
std::vector<uint8_t> upsample(const std::vector<uint8_t>& p, int cw, int ch, int fx, int fy) {
    if (fx == 1 && fy == 1) return p;
    const int ow = cw * fx, oh = ch * fy;
    std::vector<uint8_t> out((size_t)ow * oh);
    std::vector<int> cs(cw);
    for (int oy = 0; oy < oh; ++oy) {
        const int y = oy / fy;
        const uint8_t* row = &p[(size_t)y * cw];
        uint8_t* o = &out[(size_t)oy * ow];
        if (fy == 2) {
            const int ny = (oy & 1) ? std::min(y + 1, ch - 1) : std::max(y - 1, 0);
            const uint8_t* nb = &p[(size_t)ny * cw];
            if (fx == 1) {  // h1v2: always fancy
                const int bias = (oy & 1) ? 2 : 1;
                for (int x = 0; x < cw; ++x) o[x] = (uint8_t)((3 * row[x] + nb[x] + bias) >> 2);
                continue;
            }
            if (cw <= 2) {  // h2v2 box
                for (int x = 0; x < cw; ++x) o[2 * x] = o[2 * x + 1] = row[x];
                continue;
            }
            for (int x = 0; x < cw; ++x) cs[x] = 3 * row[x] + nb[x];
            for (int x = 0; x < cw; ++x) {
                const int l = cs[x > 0 ? x - 1 : 0], r = cs[x < cw - 1 ? x + 1 : cw - 1];
                o[2 * x] = (uint8_t)((3 * cs[x] + l + 8) >> 4);
                o[2 * x + 1] = (uint8_t)((3 * cs[x] + r + 7) >> 4);
            }
        } else {  // h2v1
            if (cw <= 2) {
                for (int x = 0; x < cw; ++x) o[2 * x] = o[2 * x + 1] = row[x];
                continue;
            }
            for (int x = 0; x < cw; ++x) {
                const int l = row[x > 0 ? x - 1 : 0], r = row[x < cw - 1 ? x + 1 : cw - 1];
                o[2 * x] = (uint8_t)((3 * row[x] + l + 1) >> 2);
                o[2 * x + 1] = (uint8_t)((3 * row[x] + r + 2) >> 2);
            }
        }
    }
    return out;
}

void set_error(const char* msg, char* err, int err_len) {
    if (err && err_len > 0) {
        std::strncpy(err, msg, (size_t)err_len - 1);
        err[err_len - 1] = 0;
    }
}

}  // namespace

extern "C" int jpeg_header(const uint8_t* data, long size, int* dims, char* err, int err_len) {
    try {
        Decoder dec(data, (size_t)size);
        dec.run(true);
        if (!dec.have_frame) throw Error("no image (no SOF marker)");
        dims[0] = dec.height;
        dims[1] = dec.width;
        dims[2] = (int)dec.comps.size();
        return 0;
    } catch (const std::exception& e) {
        set_error(e.what(), err, err_len);
        return 1;
    }
}

extern "C" int jpeg_decode(const uint8_t* data, long size, uint8_t* out, char* err, int err_len) {
    try {
        Decoder dec(data, (size_t)size);
        dec.run(false);
        const int W = dec.width, H = dec.height, nc = (int)dec.comps.size();
        std::vector<std::vector<uint8_t>> planes(nc);
        std::vector<int> pw(nc);
        for (int c = 0; c < nc; ++c) {
            const Component& k = dec.comps[c];
            const int sw = k.bw * 8;
            std::vector<uint8_t> full((size_t)sw * k.bh * 8);
            for (int by = 0; by < (k.ch + 7) / 8; ++by)
                for (int bx = 0; bx < (k.cw + 7) / 8; ++bx)
                    idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.qt,
                               &full[(size_t)by * 8 * sw + bx * 8], sw);
            std::vector<uint8_t> real((size_t)k.cw * k.ch);
            for (int y = 0; y < k.ch; ++y)
                std::memcpy(&real[(size_t)y * k.cw], &full[(size_t)y * sw], k.cw);
            planes[c] = upsample(real, k.cw, k.ch, dec.hmax / k.h, dec.vmax / k.v);
            pw[c] = k.cw * (dec.hmax / k.h);
        }
        if (nc == 1) {
            for (int y = 0; y < H; ++y) std::memcpy(out + (size_t)y * W, &planes[0][(size_t)y * pw[0]], W);
            return 0;
        }
        bool rgb;  // libjpeg's guess of the color space (jdapimin.c)
        if (dec.jfif)
            rgb = false;
        else if (dec.adobe >= 0)
            rgb = dec.adobe == 0;
        else
            rgb = dec.comps[0].id == 82 && dec.comps[1].id == 71 && dec.comps[2].id == 66;
        for (int y = 0; y < H; ++y) {
            const uint8_t* p0 = &planes[0][(size_t)y * pw[0]];
            const uint8_t* p1 = &planes[1][(size_t)y * pw[1]];
            const uint8_t* p2 = &planes[2][(size_t)y * pw[2]];
            uint8_t* o = out + (size_t)y * W * 3;
            for (int x = 0; x < W; ++x, o += 3) {
                if (rgb) {
                    o[0] = p2[x];
                    o[1] = p1[x];
                    o[2] = p0[x];
                    continue;
                }
                const int yy = p0[x], cb = p1[x], cr = p2[x];
                const int b = yy + kCbB[cb], g = yy + ((kCbG[cb] + kCrG[cr]) >> 16), r = yy + kCrR[cr];
                o[0] = (uint8_t)std::clamp(b, 0, 255);
                o[1] = (uint8_t)std::clamp(g, 0, 255);
                o[2] = (uint8_t)std::clamp(r, 0, 255);
            }
        }
        return 0;
    } catch (const std::exception& e) {
        set_error(e.what(), err, err_len);
        return 1;
    }
}
