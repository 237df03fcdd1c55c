// Baseline JPEG decoder (sequential Huffman, 8-bit), to RGB.
//
// Built by blazr_tpu_torch/native/__init__.py with g++ on first use and
// called through ctypes by blazr_tpu_torch/utils/preprocess.py, where an
// image part of a chat request is decoded. It follows libjpeg's default
// decompression path (the one Pillow takes): the integer "islow" IDCT of
// jidctint.c, the fancy (triangle) upsampling of jdsample.c for 2:1
// chroma (h2v1, h1v2, h2v2; box replication for other factors) with edge
// rows and columns replicated, and the fixed-point YCbCr->RGB tables of
// jdcolor.c. Progressive, arithmetic-coded, lossless, 12-bit and CMYK
// files are refused.
//
// C ABI:
//   int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, size_t cap)
// returns 0 on success or a negative error code (see JPEG_ERRORS in
// preprocess.py); out receives height * width * 3 bytes, row-major RGB.
// Every read of a marker segment stays inside the segment, a frame of
// more than kMaxPixels is refused before its planes are allocated, and no
// C++ exception crosses the C ABI.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Err {
    OK = 0,
    E_NOT_JPEG = -1,
    E_PROGRESSIVE = -2,
    E_UNSUPPORTED = -3,
    E_CORRUPT = -4,
    E_SMALL_BUFFER = -5,
    E_TOO_LARGE = -6,
    E_NO_MEMORY = -7,
};

// preprocess.py's MAX_PIXELS: Pillow's decompression-bomb limit.
const int64_t kMaxPixels = 2 * int64_t(89478485);

const int kZigzag[64] = {
    0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
    bool present = false;
    // Canonical decode tables: for each code length, the first code, the
    // count, and the index of its first symbol.
    int maxcode[18];
    int valptr[17];
    int mincode[17];
    uint8_t vals[256];
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;            // Huffman tables of the scan
    int bw = 0, bh = 0;            // blocks across / down (MCU-padded)
    int dw = 0, dh = 0;            // downsampled width / height (real samples)
    std::vector<uint8_t> plane;    // bw*8 x bh*8 samples
    int pred = 0;
};

struct Reader {
    const uint8_t* p;
    size_t n, pos = 0;
    uint32_t bits = 0;
    int nbits = 0;
    bool marker_hit = false;

    Reader(const uint8_t* d, size_t len) : p(d), n(len) {}

    int fill() {
        while (nbits <= 24) {
            uint32_t byte = 0;
            if (!marker_hit && pos < n) {
                byte = p[pos];
                if (byte == 0xFF) {
                    uint8_t next = pos + 1 < n ? p[pos + 1] : 0;
                    if (next == 0x00) {
                        pos += 2;
                    } else {
                        marker_hit = true;   // feed zeros until the marker is taken
                        byte = 0;
                    }
                } else {
                    pos++;
                }
            }
            bits |= byte << (24 - nbits);
            nbits += 8;
        }
        return 0;
    }
    int get(int k) {
        if (k == 0) return 0;
        fill();
        int v = static_cast<int>(bits >> (32 - k));
        bits <<= k;
        nbits -= k;
        return v;
    }
    int bit() { return get(1); }
    void reset() { bits = 0; nbits = 0; marker_hit = false; }
};

int decode_huff(Reader& r, const Huffman& t) {
    r.fill();
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
        code = (code << 1) | r.bit();
        if (code <= t.maxcode[l]) return t.vals[t.valptr[l] + code - t.mincode[l]];
    }
    return -1;
}

int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// jidctint.c jpeg_idct_islow: in = dequantized coefficients in natural
// order, out = 8x8 samples with the level shift and range limit applied.
void idct_islow(const int* in, uint8_t* out, int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                  F2053 = 16819, F2562 = 20995, F3072 = 25172;
    const int CB = 13, P1 = 2;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int* ip = in + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = ip[0] * (1 << P1);
            for (int k = 0; k < 8; ++k) wp[8 * k] = dc;
            continue;
        }
        int64_t z2 = ip[16], z3 = ip[48];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 + z3 * -F1847;
        int64_t tmp3 = z1 + z2 * F0765;
        z2 = ip[0];
        z3 = ip[32];
        int64_t tmp0 = (z2 + z3) * (1 << CB);
        int64_t tmp1 = (z2 - z3) * (1 << CB);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = ip[56];
        tmp1 = ip[40];
        tmp2 = ip[24];
        tmp3 = ip[8];
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
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CB - P1;
        const int64_t rnd = int64_t(1) << (sh - 1);
        wp[0] = static_cast<int>((tmp10 + tmp3 + rnd) >> sh);
        wp[56] = static_cast<int>((tmp10 - tmp3 + rnd) >> sh);
        wp[8] = static_cast<int>((tmp11 + tmp2 + rnd) >> sh);
        wp[48] = static_cast<int>((tmp11 - tmp2 + rnd) >> sh);
        wp[16] = static_cast<int>((tmp12 + tmp1 + rnd) >> sh);
        wp[40] = static_cast<int>((tmp12 - tmp1 + rnd) >> sh);
        wp[24] = static_cast<int>((tmp13 + tmp0 + rnd) >> sh);
        wp[32] = static_cast<int>((tmp13 - tmp0 + rnd) >> sh);
    }
    auto clamp = [](int64_t v) -> uint8_t {
        v += 128;
        return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    const int sh = CB + P1 + 3;
    const int64_t rnd = int64_t(1) << (sh - 1);
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + r * stride;
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 + z3 * -F1847;
        int64_t tmp3 = z1 + z2 * F0765;
        int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CB);
        int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CB);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
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
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        op[0] = clamp((tmp10 + tmp3 + rnd) >> sh);
        op[7] = clamp((tmp10 - tmp3 + rnd) >> sh);
        op[1] = clamp((tmp11 + tmp2 + rnd) >> sh);
        op[6] = clamp((tmp11 - tmp2 + rnd) >> sh);
        op[2] = clamp((tmp12 + tmp1 + rnd) >> sh);
        op[5] = clamp((tmp12 - tmp1 + rnd) >> sh);
        op[3] = clamp((tmp13 + tmp0 + rnd) >> sh);
        op[4] = clamp((tmp13 - tmp0 + rnd) >> sh);
    }
}

struct Decoder {
    const uint8_t* d;
    size_t n;
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    std::vector<Component> comps;
    int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart = 0;
    bool frame = false, done = false;

    Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

    int u16(size_t at) const { return (d[at] << 8) | d[at + 1]; }

    int build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int total) {
        t.present = true;
        std::memcpy(t.vals, vals, total);
        int code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            t.valptr[l] = k;
            t.mincode[l] = code;
            code += counts[l - 1];
            k += counts[l - 1];
            t.maxcode[l] = counts[l - 1] ? code - 1 : -1;
            code <<= 1;
        }
        t.maxcode[17] = 0x7fffffff;
        return OK;
    }

    int parse_sof(size_t at, int len) {
        if (len < 8) return E_CORRUPT;
        if (d[at] != 8) return E_UNSUPPORTED;          // 12-bit samples
        height = u16(at + 1);
        width = u16(at + 3);
        int nc = d[at + 5];
        if (width <= 0 || height <= 0) return E_UNSUPPORTED;   // DNL heights
        if (int64_t(width) * height > kMaxPixels) return E_TOO_LARGE;
        if (nc != 1 && nc != 3) return E_UNSUPPORTED;           // CMYK and others
        if (len < 6 + 3 * nc) return E_CORRUPT;
        comps.resize(nc);
        for (int i = 0; i < nc; ++i) {
            Component& c = comps[i];
            c.id = d[at + 6 + 3 * i];
            c.h = d[at + 7 + 3 * i] >> 4;
            c.v = d[at + 7 + 3 * i] & 15;
            c.tq = d[at + 8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return E_CORRUPT;
            hmax = c.h > hmax ? c.h : hmax;
            vmax = c.v > vmax ? c.v : vmax;
        }
        for (const Component& c : comps)
            if (hmax % c.h || vmax % c.v) return E_UNSUPPORTED;  // fractional factors
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (Component& c : comps) {
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.dw = (width * c.h + hmax - 1) / hmax;
            c.dh = (height * c.v + vmax - 1) / vmax;
            c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
        }
        frame = true;
        return OK;
    }

    int decode_block(Reader& r, Component& c, uint8_t* out, int stride) {
        int coef[64];
        std::memset(coef, 0, sizeof(coef));
        const Huffman& hd = dc[c.td];
        const Huffman& ha = ac[c.ta];
        if (!hd.present || !ha.present || !qt_present[c.tq]) return E_CORRUPT;
        int t = decode_huff(r, hd);
        if (t < 0 || t > 11) return E_CORRUPT;
        int diff = t ? extend(r.get(t), t) : 0;
        c.pred += diff;
        const uint16_t* q = qt[c.tq];
        coef[0] = c.pred * q[0];
        for (int k = 1; k < 64;) {
            int rs = decode_huff(r, ha);
            if (rs < 0) return E_CORRUPT;
            int run = rs >> 4, s = rs & 15;
            if (s == 0) {
                if (run != 15) break;                // EOB
                k += 16;
                continue;
            }
            k += run;
            if (k > 63) return E_CORRUPT;
            coef[kZigzag[k]] = extend(r.get(s), s) * q[k];
            ++k;
        }
        idct_islow(coef, out, stride);
        return OK;
    }

    int parse_sos(size_t at, int len, size_t* next) {
        if (!frame || len < 3) return E_CORRUPT;
        int ns = d[at];
        if (ns != static_cast<int>(comps.size())) return E_UNSUPPORTED;   // one interleaved scan
        if (len < 4 + 2 * ns) return E_CORRUPT;
        for (int i = 0; i < ns; ++i) {
            int cid = d[at + 1 + 2 * i], tables = d[at + 2 + 2 * i];
            bool found = false;
            for (Component& c : comps) {
                if (c.id == cid) {
                    c.td = tables >> 4;
                    c.ta = tables & 15;
                    if (c.td > 3 || c.ta > 3) return E_CORRUPT;
                    found = true;
                }
            }
            if (!found) return E_CORRUPT;
        }
        size_t pos = at + len - 2;
        Reader r(d + pos, n - pos);
        int mcus = 0;
        for (Component& c : comps) c.pred = 0;
        bool single = comps.size() == 1;
        // A single-component scan is not interleaved: its MCU is one block,
        // over the component's real block grid.
        int sx = single ? (comps[0].dw + 7) / 8 : mcux;
        int sy = single ? (comps[0].dh + 7) / 8 : mcuy;
        for (int my = 0; my < sy; ++my) {
            for (int mx = 0; mx < sx; ++mx) {
                if (restart && mcus && mcus % restart == 0) {
                    // Expect RSTn: realign to the marker and reset the predictors.
                    size_t p = r.pos;
                    while (p + 1 < r.n && !(r.p[p] == 0xFF && r.p[p + 1] >= 0xD0 &&
                                            r.p[p + 1] <= 0xD7))
                        ++p;
                    if (p + 1 >= r.n) return E_CORRUPT;
                    r.pos = p + 2;
                    r.reset();
                    for (Component& c : comps) c.pred = 0;
                }
                for (Component& c : comps) {
                    int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
                    for (int by = 0; by < bh; ++by) {
                        for (int bx = 0; bx < bw; ++bx) {
                            int row = (single ? my : my * c.v + by) * 8;
                            int col = (single ? mx : mx * c.h + bx) * 8;
                            int stride = c.bw * 8;
                            int e = decode_block(r, c, c.plane.data() + size_t(row) * stride + col,
                                                 stride);
                            if (e) return e;
                        }
                    }
                }
                ++mcus;
            }
        }
        // Skip to the next marker after the entropy-coded data.
        size_t p = r.pos;
        while (p + 1 < r.n && !(r.p[p] == 0xFF && r.p[p + 1] != 0x00 &&
                                !(r.p[p + 1] >= 0xD0 && r.p[p + 1] <= 0xD7)))
            ++p;
        *next = pos + p;
        done = true;
        return OK;
    }

    // Walk the markers, decoding the scan.
    int run() {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return E_NOT_JPEG;
        size_t at = 2;
        while (at + 4 <= n) {
            if (d[at] != 0xFF) return E_CORRUPT;
            int m = d[at + 1];
            if (m == 0xFF) { ++at; continue; }                 // fill bytes
            if (m == 0xD9) break;                              // EOI
            if (m >= 0xD0 && m <= 0xD7) { at += 2; continue; }
            int len = u16(at + 2);
            if (len < 2 || at + 2 + len > n) return E_CORRUPT;
            size_t body = at + 4;
            if (m == 0xC0 || m == 0xC1) {
                int e = parse_sof(body, len - 2);
                if (e) return e;
            } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
                return E_PROGRESSIVE;
            } else if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                return E_UNSUPPORTED;                          // lossless, arithmetic
            } else if (m == 0xCC) {
                return E_UNSUPPORTED;                          // arithmetic conditioning
            } else if (m == 0xDB) {
                size_t p = body, end = at + 2 + len;
                while (p < end) {
                    int pq = d[p] >> 4, tq = d[p] & 15;
                    if (tq > 3) return E_CORRUPT;
                    ++p;
                    if (p + (pq ? 128 : 64) > end) return E_CORRUPT;   // a truncated table
                    for (int k = 0; k < 64; ++k) {
                        if (pq) { qt[tq][k] = static_cast<uint16_t>(u16(p)); p += 2; }
                        else { qt[tq][k] = d[p]; p += 1; }
                    }
                    qt_present[tq] = true;
                }
            } else if (m == 0xC4) {
                size_t p = body, end = at + 2 + len;
                while (p + 17 <= end) {
                    int tc = d[p] >> 4, th = d[p] & 15;
                    if (tc > 1 || th > 3) return E_CORRUPT;
                    const uint8_t* counts = d + p + 1;
                    int total = 0;
                    for (int i = 0; i < 16; ++i) total += counts[i];
                    if (total > 256 || p + 17 + total > end) return E_CORRUPT;
                    build_huffman(tc ? ac[th] : dc[th], counts, d + p + 17, total);
                    p += 17 + total;
                }
            } else if (m == 0xDD) {
                if (len < 4) return E_CORRUPT;
                restart = u16(body);
            } else if (m == 0xDA) {
                size_t next = 0;
                int e = parse_sos(body, len, &next);
                if (e) return e;
                at = next;
                continue;
            }
            at += 2 + len;
        }
        if (!frame || !done) return E_CORRUPT;
        return OK;
    }

    // The component plane upsampled to the full image (edges replicated).
    std::vector<uint8_t> upsample(const Component& c) const {
        int fh = hmax / c.h, fv = vmax / c.v;
        int stride = c.bw * 8;
        auto at = [&](int y, int x) -> int {
            y = y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y;
            x = x < 0 ? 0 : x >= c.dw ? c.dw - 1 : x;
            return c.plane[size_t(y) * stride + x];
        };
        std::vector<uint8_t> out(size_t(width) * height);
        // jinit_upsampler: the triangle filters for 2:1 factors, h2v1 and
        // h2v2 only over more than two columns.
        bool fancy_h = fh == 2 && (fv == 1 || fv == 2) && c.dw > 2;
        bool fancy_v = fv == 2 && (fh == 1 || (fh == 2 && c.dw > 2));
        for (int y = 0; y < height; ++y) {
            int sy = y / fv;
            int ny = (y % fv == 0) ? sy - 1 : sy + 1;       // the vertical neighbour
            for (int x = 0; x < width; ++x) {
                int sx = x / fh;
                int v;
                if (fancy_h && fancy_v) {                    // h2v2_fancy_upsample
                    int nx = (x % 2 == 0) ? sx - 1 : sx + 1;
                    int cur = at(sy, sx) * 3 + at(ny, sx);
                    int nb = at(sy, nx) * 3 + at(ny, nx);
                    v = (cur * 3 + nb + ((x % 2 == 0) ? 8 : 7)) >> 4;
                } else if (fancy_h) {                        // h2v1_fancy_upsample
                    int nx = (x % 2 == 0) ? sx - 1 : sx + 1;
                    v = (at(sy, sx) * 3 + at(sy, nx) + ((x % 2 == 0) ? 1 : 2)) >> 2;
                } else if (fancy_v) {                        // h1v2_fancy_upsample
                    v = (at(sy, sx) * 3 + at(ny, sx) + ((y % 2 == 0) ? 1 : 2)) >> 2;
                } else {
                    v = at(sy, sx);                          // box replication
                }
                out[size_t(y) * width + x] = static_cast<uint8_t>(v);
            }
        }
        return out;
    }

    void to_rgb(uint8_t* out) const {
        if (comps.size() == 1) {
            std::vector<uint8_t> g = upsample(comps[0]);
            for (size_t i = 0; i < g.size(); ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
            return;
        }
        std::vector<uint8_t> y = upsample(comps[0]), cb = upsample(comps[1]),
                             cr = upsample(comps[2]);
        const int SB = 16;
        const int64_t HALF = int64_t(1) << (SB - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * (1 << 16) + 0.5); };
        int crr[256], cbb[256];
        int64_t crg[256], cbg[256];
        for (int i = 0; i < 256; ++i) {
            int64_t x = i - 128;
            crr[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
            cbb[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
            crg[i] = -fix(0.71414) * x;
            cbg[i] = -fix(0.34414) * x + HALF;
        }
        auto clamp = [](int v) -> uint8_t { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
        for (size_t i = 0; i < y.size(); ++i) {
            int yy = y[i], b = cb[i], r = cr[i];
            out[3 * i] = clamp(yy + crr[r]);
            out[3 * i + 1] = clamp(yy + static_cast<int>((cbg[b] + crg[r]) >> SB));
            out[3 * i + 2] = clamp(yy + cbb[b]);
        }
    }
};

}  // namespace

extern "C" int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, size_t cap) {
    try {
        Decoder dec(data, n);
        int e = dec.run();
        if (e) return e;
        if (cap < size_t(dec.width) * dec.height * 3) return E_SMALL_BUFFER;
        dec.to_rgb(out);
        return OK;
    } catch (const std::bad_alloc&) {
        return E_NO_MEMORY;
    } catch (...) {
        return E_CORRUPT;
    }
}
