// JPEG decoder for the host, built with g++ and called through ctypes.
//
// Decodes what the JAX package's loader reads through cv2.imread(path, IMREAD_UNCHANGED)
// from a JPEG file, with the arithmetic libjpeg-turbo applies under cv2's defaults:
//  - baseline / extended sequential and progressive Huffman, 8-bit samples, 1 or 3
//    components, any integer sampling factors, restart intervals;
//  - dequantisation and the integer "islow" inverse DCT (libjpeg's jidctint.c: 13-bit
//    constants, 2 extra bits between the passes), results clamped to 0..255;
//  - fancy (triangle-filter) chroma upsampling for 2x1, 1x2 and 2x2 factors with the edge
//    samples replicated (jdsample.c), plain replication for the other integer factors;
//  - YCbCr -> RGB through the 16-bit fixed-point tables of jdcolor.c, clamped to 0..255;
//  - EXIF orientation ignored, as IMREAD_UNCHANGED ignores it.
// Output is RGB (or one gray channel) in row order; cv2 returns the same pixels as BGR.
//
// Refused with an error message naming the feature: arithmetic coding, lossless and
// hierarchical processes, sample precision other than 8 bits, 4-component (CMYK/YCCK)
// images, fractional sampling ratios, DNL-defined heights, progressive files whose scans
// leave low coefficients incomplete (libjpeg would smooth blocks), and corrupt or
// truncated streams (bad Huffman codes, coefficient overruns, missing restart markers,
// entropy data that runs out, no EOI).
//
// Plain C ABI: jpeg_header() reads the frame size, jpeg_decode() fills a caller buffer.
// palettenerf_torch/native/__init__.py builds it at first use into palettenerf_torch/build/.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
    std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// Zig-zag position -> natural (row-major) coefficient index.
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
    bool defined = false;
    // 9-bit lookahead: code length (0 = longer than 9 bits) and value.
    uint8_t fast_len[512];
    uint8_t fast_val[512];
    int32_t maxcode[18];    // largest code of each length, -1 if none; [17] sentinel
    int32_t valoffset[18];  // index into vals of a length's first code, minus that code
    uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t counts[17], const uint8_t* vals, int nvals) {
    std::memcpy(h.vals, vals, nvals);
    std::memset(h.fast_len, 0, sizeof(h.fast_len));
    std::memset(h.fast_val, 0, sizeof(h.fast_val));
    int32_t code = 0;
    int p = 0;
    for (int len = 1; len <= 16; ++len) {
        h.valoffset[len] = p - code;
        for (int i = 0; i < counts[len]; ++i, ++p, ++code) {
            if (code >= (1 << len)) fail("corrupt stream: bad Huffman table (code space overflow)");
            if (len <= 9) {
                const int shift = 9 - len;
                for (int j = 0; j < (1 << shift); ++j) {
                    h.fast_len[(code << shift) | j] = (uint8_t)len;
                    h.fast_val[(code << shift) | j] = vals[p];
                }
            }
        }
        h.maxcode[len] = counts[len] ? code - 1 : -1;
        code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.defined = true;
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int qlatched = 0;          // quant table copied at the component's first scan
    uint16_t quant[64];        // natural order
    int bw = 0, bh = 0;        // blocks allocated (MCU-padded)
    int wib = 0, hib = 0;      // blocks covering the component's own samples
    int dw = 0, dh = 0;        // downsampled width/height in samples
    std::vector<int16_t> coef;  // [bh][bw][64], natural order
    int dc_pred = 0;
    int coef_bits[64];         // progressive: -1 unknown, else Al still to refine
};

class Reader {
  public:
    Reader(const uint8_t* data, int64_t size) : d_(data), n_(size) {}

    // --- marker-level bytes ---
    int64_t pos() const { return pos_; }
    void seek(int64_t p) { pos_ = p; }
    uint8_t byte() {
        if (pos_ >= n_) fail("truncated stream: ends inside a marker segment");
        return d_[pos_++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    const uint8_t* ptr() const { return d_ + pos_; }
    int64_t left() const { return n_ - pos_; }

    // --- entropy-coded bits ---
    void start_bits() {
        buf_ = 0;
        cnt_ = 0;
        zeros_ = 0;
        marker_ = -1;
    }
    void fill() {
        while (cnt_ <= 56) {
            uint32_t b = 0;
            if (marker_ >= 0) {
                ++zeros_;
            } else if (pos_ >= n_) {
                marker_ = n_;  // end of data: no marker follows
                ++zeros_;
            } else {
                b = d_[pos_];
                if (b != 0xFF) {
                    ++pos_;
                } else {
                    int64_t q = pos_ + 1;
                    while (q < n_ && d_[q] == 0xFF) ++q;
                    if (q < n_ && d_[q] == 0x00) {
                        pos_ = q + 1;  // stuffed 0xFF data byte
                    } else {
                        marker_ = q - 1;  // the 0xFF just before the marker code
                        b = 0;
                        ++zeros_;
                    }
                }
            }
            buf_ |= (uint64_t)b << (56 - cnt_);
            cnt_ += 8;
        }
    }
    int peek9() {
        if (cnt_ < 9) fill();
        return (int)(buf_ >> 55);
    }
    void skip(int nbits) {
        buf_ <<= nbits;
        cnt_ -= nbits;
    }
    int bits(int nbits) {
        if (nbits == 0) return 0;
        if (cnt_ < nbits) fill();
        int v = (int)(buf_ >> (64 - nbits));
        skip(nbits);
        return v;
    }
    int bit() { return bits(1); }

    int decode(const Huffman& h) {
        int look = peek9();
        int len = h.fast_len[look];
        if (len) {
            skip(len);
            return h.fast_val[look];
        }
        if (cnt_ < 16) fill();
        int code = (int)(buf_ >> 54);  // 10 bits
        len = 10;
        while (code > h.maxcode[len]) {
            code = (int)(buf_ >> (63 - len));
            ++len;
            if (len > 16) fail("corrupt stream: bad Huffman code");
        }
        skip(len);
        return h.vals[code + h.valoffset[len]];
    }

    // Receive an s-bit magnitude and extend its sign (JPEG F.2.2.1).
    int receive_extend(int s) {
        if (s == 0) return 0;
        if (s > 16) fail("corrupt stream: coefficient magnitude over 16 bits");
        int v = bits(s);
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }

    // End of an entropy-coded segment: the bits consumed must be real data, no whole byte
    // of it may be left over, and a marker must follow. Returns the marker's position
    // (its 0xFF) and leaves the reader there.
    int64_t finish_segment() {
        if (marker_ < 0 && cnt_ < 8) fill();  // read the byte after the pad bits
        const int64_t real_bits = (int64_t)cnt_ - 8 * zeros_;
        if (real_bits < 0) fail("truncated or corrupt stream: entropy-coded data runs out");
        if (real_bits >= 8) fail("corrupt stream: extraneous bytes before a marker");
        if (marker_ >= n_) fail("truncated stream: no marker after the entropy-coded data");
        pos_ = marker_;
        return marker_;
    }

  private:
    const uint8_t* d_;
    int64_t n_;
    int64_t pos_ = 0;
    uint64_t buf_ = 0;
    int cnt_ = 0;
    int64_t zeros_ = 0;
    int64_t marker_ = -1;
};

// Integer inverse DCT of one block (libjpeg jidctint.c, jpeg_idct_islow), in 64-bit
// intermediates as libjpeg's JLONG: only corrupt coefficients come near 32 bits.
const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }
inline uint8_t clamp_sample(int64_t x) { return (uint8_t)std::min<int64_t>(255, std::max<int64_t>(0, x + 128)); }

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int32_t ws[64];  // pass-1 results, as libjpeg's int workspace
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int32_t* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int32_t dc = (int32_t)(((int64_t)ip[0] * qp[0]) * (1 << PASS1_BITS));
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int s = CONST_BITS - PASS1_BITS;
        wp[0] = (int32_t)descale(tmp10 + tmp3, s);
        wp[56] = (int32_t)descale(tmp10 - tmp3, s);
        wp[8] = (int32_t)descale(tmp11 + tmp2, s);
        wp[48] = (int32_t)descale(tmp11 - tmp2, s);
        wp[16] = (int32_t)descale(tmp12 + tmp1, s);
        wp[40] = (int32_t)descale(tmp12 - tmp1, s);
        wp[24] = (int32_t)descale(tmp13 + tmp0, s);
        wp[32] = (int32_t)descale(tmp13 - tmp0, s);
    }
    const int s = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; ++r) {
        const int32_t* wp = ws + 8 * r;
        uint8_t* op = out + (int64_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t dc = clamp_sample(descale(wp[0], PASS1_BITS + 3));
            std::memset(op, dc, 8);
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
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
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        op[0] = clamp_sample(descale(tmp10 + tmp3, s));
        op[7] = clamp_sample(descale(tmp10 - tmp3, s));
        op[1] = clamp_sample(descale(tmp11 + tmp2, s));
        op[6] = clamp_sample(descale(tmp11 - tmp2, s));
        op[2] = clamp_sample(descale(tmp12 + tmp1, s));
        op[5] = clamp_sample(descale(tmp12 - tmp1, s));
        op[3] = clamp_sample(descale(tmp13 + tmp0, s));
        op[4] = clamp_sample(descale(tmp13 - tmp0, s));
    }
}

class Decoder {
  public:
    Decoder(const uint8_t* data, int64_t size) : r_(data, size) {}

    void read_header() {
        if (r_.left() < 2 || r_.byte() != 0xFF || r_.byte() != 0xD8)
            fail("not a JPEG stream (no SOI marker)");
        for (;;) {
            int m = next_marker();
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                read_sof(m);
                return;
            }
            handle_table_marker(m);
        }
    }

    int height() const { return height_; }
    int width() const { return width_; }
    int channels() const { return (int)comps_.size(); }

    void decode(uint8_t* out) {
        bool eoi = false;
        int m = next_marker();
        while (!eoi) {
            if (m == 0xDA) {
                read_sos_and_scan();
                ++scans_;
                m = next_marker();
            } else if (m == 0xD9) {
                eoi = true;
            } else if (m == 0xDC) {
                fail("DNL marker (image height defined after the first scan) not supported");
            } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                fail("corrupt stream: a second frame header");
            } else {
                handle_table_marker(m);
                m = next_marker();
            }
        }
        if (scans_ == 0) fail("corrupt stream: no scan before EOI");
        if (progressive_) check_progression();
        output(out);
    }

  private:
    Reader r_;
    int height_ = 0, width_ = 0;
    bool progressive_ = false;
    std::vector<Component> comps_;
    uint16_t qt_[4][64];
    bool qt_defined_[4] = {false, false, false, false};
    Huffman dc_[4], ac_[4];
    int restart_interval_ = 0;
    int max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
    bool jfif_ = false, adobe_ = false;
    int adobe_transform_ = -1;
    int scans_ = 0;
    int eobrun_ = 0;

    int next_marker() {
        int b = r_.byte();
        if (b != 0xFF) fail("corrupt stream: expected a marker");
        do {
            b = r_.byte();
        } while (b == 0xFF);
        if (b == 0) fail("corrupt stream: stuffed byte where a marker was expected");
        return b;
    }

    void handle_table_marker(int m) {
        if (m == 0xC4) {
            read_dht();
        } else if (m == 0xDB) {
            read_dqt();
        } else if (m == 0xDD) {
            int len = r_.u16();
            if (len != 4) fail("corrupt stream: bad DRI length");
            restart_interval_ = r_.u16();
        } else if (m == 0xCC) {
            fail("arithmetic coding (DAC marker) not supported");
        } else if (m == 0xE0 || m == 0xEE) {
            int len = r_.u16();
            if (len < 2 || r_.left() < len - 2) fail("truncated stream: ends inside a marker segment");
            const uint8_t* p = r_.ptr();
            if (m == 0xE0 && len >= 7 && !std::memcmp(p, "JFIF\0", 5)) jfif_ = true;
            if (m == 0xEE && len >= 14 && !std::memcmp(p, "Adobe", 5)) {
                adobe_ = true;
                adobe_transform_ = p[11];
            }
            r_.seek(r_.pos() + len - 2);
        } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {
            int len = r_.u16();
            if (len < 2 || r_.left() < len - 2) fail("truncated stream: ends inside a marker segment");
            r_.seek(r_.pos() + len - 2);
        } else if (m >= 0xD0 && m <= 0xD7) {
            fail("corrupt stream: restart marker outside a scan");
        } else if (m == 0xD8) {
            fail("corrupt stream: a second SOI marker");
        } else if (m == 0xD9) {
            fail("corrupt stream: EOI before the frame header");
        } else if (m == 0xDA) {
            fail("corrupt stream: scan before the frame header");
        } else {
            // other segments (APPn variants, reserved JPGn): skip by their length
            int len = r_.u16();
            if (len < 2 || r_.left() < len - 2) fail("truncated stream: ends inside a marker segment");
            r_.seek(r_.pos() + len - 2);
        }
    }

    void read_dht() {
        int len = r_.u16() - 2;
        while (len > 0) {
            int tc_th = r_.byte();
            int tc = tc_th >> 4, th = tc_th & 15;
            if (tc > 1 || th > 3) fail("corrupt stream: bad DHT table id");
            uint8_t counts[17] = {0};
            int total = 0;
            for (int i = 1; i <= 16; ++i) total += counts[i] = r_.byte();
            if (total > 256 || 17 + total > len) fail("corrupt stream: bad DHT length");
            uint8_t vals[256];
            for (int i = 0; i < total; ++i) vals[i] = r_.byte();
            build_huffman(tc ? ac_[th] : dc_[th], counts, vals, total);
            len -= 17 + total;
        }
        if (len != 0) fail("corrupt stream: bad DHT length");
    }

    void read_dqt() {
        int len = r_.u16() - 2;
        while (len > 0) {
            int pq_tq = r_.byte();
            int pq = pq_tq >> 4, tq = pq_tq & 15;
            if (pq > 1 || tq > 3) fail("corrupt stream: bad DQT table id");
            for (int i = 0; i < 64; ++i) qt_[tq][kNatural[i]] = (uint16_t)(pq ? r_.u16() : r_.byte());
            qt_defined_[tq] = true;
            len -= 1 + 64 * (pq + 1);
        }
        if (len != 0) fail("corrupt stream: bad DQT length");
    }

    void read_sof(int m) {
        switch (m) {
            case 0xC0: case 0xC1: break;
            case 0xC2: progressive_ = true; break;
            case 0xC3: fail("lossless JPEG (SOF3) not supported");
            case 0xC5: case 0xC6: case 0xC7: fail("hierarchical JPEG (SOF5-7) not supported");
            case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
                fail("arithmetic coding not supported");
            default: fail("corrupt stream: unknown frame type");
        }
        int len = r_.u16();
        int precision = r_.byte();
        height_ = r_.u16();
        width_ = r_.u16();
        int nc = r_.byte();
        if (precision != 8) fail(std::to_string(precision) + "-bit samples not supported (8-bit only)");
        if (height_ == 0) fail("DNL marker (image height defined after the first scan) not supported");
        if (width_ == 0) fail("corrupt stream: image width 0");
        if (nc == 4) fail("4-component (CMYK/YCCK) JPEG not supported");
        if (nc != 1 && nc != 3) fail("corrupt stream: " + std::to_string(nc) + " components");
        if (len != 8 + 3 * nc) fail("corrupt stream: bad SOF length");
        comps_.resize(nc);
        for (auto& c : comps_) {
            c.id = r_.byte();
            int hv = r_.byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = r_.byte();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                fail("corrupt stream: bad sampling factors or quant table id");
            max_h_ = std::max(max_h_, c.h);
            max_v_ = std::max(max_v_, c.v);
        }
        for (auto& c : comps_)
            if (max_h_ % c.h || max_v_ % c.v)
                fail("fractional sampling ratios not supported");
        mcus_x_ = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
        mcus_y_ = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
        for (auto& c : comps_) {
            c.dw = (int)(((int64_t)width_ * c.h + max_h_ - 1) / max_h_);
            c.dh = (int)(((int64_t)height_ * c.v + max_v_ - 1) / max_v_);
            c.wib = (c.dw + 7) / 8;
            c.hib = (c.dh + 7) / 8;
            c.bw = mcus_x_ * c.h;
            c.bh = mcus_y_ * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
        }
    }

    void read_sos_and_scan() {
        if (comps_.empty()) fail("corrupt stream: scan before the frame header");
        int len = r_.u16();
        int ns = r_.byte();
        if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("corrupt stream: bad SOS header");
        std::vector<Component*> sc;
        std::vector<int> td(ns), ta(ns);
        for (int i = 0; i < ns; ++i) {
            int cid = r_.byte();
            int t = r_.byte();
            Component* found = nullptr;
            for (auto& c : comps_)
                if (c.id == cid) found = &c;
            if (!found) fail("corrupt stream: scan names an unknown component");
            for (auto* c : sc)
                if (c == found) fail("corrupt stream: component twice in a scan");
            sc.push_back(found);
            td[i] = t >> 4;
            ta[i] = t & 15;
            if (td[i] > 3 || ta[i] > 3) fail("corrupt stream: bad Huffman table id");
        }
        int ss = r_.byte(), se = r_.byte(), ahal = r_.byte();
        int ah = ahal >> 4, al = ahal & 15;
        if (progressive_) {
            if (ss > 63 || se > 63 || ss > se || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
                al > 13 || ah > 13 || (ah != 0 && al != ah - 1))
                fail("corrupt stream: bad progressive scan parameters");
        } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
            fail("corrupt stream: bad sequential scan parameters");
        }
        if (ns > 1) {
            int blocks = 0;
            for (auto* c : sc) blocks += c->h * c->v;
            if (blocks > 10) fail("corrupt stream: more than 10 blocks in an MCU");
        }
        for (int i = 0; i < ns; ++i) {
            Component* c = sc[i];
            if (!c->qlatched) {
                if (!qt_defined_[c->tq]) fail("corrupt stream: quantization table not defined");
                std::memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
                c->qlatched = 1;
            }
            bool need_dc = ss == 0 && ah == 0, need_ac = ss > 0 || !progressive_;
            if (need_dc && !dc_[td[i]].defined) fail("corrupt stream: Huffman table not defined");
            if (need_ac && !ac_[ta[i]].defined) fail("corrupt stream: Huffman table not defined");
            if (progressive_) {
                for (int k = ss; k <= se; ++k) {
                    int expected = c->coef_bits[k] < 0 ? 0 : c->coef_bits[k];
                    if (ah != expected) fail("corrupt stream: bad progression (successive approximation)");
                    c->coef_bits[k] = al;
                }
            }
        }

        for (auto* c : sc) c->dc_pred = 0;
        eobrun_ = 0;
        r_.start_bits();

        // MCU geometry of this scan
        int mx, my;
        if (ns == 1) {
            mx = sc[0]->wib;
            my = sc[0]->hib;
        } else {
            mx = mcus_x_;
            my = mcus_y_;
        }
        const int64_t total = (int64_t)mx * my;
        int64_t todo = restart_interval_ ? restart_interval_ : total;
        int next_rst = 0;
        for (int64_t mcu = 0; mcu < total; ++mcu) {
            if (todo == 0) {
                int64_t p = r_.finish_segment();
                r_.seek(p);
                int m = next_marker();
                if (m != 0xD0 + next_rst) fail("corrupt stream: missing or out-of-order restart marker");
                next_rst = (next_rst + 1) & 7;
                for (auto* c : sc) c->dc_pred = 0;
                eobrun_ = 0;
                r_.start_bits();
                todo = restart_interval_;
            }
            const int x = (int)(mcu % mx), y = (int)(mcu / mx);
            if (ns == 1) {
                decode_block(*sc[0], x, y, td[0], ta[0], ss, se, ah, al);
            } else {
                for (int i = 0; i < ns; ++i) {
                    Component& c = *sc[i];
                    for (int by = 0; by < c.v; ++by)
                        for (int bx = 0; bx < c.h; ++bx)
                            decode_block(c, x * c.h + bx, y * c.v + by, td[i], ta[i], ss, se, ah, al);
                }
            }
            --todo;
        }
        r_.seek(r_.finish_segment());
    }

    // The DC prediction, refused where it would leave int (libjpeg-turbo's JERR_BAD_DCT_COEF).
    static void add_dc(Component& c, int diff) {
        const int64_t v = (int64_t)c.dc_pred + diff;
        if (v > INT32_MAX || v < INT32_MIN) fail("corrupt stream: DC coefficient out of range");
        c.dc_pred = (int)v;
    }

    void decode_block(Component& c, int bx, int by, int td, int ta, int ss, int se, int ah, int al) {
        int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
        if (!progressive_) {
            int s = r_.decode(dc_[td]);
            if (s > 15) fail("corrupt stream: bad DC magnitude");
            add_dc(c, r_.receive_extend(s));
            blk[0] = (int16_t)c.dc_pred;
            const Huffman& h = ac_[ta];
            for (int k = 1; k < 64; ++k) {
                int rs = r_.decode(h);
                int run = rs >> 4, s2 = rs & 15;
                if (s2) {
                    k += run;
                    if (k > 63) fail("corrupt stream: coefficient index past 63");
                    blk[kNatural[k]] = (int16_t)r_.receive_extend(s2);
                } else {
                    if (run != 15) break;
                    k += 15;
                }
            }
            return;
        }
        if (ss == 0) {  // DC scans
            if (ah == 0) {
                int s = r_.decode(dc_[td]);
                if (s > 15) fail("corrupt stream: bad DC magnitude");
                add_dc(c, r_.receive_extend(s));
                blk[0] = (int16_t)((int64_t)c.dc_pred * (1 << al));
            } else if (r_.bit()) {
                blk[0] = (int16_t)(blk[0] | (1 << al));
            }
            return;
        }
        const Huffman& h = ac_[ta];
        if (ah == 0) {  // AC first pass
            if (eobrun_ > 0) {
                --eobrun_;
                return;
            }
            for (int k = ss; k <= se; ++k) {
                int rs = r_.decode(h);
                int run = rs >> 4, s = rs & 15;
                if (s) {
                    k += run;
                    if (k > se) fail("corrupt stream: coefficient index past the band");
                    blk[kNatural[k]] = (int16_t)(r_.receive_extend(s) * (1 << al));
                } else if (run == 15) {
                    k += 15;
                } else {
                    eobrun_ = 1 << run;
                    if (run) eobrun_ += r_.bits(run);
                    --eobrun_;
                    break;
                }
            }
            return;
        }
        // AC refinement (jdphuff.c decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        if (eobrun_ == 0) {
            for (; k <= se; ++k) {
                int rs = r_.decode(h);
                int run = rs >> 4, s = rs & 15;
                if (s) {
                    if (s != 1) fail("corrupt stream: bad refinement coefficient size");
                    s = r_.bit() ? p1 : m1;
                } else if (run != 15) {
                    eobrun_ = 1 << run;
                    if (run) eobrun_ += r_.bits(run);
                    break;
                }
                do {
                    int16_t* coef = blk + kNatural[k];
                    if (*coef != 0) {
                        if (r_.bit() && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                    } else {
                        if (--run < 0) break;
                    }
                    ++k;
                } while (k <= se);
                if (s) {
                    if (k > se) fail("corrupt stream: coefficient index past the band");
                    blk[kNatural[k]] = (int16_t)s;
                }
            }
        }
        if (eobrun_ > 0) {
            for (; k <= se; ++k) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0 && r_.bit() && (*coef & p1) == 0)
                    *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            --eobrun_;
        }
    }

    // libjpeg smooths blocks (jdcoefct.c) when the scans left the DC or any of the first
    // nine AC coefficients of a component not fully known: such files are refused.
    void check_progression() {
        for (auto& c : comps_)
            for (int k = 0; k < 10; ++k)
                if (c.coef_bits[k] != 0)
                    fail("incomplete progressive JPEG (scans leave low coefficients unrefined; "
                         "libjpeg would apply block smoothing)");
    }

    // One component's samples at its own resolution, [bh*8][bw*8].
    std::vector<uint8_t> component_plane(const Component& c) const {
        const int stride = c.bw * 8;
        std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
        for (int by = 0; by < c.bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                           &plane[(size_t)by * 8 * stride + bx * 8], stride);
        return plane;
    }

    // Upsample a component plane to width_ x height_ (jdsample.c, do_fancy_upsampling).
    std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane) const {
        const int fx = max_h_ / c.h, fy = max_v_ / c.v;
        const int stride = c.bw * 8;
        const int W = width_, H = height_;
        std::vector<uint8_t> out((size_t)W * H);
        // the component's own samples with one replicated sample on every side, so that
        // in(y, x) reads -1 <= y <= dh and -1 <= x <= dw
        const int pw = c.dw + 2;
        std::vector<uint8_t> pad((size_t)pw * (c.dh + 2));
        for (int y = -1; y <= c.dh; ++y) {
            const uint8_t* src = &plane[(size_t)std::min(std::max(y, 0), c.dh - 1) * stride];
            uint8_t* dst = &pad[(size_t)(y + 1) * pw];
            std::memcpy(dst + 1, src, c.dw);
            dst[0] = src[0];
            dst[c.dw + 1] = src[c.dw - 1];
        }
        auto in = [&](int y, int x) -> int { return pad[(size_t)(y + 1) * pw + x + 1]; };
        if (fx == 1 && fy == 1) {
            for (int y = 0; y < H; ++y) std::memcpy(&out[(size_t)y * W], &plane[(size_t)y * stride], W);
        } else if (fx == 2 && fy == 1) {
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) {
                    int j = x >> 1;
                    int v = in(y, j) * 3;
                    out[(size_t)y * W + x] =
                        (x & 1) ? (uint8_t)((v + in(y, j + 1) + 2) >> 2) : (uint8_t)((v + in(y, j - 1) + 1) >> 2);
                }
        } else if (fx == 1 && fy == 2) {
            for (int y = 0; y < H; ++y) {
                int i = y >> 1, other = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
                for (int x = 0; x < W; ++x)
                    out[(size_t)y * W + x] = (uint8_t)((in(i, x) * 3 + in(other, x) + bias) >> 2);
            }
        } else if (fx == 2 && fy == 2) {
            for (int y = 0; y < H; ++y) {
                int i = y >> 1, other = (y & 1) ? i + 1 : i - 1;
                for (int x = 0; x < W; ++x) {
                    int j = x >> 1;
                    int thiscol = in(i, j) * 3 + in(other, j);
                    int v;
                    if (x & 1) {
                        int nextcol = in(i, j + 1) * 3 + in(other, j + 1);
                        v = (thiscol * 3 + nextcol + 7) >> 4;
                    } else {
                        int lastcol = in(i, j - 1) * 3 + in(other, j - 1);
                        v = (thiscol * 3 + lastcol + 8) >> 4;
                    }
                    out[(size_t)y * W + x] = (uint8_t)v;
                }
            }
        } else {
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x) out[(size_t)y * W + x] = plane[(size_t)(y / fy) * stride + x / fx];
        }
        return out;
    }

    void output(uint8_t* out) const {
        const size_t npix = (size_t)width_ * height_;
        if (comps_.size() == 1) {
            std::vector<uint8_t> plane = component_plane(comps_[0]);
            const int stride = comps_[0].bw * 8;
            for (int y = 0; y < height_; ++y)
                std::memcpy(out + (size_t)y * width_, &plane[(size_t)y * stride], width_);
            return;
        }
        std::vector<uint8_t> full[3];
        for (int i = 0; i < 3; ++i) full[i] = upsample(comps_[i], component_plane(comps_[i]));
        // jdapimin.c default_decompress_parms: JFIF -> YCbCr; Adobe transform 0 -> RGB;
        // no marker: component ids 'R','G','B' -> RGB; otherwise YCbCr.
        bool rgb;
        if (jfif_) rgb = false;
        else if (adobe_) rgb = adobe_transform_ == 0;
        else rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
        if (rgb) {
            for (size_t p = 0; p < npix; ++p)
                for (int i = 0; i < 3; ++i) out[3 * p + i] = full[i][p];
            return;
        }
        // jdcolor.c build_ycc_rgb_table: 16-bit fixed point, rounded by ONE_HALF
        int cr_r[256], cb_b[256];
        int32_t cr_g[256], cb_g[256];
        const int SCALEBITS = 16;
        const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
        auto FIX = [](double x) { return (int32_t)(x * (1 << 16) + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -FIX(0.71414) * x;
            cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
        }
        auto lim = [](int v) { return (uint8_t)std::min(255, std::max(0, v)); };
        const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
        for (size_t p = 0; p < npix; ++p) {
            int y = Y[p], cb = Cb[p], cr = Cr[p];
            out[3 * p + 0] = lim(y + cr_r[cr]);
            out[3 * p + 1] = lim(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
            out[3 * p + 2] = lim(y + cb_b[cb]);
        }
    }
};

void set_error(char* err, int64_t errlen, const std::string& msg) {
    if (errlen <= 0) return;
    size_t n = std::min((size_t)errlen - 1, msg.size());
    std::memcpy(err, msg.data(), n);
    err[n] = 0;
}

}  // namespace

extern "C" {

// Frame size of a JPEG stream: hwc = {height, width, channels}. Returns 0, or 1 with a
// message in err.
int jpeg_header(const uint8_t* data, int64_t size, int32_t* hwc, char* err, int64_t errlen) {
    try {
        Decoder dec(data, size);
        dec.read_header();
        hwc[0] = dec.height();
        hwc[1] = dec.width();
        hwc[2] = dec.channels();
        return 0;
    } catch (const JpegError& e) {
        set_error(err, errlen, e.msg);
    } catch (const std::exception& e) {
        set_error(err, errlen, std::string("decoder failure: ") + e.what());
    }
    return 1;
}

// Decode into out [height, width, channels] uint8 (out_size bytes). Returns 0, or 1 with
// a message in err.
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size, char* err,
                int64_t errlen) {
    try {
        Decoder dec(data, size);
        dec.read_header();
        if ((int64_t)dec.height() * dec.width() * dec.channels() != out_size)
            fail("output buffer size does not match the frame");
        dec.decode(out);
        return 0;
    } catch (const JpegError& e) {
        set_error(err, errlen, e.msg);
    } catch (const std::exception& e) {
        set_error(err, errlen, std::string("decoder failure: ") + e.what());
    }
    return 1;
}

}  // extern "C"
