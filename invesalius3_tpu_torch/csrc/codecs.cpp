// DICOM pixel-data codecs on the host: lossless JPEG (process 14, SOF3)
// decode and PackBits (RLE segment) decode.
//
// The port's copy of the JAX package's native codecs: jpegll_decode as it
// is; packbits_decode ends a segment as the JAX package's Python decoder
// does (see there), so every segment decodes here and none needs Python.
// The reference decompresses encapsulated transfer syntaxes through GDCM
// (reference invesalius/reader/dicom_reader.py:86-140); these decode the
// two syntaxes clinical CT/MR exports use losslessly: JPEG Lossless
// Non-Hierarchical (1.2.840.10008.1.2.4.57/.70, ITU T.81 process 14) and RLE
// Lossless (1.2.840.10008.1.2.5, PS3.5 Annex G PackBits).
// Built by g++ through _build.py.
//
// C ABI (ctypes):
//   jpegll_decode(src, n, out_u16, out_cap, &rows, &cols, &ncomp) -> rc
//   packbits_decode(src, n, dst, dst_cap) -> bytes written

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t bits = 0;   // bit buffer (MSB-aligned consumption)
    int nbits = 0;
    bool marker_hit = false;  // stopped at a non-stuffed marker

    BitReader(const uint8_t* s, const uint8_t* e) : p(s), end(e) {}

    // Refill up to >=16 bits.  0xFF00 unstuffs to a literal 0xFF; a real
    // marker (0xFF followed by anything else) ends the entropy stream.
    void fill() {
        while (nbits <= 24 && p < end && !marker_hit) {
            uint8_t b = *p;
            if (b == 0xFF) {
                if (p + 1 < end && p[1] == 0x00) {
                    p += 2;
                } else {
                    marker_hit = true;
                    break;
                }
            } else {
                p += 1;
            }
            bits |= uint32_t(b) << (24 - nbits);
            nbits += 8;
        }
    }

    int get(int n) {  // read n bits (n <= 16)
        if (n == 0) return 0;
        if (nbits < n) fill();
        if (nbits < n) return -1;  // truncated
        int v = int(bits >> (32 - n));
        bits <<= n;
        nbits -= n;
        return v;
    }

    int peek16() {
        if (nbits < 16) fill();
        return int(bits >> 16);
    }

    void drop(int n) { bits <<= n; nbits -= n; }
};

struct Huff {
    // Canonical table: for each code length L (1..16) the smallest code
    // value and the symbol index base; flat 16-bit lookup for speed.
    uint8_t lut_sym[1 << 16];
    uint8_t lut_len[1 << 16];
    bool ok = false;

    void build(const uint8_t* bits /*[16]*/, const uint8_t* vals, int nvals) {
        std::memset(lut_len, 0, sizeof(lut_len));
        uint32_t code = 0;
        int k = 0;
        for (int len = 1; len <= 16; ++len) {
            for (int i = 0; i < bits[len - 1]; ++i) {
                if (k >= nvals) return;
                uint32_t lo = code << (16 - len);
                uint32_t hi = lo + (1u << (16 - len));
                for (uint32_t c = lo; c < hi; ++c) {
                    lut_sym[c] = vals[k];
                    lut_len[c] = uint8_t(len);
                }
                ++code;
                ++k;
            }
            code <<= 1;
        }
        ok = true;
    }

    int decode(BitReader& br) const {
        int idx = br.peek16();
        if (idx < 0) return -1;
        int len = lut_len[idx];
        if (len == 0) return -1;
        if (br.nbits < len) return -1;
        br.drop(len);
        return lut_sym[idx];
    }
};

inline int extend(int v, int ssss) {
    // ITU T.81 F.2.2.1 EXTEND: map magnitude bits to signed difference.
    if (ssss == 0) return 0;
    if (ssss == 16) return -32768;  // lossless special case: diff = 32768
    if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
    return v;
}

inline uint16_t rd16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }

}  // namespace

extern "C" {

// Decode one lossless-JPEG frame.  out is caller-allocated uint16 of
// capacity out_cap samples.  Returns 0 on success; negative error codes.
int jpegll_decode(const uint8_t* src, int64_t n, uint16_t* out,
                  int64_t out_cap, int32_t* rows_out, int32_t* cols_out,
                  int32_t* ncomp_out) {
    if (n < 4 || src[0] != 0xFF || src[1] != 0xD8) return -1;  // no SOI
    int64_t pos = 2;
    int precision = 0, rows = 0, cols = 0, ncomp = 0;
    int comp_dc_tbl[4] = {0, 0, 0, 0};
    int scan_comp[4] = {0, 0, 0, 0};
    int predictor = 1, pt = 0, ri = 0;
    Huff tables[4];
    int64_t scan_start = -1;

    while (pos + 4 <= n) {
        if (src[pos] != 0xFF) { ++pos; continue; }
        uint8_t m = src[pos + 1];
        pos += 2;
        if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
        if (m == 0xD9) break;  // EOI
        if (pos + 2 > n) return -2;
        int seglen = rd16(src + pos);
        if (pos + seglen > n) return -2;
        const uint8_t* seg = src + pos + 2;
        int paylen = seglen - 2;
        if (m == 0xC3 || m == 0xC7 || m == 0xCB) {  // SOF3 / SOF7 / SOF11
            if (paylen < 6) return -3;
            precision = seg[0];
            rows = rd16(seg + 1);
            cols = rd16(seg + 3);
            ncomp = seg[5];
            if (ncomp < 1 || ncomp > 4 || paylen < 6 + 3 * ncomp) return -3;
        } else if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC5 ||
                   m == 0xC6 || m == 0xC9 || m == 0xCA || m == 0xCD ||
                   m == 0xCE || m == 0xCF) {
            return -4;  // lossy/arithmetic SOF: not process 14
        } else if (m == 0xC4) {  // DHT
            int off = 0;
            while (off + 17 <= paylen) {
                int tc = seg[off] >> 4, th = seg[off] & 0x0F;
                const uint8_t* bits = seg + off + 1;
                int nvals = 0;
                for (int i = 0; i < 16; ++i) nvals += bits[i];
                if (off + 17 + nvals > paylen || th > 3) return -5;
                if (tc == 0) tables[th].build(bits, seg + off + 17, nvals);
                off += 17 + nvals;
            }
        } else if (m == 0xDD) {  // DRI
            if (paylen >= 2) ri = rd16(seg);
        } else if (m == 0xDA) {  // SOS
            if (paylen < 1) return -6;
            int ns = seg[0];
            if (ns < 1 || ns > 4 || paylen < 1 + 2 * ns + 3) return -6;
            for (int i = 0; i < ns; ++i) {
                scan_comp[i] = seg[1 + 2 * i];
                comp_dc_tbl[i] = seg[2 + 2 * i] >> 4;
            }
            predictor = seg[1 + 2 * ns];      // Ss
            pt = seg[3 + 2 * ns] & 0x0F;      // Al
            scan_start = pos + seglen;
            break;
        }
        pos += seglen;
    }
    (void)scan_comp;

    if (scan_start < 0 || rows <= 0 || cols <= 0 || ncomp <= 0) return -7;
    if (precision < 2 || precision > 16) return -7;
    if (predictor < 1 || predictor > 7) return -7;
    if (int64_t(rows) * cols * ncomp > out_cap) return -8;

    BitReader br(src + scan_start, src + n);
    const int default_pred = 1 << (precision - pt - 1);
    int64_t samples_per_row = int64_t(cols) * ncomp;
    int64_t count_since_rst = 0;
    bool rst_reset = true;  // treat start-of-scan like a restart boundary

    for (int y = 0; y < rows; ++y) {
        for (int x = 0; x < cols; ++x) {
            for (int c = 0; c < ncomp; ++c) {
                const Huff& h = tables[comp_dc_tbl[c]];
                if (!h.ok) return -9;
                int ssss = h.decode(br);
                if (ssss < 0) return -10;
                int diff;
                if (ssss == 16) {
                    diff = 32768;
                } else {
                    int extra = br.get(ssss);
                    if (extra < 0) return -10;
                    diff = extend(extra, ssss);
                }
                int64_t idx = int64_t(y) * samples_per_row + int64_t(x) * ncomp + c;
                int px;
                if (rst_reset && x == 0) {
                    // first sample after (re)start: default prediction;
                    // rest of that first row predicts from the left
                    px = default_pred;
                } else if (y == 0 || rst_reset) {
                    px = x == 0 ? default_pred : out[idx - ncomp];
                } else if (x == 0) {
                    px = out[idx - samples_per_row];  // Rb
                } else {
                    int ra = out[idx - ncomp];
                    int rb = out[idx - samples_per_row];
                    int rc_ = out[idx - samples_per_row - ncomp];
                    switch (predictor) {
                        case 1: px = ra; break;
                        case 2: px = rb; break;
                        case 3: px = rc_; break;
                        case 4: px = ra + rb - rc_; break;
                        case 5: px = ra + ((rb - rc_) >> 1); break;
                        case 6: px = rb + ((ra - rc_) >> 1); break;
                        default: px = (ra + rb) >> 1; break;
                    }
                }
                out[idx] = uint16_t((px + diff) & 0xFFFF);
            }
        }
        rst_reset = false;
        if (ri > 0) {
            count_since_rst += cols;  // MCUs per row (one sample per comp)
            if (count_since_rst >= ri && y + 1 < rows) {
                count_since_rst = 0;
                // skip to the RST marker: byte-align and consume it
                br.bits = 0; br.nbits = 0; br.marker_hit = false;
                while (br.p + 1 < br.end && !(br.p[0] == 0xFF && br.p[1] >= 0xD0 && br.p[1] <= 0xD7))
                    ++br.p;
                if (br.p + 1 < br.end) br.p += 2;
                rst_reset = true;  // next row restarts prediction
            }
        }
    }

    if (pt > 0) {
        int64_t total = int64_t(rows) * samples_per_row;
        for (int64_t i = 0; i < total; ++i) out[i] = uint16_t(out[i] << pt);
    }
    *rows_out = rows;
    *cols_out = cols;
    *ncomp_out = ncomp;
    return 0;
}

// PackBits (TIFF/DICOM RLE segment) decode.  Returns the bytes written (at
// most cap).  Stops once cap bytes are written, and a run cut short by the
// end of the segment yields what it holds: the JAX package's Python decoder
// does the same, and the JAX package falls back to it whenever its native
// decoder rejects a segment (an RLE segment's even-length pad byte reads as
// a literal header with nothing after it).
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
    int64_t i = 0, o = 0;
    while (i < n && o < cap) {
        int8_t h = int8_t(src[i++]);
        if (h >= 0) {
            int64_t len = std::min(int64_t(h) + 1, n - i);
            len = std::min(len, cap - o);
            std::memcpy(dst + o, src + i, size_t(len));
            i += int64_t(h) + 1;
            o += len;
        } else if (h != -128) {
            int64_t len = std::min(1 - int64_t(h), cap - o);
            if (i < n) {
                std::memset(dst + o, src[i], size_t(len));
                o += len;
            }
            i += 1;
        }
    }
    return o;
}

}  // extern "C"
