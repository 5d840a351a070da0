// Native acceleration for the builtin PDF rasterizer's byte-level hot loops.
//
// The PyTorch port's copy of the JAX package's native source
// (dots_ocr_tpu/native/minipdf_accel.cc), whole: the PDF filters, the JBIG2
// decoders and the vision patcher's im2col. The pure-Python fallbacks in
// dots_ocr_tpu_torch/ingest/minipdf.py are correct but slow on
// multi-megabyte page images. Compiled on demand by
// dots_ocr_tpu_torch/native/__init__.py (c++ -O3) into native/build/;
// loaded via ctypes; every entry point has a Python fallback.
//
// Exposed C ABI:
//   png_unpredict(data, n, predictor, columns, colors, bpc, out, out_cap)
//       -> bytes written (PNG row filters 0-4 + TIFF predictor 2)
//   runlength_decode(data, n, out, out_cap) -> bytes written or -1
//   composite_over(dst, src, mask, n)       -> alpha-composite helper

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

// Returns number of output bytes written, or -1 on error.
long png_unpredict(const uint8_t* data, long n, int predictor, int columns,
                   int colors, int bpc, uint8_t* out, long out_cap) {
    if (predictor == 2) {  // TIFF horizontal differencing (8-bit only)
        if (bpc != 8) return -1;
        long row_len = (long)columns * colors;
        if (n > out_cap) return -1;
        std::memcpy(out, data, (size_t)n);
        for (long r = 0; r + row_len <= n; r += row_len) {
            for (long i = colors; i < row_len; i++) {
                out[r + i] = (uint8_t)(out[r + i] + out[r + i - colors]);
            }
        }
        return n;
    }
    if (predictor < 10) {
        if (n > out_cap) return -1;
        std::memcpy(out, data, (size_t)n);
        return n;
    }
    // PNG row filters: each row is [filter_type, row_len bytes].
    long bpp = ((long)colors * bpc) / 8;
    if (bpp < 1) bpp = 1;
    long row_len = ((long)columns * colors * bpc + 7) / 8;
    uint8_t* prev = new uint8_t[row_len];
    std::memset(prev, 0, (size_t)row_len);

    long pos = 0;
    long written = 0;
    while (pos < n) {
        int ft = data[pos++];
        long avail = n - pos;
        long take = avail < row_len ? avail : row_len;
        if (written + row_len > out_cap) { delete[] prev; return -1; }
        uint8_t* row = out + written;
        std::memcpy(row, data + pos, (size_t)take);
        if (take < row_len) std::memset(row + take, 0, (size_t)(row_len - take));
        pos += take;

        switch (ft) {
            case 0: break;
            case 1:
                for (long i = bpp; i < row_len; i++) row[i] = (uint8_t)(row[i] + row[i - bpp]);
                break;
            case 2:
                for (long i = 0; i < row_len; i++) row[i] = (uint8_t)(row[i] + prev[i]);
                break;
            case 3:
                for (long i = 0; i < row_len; i++) {
                    int left = i >= bpp ? row[i - bpp] : 0;
                    row[i] = (uint8_t)(row[i] + ((left + prev[i]) >> 1));
                }
                break;
            case 4:
                for (long i = 0; i < row_len; i++) {
                    int a = i >= bpp ? row[i - bpp] : 0;
                    int c = i >= bpp ? prev[i - bpp] : 0;
                    row[i] = (uint8_t)(row[i] + paeth(a, prev[i], c));
                }
                break;
            default:
                break;  // unknown filter: leave raw (matches fallback laxity)
        }
        std::memcpy(prev, row, (size_t)row_len);
        written += row_len;
    }
    delete[] prev;
    return written;
}

long runlength_decode(const uint8_t* data, long n, uint8_t* out, long out_cap) {
    long i = 0, w = 0;
    while (i < n) {
        int len = data[i++];
        if (len == 128) break;
        if (len < 128) {
            long cnt = len + 1;
            if (i + cnt > n) cnt = n - i;
            if (w + cnt > out_cap) return -1;
            std::memcpy(out + w, data + i, (size_t)cnt);
            i += cnt;
            w += cnt;
        } else {
            long cnt = 257 - len;
            if (i >= n) break;
            if (w + cnt > out_cap) return -1;
            std::memset(out + w, data[i], (size_t)cnt);
            i += 1;
            w += cnt;
        }
    }
    return w;
}

// TIFF/PDF LZW (PDF 1.7 §7.4.4): variable-width 9-12 bit codes
// MSB-first, 256 = clear, 257 = EOD; `early` (EarlyChange) bumps the
// width one code ahead. Table entries are (prev_code, appended_byte)
// pairs expanded back-to-front into a scratch buffer. Returns bytes
// written, -1 on out_cap overflow (caller retries bigger), -2 on a
// corrupt stream.
long lzw_decode(const uint8_t* data, long n, int early,
                uint8_t* out, long out_cap) {
    const int MAXCODES = 4096;
    int prev_of[4096];
    uint8_t byte_of[4096];
    uint8_t buf[4096];
    int next = 258, width = 9, prev = -1;
    long w = 0;
    unsigned long long acc = 0;
    int nbits = 0;
    for (long p = 0; p < n; ++p) {
        acc = (acc << 8) | data[p];
        nbits += 8;
        while (nbits >= width) {
            int code = (int)((acc >> (nbits - width)) & ((1u << width) - 1));
            nbits -= width;
            if (code == 256) { next = 258; width = 9; prev = -1; continue; }
            if (code == 257) return w;
            long len = 0;
            long i = MAXCODES;
            int c;
            if (prev < 0) {
                if (code >= 256) return -2;
                buf[--i] = (uint8_t)code;
                prev = code;
            } else if (code < next && code != 256 && code != 257) {
                c = code;
                while (c >= 258) { buf[--i] = byte_of[c]; c = prev_of[c]; }
                if (c >= 256) return -2;
                buf[--i] = (uint8_t)c;
                if (next < MAXCODES) {
                    prev_of[next] = prev;
                    byte_of[next] = buf[i];
                    next++;
                }
                prev = code;
            } else if (code == next) {  // KwKwK
                c = prev;
                while (c >= 258) { buf[--i] = byte_of[c]; c = prev_of[c]; }
                if (c >= 256) return -2;
                buf[--i] = (uint8_t)c;
                uint8_t first = buf[i];
                if (next < MAXCODES) {
                    prev_of[next] = prev;
                    byte_of[next] = first;
                    next++;
                }
                // entry = prev-string + its first byte: shift what we
                // expanded and append.
                long plen = MAXCODES - i;
                if (w + plen + 1 > out_cap) return -1;
                std::memcpy(out + w, buf + i, (size_t)plen);
                out[w + plen] = first;
                w += plen + 1;
                prev = next - 1;
                if (next + early >= (1 << width) && width < 12) width++;
                continue;
            } else {
                return -2;
            }
            len = MAXCODES - i;
            if (w + len > out_cap) return -1;
            std::memcpy(out + w, buf + i, (size_t)len);
            w += len;
            if (next + early >= (1 << width) && width < 12) width++;
        }
    }
    return w;
}

// RC4 stream cipher (PDF standard security handler).
void rc4(const uint8_t* key, int keylen, const uint8_t* data, long n,
         uint8_t* out) {
    uint8_t s[256];
    for (int i = 0; i < 256; ++i) s[i] = (uint8_t)i;
    int j = 0;
    for (int i = 0; i < 256; ++i) {
        j = (j + s[i] + key[i % keylen]) & 0xFF;
        uint8_t t = s[i]; s[i] = s[j]; s[j] = t;
    }
    int i = 0;
    j = 0;
    for (long p = 0; p < n; ++p) {
        i = (i + 1) & 0xFF;
        j = (j + s[i]) & 0xFF;
        uint8_t t = s[i]; s[i] = s[j]; s[j] = t;
        out[p] = data[p] ^ s[(s[i] + s[j]) & 0xFF];
    }
}

// Single-pass im2col + emission-order reorder for the vision patcher
// (preprocess.extract_patches). The numpy path makes 2-3 full-image
// passes (reshape/transpose copy, then a gather by the emission perm);
// on a 1-core serving host that's a measurable slice of per-page submit
// time. Here each emitted token's 14x14x3 patch is copied straight from
// the strided image rows to its final row — one pass, pure memcpy.
//
// img:  [H, W, C] uint8, row-major;  perm: [n_tokens] int32 patch index
// in (gy * grid_w + gx) order, -1 = padded window slot (zero-filled);
// out:  [n_tokens, p*p*C] uint8.  Returns 0, or -1 on bad geometry.
long patchify(const unsigned char* img, int H, int W, int C, int p,
              const int* perm, long n_tokens, int grid_w,
              unsigned char* out) {
    if (p <= 0 || C <= 0 || grid_w <= 0 || W < p * grid_w) return -1;
    const long patch_bytes = (long)p * p * C;
    const long row_bytes = (long)p * C;
    const long img_row = (long)W * C;
    const int grid_h = H / p;
    for (long t = 0; t < n_tokens; ++t) {
        unsigned char* dst = out + t * patch_bytes;
        int q = perm[t];
        if (q < 0) {
            std::memset(dst, 0, (size_t)patch_bytes);
            continue;
        }
        int gy = q / grid_w, gx = q % grid_w;
        if (gy >= grid_h) return -1;
        const unsigned char* src = img + (long)gy * p * img_row
                                       + (long)gx * row_bytes;
        for (int r = 0; r < p; ++r) {
            std::memcpy(dst + r * row_bytes, src + r * img_row,
                        (size_t)row_bytes);
        }
    }
    return 0;
}

// ---------------------------------------------------------------------
// JBIG2 arithmetic generic-region decode (ITU-T T.88). Mirrors
// ingest/jbig2.py exactly (MQ coder Annex E + template contexts with
// the (y,x)-sorted MSB-first bit ordering); full-page generic regions
// are per-pixel sequential and ~2 orders of magnitude faster here.

static const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
static const uint8_t kNMPS[47] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t kNLPS[47] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t kSwitch[47] = {
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

typedef struct {
    const uint8_t* data;
    long n, bp;
    uint32_t c, a;
    int ct;
} MQDec;

static void mq_bytein(MQDec* d) {
    uint8_t b = d->bp < d->n ? d->data[d->bp] : 0xFF;
    if (b == 0xFF) {
        uint8_t b1 = d->bp + 1 < d->n ? d->data[d->bp + 1] : 0xFF;
        if (b1 > 0x8F) {
            d->c += 0xFF00;
            d->ct = 8;
        } else {
            d->bp += 1;
            d->c += (uint32_t)b1 << 9;
            d->ct = 7;
        }
    } else {
        d->bp += 1;
        uint8_t b1 = d->bp < d->n ? d->data[d->bp] : 0xFF;
        d->c += (uint32_t)b1 << 8;
        d->ct = 8;
    }
}

static void mq_init(MQDec* d, const uint8_t* data, long n) {
    d->data = data;
    d->n = n;
    d->bp = 0;
    d->c = (uint32_t)(n ? data[0] : 0xFF) << 16;
    mq_bytein(d);
    d->c <<= 7;
    d->ct -= 7;
    d->a = 0x8000;
}

static int mq_decode(MQDec* d, uint8_t* icx, uint8_t* mps, int cx) {
    uint8_t i = icx[cx];
    uint32_t qe = kQe[i];
    int dbit;
    d->a -= qe;
    if (((d->c >> 16) & 0xFFFF) < qe) {
        if (d->a < qe) {
            dbit = mps[cx];
            icx[cx] = kNMPS[i];
        } else {
            dbit = 1 - mps[cx];
            if (kSwitch[i]) mps[cx] ^= 1;
            icx[cx] = kNLPS[i];
        }
        d->a = qe;
        do {
            if (d->ct == 0) mq_bytein(d);
            d->a = (d->a << 1) & 0xFFFF;
            d->c <<= 1;
            d->ct -= 1;
        } while (!(d->a & 0x8000));
        return dbit;
    }
    d->c -= qe << 16;
    if (d->a & 0x8000) return mps[cx];
    if (d->a < qe) {
        dbit = 1 - mps[cx];
        if (kSwitch[i]) mps[cx] ^= 1;
        icx[cx] = kNLPS[i];
    } else {
        dbit = mps[cx];
        icx[cx] = kNMPS[i];
    }
    do {
        if (d->ct == 0) mq_bytein(d);
        d->a = (d->a << 1) & 0xFFFF;
        d->c <<= 1;
        d->ct -= 1;
    } while (!(d->a & 0x8000));
    return dbit;
}

// Decode one generic region into `out` using a live coder + contexts.
static void generic_into(MQDec* d, uint8_t* icx, uint8_t* mps, int width,
                         int height, int npix, const int8_t* dx,
                         const int8_t* dy, int tpgdon, int sltp_cx,
                         uint8_t* out) {
    int ltp = 0;
    for (int y = 0; y < height; ++y) {
        if (tpgdon) {
            if (mq_decode(d, icx, mps, sltp_cx)) ltp ^= 1;
            if (ltp) {
                if (y > 0)
                    std::memcpy(out + (long)y * width,
                                out + (long)(y - 1) * width, (size_t)width);
                else
                    std::memset(out + (long)y * width, 0, (size_t)width);
                continue;
            }
        }
        uint8_t* row = out + (long)y * width;
        for (int x = 0; x < width; ++x) {
            int cx = 0;
            for (int k = 0; k < npix; ++k) {
                int xx = x + dx[k], yy = y + dy[k];
                int bit = 0;
                if (yy >= 0 && yy < height && xx >= 0 && xx < width &&
                    (yy < y || (yy == y && xx < x)))
                    bit = out[(long)yy * width + xx];
                cx = (cx << 1) | bit;
            }
            row[x] = (uint8_t)mq_decode(d, icx, mps, cx);
        }
    }
}

// out: uint8[height*width] (0/1). dx/dy: template pixel offsets sorted
// by (dy, dx), MSB first — npix <= 16. Returns 0, or -1 on bad input.
int jbig2_generic(const uint8_t* data, long n, int width, int height,
                  int npix, const int8_t* dx, const int8_t* dy,
                  int tpgdon, int sltp_cx, uint8_t* out) {
    if (npix <= 0 || npix > 16 || width <= 0 || height <= 0) return -1;
    int ncx = 1 << npix;
    uint8_t* icx = (uint8_t*)calloc((size_t)ncx * 2, 1);
    if (!icx) return -1;
    uint8_t* mps = icx + ncx;
    MQDec d;
    mq_init(&d, data, n);
    generic_into(&d, icx, mps, width, height, npix, dx, dy, tpgdon,
                 sltp_cx, out);
    free(icx);
    return 0;
}

// T.88 Annex A arithmetic integer decoding over a 512-context tree.
// Returns 1 with *out set, or 0 for OOB.
static int mq_int(MQDec* d, uint8_t* icx, uint8_t* mps, int* out) {
    int prev = 1;
    int bits_total = 0;
#define IBIT(var)                                                     \
    do {                                                              \
        var = mq_decode(d, icx, mps, prev);                           \
        prev = prev < 256 ? ((prev << 1) | var)                       \
                          : (((((prev << 1) | var)) & 511) | 256);    \
    } while (0)
    int sign, b;
    IBIT(sign);
    long offset;
    IBIT(b);
    if (!b) {
        offset = 0;
        bits_total = 2;
    } else {
        IBIT(b);
        if (!b) {
            offset = 4;
            bits_total = 4;
        } else {
            IBIT(b);
            if (!b) {
                offset = 20;
                bits_total = 6;
            } else {
                IBIT(b);
                if (!b) {
                    offset = 84;
                    bits_total = 8;
                } else {
                    IBIT(b);
                    if (!b) {
                        offset = 340;
                        bits_total = 12;
                    } else {
                        offset = 4436;
                        bits_total = 32;
                    }
                }
            }
        }
    }
    long val = 0;
    for (int i = 0; i < bits_total; ++i) {
        IBIT(b);
        val = (val << 1) | b;
    }
    val += offset;
#undef IBIT
    if (sign) {
        if (val == 0) return 0;  // OOB
        *out = (int)(-val);
    } else {
        *out = (int)val;
    }
    return 1;
}

// Decode a full symbol dictionary (T.88 6.5, SDHUFF=0/SDREFAGG=0) in one
// call. data: the MQ stream (after the parsed header). Writes per-symbol
// (h, w) into out_dims[2*i], row-major bits packed consecutively into
// out_bits (capacity max_pixels), and the export flags for
// num_input + num_new symbols into out_export. Returns 0, or -1 on
// malformed/oversized input.
int jbig2_symbol_dict(const uint8_t* data, long n, int npix,
                      const int8_t* dx, const int8_t* dy, int num_new,
                      int num_input, long max_pixels, int32_t* out_dims,
                      uint8_t* out_bits, uint8_t* out_export) {
    if (npix <= 0 || npix > 16 || num_new < 0 || num_input < 0) return -1;
    int ncx = 1 << npix;
    // GB contexts + one 512-tree per integer procedure (IADH/IADW/IAEX).
    uint8_t* mem = (uint8_t*)calloc((size_t)ncx * 2 + 512 * 6, 1);
    if (!mem) return -1;
    uint8_t* gb_icx = mem;
    uint8_t* gb_mps = mem + ncx;
    uint8_t* iadh_icx = gb_mps + ncx;
    uint8_t* iadh_mps = iadh_icx + 512;
    uint8_t* iadw_icx = iadh_mps + 512;
    uint8_t* iadw_mps = iadw_icx + 512;
    uint8_t* iaex_icx = iadw_mps + 512;
    uint8_t* iaex_mps = iaex_icx + 512;
    MQDec d;
    mq_init(&d, data, n);
    long used = 0;
    int count = 0;
    int classes = 0;
    long height = 0;
    while (count < num_new) {
        if (++classes > num_new + 64) goto fail;  // hostile: empty classes
        int dh;
        if (!mq_int(&d, iadh_icx, iadh_mps, &dh)) goto fail;
        height += dh;
        long width = 0;
        for (;;) {
            int dw;
            if (!mq_int(&d, iadw_icx, iadw_mps, &dw)) break;  // OOB
            width += dw;
            // Bound each dimension BEFORE multiplying: unbounded
            // accumulated deltas overflow the product and bypass the
            // buffer cap (heap overflow otherwise).
            if (width <= 0 || height <= 0 || width > (1 << 20) ||
                height > (1 << 20) || count >= num_new ||
                used + width * height > max_pixels)
                goto fail;
            generic_into(&d, gb_icx, gb_mps, (int)width, (int)height, npix,
                         dx, dy, 0, 0, out_bits + used);
            out_dims[2 * count] = (int32_t)height;
            out_dims[2 * count + 1] = (int32_t)width;
            used += width * height;
            count += 1;
        }
    }
    {
        int total = num_input + num_new;
        int flag = 0, got = 0, runs = 0;
        while (got < total) {
            // zero-length runs are legal but an exhausted hostile stream
            // can yield them forever — bound the run count.
            if (++runs > 2 * total + 64) goto fail;
            int run;
            if (!mq_int(&d, iaex_icx, iaex_mps, &run) || run < 0) goto fail;
            if (run > total - got) run = total - got;
            for (int i = 0; i < run; ++i) out_export[got + i] = (uint8_t)flag;
            got += run;
            flag ^= 1;
        }
    }
    free(mem);
    return 0;
fail:
    free(mem);
    return -1;
}

}  // extern "C"
