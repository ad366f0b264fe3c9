// Host codec of stereomatching_tpu_torch: 8-bit grayscale PNG decode and
// encode, and the ASCII PPM-P3 artifact renderer (the reference's
// write_image, src/image.c:71-88).  The port's own copy of the JAX
// package's native/stereo_io.cpp.  Every function computes what the plain
// versions in utils/imageio.py compute, byte for byte, and refuses what
// they refuse.  Built at first use with the host C++ compiler and -lz by
// utils/build.py, loaded with ctypes by utils/native.py.
//
// C interface; each function returns 0 or a negative STEREO_ERR_* code:
//   stereo_png_info        - the IHDR fields and the IDAT byte count
//   stereo_png_read_gray   - decode into a caller buffer of h*w bytes
//   stereo_png_size_bound  - capacity stereo_png_write_gray needs
//   stereo_png_write_gray  - encode (filter-0 rows, zlib level 9)
//   stereo_ppm_size_bound  - capacity the PPM renderers need
//   stereo_ppm_render      - BINARY / GRAY_INT mapping of an int64 plane
//   stereo_ppm_render_float - GRAY_FLOAT mapping of a float64 plane

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

#include <zlib.h>

extern "C" {

enum {
    STEREO_OK = 0,
    STEREO_ERR_SIG = -1,      // not a PNG file
    STEREO_ERR_CHUNK = -2,    // a chunk's payload runs past the end of the file
    STEREO_ERR_NO_IHDR = -3,  // no IHDR chunk
    STEREO_ERR_IHDR = -4,     // an IHDR chunk that is not 13 bytes long
    STEREO_ERR_ZLIB = -5,     // the IDAT stream does not inflate (detail: zlib's code)
    STEREO_ERR_TRUNC = -6,    // the stream holds fewer bytes than the image
    STEREO_ERR_FILTER = -7,   // a row's filter type is not 0-4 (detail: the type)
    STEREO_ERR_BOUNDS = -8,   // the output buffer is too small
    STEREO_ERR_ARG = -9,      // arguments that do not match the input
    STEREO_ERR_RANGE = -10,   // a GRAY_FLOAT value maps outside 0..255
    STEREO_ERR_NOMEM = -11,
};

// PPM pixel mappings (reference ImageType, src/image.h:15-19).
enum { IMTYPE_BINARY = 0, IMTYPE_GRAY_INT = 2 };

}  // extern "C"

namespace {

const unsigned char PNG_SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const unsigned char *p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
           uint32_t(p[3]);
}

void put_be32(unsigned char *p, uint32_t v) {
    p[0] = (unsigned char)(v >> 24);
    p[1] = (unsigned char)(v >> 16);
    p[2] = (unsigned char)(v >> 8);
    p[3] = (unsigned char)v;
}

struct Header {
    int64_t width = -1, height = -1;
    int32_t depth = -1, color_type = -1, interlace = -1;
    int64_t idat_len = 0;
};

// Walk the chunks as the plain decoder does: each IHDR sets the header
// (the last one counts), IDAT payloads are concatenated into *idat (when
// given), IEND or fewer than 8 bytes left end the walk.  CRCs are not
// checked.
int walk(const unsigned char *buf, int64_t len, Header *hdr,
         std::vector<unsigned char> *idat) {
    if (len < 8 || memcmp(buf, PNG_SIG, 8) != 0) return STEREO_ERR_SIG;
    int64_t pos = 8;
    bool have_ihdr = false;
    while (pos + 8 <= len) {
        const int64_t clen = be32(buf + pos);
        const unsigned char *tag = buf + pos + 4;
        const unsigned char *chunk = buf + pos + 8;
        if (pos + 8 + clen > len) return STEREO_ERR_CHUNK;
        if (memcmp(tag, "IHDR", 4) == 0) {
            if (clen != 13) return STEREO_ERR_IHDR;
            hdr->width = be32(chunk);
            hdr->height = be32(chunk + 4);
            hdr->depth = chunk[8];
            hdr->color_type = chunk[9];
            hdr->interlace = chunk[12];
            have_ihdr = true;
        } else if (memcmp(tag, "IDAT", 4) == 0) {
            hdr->idat_len += clen;
            if (idat) idat->insert(idat->end(), chunk, chunk + clen);
        } else if (memcmp(tag, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + clen;
    }
    return have_ihdr ? STEREO_OK : STEREO_ERR_NO_IHDR;
}

// Inflate the whole zlib stream of src, as zlib.decompress does: its
// first dst_len bytes go to dst, the rest is inflated and dropped, and a
// stream that does not reach its end is an error.  *got: bytes placed.
int inflate_into(const unsigned char *src, int64_t src_len, unsigned char *dst,
                 int64_t dst_len, int64_t *got, int64_t *detail) {
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    int rc = inflateInit(&zs);
    if (rc != Z_OK) {
        *detail = rc;
        return STEREO_ERR_ZLIB;
    }
    const int64_t piece = int64_t(1) << 30;  // avail_in / avail_out are 32-bit
    unsigned char sink[1 << 16];
    int64_t placed = 0, fed = 0;
    for (;;) {
        if (zs.avail_in == 0 && fed < src_len) {
            zs.next_in = const_cast<unsigned char *>(src + fed);
            zs.avail_in = (uInt)std::min(src_len - fed, piece);
            fed += zs.avail_in;
        }
        const bool to_dst = placed < dst_len;
        zs.next_out = to_dst ? dst + placed : sink;
        zs.avail_out = to_dst ? (uInt)std::min(dst_len - placed, piece) : (uInt)sizeof sink;
        const uInt room = zs.avail_out;
        rc = inflate(&zs, Z_NO_FLUSH);
        if (to_dst) placed += room - zs.avail_out;
        if (rc == Z_STREAM_END) break;
        if (rc == Z_OK || (rc == Z_BUF_ERROR && (zs.avail_in || fed < src_len))) continue;
        inflateEnd(&zs);
        *detail = rc;  // Z_BUF_ERROR here: the input ended inside the stream
        return STEREO_ERR_ZLIB;
    }
    inflateEnd(&zs);
    *got = placed;
    return STEREO_OK;
}

// Paeth predictor (PNG spec 9.4; the plain decoder's tie order).
inline int paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = p > a ? p - a : a - p;
    const int pb = p > b ? p - b : b - p;
    const int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Undo the row filters of raw (h rows of a filter byte and w bytes) into out.
int unfilter(const unsigned char *raw, unsigned char *out, int64_t w, int64_t h,
             int64_t *detail) {
    std::vector<unsigned char> zeros(w, 0);
    const unsigned char *prev = zeros.data();
    for (int64_t y = 0; y < h; y++) {
        const unsigned char *src = raw + y * (w + 1);
        const unsigned char *fs = src + 1;
        unsigned char *row = out + y * w;
        switch (src[0]) {
        case 0:
            memcpy(row, fs, w);
            break;
        case 1: {  // Sub
            unsigned acc = 0;
            for (int64_t x = 0; x < w; x++) row[x] = (unsigned char)(acc += fs[x]);
            break;
        }
        case 2:  // Up
            for (int64_t x = 0; x < w; x++) row[x] = (unsigned char)(fs[x] + prev[x]);
            break;
        case 3: {  // Average
            int left = 0;
            for (int64_t x = 0; x < w; x++) {
                row[x] = (unsigned char)(fs[x] + ((left + prev[x]) >> 1));
                left = row[x];
            }
            break;
        }
        case 4: {  // Paeth
            int left = 0, upleft = 0;
            for (int64_t x = 0; x < w; x++) {
                row[x] = (unsigned char)(fs[x] + paeth(left, prev[x], upleft));
                upleft = prev[x];
                left = row[x];
            }
            break;
        }
        default:
            *detail = src[0];
            return STEREO_ERR_FILTER;
        }
        prev = row;
    }
    return STEREO_OK;
}

uLong crc_of(uLong crc, const unsigned char *p, int64_t n) {
    for (const int64_t piece = int64_t(1) << 30; n > 0; n -= piece, p += piece)
        crc = crc32(crc, p, (uInt)std::min(n, piece));
    return crc;
}

// "v v v\n" for v in 0..255, each padded to 16 bytes; len[v] is its length.
struct Lines {
    char text[256][16];
    int len[256];
    Lines() {
        for (int v = 0; v < 256; v++)
            len[v] = snprintf(text[v], sizeof text[v], "%d %d %d\n", v, v, v);
    }
};

const Lines &lines() {
    static const Lines table;  // initialised once, thread-safe
    return table;
}

// "P3\n{w} {h}\n255\n" at out -> its end.
unsigned char *ppm_header(unsigned char *out, int64_t w, int64_t h) {
    return out + snprintf((char *)out, 64, "P3\n%lld %lld\n255\n", (long long)w, (long long)h);
}

// Each line is copied as 12 bytes and the pointer advanced by its length:
// every line is at most 12 bytes, so a buffer of stereo_ppm_size_bound
// bytes holds the last one's slack.
inline unsigned char *put_line(unsigned char *p, const Lines &t, int v) {
    memcpy(p, t.text[v], 12);
    return p + t.len[v];
}

}  // namespace

extern "C" {

int stereo_png_info(const unsigned char *buf, int64_t len, int64_t *width, int64_t *height,
                    int32_t *depth, int32_t *color_type, int32_t *interlace,
                    int64_t *idat_len) {
    Header hdr;
    const int rc = walk(buf, len, &hdr, nullptr);
    if (rc != STEREO_OK) return rc;
    *width = hdr.width;
    *height = hdr.height;
    *depth = hdr.depth;
    *color_type = hdr.color_type;
    *interlace = hdr.interlace;
    *idat_len = hdr.idat_len;
    return STEREO_OK;
}

// Decode an 8-bit grayscale non-interlaced PNG of w x h (what
// stereo_png_info reported) into out[h * w].
int stereo_png_read_gray(const unsigned char *buf, int64_t len, unsigned char *out,
                         int64_t w, int64_t h, int64_t *detail) {
    try {
        Header hdr;
        std::vector<unsigned char> idat;
        int rc = walk(buf, len, &hdr, &idat);
        if (rc != STEREO_OK) return rc;
        if (hdr.width != w || hdr.height != h || hdr.depth != 8 || hdr.color_type != 0 ||
            hdr.interlace != 0)
            return STEREO_ERR_ARG;
        const int64_t raw_len = (w + 1) * h;
        std::vector<unsigned char> raw(raw_len);
        int64_t got = 0;
        rc = inflate_into(idat.data(), (int64_t)idat.size(), raw.data(), raw_len, &got, detail);
        if (rc != STEREO_OK) return rc;
        if (got < raw_len) return STEREO_ERR_TRUNC;
        return unfilter(raw.data(), out, w, h, detail);
    } catch (const std::bad_alloc &) {
        return STEREO_ERR_NOMEM;
    }
}

int64_t stereo_png_size_bound(int64_t w, int64_t h) {
    // signature, IHDR, IDAT's length, tag and CRC, IEND
    return 8 + 25 + 12 + (int64_t)compressBound((uLong)((w + 1) * h)) + 12;
}

// Encode uint8 [h, w] as a grayscale PNG: filter-0 rows, one IDAT of
// zlib level 9 (== the plain writer's zlib.compress(raw, 9)).  *out_len:
// the capacity in, the bytes written out.
int stereo_png_write_gray(const unsigned char *pixels, int64_t w, int64_t h, unsigned char *out,
                          int64_t *out_len) {
    if (*out_len < stereo_png_size_bound(w, h)) return STEREO_ERR_BOUNDS;
    try {
        std::vector<unsigned char> raw((w + 1) * h);
        for (int64_t y = 0; y < h; y++) {
            raw[y * (w + 1)] = 0;
            memcpy(raw.data() + y * (w + 1) + 1, pixels + y * w, w);
        }
        unsigned char *p = out;
        memcpy(p, PNG_SIG, 8);
        p += 8;
        auto chunk = [&](const char *tag, int64_t n) {  // payload already at p + 8
            put_be32(p, (uint32_t)n);
            memcpy(p + 4, tag, 4);
            put_be32(p + 8 + n, (uint32_t)crc_of(crc32(0L, Z_NULL, 0), p + 4, n + 4));
            p += 12 + n;
        };
        unsigned char *ihdr = p + 8;
        put_be32(ihdr, (uint32_t)w);
        put_be32(ihdr + 4, (uint32_t)h);
        ihdr[8] = 8;  // bit depth
        ihdr[9] = ihdr[10] = ihdr[11] = ihdr[12] = 0;  // gray, deflate, filter 0, no interlace
        chunk("IHDR", 13);
        uLongf comp_len = (uLongf)(*out_len - (p - out) - 12 - 12);
        if (compress2(p + 8, &comp_len, raw.data(), (uLong)raw.size(), 9) != Z_OK)
            return STEREO_ERR_ZLIB;
        chunk("IDAT", (int64_t)comp_len);
        chunk("IEND", 0);
        *out_len = p - out;
        return STEREO_OK;
    } catch (const std::bad_alloc &) {
        return STEREO_ERR_NOMEM;
    }
}

int64_t stereo_ppm_size_bound(int64_t w, int64_t h) {
    // the header is under 64 bytes; a pixel's line "255 255 255\n" is 12
    return 64 + w * h * 12;
}

// Render an int64 plane as PPM-P3 bytes: the header, then one "v v v\n"
// line per pixel.
//   IMTYPE_BINARY:   v = (x == 1) ? 0 : 255              (src/image.c:45)
//   IMTYPE_GRAY_INT: v = (x - min) * 255 / (max - min)   (src/image.c:37-47),
//                    exact (128-bit product); max == min -> 0.
// *out_len: the capacity in, the bytes written out.
int stereo_ppm_render(const int64_t *data, int64_t w, int64_t h, int32_t imtype,
                      unsigned char *out, int64_t *out_len) {
    const int64_t n = w * h;
    if (*out_len < stereo_ppm_size_bound(w, h)) return STEREO_ERR_BOUNDS;
    if (imtype != IMTYPE_BINARY && imtype != IMTYPE_GRAY_INT) return STEREO_ERR_ARG;
    if (imtype == IMTYPE_GRAY_INT && n == 0) return STEREO_ERR_ARG;
    const Lines &t = lines();
    unsigned char *p = ppm_header(out, w, h);
    if (imtype == IMTYPE_BINARY) {
        for (int64_t i = 0; i < n; i++) p = put_line(p, t, data[i] == 1 ? 0 : 255);
    } else {
        int64_t mn = data[0], mx = data[0];
        for (int64_t i = 1; i < n; i++) {
            mn = std::min(mn, data[i]);
            mx = std::max(mx, data[i]);
        }
        const uint64_t rng = (uint64_t)mx - (uint64_t)mn;
        for (int64_t i = 0; i < n; i++) {
            const unsigned __int128 d = (uint64_t)data[i] - (uint64_t)mn;
            p = put_line(p, t, rng == 0 ? 0 : (int)(d * 255 / rng));
        }
    }
    *out_len = p - out;
    return STEREO_OK;
}

// GRAY_FLOAT (src/image.c:46): v = (int)(x * scale), C truncation toward
// zero, for planes whose every v lies in 0..255 (else STEREO_ERR_RANGE,
// nothing promised of out).  *out_len as above.
int stereo_ppm_render_float(const double *data, double scale, int64_t w, int64_t h,
                            unsigned char *out, int64_t *out_len) {
    const int64_t n = w * h;
    if (*out_len < stereo_ppm_size_bound(w, h)) return STEREO_ERR_BOUNDS;
    const Lines &t = lines();
    unsigned char *p = ppm_header(out, w, h);
    for (int64_t i = 0; i < n; i++) {
        const double v = data[i] * scale;
        if (!(v >= 0.0 && v < 256.0)) return STEREO_ERR_RANGE;
        p = put_line(p, t, (int)v);
    }
    *out_len = p - out;
    return STEREO_OK;
}

}  // extern "C"
