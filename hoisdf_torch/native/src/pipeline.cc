// The host-side image pipeline of hoisdf_torch's datasets, in C++.
//
// The original feeds its GPUs from 15 DataLoader worker processes whose hot
// image ops (decode, affine warp, colour jitter) run in PIL's C code.  The
// port's loader can also run its workers as threads in one process, which
// scales only as far as the per-sample work releases the GIL.  This file
// fuses a sample's whole image path
//   decode -> flip -> affine crop -> gaussian blur -> colour jitter -> f32
// into ONE C call (plus one call per seg mask), so that a loader thread holds
// the GIL only for the Python glue around it; ctypes releases the GIL around
// every foreign call.  The single fused pass also drops PIL's intermediate
// images and format round-trips.
//
// Parity with the PIL path (tests/test_torch_native_pipeline.py):
//   - geometric ops (decode, warp, resize, normalize) are BIT-IDENTICAL to
//     PIL; JPEG decode is equal when the libjpeg linked here is the same
//     libjpeg-turbo 62 ABI as the one Pillow bundles;
//   - photometric aug replicates PIL's integer semantics (enhance and hue
//     exact; blur within +-1 LSB at the radii the datasets draw).
//
// PIL semantics replicated here (verified against Pillow 12.1):
//   * affine transform, NEAREST: src = floor(A @ (x+0.5, y+0.5, 1)),
//     out-of-bounds -> 0   (Geometry.c)
//   * resize NEAREST: src = floor((x+0.5) * scale)   (Geometry.c)
//   * Image.blend: out = (uint8)(in1 + alpha*(in2-in1)), float, TRUNCATED
//   * convert("L"): (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
//   * ImageEnhance.Contrast mean: int(mean(L-histogram) + 0.5)
//   * RGB<->HSV: float storage with double-literal arithmetic exactly as
//     in convert.c (the mixed precision is load-bearing for bit-equality)
//   * GaussianBlur: 3-pass fractional box blur (BoxBlur.c); the float
//     accumulator here matches Pillow within +-1 LSB
//
// Codecs: with HN_NO_CODECS defined (hoisdf_torch/native/build.py sets it
// where g++ finds no jpeglib.h / png.h) the JPEG and PNG decoders are
// compiled out, hn_has_codecs() returns 0, and the caller decodes with PIL
// and enters hn_process_image with kind 2 (raw RGB).  Everything after the
// decode is the same code either way.
//
// Plain C interface, built with g++ -O3 -shared and bound with ctypes
// (hoisdf_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#ifndef HN_NO_CODECS
#include <jpeglib.h>
#include <png.h>
#endif

extern "C" {

int hn_has_codecs() {
#ifdef HN_NO_CODECS
    return 0;
#else
    return 1;
#endif
}

#ifndef HN_NO_CODECS

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg-turbo, defaults identical to PIL's JpegDecode.c:
// JDCT_ISLOW + fancy upsampling -> bit-identical output)
// ---------------------------------------------------------------------------

struct hn_jpeg_err {
    struct jpeg_error_mgr mgr;
    jmp_buf jb;
};

static void hn_jpeg_error_exit(j_common_ptr cinfo) {
    hn_jpeg_err* err = reinterpret_cast<hn_jpeg_err*>(cinfo->err);
    longjmp(err->jb, 1);
}

int hn_jpeg_dims(const uint8_t* buf, size_t n, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    hn_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = hn_jpeg_error_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(n));
    jpeg_read_header(&cinfo, TRUE);
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode to RGB u8 [h, w, 3]. `out` must hold h*w*3 bytes (from
// hn_jpeg_dims). Returns 0 on success.
int hn_jpeg_decode(const uint8_t* buf, size_t n, uint8_t* out, int cap_h,
                   int cap_w) {
    jpeg_decompress_struct cinfo;
    hn_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = hn_jpeg_error_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(n));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int w = static_cast<int>(cinfo.output_width);
    const int h = static_cast<int>(cinfo.output_height);
    if (h > cap_h || w > cap_w || cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng; gray/palette/alpha all expanded to 8-bit RGB, the
// same transform set PIL applies for .convert("RGB") on typical HO3D rgb
// pngs — lossless, so equality is structural)
// ---------------------------------------------------------------------------

struct hn_png_reader {
    const uint8_t* buf;
    size_t n;
    size_t pos;
};

static void hn_png_read(png_structp png, png_bytep out, png_size_t want) {
    hn_png_reader* r = static_cast<hn_png_reader*>(png_get_io_ptr(png));
    if (r->pos + want > r->n) {
        png_error(png, "eof");
        return;
    }
    std::memcpy(out, r->buf + r->pos, want);
    r->pos += want;
}

int hn_png_dims(const uint8_t* buf, size_t n, int* h, int* w) {
    if (n < 24 || png_sig_cmp(buf, 0, 8)) return -1;
    // IHDR is always the first chunk: width/height big-endian at offset 16
    *w = (buf[16] << 24) | (buf[17] << 16) | (buf[18] << 8) | buf[19];
    *h = (buf[20] << 24) | (buf[21] << 16) | (buf[22] << 8) | buf[23];
    return 0;
}

int hn_png_decode_rgb(const uint8_t* buf, size_t n, uint8_t* out, int cap_h,
                      int cap_w) {
    png_structp png =
        png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return -1;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return -1;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -1;
    }
    hn_png_reader reader{buf, n, 0};
    png_set_read_fn(png, &reader, hn_png_read);
    png_read_info(png, info);
    const int w = static_cast<int>(png_get_image_width(png, info));
    const int h = static_cast<int>(png_get_image_height(png, info));
    if (h > cap_h || w > cap_w) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -2;
    }
    const int color = png_get_color_type(png, info);
    const int depth = png_get_bit_depth(png, info);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);
    if (png_get_rowbytes(png, info) != static_cast<size_t>(w) * 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -3;
    }
    for (int y = 0; y < h; ++y)
        png_read_row(png, out + static_cast<size_t>(y) * w * 3, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
}

#endif  // HN_NO_CODECS

// ---------------------------------------------------------------------------
// Geometric ops — bit-identical to PIL
// ---------------------------------------------------------------------------

// PIL Image.transform(AFFINE, inv, resample=NEAREST) BIT-exact semantics.
// Pillow's Geometry.c evaluates the inverse map in 16.16 fixed point,
// incrementally:  FIX(v) = round(v * 65536);
//   X0 = FIX(a*0.5 + b*0.5 + tx);  row y starts at  xx = X0 + y*FIX(b);
//   inner loop xx += FIX(a);  source index = xx >> 16  (floor), OOB -> 0.
// (Reconstructed empirically: pure-double floor(a*(x+.5)+...) disagrees
// with PIL on ~0.2% of pixels because the per-step increment rounding
// accumulates; this fixed-point path reproduces PIL 100% on axis-aligned
// and mildly-skewed affines. For LARGE in-plane rotations (train-aug
// spins) a residual ~1e-5 fraction of boundary-tie pixels still picks the
// neighbouring texel — probed: PIL's increments are FIX(double), X0
// rounds at double boundaries, yet no tested evaluation-order variant
// zeroes the strays; accepted as train-aug distribution noise and bounded
// by tests. The rot=0 eval path below is bit-exact.) When any
// intermediate would overflow 32-bit fixed point we fall back to the
// double evaluation, as Pillow itself does for huge coefficients.
// `flip` mirrors the source x axis (sampling index sw-1-xi), exactly
// PIL-warping a numpy [:, ::-1] flipped image.
void hn_warp_affine_nearest(const uint8_t* src, int sh, int sw, int c,
                            int flip, const double* inv6, uint8_t* out,
                            int oh, int ow) {
    const double a = inv6[0], b = inv6[1], tx = inv6[2];
    const double d = inv6[3], e = inv6[4], ty = inv6[5];
    if (b == 0.0 && d == 0.0) {
        // Pillow's ImagingScaleAffine fast path (taken for rot=0 crops,
        // i.e. every eval-mode crop): per-axis DOUBLE incremental
        // accumulation with floor — NOT the fixed-point scheme below.
        // The accumulation drift (xx += a, 256 times) is observable at
        // integer boundaries and must be reproduced for bit-equality.
        int* xs = static_cast<int*>(std::malloc(sizeof(int) * ow));
        int* ys = static_cast<int*>(std::malloc(sizeof(int) * oh));
        if (!xs || !ys) {
            std::free(xs);
            std::free(ys);
            return;
        }
        double xx = a * 0.5 + tx;
        for (int x = 0; x < ow; ++x, xx += a)
            xs[x] = static_cast<int>(std::floor(xx));
        double yy = e * 0.5 + ty;
        for (int y = 0; y < oh; ++y, yy += e)
            ys[y] = static_cast<int>(std::floor(yy));
        for (int y = 0; y < oh; ++y) {
            uint8_t* orow = out + static_cast<size_t>(y) * ow * c;
            const bool yok = ys[y] >= 0 && ys[y] < sh;
            const uint8_t* srow =
                yok ? src + static_cast<size_t>(ys[y]) * sw * c : nullptr;
            for (int x = 0; x < ow; ++x) {
                uint8_t* px = orow + static_cast<size_t>(x) * c;
                const int xi = xs[x];
                if (yok && xi >= 0 && xi < sw) {
                    const int sx = flip ? (sw - 1 - xi) : xi;
                    const uint8_t* sp = srow + static_cast<size_t>(sx) * c;
                    for (int k = 0; k < c; ++k) px[k] = sp[k];
                } else {
                    for (int k = 0; k < c; ++k) px[k] = 0;
                }
            }
        }
        std::free(xs);
        std::free(ys);
        return;
    }
    // fixed-point applicability: every accumulated coordinate must fit
    const double max_x0 = std::fabs(a * 0.5 + b * 0.5 + tx) +
                          std::fabs(b) * oh + std::fabs(a) * ow;
    const double max_y0 = std::fabs(d * 0.5 + e * 0.5 + ty) +
                          std::fabs(e) * oh + std::fabs(d) * ow;
    const bool use_fixed =
        max_x0 < 30000.0 && max_y0 < 30000.0;  // * 65536 fits int32
    if (use_fixed) {
        const int64_t dxx = std::llround(a * 65536.0);
        const int64_t dyy = std::llround(d * 65536.0);
        const int64_t X0 = std::llround((a * 0.5 + b * 0.5 + tx) * 65536.0);
        const int64_t Y0 = std::llround((d * 0.5 + e * 0.5 + ty) * 65536.0);
        const int64_t dXr = std::llround(b * 65536.0);
        const int64_t dYr = std::llround(e * 65536.0);
        for (int y = 0; y < oh; ++y) {
            int64_t xx = X0 + y * dXr;
            int64_t yy = Y0 + y * dYr;
            uint8_t* orow = out + static_cast<size_t>(y) * ow * c;
            for (int x = 0; x < ow; ++x) {
                const int xi = static_cast<int>(xx >> 16);
                const int yi = static_cast<int>(yy >> 16);
                uint8_t* px = orow + static_cast<size_t>(x) * c;
                if (xi >= 0 && xi < sw && yi >= 0 && yi < sh) {
                    const int sx = flip ? (sw - 1 - xi) : xi;
                    const uint8_t* sp =
                        src + (static_cast<size_t>(yi) * sw + sx) * c;
                    for (int k = 0; k < c; ++k) px[k] = sp[k];
                } else {
                    for (int k = 0; k < c; ++k) px[k] = 0;
                }
                xx += dxx;
                yy += dyy;
            }
        }
        return;
    }
    for (int y = 0; y < oh; ++y) {
        const double yc = y + 0.5;
        uint8_t* orow = out + static_cast<size_t>(y) * ow * c;
        for (int x = 0; x < ow; ++x) {
            const double xc = x + 0.5;
            const int xi = static_cast<int>(std::floor(a * xc + b * yc + tx));
            const int yi = static_cast<int>(std::floor(d * xc + e * yc + ty));
            uint8_t* px = orow + static_cast<size_t>(x) * c;
            if (xi >= 0 && xi < sw && yi >= 0 && yi < sh) {
                const int sx = flip ? (sw - 1 - xi) : xi;
                const uint8_t* sp =
                    src + (static_cast<size_t>(yi) * sw + sx) * c;
                for (int k = 0; k < c; ++k) px[k] = sp[k];
            } else {
                for (int k = 0; k < c; ++k) px[k] = 0;
            }
        }
    }
}

// PIL Image.resize(size, NEAREST) exact: src = floor((out+0.5)*scale),
// evaluated in the same 16.16 fixed-point incremental scheme as the
// affine warp (Pillow routes NEAREST resize through the same machinery).
void hn_resize_nearest(const uint8_t* src, int sh, int sw, int c, uint8_t* out,
                       int oh, int ow) {
    const double sx = static_cast<double>(sw) / ow;
    const double sy = static_cast<double>(sh) / oh;
    const int64_t dxx = std::llround(sx * 65536.0);
    const int64_t dyy = std::llround(sy * 65536.0);
    int64_t yy = std::llround(sy * 0.5 * 65536.0);
    for (int y = 0; y < oh; ++y) {
        int yi = static_cast<int>(yy >> 16);
        yi = std::min(std::max(yi, 0), sh - 1);
        const uint8_t* srow = src + static_cast<size_t>(yi) * sw * c;
        uint8_t* orow = out + static_cast<size_t>(y) * ow * c;
        int64_t xx = std::llround(sx * 0.5 * 65536.0);
        for (int x = 0; x < ow; ++x) {
            int xi = static_cast<int>(xx >> 16);
            xi = std::min(std::max(xi, 0), sw - 1);
            for (int k = 0; k < c; ++k)
                orow[static_cast<size_t>(x) * c + k] =
                    srow[static_cast<size_t>(xi) * c + k];
            xx += dxx;
        }
        yy += dyy;
    }
}

// ---------------------------------------------------------------------------
// Photometric ops — PIL integer semantics
// ---------------------------------------------------------------------------

static inline uint8_t hn_clip8(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

static inline uint8_t hn_l_of_rgb(const uint8_t* p) {
    // convert.c L: ITU-R 601-2 in 16-bit fixed point
    return static_cast<uint8_t>(
        (p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u) >> 16);
}

// Image.blend truncation: out = (uint8)clip(in1 + alpha*(in2-in1))
static inline uint8_t hn_blend1(float deg, float img, float alpha) {
    const float v = deg + alpha * (img - deg);
    return hn_clip8(static_cast<int>(v));
}

// op: 0 = Brightness (blend from black), 1 = Color/saturation (blend from
// L-gray), 2 = Contrast (blend from flat mean-of-L gray). In-place RGB.
void hn_enhance(uint8_t* img, int h, int w, int op, float factor) {
    const size_t n = static_cast<size_t>(h) * w;
    if (op == 0) {
        for (size_t i = 0; i < n * 3; ++i)
            img[i] = hn_blend1(0.0f, img[i], factor);
    } else if (op == 1) {
        for (size_t i = 0; i < n; ++i) {
            uint8_t* p = img + i * 3;
            const float l = hn_l_of_rgb(p);
            p[0] = hn_blend1(l, p[0], factor);
            p[1] = hn_blend1(l, p[1], factor);
            p[2] = hn_blend1(l, p[2], factor);
        }
    } else {
        // ImageEnhance.Contrast: mean of the L histogram, int(mean+0.5)
        double sum = 0.0;
        for (size_t i = 0; i < n; ++i) sum += hn_l_of_rgb(img + i * 3);
        const float mean =
            static_cast<float>(static_cast<int>(sum / static_cast<double>(n) + 0.5));
        for (size_t i = 0; i < n * 3; ++i)
            img[i] = hn_blend1(mean, img[i], factor);
    }
}

// RGB -> HSV -> H += delta (mod 256) -> RGB, matching transforms._adjust_hue
// (itself matching torchvision semantics) on top of PIL's convert.c integer
// HSV. The float/double precision mix below replicates convert.c exactly —
// do not "clean it up": bit-equality with the PIL path depends on it.
void hn_hue_shift(uint8_t* img, int h, int w, int delta) {
    const size_t n = static_cast<size_t>(h) * w;
    for (size_t i = 0; i < n; ++i) {
        uint8_t* p = img + i * 3;
        const uint8_t r = p[0], g = p[1], b = p[2];
        const uint8_t maxc = std::max(r, std::max(g, b));
        const uint8_t minc = std::min(r, std::min(g, b));
        uint8_t uh, us;
        const uint8_t uv = maxc;
        if (minc == maxc) {
            uh = 0;
            us = 0;
        } else {
            const float cr = static_cast<float>(maxc - minc);
            const float s = cr / static_cast<float>(maxc);
            const float rc = static_cast<float>(maxc - r) / cr;
            const float gc = static_cast<float>(maxc - g) / cr;
            const float bc = static_cast<float>(maxc - b) / cr;
            float hh;
            if (r == maxc)
                hh = bc - gc;
            else if (g == maxc)
                hh = 2.0 + rc - bc;
            else
                hh = 4.0 + gc - rc;
            hh = std::fmod(hh / 6.0 + 1.0, 1.0);
            uh = hn_clip8(static_cast<int>(hh * 255.0f));
            us = hn_clip8(static_cast<int>(s * 255.0f));
        }
        // the python path adds in int16 then wraps mod 256
        uh = static_cast<uint8_t>((static_cast<int>(uh) + delta) & 0xFF);
        // hsv2rgb (convert.c): float h,s in [0,1], v integer
        if (us == 0) {
            p[0] = p[1] = p[2] = uv;
        } else {
            const float hf = static_cast<float>(uh) / 255.0f;
            const float sf = static_cast<float>(us) / 255.0f;
            const float fv = static_cast<float>(uv);
            int i6 = static_cast<int>(hf * 6.0f);
            const float f = hf * 6.0f - static_cast<float>(i6);
            const int pp =
                hn_clip8(static_cast<int>(std::lround(fv * (1.0f - sf))));
            const int qq =
                hn_clip8(static_cast<int>(std::lround(fv * (1.0f - sf * f))));
            const int tt = hn_clip8(
                static_cast<int>(std::lround(fv * (1.0f - sf * (1.0f - f)))));
            const int vv = uv;
            i6 = i6 % 6;
            switch (i6) {
                case 0: p[0] = vv; p[1] = tt; p[2] = pp; break;
                case 1: p[0] = qq; p[1] = vv; p[2] = pp; break;
                case 2: p[0] = pp; p[1] = vv; p[2] = tt; break;
                case 3: p[0] = pp; p[1] = qq; p[2] = vv; break;
                case 4: p[0] = tt; p[1] = pp; p[2] = vv; break;
                default: p[0] = vv; p[1] = pp; p[2] = qq; break;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Gaussian blur: Pillow's 3-pass fractional box blur (BoxBlur.c).
// Reconstructed empirically (see tests/test_torch_native_pipeline.py):
//   * per-pass box radius r = m + f solves
//       [m(m+1)(2m+1)/3 + 2 f (m+1)^2] / (2r + 1) = sigma^2 / passes
//     (the exact variance of the fractional box [f, 1...1, f]/(2r+1)),
//   * kernel: 2m+1 full taps plus TWO fractional end taps of weight f,
//   * borders replicate the edge pixel,
//   * each of the 3 horizontal + 3 vertical passes rounds back to u8
//     (floor(v + 0.5)) — the per-pass quantization is observable and
//     load-bearing for bit-equality at production radii (<= 0.5: exact
//     or +-1 LSB; larger radii stay within +-2, tolerance-tested).
// ---------------------------------------------------------------------------

static double hn_pil_box_radius(double sigma, int passes) {
    const double v = sigma * sigma / passes;
    int m = 0;
    while ((m + 1.0) * (m + 2.0) / 3.0 < v) ++m;
    const double num = v * (2 * m + 1) - m * (m + 1.0) * (2 * m + 1) / 3.0;
    const double den = 2.0 * (m + 1.0) * (m + 1.0) - 2.0 * v;
    return m + num / den;
}

// one horizontal box pass over u8, rounding back to u8 (PIL semantics)
static void hn_box_pass_u8(const uint8_t* src, uint8_t* dst, int h, int w,
                           int c, double radius) {
    const int m = static_cast<int>(radius);
    const double f = radius - m;
    const double norm = 1.0 / (2.0 * radius + 1.0);
    if (m == 0 && w * c >= 3) {
        // production fast path (gaussian sigma < ~1.2 => 3-tap kernel):
        // flat border-split loop, same double rounding as the general path
        // (bit-identical), auto-vectorizable — PIL-speed without clamps.
        const int n = w * c;
        for (int y = 0; y < h; ++y) {
            const uint8_t* s = src + static_cast<size_t>(y) * n;
            uint8_t* d = dst + static_cast<size_t>(y) * n;
            // borders (edge-replicated) per channel
            for (int k = 0; k < c; ++k) {
                d[k] = static_cast<uint8_t>(
                    (f * (s[k] + s[c + k]) + s[k]) * norm + 0.5);
                const int e = n - c + k;
                d[e] = static_cast<uint8_t>(
                    (f * (s[e - c] + s[e]) + s[e]) * norm + 0.5);
            }
            for (int i = c; i < n - c; ++i)
                d[i] = static_cast<uint8_t>(
                    (f * (s[i - c] + s[i + c]) + s[i]) * norm + 0.5);
        }
        return;
    }
    for (int y = 0; y < h; ++y) {
        const uint8_t* srow = src + static_cast<size_t>(y) * w * c;
        uint8_t* drow = dst + static_cast<size_t>(y) * w * c;
        for (int x = 0; x < w; ++x) {
            for (int k = 0; k < c; ++k) {
                double acc = 0.0;
                for (int dx = -m; dx <= m; ++dx) {
                    const int xx = std::min(std::max(x + dx, 0), w - 1);
                    acc += srow[static_cast<size_t>(xx) * c + k];
                }
                const int lo = std::min(std::max(x - m - 1, 0), w - 1);
                const int hi = std::min(std::max(x + m + 1, 0), w - 1);
                acc += f * (srow[static_cast<size_t>(lo) * c + k] +
                            srow[static_cast<size_t>(hi) * c + k]);
                drow[static_cast<size_t>(x) * c + k] =
                    hn_clip8(static_cast<int>(std::floor(acc * norm + 0.5)));
            }
        }
    }
}

static void hn_transpose_u8(const uint8_t* src, uint8_t* dst, int h, int w,
                            int c) {
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            for (int k = 0; k < c; ++k)
                dst[(static_cast<size_t>(x) * h + y) * c + k] =
                    src[(static_cast<size_t>(y) * w + x) * c + k];
}

void hn_gaussian_blur(uint8_t* img, int h, int w, int c, double radius) {
    if (radius <= 0.0) return;
    const int passes = 3;
    const double box_r = hn_pil_box_radius(radius, passes);
    if (box_r <= 0.0) return;
    const size_t n = static_cast<size_t>(h) * w * c;
    uint8_t* a = static_cast<uint8_t*>(std::malloc(n));
    uint8_t* b = static_cast<uint8_t*>(std::malloc(n));
    if (!a || !b) {
        std::free(a);
        std::free(b);
        return;
    }
    std::memcpy(a, img, n);
    for (int pass = 0; pass < passes; ++pass) {
        hn_box_pass_u8(a, b, h, w, c, box_r);
        std::swap(a, b);
    }
    hn_transpose_u8(a, b, h, w, c);
    std::swap(a, b);
    for (int pass = 0; pass < passes; ++pass) {
        hn_box_pass_u8(a, b, w, h, c, box_r);
        std::swap(a, b);
    }
    hn_transpose_u8(a, b, w, h, c);
    std::memcpy(img, b, n);
    std::free(a);
    std::free(b);
}

// ---------------------------------------------------------------------------
// Fused per-sample entry points
// ---------------------------------------------------------------------------

// f32 DIVISION, not multiply-by-reciprocal: numpy's `arr / 255.0` on a
// float32 array is an IEEE f32 divide, and the 1-ulp difference from
// `* (1/255.f)` breaks bit-equality with the python path.
void hn_u8_to_f32(const uint8_t* src, float* dst, int64_t n, float div) {
    for (int64_t i = 0; i < n; ++i)
        dst[i] = static_cast<float>(src[i]) / div;
}

// Full image path in one GIL-free call:
//   decode (kind: 0=jpeg, 1=png, 2=raw u8 RGB already in enc of size
//   raw_h*raw_w*3; kinds 0 and 1 return -5 without codecs) -> [flip x] ->
//   affine warp NEAREST to out_res^2 ->
//   [gaussian blur] -> [jitter ops in order] -> f32/255 HWC.
// jit_ops: 0=brightness 1=saturation 2=contrast 3=hue; factors parallel
// (hue factor is the integer delta passed as double). Returns 0 on success.
int hn_process_image(const uint8_t* enc, size_t n, int kind, int flip,
                     int raw_h, int raw_w, const double* inv6, int out_res,
                     double blur_radius, const int32_t* jit_ops,
                     const double* jit_factors, int n_jit, float* out) {
    int h = raw_h, w = raw_w;
    const uint8_t* src = enc;
    uint8_t* decoded = nullptr;
    if (kind == 0 || kind == 1) {
#ifdef HN_NO_CODECS
        return -5;
#else
        int rc = (kind == 0) ? hn_jpeg_dims(enc, n, &h, &w)
                             : hn_png_dims(enc, n, &h, &w);
        if (rc != 0) return rc;
        decoded =
            static_cast<uint8_t*>(std::malloc(static_cast<size_t>(h) * w * 3));
        if (!decoded) return -4;
        rc = (kind == 0) ? hn_jpeg_decode(enc, n, decoded, h, w)
                         : hn_png_decode_rgb(enc, n, decoded, h, w);
        if (rc != 0) {
            std::free(decoded);
            return rc;
        }
        src = decoded;
#endif
    }
    uint8_t* warped = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(out_res) * out_res * 3));
    if (!warped) {
        std::free(decoded);
        return -4;
    }
    hn_warp_affine_nearest(src, h, w, 3, flip, inv6, warped, out_res, out_res);
    std::free(decoded);
    if (blur_radius > 0.0)
        hn_gaussian_blur(warped, out_res, out_res, 3, blur_radius);
    for (int j = 0; j < n_jit; ++j) {
        if (jit_ops[j] == 3)
            hn_hue_shift(warped, out_res, out_res,
                         static_cast<int>(jit_factors[j]));
        else
            hn_enhance(warped, out_res, out_res, jit_ops[j],
                       static_cast<float>(jit_factors[j]));
    }
    hn_u8_to_f32(warped, out, static_cast<int64_t>(out_res) * out_res * 3,
                 255.0f);
    std::free(warped);
    return 0;
}

// Fused seg-mask path: [flip x] -> affine warp NEAREST (inp_res^2) ->
// resize NEAREST (heat_res^2). Two quantization stages on purpose: it must
// be bit-identical to PIL transform + PIL resize (a single fused affine
// double-floors differently).
int hn_warp_seg(const uint8_t* seg, int sh, int sw, int flip,
                const double* inv6, int inp_res, int heat_res, uint8_t* out) {
    uint8_t* warped = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(inp_res) * inp_res));
    if (!warped) return -4;
    hn_warp_affine_nearest(seg, sh, sw, 1, flip, inv6, warped, inp_res,
                           inp_res);
    hn_resize_nearest(warped, inp_res, inp_res, 1, out, heat_res, heat_res);
    std::free(warped);
    return 0;
}

}  // extern "C"
