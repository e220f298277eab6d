// Host data-loader core of the PyTorch port: JPEG decode and the bilinear
// letterbox, PNG row unfiltering, and a JPEG writer for test data. Plain C
// ABI, built with the host compiler (no CUDA) by ops/_build.host_library
// and bound with ctypes by utils/native_loader.py.
//
// Counterpart of efficientteacher_tpu/native/loader_core.cpp, with three
// changes:
//   1. the resize is OpenCV's INTER_LINEAR for 8-bit images (11-bit fixed
//      point coefficients, rows clamped but not their weights, the rounding
//      of its vector path), so an image letterboxed here is bit-equal to
//      cv2.imread + cv2.resize, upscales included (the JAX core's float
//      bilinear is off by 1 on some pixels);
//   2. the IDCT prescale (libjpeg decoding at 1/2, 1/4, 1/8 inside the
//      inverse DCT) is a per-call option: off, the decode is at full
//      resolution, as cv2.imread decodes (Dataset.native_loader False);
//   3. output is RGB, the order the datasets yield, with no swizzle.
// Every entry writes into buffers the caller owns; none keeps state
// between calls, so Python threads may call it at once (ctypes releases
// the interpreter lock for the call).
//
// Built with ET_NO_JPEG when the machine has no libjpeg headers: the JPEG
// entries then return ET_ERR_NO_JPEG, and the resize and PNG entries work.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifndef ET_NO_JPEG
#include <jpeglib.h>
#endif

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;       // file missing or unreadable
constexpr int kErrDecode = -2;     // libjpeg refused the data
constexpr int kErrSize = -3;       // dims differ from what the caller expects
constexpr int kErrNoJpeg = -4;     // built without libjpeg
constexpr int kErrArgs = -5;       // bad sizes
constexpr int kErrFilter = -6;     // unknown PNG filter type

constexpr int kCoefBits = 11;
constexpr int kCoefScale = 1 << kCoefBits;

// One axis of cv2's INTER_LINEAR table (imgproc/src/resize.cpp,
// resize(): scale = 1 / (dsize / ssize) in double, source position in
// float, coefficients saturate_cast<short>(w * 2048) = round half even).
// `clamp` is the x axis: a position left of the first or right of the last
// source pixel takes that pixel with weight 1. The y axis keeps its
// weights and clamps only the row it reads.
void axis_table(int ssize, int dsize, bool clamp, std::vector<int>& i0,
                std::vector<int>& i1, std::vector<int>& c0,
                std::vector<int>& c1) {
  const double scale = 1.0 / (static_cast<double>(dsize) / ssize);
  i0.resize(dsize);
  i1.resize(dsize);
  c0.resize(dsize);
  c1.resize(dsize);
  for (int d = 0; d < dsize; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= static_cast<float>(s);
    if (clamp) {
      if (s < 0) {
        f = 0.f;
        s = 0;
      }
      if (s >= ssize - 1) {
        f = 0.f;
        s = ssize - 1;
      }
    }
    i0[d] = std::min(std::max(s, 0), ssize - 1);
    i1[d] = std::min(std::max(s + 1, 0), ssize - 1);
    c0[d] = static_cast<int>(std::nearbyint((1.f - f) * kCoefScale));
    c1[d] = static_cast<int>(std::nearbyint(f * kCoefScale));
  }
}

// src (sh, sw, 3) rows `sstride` bytes apart -> dst (dh, dw, 3) rows
// `dstride` bytes apart.
void resize_rgb(const uint8_t* src, int sw, int sh, size_t sstride,
                uint8_t* dst, int dw, int dh, size_t dstride) {
  if (sw == dw && sh == dh) {
    for (int y = 0; y < dh; ++y) {
      std::memcpy(dst + y * dstride, src + y * sstride,
                  static_cast<size_t>(dw) * 3);
    }
    return;
  }
  std::vector<int> x0, x1, a0, a1, y0, y1, b0, b1;
  axis_table(sw, dw, true, x0, x1, a0, a1);
  axis_table(sh, dh, false, y0, y1, b0, b1);
  // horizontal pass into a rolling pair of int rows, each computed once
  const size_t n = static_cast<size_t>(dw) * 3;
  std::vector<int> rows(2 * n);
  int cached[2] = {-1, -1};
  auto hrow = [&](int sy) -> const int* {
    for (int k = 0; k < 2; ++k) {
      if (cached[k] == sy) return rows.data() + k * n;
    }
    const int k = (cached[0] == -1 || cached[1] != -1) ? 0 : 1;
    // evict the row that is not the other tap of this output row
    int* out = rows.data() + k * n;
    cached[k] = sy;
    const uint8_t* r = src + static_cast<size_t>(sy) * sstride;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p = r + x0[x] * 3;
      const uint8_t* q = r + x1[x] * 3;
      for (int c = 0; c < 3; ++c) out[x * 3 + c] = p[c] * a0[x] + q[c] * a1[x];
    }
    return out;
  };
  for (int y = 0; y < dh; ++y) {
    // keep the slot of y0 when computing y1: drop the stale one first
    if (cached[0] != y0[y] && cached[0] != y1[y]) cached[0] = -1;
    if (cached[1] != y0[y] && cached[1] != y1[y]) cached[1] = -1;
    const int* r0 = hrow(y0[y]);
    const int* r1 = hrow(y1[y]);
    const int c0 = b0[y], c1 = b1[y];
    uint8_t* out = dst + y * dstride;
    for (size_t i = 0; i < n; ++i) {
      // cv2's VResizeLinearVec_32s8u: 16-bit high products, then >> 2
      const int v = (((c0 * (r0[i] >> 4)) >> 16) +
                     ((c1 * (r1[i] >> 4)) >> 16) + 2) >> 2;
      out[i] = static_cast<uint8_t>(std::min(std::max(v, 0), 255));
    }
  }
}

void fill_canvas(uint8_t* canvas, int ch, int cw, int pad_value) {
  std::memset(canvas, pad_value, static_cast<size_t>(ch) * cw * 3);
}

bool rect_fits(int ch, int cw, int top, int left, int new_w, int new_h) {
  return new_w > 0 && new_h > 0 && top >= 0 && left >= 0 &&
         top + new_h <= ch && left + new_w <= cw;
}

#ifndef ET_NO_JPEG
struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrMgr*>(cinfo->err)->jump, 1);
}

void quiet(j_common_ptr, int) {}

// Decode `path` and resize it to (new_w, new_h) into dst (rows `dstride`
// bytes apart). With `prescale`, the largest IDCT downscale d in
// {1, 2, 4, 8} that keeps both decoded dims >= 2x the target is used (the
// JAX core's rule); without it the decode is at full resolution.
int decode_resize(const char* path, int expect_w, int expect_h, int new_w,
                  int new_h, uint8_t* dst, size_t dstride, bool prescale) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.emit_message = quiet;
  std::vector<uint8_t> scratch;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  const int fw = static_cast<int>(cinfo.image_width);
  const int fh = static_cast<int>(cinfo.image_height);
  if ((expect_w > 0 && fw != expect_w) || (expect_h > 0 && fh != expect_h)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kErrSize;
  }
  int denom = 1;
  while (prescale && denom < 8 && fw >= new_w * denom * 2 &&
         fh >= new_h * denom * 2) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned>(denom);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int ow = static_cast<int>(cinfo.output_width);
  const int oh = static_cast<int>(cinfo.output_height);
  if (ow == new_w && oh == new_h) {
    // decoded at the target size: rows go straight into the destination
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = dst + cinfo.output_scanline * dstride;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
  } else {
    scratch.resize(static_cast<size_t>(ow) * oh * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = scratch.data() +
                     static_cast<size_t>(cinfo.output_scanline) * ow * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    resize_rgb(scratch.data(), ow, oh, static_cast<size_t>(ow) * 3, dst,
               new_w, new_h, dstride);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return kOk;
}
#endif

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// 1 when built with libjpeg, else 0.
int et_has_jpeg() {
#ifdef ET_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

// Width and height of a JPEG from its header, without decoding it.
int et_jpeg_size(const char* path, int* w, int* h) {
#ifdef ET_NO_JPEG
  (void)path, (void)w, (void)h;
  return kErrNoJpeg;
#else
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.emit_message = quiet;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return kOk;
#endif
}

// Decode the JPEG at `path` (expected dims expect_w x expect_h; <= 0
// skips the check), resize it to (new_w, new_h) and place it at (top,
// left) in the RGB canvas (ch, cw, 3). With pad_value >= 0 the canvas is
// first filled with it. A canvas the size of the image with top = left = 0
// is a plain decode + resize.
int et_jpeg_letterbox(const char* path, int expect_w, int expect_h,
                      uint8_t* canvas, int ch, int cw, int top, int left,
                      int new_w, int new_h, int pad_value, int prescale) {
  if (!rect_fits(ch, cw, top, left, new_w, new_h)) return kErrArgs;
#ifdef ET_NO_JPEG
  (void)path, (void)expect_w, (void)expect_h, (void)canvas, (void)pad_value,
      (void)prescale;
  return kErrNoJpeg;
#else
  if (pad_value >= 0) fill_canvas(canvas, ch, cw, pad_value);
  const size_t stride = static_cast<size_t>(cw) * 3;
  return decode_resize(path, expect_w, expect_h, new_w, new_h,
                       canvas + top * stride + static_cast<size_t>(left) * 3,
                       stride, prescale != 0);
#endif
}

// Resize the RGB image src (sh, sw, 3), rows `sstride` bytes apart, to
// (new_w, new_h) at (top, left) in the canvas (ch, cw, 3), filled first
// with pad_value when it is >= 0.
int et_resize_letterbox(const uint8_t* src, int sw, int sh, int sstride,
                        uint8_t* canvas, int ch, int cw, int top, int left,
                        int new_w, int new_h, int pad_value) {
  if (sw <= 0 || sh <= 0 || sstride < sw * 3 ||
      !rect_fits(ch, cw, top, left, new_w, new_h)) {
    return kErrArgs;
  }
  if (pad_value >= 0) fill_canvas(canvas, ch, cw, pad_value);
  const size_t stride = static_cast<size_t>(cw) * 3;
  resize_rgb(src, sw, sh, static_cast<size_t>(sstride),
             canvas + top * stride + static_cast<size_t>(left) * 3, new_w,
             new_h, stride);
  return kOk;
}

// Undo PNG's per-row filters in place: `data` holds h rows of 1 filter
// byte + `row_bytes` bytes; `out` gets the (h, row_bytes) raw bytes. `bpp`
// is the bytes per pixel (PNG spec section 9: None, Sub, Up, Average,
// Paeth).
int et_png_unfilter(const uint8_t* data, int h, int row_bytes, int bpp,
                    uint8_t* out) {
  if (h <= 0 || row_bytes <= 0 || bpp <= 0) return kErrArgs;
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = data + static_cast<size_t>(y) * (row_bytes + 1);
    const int type = in[0];
    ++in;
    uint8_t* o = out + static_cast<size_t>(y) * row_bytes;
    const uint8_t* up = y ? o - row_bytes : nullptr;
    for (int i = 0; i < row_bytes; ++i) {
      const int a = i >= bpp ? o[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int v;
      switch (type) {
        case 0: v = in[i]; break;
        case 1: v = in[i] + a; break;
        case 2: v = in[i] + b; break;
        case 3: v = in[i] + ((a + b) >> 1); break;
        case 4: v = in[i] + paeth(a, b, c); break;
        default: return kErrFilter;
      }
      o[i] = static_cast<uint8_t>(v & 0xff);
    }
  }
  return kOk;
}

// Test-data support, never called by the loaders: write the RGB image
// (h, w, 3) as a baseline JPEG at `quality` (libjpeg's defaults: 4:2:0).
int et_jpeg_write(const char* path, const uint8_t* rgb, int w, int h,
                  int quality) {
#ifdef ET_NO_JPEG
  (void)path, (void)rgb, (void)w, (void)h, (void)quality;
  return kErrNoJpeg;
#else
  FILE* f = std::fopen(path, "wb");
  if (!f) return kErrOpen;
  jpeg_compress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return kErrDecode;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   static_cast<size_t>(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(f);
  return kOk;
#endif
}

}  // extern "C"
