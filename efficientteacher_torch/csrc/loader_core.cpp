// Host data-loader core of the PyTorch port: JPEG decode and the bilinear
// letterbox, the per-pixel stages of PNG, BMP and TIFF (raster_decode.h:
// row filters, Adam7, bit unpacking, palettes, RLE, LZW, PackBits, the
// TIFF predictor, CCITT fax, YCbCr, CMYK and CIELab) and TIFF's LZW
// writer, the VP8L and VP8 bitstreams of
// WebP (webp_decode.h) and WebP writers (webp_encode.h), the
// host augmentation's pixel
// operations (pixel_ops.h: cv2's warpAffine / warpPerspective, HSV, grey
// and 3x3 filter), label text as cv2.putText draws it (text_render.h), and
// a JPEG writer for test data, and the frames of MPEG-4 Part 2 and MJPEG
// video (mpeg4_decode.h, mjpeg_decode.h, video_dsp.h). Plain C
// ABI, built with the host compiler (no CUDA, no libjpeg) by
// ops/_build.host_library and bound with ctypes by utils/native_loader.py.
//
// Counterpart of efficientteacher_tpu/native/loader_core.cpp, with these
// changes:
//   1. the JPEG decoder is the core's own (jpeg_decode.h), bit-equal to
//      cv2.imread's libjpeg-turbo on the kinds it reads; the EXIF
//      orientation cv2.imread applies is applied on request;
//   2. the resize is OpenCV's INTER_LINEAR for 8-bit images (11-bit fixed
//      point coefficients, rows clamped but not their weights, the rounding
//      of its vector path), so an image letterboxed here is bit-equal to
//      cv2.imread + cv2.resize, upscales included (the JAX core's float
//      bilinear is off by 1 on some pixels);
//   3. the IDCT prescale (decoding at 1/2, 1/4, 1/8 inside the inverse
//      DCT, as libjpeg's scale_denom does) is a per-call option: off, the
//      decode is at full resolution, as cv2.imread decodes
//      (Dataset.native_loader False);
//   4. output is RGB, the order the datasets yield, with no swizzle.
// Every entry writes into buffers the caller owns; none keeps state
// between calls but a video decoder's handle (et_video_*), which one
// thread at a time uses, so Python threads may call it at once (ctypes
// releases the interpreter lock for the call).

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

#include "h264_decode.h"
#include "jpeg_decode.h"
#include "jpeg_encode.h"
#include "mjpeg_decode.h"
#include "mpeg4_decode.h"
#include "pixel_ops.h"
#include "raster_decode.h"
#include "text_render.h"
#include "webp_decode.h"
#include "webp_encode.h"

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;       // file missing or unreadable
constexpr int kErrDecode = -2;     // corrupt or truncated data
constexpr int kErrSize = -3;       // dims differ from what the caller expects
constexpr int kErrUnsupported = -4;  // a JPEG kind libjpeg refuses
constexpr int kErrArgs = -5;       // bad sizes

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

// The whole file at `path`, or its first `limit` bytes (0: all of it);
// `whole` tells which. False when it cannot be read.
bool read_file(const char* path, size_t limit, std::vector<uint8_t>* out,
               bool* whole) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  long size = -1;
  if (std::fseek(f, 0, SEEK_END) == 0) size = std::ftell(f);
  if (size < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
    std::fclose(f);
    return false;
  }
  const size_t n = limit ? std::min(limit, static_cast<size_t>(size))
                         : static_cast<size_t>(size);
  out->resize(n);
  out->resize(std::fread(out->data(), 1, n, f));
  std::fclose(f);
  *whole = out->size() == static_cast<size_t>(size);
  return true;
}

// cv2.imread picks its decoder by signature: a JPEG file must begin FF D8
// FF (JpegDecoder's), else cv2 reads nothing of it
bool jpeg_signature(const std::vector<uint8_t>& data) {
  return data.size() >= 3 && data[0] == 0xFF && data[1] == 0xD8 &&
         data[2] == 0xFF;
}

int status_code(int st) {
  return st == etjpeg::kOk ? kOk
         : st == etjpeg::kRefused ? kErrUnsupported : kErrDecode;
}

// (w, h) of an image of size (w, h) under EXIF orientation o: 5-8 swap.
void oriented(int o, int w, int h, int* ow, int* oh) {
  *ow = o >= 5 ? h : w;
  *oh = o >= 5 ? w : h;
}

// cv2's ApplyExifOrientation: src (h, w, 3) -> dst (its oriented size),
// dst rows `dstride` bytes apart.
void orient_copy(const uint8_t* src, int w, int h, int o, uint8_t* dst,
                 size_t dstride) {
  int dw, dh;
  oriented(o, w, h, &dw, &dh);
  for (int y = 0; y < dh; ++y) {
    uint8_t* d = dst + y * dstride;
    for (int x = 0; x < dw; ++x) {
      int sx, sy;
      switch (o) {
        case 2: sx = w - 1 - x, sy = y; break;          // flip x
        case 3: sx = w - 1 - x, sy = h - 1 - y; break;  // rotate 180
        case 4: sx = x, sy = h - 1 - y; break;          // flip y
        case 5: sx = y, sy = x; break;                  // transpose
        case 6: sx = y, sy = h - 1 - x; break;          // rotate 90 cw
        case 7: sx = w - 1 - y, sy = h - 1 - x; break;  // transverse
        case 8: sx = w - 1 - y, sy = x; break;          // rotate 90 ccw
        default: sx = x, sy = y; break;
      }
      std::memcpy(d + x * 3, src + (static_cast<size_t>(sy) * w + sx) * 3, 3);
    }
  }
}

// Decode `path` at scale 1/denom and resize it to (new_w, new_h) into dst
// (rows `dstride` bytes apart). `expect_w` / `expect_h` (<= 0: unchecked)
// are checked against the oriented size, the one et_jpeg_info reports to
// the labels cache. With `orient` the EXIF orientation is applied, as
// cv2.imread applies it. `denom` 0 is the prescale rule: the largest IDCT
// downscale d in {1, 2, 4, 8} that keeps both decoded dims >= 2x the
// target (the JAX core's rule).
int decode_resize_impl(const char* path, int expect_w, int expect_h,
                       int new_w, int new_h, uint8_t* dst, size_t dstride,
                       int denom, bool orient) {
  std::vector<uint8_t> data;
  bool whole;
  if (!read_file(path, 0, &data, &whole)) return kErrOpen;
  if (!jpeg_signature(data)) return kErrDecode;
  etjpeg::Decoder dec;
  const int st = dec.read(data.data(), data.size(), true);
  if (st != etjpeg::kOk) return status_code(st);
  int vw, vh;
  oriented(dec.orientation, dec.width, dec.height, &vw, &vh);
  if ((expect_w > 0 && vw != expect_w) || (expect_h > 0 && vh != expect_h)) {
    return kErrSize;
  }
  const int o = orient ? dec.orientation : 1;
  int fw, fh;  // the size the caller resizes from
  oriented(o, dec.width, dec.height, &fw, &fh);
  if (denom == 0) {
    denom = 1;
    while (dec.scalable() && denom < 8 && fw >= new_w * denom * 2 &&
           fh >= new_h * denom * 2) {
      denom *= 2;
    }
  }
  const int ow = dec.out_width(denom), oh = dec.out_height(denom);
  int rw, rh;
  oriented(o, ow, oh, &rw, &rh);
  if (o == 1 && ow == new_w && oh == new_h) {
    // decoded at the target size: rows go straight into the destination
    dec.output(denom, [&](int y, const uint8_t* row) {
      std::memcpy(dst + y * dstride, row, static_cast<size_t>(ow) * 3);
    });
    return kOk;
  }
  std::vector<uint8_t> img(static_cast<size_t>(ow) * oh * 3);
  dec.output(denom, [&](int y, const uint8_t* row) {
    std::memcpy(&img[static_cast<size_t>(y) * ow * 3], row,
                static_cast<size_t>(ow) * 3);
  });
  if (o == 1) {
    resize_rgb(img.data(), ow, oh, static_cast<size_t>(ow) * 3, dst, new_w,
               new_h, dstride);
  } else if (rw == new_w && rh == new_h) {
    orient_copy(img.data(), ow, oh, o, dst, dstride);
  } else {
    std::vector<uint8_t> rot(img.size());
    orient_copy(img.data(), ow, oh, o, rot.data(),
                static_cast<size_t>(rw) * 3);
    resize_rgb(rot.data(), rw, rh, static_cast<size_t>(rw) * 3, dst, new_w,
               new_h, dstride);
  }
  return kOk;
}

// A header may declare up to 65535 x 65535 pixels: a decode that cannot
// get its buffers is refused as corrupt, never thrown across the C ABI.
template <class F>
int guarded(F&& f) {
  try {
    return f();
  } catch (const std::bad_alloc&) {
    return kErrDecode;
  }
}

int decode_resize(const char* path, int expect_w, int expect_h, int new_w,
                  int new_h, uint8_t* dst, size_t dstride, int denom,
                  bool orient) {
  return guarded([&] {
    return decode_resize_impl(path, expect_w, expect_h, new_w, new_h, dst,
                              dstride, denom, orient);
  });
}

// a video stream's decoder: one of the three is set
struct VideoHandle {
  etmpeg4::Decoder* mpeg4;
  etmjpeg::Decoder* mjpeg;
  eth264::Decoder* h264;
};

}  // namespace

extern "C" {

// The header of the JPEG at `path`: info = {w, h (as stored), EXIF
// orientation (1-8), refusal kind (etjpeg::Kind, 0 when it decodes), 1
// when the decoder scales it (0: a lossless file, read at full size)}.
// Returns kErrUnsupported for a kind the decoder refuses, without reading
// any entropy-coded data. A sequential file is parsed from its first
// 64 KiB when its headers fit there; a progressive one is walked to the end
// (an error in a later scan's headers makes cv2.imread fail).
int et_jpeg_info(const char* path, int* info) {
  std::vector<uint8_t> data;
  bool whole;
  if (!read_file(path, 1 << 16, &data, &whole)) return kErrOpen;
  if (!jpeg_signature(data)) return kErrDecode;
  etjpeg::Decoder dec;
  int st = dec.read(data.data(), data.size(), false);
  if (!whole && (st != etjpeg::kOk || dec.progressive)) {
    if (!read_file(path, 0, &data, &whole)) return kErrOpen;
    dec = etjpeg::Decoder();
    st = dec.read(data.data(), data.size(), false);
  }
  info[0] = dec.width;
  info[1] = dec.height;
  info[2] = dec.orientation;
  info[3] = dec.kind;
  info[4] = dec.scalable() ? 1 : 0;
  return status_code(st);
}

// Decode the JPEG at `path` at scale 1/denom (1, 2, 4 or 8) into `out`
// (oh, ow, 3): the decoded size (oriented with `orient`), as et_jpeg_info
// gives it; another size is resized to.
int et_jpeg_decode(const char* path, int denom, int orient, uint8_t* out,
                   int ow, int oh) {
  if (denom != 1 && denom != 2 && denom != 4 && denom != 8) return kErrArgs;
  if (ow <= 0 || oh <= 0) return kErrArgs;
  return decode_resize(path, 0, 0, ow, oh, out, static_cast<size_t>(ow) * 3,
                       denom, orient != 0);
}

// Decode the JPEG at `path` (expected oriented dims expect_w x expect_h;
// <= 0 skips the check), resize it to (new_w, new_h) and place it at (top,
// left) in the RGB canvas (ch, cw, 3). With pad_value >= 0 the canvas is
// first filled with it. `flags`: 1 allows the IDCT prescale, 2 applies the
// EXIF orientation. A canvas the size of the image with top = left = 0 is
// a plain decode + resize.
int et_jpeg_letterbox(const char* path, int expect_w, int expect_h,
                      uint8_t* canvas, int ch, int cw, int top, int left,
                      int new_w, int new_h, int pad_value, int flags) {
  if (!rect_fits(ch, cw, top, left, new_w, new_h)) return kErrArgs;
  if (pad_value >= 0) fill_canvas(canvas, ch, cw, pad_value);
  const size_t stride = static_cast<size_t>(cw) * 3;
  return decode_resize(path, expect_w, expect_h, new_w, new_h,
                       canvas + top * stride + static_cast<size_t>(left) * 3,
                       stride, (flags & 1) ? 0 : 1, (flags & 2) != 0);
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

// The inflated IDAT stream `data` (n bytes) of a (w, h) PNG with `spp`
// samples of `bits` bits, Adam7 when `interlaced` -> out (h, w, spp): one
// byte per sample, 16-bit samples as their high byte.
int et_png_decode(const uint8_t* data, int64_t n, int w, int h, int bits,
                  int spp, int interlaced, uint8_t* out) {
  if (w <= 0 || h <= 0 || spp < 1 || spp > 4 || n < 0 ||
      (bits != 1 && bits != 2 && bits != 4 && bits != 8 && bits != 16)) {
    return kErrArgs;
  }
  return guarded([&] {
    return etraster::png_decode(data, static_cast<size_t>(n), w, h, bits,
                                spp, interlaced != 0, out) == etraster::kOk
               ? kOk
               : kErrDecode;
  });
}

// n pixels of spp bytes -> RGB (etraster::to_rgb): through `lut` (256 x 3,
// indexed by the first sample) when it is not null, else samples 0-2;
// premultiplied by the sample at `alpha` when alpha >= 0.
int et_to_rgb(const uint8_t* src, int64_t n, int spp, const uint8_t* lut,
              int alpha, uint8_t* out) {
  if (n < 0 || spp < 1 || (!lut && spp < 3) || alpha >= spp) return kErrArgs;
  etraster::to_rgb(src, static_cast<size_t>(n), spp, lut, alpha, out);
  return kOk;
}

// The BMP file `data` (n bytes), pixels from `offset`, as OpenCV's
// BmpDecoder reads it (etraster::BmpReader) -> out (h, w, 3) RGB.
int et_bmp_decode(const uint8_t* data, int64_t n, int64_t offset, int w,
                  int h, int bottom_up, int bpp, int rle,
                  const uint8_t* palette, uint8_t* out) {
  if (w <= 0 || h <= 0 || n < 0 || offset < 0 ||
      (rle != 0 && rle != 4 && rle != 8)) {
    return kErrArgs;
  }
  return guarded([&] {
    etraster::BmpReader r(data, static_cast<size_t>(n),
                          static_cast<size_t>(offset), w, h, bottom_up != 0,
                          palette, out);
    return r.read(bpp, rle) == etraster::kOk ? kOk : kErrDecode;
  });
}

// The strips or tiles of a TIFF (etraster::tiff_decode) -> out (h, w, spp):
// layout = {w, h, cw, ch, tiled, planes, per_chunk, spp, bits, flags,
// g3_2d, sub_h, sub_v, jpeg_colour, jpeg_h, jpeg_v}; `tables`
// (ntables bytes, may be null) a JPEG file's JPEGTables.
int et_tiff_decode(const uint8_t* data, int64_t n, const int64_t* offsets,
                   const int64_t* counts, int nchunks, int compression,
                   const int* layout, const uint8_t* tables, int64_t ntables,
                   uint8_t* out) {
  const etraster::TiffLayout L{
      layout[0],  layout[1],  layout[2],  layout[3],  layout[4],  layout[5],
      layout[6],  layout[7],  layout[8],  layout[9],  layout[10], layout[11],
      layout[12], layout[13], layout[14], layout[15]};
  if (n < 0 || nchunks <= 0 || L.w <= 0 || L.h <= 0 || L.cw <= 0 ||
      L.ch <= 0 || L.planes <= 0 || L.per_chunk <= 0 || ntables < 0 ||
      L.spp != L.per_chunk * L.planes || L.sub_h < 0 || L.sub_v < 0 ||
      (L.sub_h > 0) != (L.sub_v > 0) ||
      (L.sub_h > 0 && (L.per_chunk != 3 || L.bits != 8))) {
    return kErrArgs;
  }
  return guarded([&] {
    const int st = etraster::tiff_decode(
        data, static_cast<size_t>(n), offsets, counts, nchunks, compression,
        L, tables, static_cast<size_t>(ntables), out);
    return st == etraster::kOk     ? kOk
           : st == etraster::kArgs ? kErrArgs
                                   : kErrDecode;
  });
}

// n pixels of a TIFF's CMYK, YCbCr or CIELab samples (spp bytes each; two
// per sample for kind 4) -> RGB (etraster::tiff_colour).
int et_tiff_colour(const uint8_t* src, int64_t n, int spp, int kind,
                   const float* params, uint8_t* out) {
  if (n < 0 || spp < 3 || (kind == 1 && spp < 4)) return kErrArgs;
  return etraster::tiff_colour(src, static_cast<size_t>(n), spp, kind,
                               params, out) == etraster::kOk
             ? kOk
             : kErrArgs;
}

// n bytes -> a TIFF LZW stream into dst (cap bytes); *written its length,
// kErrArgs when it does not fit.
int et_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                  int64_t* written) {
  if (n < 0 || cap < 0) return kErrArgs;
  std::vector<uint8_t> out;
  if (guarded([&] {
        etraster::lzw_encode(src, static_cast<size_t>(n), &out);
        return kOk;
      }) != kOk ||
      static_cast<int64_t>(out.size()) > cap) {
    return kErrArgs;
  }
  std::memcpy(dst, out.data(), out.size());
  *written = static_cast<int64_t>(out.size());
  return kOk;
}

// cv2.warpAffine (flags 1: warpPerspective) of src (sh, sw, 3), rows
// `sstride` bytes apart, into dst (dh, dw, 3), packed: INTER_LINEAR, the
// constant border `border` (grey), `m` the forward map, 2x3 (3x3 for the
// perspective) row-major doubles, inverted as cv2 inverts it.
int et_warp(const uint8_t* src, int sw, int sh, int sstride, uint8_t* dst,
            int dw, int dh, const double* m, int border, int flags) {
  if (sw <= 0 || sh <= 0 || sstride < sw * 3 || dw <= 0 || dh <= 0 ||
      border < 0 || border > 255) {
    return kErrArgs;
  }
  const bool persp = (flags & 1) != 0;
  double inv[9];
  if (persp) {
    if (!etpix::invert3(m, inv)) std::memset(inv, 0, sizeof(inv));
  } else {
    etpix::invert_affine(m, inv);
  }
  float mf[9];
  for (int i = 0; i < 9; ++i) mf[i] = static_cast<float>(inv[i]);
  const uint8_t bval[3] = {static_cast<uint8_t>(border),
                           static_cast<uint8_t>(border),
                           static_cast<uint8_t>(border)};
  etpix::warp_linear(src, sw, sh, static_cast<size_t>(sstride), dst, dw, dh,
                     static_cast<size_t>(dw) * 3, mf, persp, bval);
  return kOk;
}

// augment_hsv in place on img (h, w, 3), rows `stride` bytes apart: each
// pixel through cv2's BGR2HSV, the LUTs (256 entries each) and HSV2BGR.
// `blue` is the channel of blue (0 BGR, 2 RGB).
int et_augment_hsv(uint8_t* img, int h, int w, int stride,
                   const uint8_t* lut_h, const uint8_t* lut_s,
                   const uint8_t* lut_v, int blue) {
  if (h <= 0 || w <= 0 || stride < w * 3 || (blue != 0 && blue != 2)) {
    return kErrArgs;
  }
  etpix::augment_hsv(img, h, w, static_cast<size_t>(stride), lut_h, lut_s,
                     lut_v, blue);
  return kOk;
}

// cv2 BGR2GRAY of img (h, w, 3) into out (h, w).
int et_gray(const uint8_t* img, int h, int w, int stride, uint8_t* out,
            int blue) {
  if (h <= 0 || w <= 0 || stride < w * 3 || (blue != 0 && blue != 2)) {
    return kErrArgs;
  }
  etpix::bgr2gray(img, h, w, static_cast<size_t>(stride), out, blue);
  return kOk;
}

// cv2.filter2D(img, -1, k / div) of img (h, w, 3) into out (h, w, 3),
// packed: `k` 9 integers, `div` odd and positive.
int et_filter3x3(const uint8_t* img, int h, int w, int stride, const int* k,
                 int div, uint8_t* out) {
  if (h <= 0 || w <= 0 || stride < w * 3 || div <= 0 || div % 2 == 0) {
    return kErrArgs;
  }
  etpix::filter3x3(img, h, w, static_cast<size_t>(stride), k, div, out,
                   static_cast<size_t>(w) * 3);
  return kOk;
}

// The port's JPEG writer (data/image_io.imwrite: detect's annotated images
// and crops; the tests' and chip_smoke's data): write the RGB image (h, w,
// 3) as a baseline JFIF JPEG, 4:2:0, at `quality` (jpeg_encode.h).
int et_jpeg_write(const char* path, const uint8_t* rgb, int w, int h,
                  int quality) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) return kErrArgs;
  std::vector<uint8_t> bytes;
  if (guarded([&] {
        bytes = etjpeg::Encoder().encode(rgb, w, h, quality);
        return kOk;
      }) != kOk) {
    return kErrArgs;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return kErrOpen;
  const bool ok = std::fwrite(bytes.data(), 1, bytes.size(), f) ==
                  bytes.size();
  return (std::fclose(f) == 0 && ok) ? kOk : kErrOpen;
}

// A WebP bitstream (etwebp::decode_vp8l / decode_vp8): `data`, n bytes
// from the VP8L or VP8 chunk's payload on (libwebp reads to the end of
// what it was given), of size (w, h) -> out, RGB, (h, w, 3) turned as
// the EXIF orientation `orient` (1-8) asks, as cv2.imread turns it. A
// VP8 frame with an ALPH chunk (`has_alpha`; `alpha`, alpha_n bytes of
// its payload) fails when the alpha fails, as cv2.imread does.
int et_webp_decode(const uint8_t* data, int64_t n, int lossless, int w,
                   int h, const uint8_t* alpha, int64_t alpha_n,
                   int has_alpha, int orient, uint8_t* out) {
  if (n < 0 || alpha_n < 0 || w <= 0 || h <= 0 || orient < 1 ||
      orient > 8) {
    return kErrArgs;
  }
  return guarded([&] {
    std::vector<uint8_t> img;
    uint8_t* dst = out;
    if (orient != 1) {
      img.resize(static_cast<size_t>(w) * h * 3);
      dst = img.data();
    }
    const int st =
        lossless ? etwebp::decode_vp8l(data, static_cast<size_t>(n), w, h,
                                       dst)
                 : etwebp::decode_vp8(data, static_cast<size_t>(n), w, h,
                                      alpha, static_cast<size_t>(alpha_n),
                                      has_alpha != 0, dst);
    if (st != etwebp::kOk) return kErrDecode;
    if (orient != 1) {
      int ow, oh;
      oriented(orient, w, h, &ow, &oh);
      orient_copy(img.data(), w, h, orient, out, static_cast<size_t>(ow) * 3);
    }
    return kOk;
  });
}

// The RGB image (h, w, 3) as a WebP bitstream (webp_encode.h) into dst
// (cap bytes): VP8L when quality < 0, else VP8 at that quality (0-100);
// *written its length, kErrArgs when it does not fit.
int et_webp_encode(const uint8_t* rgb, int w, int h, int quality,
                   uint8_t* dst, int64_t cap, int64_t* written) {
  if (w <= 0 || h <= 0 || w > 16383 || h > 16383 || cap < 0 ||
      quality > 100) {
    return kErrArgs;
  }
  std::vector<uint8_t> out;
  if (guarded([&] {
        if (quality < 0) {
          etwebp::encode_vp8l(rgb, w, h, &out);
        } else {
          etwebp::encode_vp8(rgb, w, h, quality, &out);
        }
        return kOk;
      }) != kOk ||
      static_cast<int64_t>(out.size()) > cap) {
    return kErrArgs;
  }
  std::memcpy(dst, out.data(), out.size());
  *written = static_cast<int64_t>(out.size());
  return kOk;
}

// cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1) of the
// code points cps[0..n) into img (h, w, 3), rows `stride` bytes apart, in
// color[0..3) (the canvas's channel order), with the TrueType font `font`
// (font_n bytes: cv2's Rubik) and the fallback font `uni` (uni_n bytes:
// cv2's WenQuanYi Micro Hei; uni_n 0: none; text_render.h).
int et_put_text(const uint8_t* font, int64_t font_n, const uint8_t* uni,
                int64_t uni_n, uint8_t* img, int h, int w, int stride,
                const uint32_t* cps, int n, int org_x, int org_y,
                const int* color) {
  ettext::Font f, u;
  if (h < 0 || w < 0 || n < 0 ||
      !ettext::open_font(f, font, static_cast<size_t>(font_n)) ||
      (uni_n > 0 && !ettext::open_font(u, uni, static_cast<size_t>(uni_n)))) {
    return kErrArgs;
  }
  return guarded([&] {
    ettext::put_text(f, uni_n > 0 ? &u : nullptr, img, h, w, stride, cps, n,
                     org_x, org_y, color);
    return kOk;
  });
}

// A video decoder of one stream: codec 1 MPEG-4 Part 2 (flags: 1 the
// container's fourcc is one FFmpeg takes for Xvid, 2 it is DIVX; `extra`
// is the decoder's extradata, or null), 2 MJPEG (flags: the container's
// frame height, 0 for none), 3 H.264 (`extra`: an avcC record, or Annex B
// parameter sets; packets are length-prefixed after an avcC record, else
// Annex B). Null for another codec.
void* et_video_open(int codec, const uint8_t* extra, int64_t n, int flags) {
  if (codec == 1) {
    auto* d = new (std::nothrow) etmpeg4::Decoder(flags & 1, flags & 2);
    if (d && extra && n > 0) d->headers(extra, static_cast<int>(n));
    return d ? new (std::nothrow) VideoHandle{d, nullptr, nullptr} : nullptr;
  }
  if (codec == 2) {
    auto* d = new (std::nothrow) etmjpeg::Decoder(flags);
    return d ? new (std::nothrow) VideoHandle{nullptr, d, nullptr} : nullptr;
  }
  if (codec == 3) {
    auto* d = new (std::nothrow) eth264::Decoder();
    if (d && extra && n > 0) d->headers(extra, static_cast<int>(n));
    return d ? new (std::nothrow) VideoHandle{nullptr, nullptr, d} : nullptr;
  }
  return nullptr;
}

void et_video_close(void* handle) {
  auto* h = static_cast<VideoHandle*>(handle);
  if (!h) return;
  delete h->mpeg4;
  delete h->mjpeg;
  delete h->h264;
  delete h;
}

// Decode one packet. 1: a picture, whose size goes to info[0..2) and which
// et_video_bgr converts; 0: no picture; -2: FFmpeg fails on the packet (the
// reader stops there); -4: a tool not decoded, info[2] says which
// (etmpeg4::Tool, etmjpeg::Kind, eth264::Tool). An H.264 picture goes out
// as soon as it is decoded (the decoder refuses a stream whose output order
// differs from its decoding order), so nothing is left to drain at the end.
int et_video_decode(void* handle, const uint8_t* data, int64_t n, int* info) {
  auto* h = static_cast<VideoHandle*>(handle);
  if (!h || n < 0 || n > (int64_t{1} << 30)) return kErrArgs;
  return guarded([&] {
    int r, w, ht, tool;
    if (h->mpeg4) {
      r = h->mpeg4->decode(data, static_cast<int>(n));
      w = h->mpeg4->width();
      ht = h->mpeg4->height();
      tool = h->mpeg4->tool();
    } else if (h->h264) {
      r = h->h264->decode(data, static_cast<int>(n));
      w = h->h264->width();
      ht = h->h264->height();
      tool = h->h264->tool();
    } else {
      r = h->mjpeg->decode(data, static_cast<int>(n));
      w = h->mjpeg->width();
      ht = h->mjpeg->height();
      tool = h->mjpeg->kind();
    }
    info[0] = w;
    info[1] = ht;
    info[2] = tool;
    return r;
  });
}

// The last picture as BGR24 (info[1] rows of info[0] * 3 bytes), the
// conversion cv2's FFmpeg backend asks swscale for.
int et_video_bgr(void* handle, uint8_t* out) {
  auto* h = static_cast<VideoHandle*>(handle);
  if (!h) return kErrArgs;
  return guarded([&] {
    if (h->mpeg4) {
      h->mpeg4->to_bgr(out, h->mpeg4->width() * 3);
    } else if (h->h264) {
      h->h264->to_bgr(out, h->h264->width() * 3);
    } else {
      h->mjpeg->to_bgr(out, h->mjpeg->width() * 3);
    }
    return kOk;
  });
}

}  // extern "C"
