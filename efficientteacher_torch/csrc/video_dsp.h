// The pixel stages of the video decoders of the host loader core, as the
// FFmpeg 8 (libavcodec 62.28, libswscale 9.5) inside cv2 5.0's FFmpeg
// backend runs them on x86-64: the inverse DCT, half-pel motion
// compensation and the YUV -> BGR24 conversion cv2 asks swscale for.
// Included by mpeg4_decode.h and mjpeg_decode.h.
//
// Reproduced FFmpeg routines (names are its files and functions):
//   libavcodec/simple_idct_template.c  idctRowCondDC (the 64-bit DC-only
//       row shortcut: row[0] << 3), idctSparseColPut / idctSparseColAdd
//       (the 8-bit simple IDCT: W1..W7 at 14 bits, ROW_SHIFT 11,
//       COL_SHIFT 20, the column bias (1 << 19) / W4 = 32 times W4). The
//       x86-64 build picks ff_simple_idct8_put_sse2 / _avx for the default
//       idct_algo; they give this C code's output (held against libavcodec
//       with idct=simple on every test stream).
//   libavcodec/hpeldsp.c, x86/hpeldsp_init.c   put_pixels_tab and
//       put_no_rnd_pixels_tab: the rounding average of 2 or 4 pixels, and
//       (a + b) >> 1, (a + b + c + d + 1) >> 2 without rounding; but without
//       cv2's AV_CODEC_FLAG_BITEXACT the 8-wide no-rounding x2 / y2 are the
//       MMXEXT ones, pavgb(a - 1 saturated, b): (max(a - 1, 0) + b + 1) >>
//       1, off by one where a is 0 and b odd; a is the left pixel (x2), the
//       pixel of the odd source row (y2). Found against libavcodec on
//       streams rich in zero pixels; the 16-wide ones are exact there.
//   libswscale/x86/yuv2rgb.c, yuv_2_rgb.asm   yuv420_bgr24_ssse3 (also
//       4:2:2): the unscaled converter swscale takes for a same-size
//       yuv420p / yuv422p (and yuvj: full range) -> bgr24 with an even
//       height. Per pixel, 16-bit lanes: Y and chroma shifted left 3,
//       offsets subtracted, pmulhw by the coefficients of
//       ff_yuv2rgb_c_init_tables (ITU-R 601, SWS_CS_DEFAULT; for full
//       range the chroma scaled by 224 / 255, luma 1:1), sums saturated to
//       0..255. Every width takes that formula (its tail included): held
//       against cv2.VideoCapture at widths 64 to 130.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace etvideo {

inline uint8_t clip_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------- IDCT

constexpr int kW1 = 22725, kW2 = 21407, kW3 = 19266, kW4 = 16383,
              kW5 = 12873, kW6 = 8867, kW7 = 4520;
constexpr int kRowShift = 11, kColShift = 20;

inline void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    const int16_t t = static_cast<int16_t>(
        static_cast<uint16_t>(static_cast<uint32_t>(row[0]) << 3));
    for (int i = 0; i < 8; ++i) row[i] = t;
    return;
  }
  // unsigned arithmetic: SUINT in the template, wraps as the C code does
  uint32_t a0 = static_cast<uint32_t>(kW4 * row[0]) + (1u << (kRowShift - 1));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += static_cast<uint32_t>(kW2 * row[2]);
  a1 += static_cast<uint32_t>(kW6 * row[2]);
  a2 -= static_cast<uint32_t>(kW6 * row[2]);
  a3 -= static_cast<uint32_t>(kW2 * row[2]);
  uint32_t b0 = static_cast<uint32_t>(kW1 * row[1] + kW3 * row[3]);
  uint32_t b1 = static_cast<uint32_t>(kW3 * row[1] - kW7 * row[3]);
  uint32_t b2 = static_cast<uint32_t>(kW5 * row[1] - kW1 * row[3]);
  uint32_t b3 = static_cast<uint32_t>(kW7 * row[1] - kW5 * row[3]);
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += static_cast<uint32_t>(kW4 * row[4] + kW6 * row[6]);
    a1 += static_cast<uint32_t>(-kW4 * row[4] - kW2 * row[6]);
    a2 += static_cast<uint32_t>(-kW4 * row[4] + kW2 * row[6]);
    a3 += static_cast<uint32_t>(kW4 * row[4] - kW6 * row[6]);
    b0 += static_cast<uint32_t>(kW5 * row[5] + kW7 * row[7]);
    b1 += static_cast<uint32_t>(-kW1 * row[5] - kW5 * row[7]);
    b2 += static_cast<uint32_t>(kW7 * row[5] + kW3 * row[7]);
    b3 += static_cast<uint32_t>(kW3 * row[5] - kW1 * row[7]);
  }
  row[0] = static_cast<int16_t>(static_cast<int32_t>(a0 + b0) >> kRowShift);
  row[7] = static_cast<int16_t>(static_cast<int32_t>(a0 - b0) >> kRowShift);
  row[1] = static_cast<int16_t>(static_cast<int32_t>(a1 + b1) >> kRowShift);
  row[6] = static_cast<int16_t>(static_cast<int32_t>(a1 - b1) >> kRowShift);
  row[2] = static_cast<int16_t>(static_cast<int32_t>(a2 + b2) >> kRowShift);
  row[5] = static_cast<int16_t>(static_cast<int32_t>(a2 - b2) >> kRowShift);
  row[3] = static_cast<int16_t>(static_cast<int32_t>(a3 + b3) >> kRowShift);
  row[4] = static_cast<int16_t>(static_cast<int32_t>(a3 - b3) >> kRowShift);
}

// One column's eight outputs (before the clip), from column c of `b`.
inline void idct_col(const int16_t* b, int c, int* out) {
  const int16_t* col = b + c;
  uint32_t a0 = static_cast<uint32_t>(
      kW4 * (col[0] + ((1 << (kColShift - 1)) / kW4)));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += static_cast<uint32_t>(kW2 * col[16]);
  a1 += static_cast<uint32_t>(kW6 * col[16]);
  a2 += static_cast<uint32_t>(-kW6 * col[16]);
  a3 += static_cast<uint32_t>(-kW2 * col[16]);
  uint32_t b0 = static_cast<uint32_t>(kW1 * col[8] + kW3 * col[24]);
  uint32_t b1 = static_cast<uint32_t>(kW3 * col[8] - kW7 * col[24]);
  uint32_t b2 = static_cast<uint32_t>(kW5 * col[8] - kW1 * col[24]);
  uint32_t b3 = static_cast<uint32_t>(kW7 * col[8] - kW5 * col[24]);
  a0 += static_cast<uint32_t>(kW4 * col[32]);
  a1 += static_cast<uint32_t>(-kW4 * col[32]);
  a2 += static_cast<uint32_t>(-kW4 * col[32]);
  a3 += static_cast<uint32_t>(kW4 * col[32]);
  b0 += static_cast<uint32_t>(kW5 * col[40]);
  b1 += static_cast<uint32_t>(-kW1 * col[40]);
  b2 += static_cast<uint32_t>(kW7 * col[40]);
  b3 += static_cast<uint32_t>(kW3 * col[40]);
  a0 += static_cast<uint32_t>(kW6 * col[48]);
  a1 += static_cast<uint32_t>(-kW2 * col[48]);
  a2 += static_cast<uint32_t>(kW2 * col[48]);
  a3 += static_cast<uint32_t>(-kW6 * col[48]);
  b0 += static_cast<uint32_t>(kW7 * col[56]);
  b1 += static_cast<uint32_t>(-kW5 * col[56]);
  b2 += static_cast<uint32_t>(kW3 * col[56]);
  b3 += static_cast<uint32_t>(-kW1 * col[56]);
  out[0] = static_cast<int32_t>(a0 + b0) >> kColShift;
  out[1] = static_cast<int32_t>(a1 + b1) >> kColShift;
  out[2] = static_cast<int32_t>(a2 + b2) >> kColShift;
  out[3] = static_cast<int32_t>(a3 + b3) >> kColShift;
  out[4] = static_cast<int32_t>(a3 - b3) >> kColShift;
  out[5] = static_cast<int32_t>(a2 - b2) >> kColShift;
  out[6] = static_cast<int32_t>(a1 - b1) >> kColShift;
  out[7] = static_cast<int32_t>(a0 - b0) >> kColShift;
}

// ff_simple_idct_put_int16_8bit: `block` (raster order) is overwritten.
inline void idct_put(int16_t* block, uint8_t* dst, int stride) {
  for (int r = 0; r < 8; ++r) idct_row(block + 8 * r);
  int o[8];
  for (int c = 0; c < 8; ++c) {
    idct_col(block, c, o);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip_u8(o[r]);
  }
}

// ff_simple_idct_add_int16_8bit
inline void idct_add(int16_t* block, uint8_t* dst, int stride) {
  for (int r = 0; r < 8; ++r) idct_row(block + 8 * r);
  int o[8];
  for (int c = 0; c < 8; ++c) {
    idct_col(block, c, o);
    for (int r = 0; r < 8; ++r)
      dst[r * stride + c] = clip_u8(dst[r * stride + c] + o[r]);
  }
}

// ---------------------------------------------------------------- MC

// A plane of the reference picture, read with every coordinate clamped into
// [0, edge_w) x [0, edge_h): what emulated_edge_mc gives past the edges.
struct RefPlane {
  const uint8_t* data;
  int stride, edge_w, edge_h;
  uint8_t at(int x, int y) const {
    x = x < 0 ? 0 : (x >= edge_w ? edge_w - 1 : x);
    y = y < 0 ? 0 : (y >= edge_h ? edge_h - 1 : y);
    return data[y * stride + x];
  }
};

// put_pixels_tab / put_no_rnd_pixels_tab [size][dxy] of a w x h block whose
// top-left full-pel source is (sx, sy).
inline void hpel_put(const RefPlane& ref, int sx, int sy, int dxy,
                     bool no_rnd, uint8_t* dst, int stride, int w, int h) {
  uint8_t src[17 * 17];
  const int sw = w + 1;
  const bool approx = w == 8;  // put_no_rnd_pixels_tab[1]: MMXEXT
  for (int y = 0; y <= h; ++y)
    for (int x = 0; x <= w; ++x) src[y * sw + x] = ref.at(sx + x, sy + y);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s0 = src + y * sw;
    const uint8_t* s1 = s0 + sw;
    uint8_t* d = dst + y * stride;
    for (int x = 0; x < w; ++x) {
      int v;
      switch (dxy) {
        case 0:
          v = s0[x];
          break;
        case 1:
          v = !no_rnd ? (s0[x] + s0[x + 1] + 1) >> 1
              : approx ? (std::max(s0[x] - 1, 0) + s0[x + 1] + 1) >> 1
                       : (s0[x] + s0[x + 1]) >> 1;
          break;
        case 2:
          // the MMXEXT y2 code lowers every odd source row, so output row y
          // lowers its upper source row where y is odd, its lower one else
          v = !no_rnd ? (s0[x] + s1[x] + 1) >> 1
              : !approx ? (s0[x] + s1[x]) >> 1
              : (y & 1) ? (std::max(s0[x] - 1, 0) + s1[x] + 1) >> 1
                        : (s0[x] + std::max(s1[x] - 1, 0) + 1) >> 1;
          break;
        default:
          v = (s0[x] + s0[x + 1] + s1[x] + s1[x + 1] + (no_rnd ? 1 : 2)) >> 2;
      }
      d[x] = static_cast<uint8_t>(v);
    }
  }
}

// ---------------------------------------------------------------- colour

// ff_yuv2rgb_coeffs (crv, cbu, -cgu, -cgv) of a colorspace (AVColorSpace =
// H.264's matrix_coefficients): cv2 sets the frame's colorspace on its
// swscale context, so BT.709, FCC, SMPTE 240M and BT.2020 streams convert
// with their own matrices; every other value (unspecified, 601, YCgCo,
// ...) takes ITU-R 601, sws_getCoefficients' default.
inline const int32_t* yuv2rgb_table(int colorspace) {
  static const int32_t k601[4] = {104597, 132201, 25675, 53279};
  static const int32_t k709[4] = {117489, 138438, 13975, 34925};
  static const int32_t kFcc[4] = {104448, 132798, 24759, 53109};
  static const int32_t k240[4] = {117579, 136230, 16907, 35559};
  static const int32_t k2020[4] = {110013, 140363, 12277, 42626};
  switch (colorspace) {
    case 1: return k709;
    case 4: return kFcc;
    case 7: return k240;
    case 9: case 10: return k2020;
    default: return k601;
  }
}

// The coefficients of ff_yuv2rgb_c_init_tables at the default contrast,
// saturation and brightness, as the SIMD code reads them
// (roundToInt16(x * 2^13) = (x * 2^13 + 2^15) >> 16).
struct Yuv2RgbCoeffs {
  int y_coeff, y_offset, ub, ug, vg, vr;
  explicit Yuv2RgbCoeffs(bool full_range, int colorspace = 2) {
    const int32_t* t = yuv2rgb_table(colorspace);
    int64_t crv = t[0], cbu = t[1], cgu = -t[2], cgv = -t[3];
    int64_t cy = 1 << 16, oy = 0;
    if (!full_range) {
      cy = cy * 255 / 219;
      oy = 16 << 16;
    } else {
      crv = crv * 224 / 255;
      cbu = cbu * 224 / 255;
      cgu = cgu * 224 / 255;
      cgv = cgv * 224 / 255;
    }
    auto r16 = [](int64_t x) {
      return static_cast<int>((x * (1 << 13) + (1 << 15)) >> 16);
    };
    y_coeff = r16(cy);
    vr = r16(crv);
    ub = r16(cbu);
    vg = r16(cgv);
    ug = r16(cgu);
    y_offset = static_cast<int>((oy * 8 + (1 << 15)) >> 16);
  }
};

// pmulhw: the high 16 bits of the signed product
inline int mulhi(int a, int b) { return (a * b) >> 16; }

// Planar 4:2:0 (chroma_rows_shift 1) or 4:2:2 (0) -> packed BGR24 of
// w x h (h even for 4:2:0, as swscale's special converter needs).
inline void yuv_to_bgr(const uint8_t* py, int ys, const uint8_t* pu,
                       const uint8_t* pv, int cs, int w, int h,
                       int chroma_rows_shift, bool full_range, uint8_t* out,
                       int out_stride, int colorspace = 2) {
  const Yuv2RgbCoeffs k(full_range, colorspace);
  for (int y = 0; y < h; ++y) {
    const uint8_t* yr = py + y * ys;
    const uint8_t* ur = pu + (y >> chroma_rows_shift) * cs;
    const uint8_t* vr = pv + (y >> chroma_rows_shift) * cs;
    uint8_t* o = out + y * out_stride;
    for (int x = 0; x < w; ++x) {
      const int u = (ur[x >> 1] << 3) - 1024;
      const int v = (vr[x >> 1] << 3) - 1024;
      const int yy = mulhi((yr[x] << 3) - k.y_offset, k.y_coeff);
      o[3 * x + 0] = clip_u8(yy + mulhi(u, k.ub));
      o[3 * x + 1] = clip_u8(yy + mulhi(u, k.ug) + mulhi(v, k.vg));
      o[3 * x + 2] = clip_u8(yy + mulhi(v, k.vr));
    }
  }
}

}  // namespace etvideo
