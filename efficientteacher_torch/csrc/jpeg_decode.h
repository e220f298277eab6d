// JPEG decoder of the host loader core: the decode libjpeg-turbo (8-bit,
// its defaults, as cv2.imread calls it) gives, bit for bit, with no
// library. Included by loader_core.cpp only.
//
// Decodes baseline (SOF0), extended 8-bit Huffman (SOF1) and progressive
// Huffman (SOF2) files of 1 component (grey), 3 (YCbCr, or RGB where the
// markers say so) or 4 (CMYK, YCCK), with any sampling factors libjpeg
// accepts (1-4 each, integral ratios, at most 10 blocks in an interleaved
// MCU), with restart intervals, at scale 1, 1/2, 1/4 or 1/8. Everything
// else is refused with a Kind, from the headers, before any entropy-coded
// data is read.
//
// Reproduced libjpeg-turbo routines (names are its files and functions):
//   jdhuff.c / jdphuff.c    Huffman decode; sequential, DC/AC first and
//                           refinement scans, EOB runs; a table the file
//                           never defines is the standard one (jstdhuff.c)
//   jidctint.c  jpeg_idct_islow   (13-bit constants, PASS1_BITS 2)
//   jidctred.c  jpeg_idct_4x4 / _2x2 / _1x1   (the reduced-size IDCTs)
//   jdmaster.c  prepare_range_limit_table   (the IDCT's wrap, RANGE_MASK)
//   jdmaster.c  jpeg_calc_output_dimensions   (each component's DCT size:
//                           chroma is scaled up by its IDCT, not upsampled,
//                           where the scale allows)
//   jdapimin.c  default_decompress_parms   (the colour space from JFIF /
//                           Adobe markers and component ids)
//   jdsample.c  jinit_upsampler's choice per component: fullsize,
//                           h2v1 / h2v2 / h1v2 fancy (triangle filter,
//                           +1/+2 and +8/+7 biases, edge columns and
//                           context rows repeated), h2v1 / h2v2 box where
//                           libjpeg turns fancy off (min DCT size 1, or a
//                           component <= 2 wide), int_upsample (box) for
//                           every other integral ratio (4:1:1, ...)
//   jdcolor.c   ycc_rgb_convert   (16-bit fixed-point tables, ONE_HALF),
//               rgb_rgb_convert, ycck_cmyk_convert
// and OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, with which cv2.imread turns the
// CMYK libjpeg gives it into BGR.
// A progressive file whose scans leave a coefficient unrefined would be
// block-smoothed by libjpeg (jdcoefct.c smoothing_ok); that smoothing is
// not reproduced: such a file is refused (kUnrefined).
//
// For JPEG-in-TIFF it also reads a tables-only stream (read_tables) whose
// tables the strips' abbreviated streams start from (preload), and decodes
// as the colour space libtiff sets (forced_colour: YCbCr to RGB, or the
// raw components).
//
// Every decode is a value of its own (no globals but const tables), so
// threads may decode at once.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace etjpeg {

// Why a file is refused (0: it is decoded).
enum Kind {
  kSupported = 0,
  kArithmetic = 1,    // arithmetic entropy coding (SOF9-15, DAC)
  kPrecision = 2,     // sample precision other than 8 bits
  kLossless = 3,      // lossless (SOF3)
  kHierarchical = 4,  // hierarchical / differential (SOF5-7, DHP, EXP)
  kComponents = 5,    // neither 1, 3 nor 4 components
  kSampling = 6,      // sampling factors libjpeg does not decode
  kUnrefined = 7,     // progressive scans leave coefficients unrefined
};

// The colour space of the file (jdapimin.c default_decompress_parms).
// kRaw: the components as decoded, no conversion (libjpeg's JCS_UNKNOWN
// output, which libtiff asks for in a TIFF that is not YCbCr).
enum Colour { kGrey, kYCbCr, kRGB, kCMYK, kYCCK, kRaw };

enum Status { kOk = 0, kCorrupt = -2, kRefused = -4 };

// zigzag index -> natural index, with libjpeg's 16 guard entries
constexpr uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables (ITU T.81 K.3): counts per length 1..16,
// then symbols. Index 0 luminance, 1 chrominance.
constexpr uint8_t kStdDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// ---------------------------------------------------------------- Huffman

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  // jdhuff.c jpeg_make_d_derived_tbl; false for a table no code fits
  bool build(const uint8_t* bits, const uint8_t* symbols) {
    int huffsize[257], huffcode[257];
    int n = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i) {
        if (n >= 256) return false;
        huffsize[n++] = l;
      }
    }
    huffsize[n] = 0;
    std::memcpy(vals, symbols, n);
    int code = 0, si = n ? huffsize[0] : 0, p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) return false;  // no all-ones code
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look_len, 0, sizeof(look_len));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        const int lo = huffcode[p] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); ++j) {
          look_len[lo + j] = static_cast<uint8_t>(l);
          look_val[lo + j] = vals[p];
        }
      }
    }
    defined = true;
    return true;
  }
};

// Entropy-coded bits, MSB first. At a marker (or the end of the data) it
// reads zeros from then on, as libjpeg does (jdhuff.c jpeg_fill_bit_buffer).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0) {
            p += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int n) {
    if (cnt < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  int decode(const Huffman& t) {
    const uint32_t look = peek(16);
    const uint32_t top = look >> (16 - kLookBits);
    if (t.look_len[top]) {
      skip(t.look_len[top]);
      return t.look_val[top];
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(look >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xff];
      }
    }
    skip(16);  // corrupt data: libjpeg warns and yields 0
    return 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------- IDCTs

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int kRangeMask = 1023;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// jdmaster.c prepare_range_limit_table as the IDCTs index it:
// idct_limit(x & RANGE_MASK) = clamp(x + 128) for x in [-512, 511], and
// the table's wrap outside.
inline uint8_t idct_limit(int64_t x) {
  const int u = static_cast<int>(x) & kRangeMask;
  if (u < 128) return static_cast<uint8_t>(u + 128);
  if (u < 512) return 255;
  if (u < 896) return 0;
  return static_cast<uint8_t>(u - 896);
}

constexpr int64_t fix(double x) {
  return static_cast<int64_t>(x * (1 << kConstBits) + 0.5);
}

// jidctint.c jpeg_idct_islow: 8x8 coefficients (natural order) x quant
// table -> 8x8 samples.
inline void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                       int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* i = in + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!i[8] && !i[16] && !i[24] && !i[32] && !i[40] && !i[48] && !i[56]) {
      const int dc = (i[0] * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = i[16] * qq[16], z3 = i[48] * qq[48];
    int64_t z1 = (z2 + z3) * fix(0.541196100);
    const int64_t tmp2 = z1 + z3 * -fix(1.847759065);
    const int64_t tmp3 = z1 + z2 * fix(0.765366865);
    z2 = i[0] * qq[0];
    z3 = i[32] * qq[32];
    const int64_t tmp0e = (z2 + z3) * (1 << kConstBits);
    const int64_t tmp1e = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0e + tmp3, tmp13 = tmp0e - tmp3;
    const int64_t tmp11 = tmp1e + tmp2, tmp12 = tmp1e - tmp2;
    int64_t t0 = i[56] * qq[56], t1 = i[40] * qq[40];
    int64_t t2 = i[24] * qq[24], t3 = i[8] * qq[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3;
    const int64_t z5 = (z3 + z4) * fix(1.175875602);
    t0 *= fix(0.298631336);
    t1 *= fix(2.053119869);
    t2 *= fix(3.072711026);
    t3 *= fix(1.501321110);
    z1 *= -fix(0.899976223);
    z2 *= -fix(2.562915447);
    z3 = z3 * -fix(1.961570560) + z5;
    z4 = z4 * -fix(0.390180644) + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + t3, n));
    w[56] = static_cast<int>(descale(tmp10 - t3, n));
    w[8] = static_cast<int>(descale(tmp11 + t2, n));
    w[48] = static_cast<int>(descale(tmp11 - t2, n));
    w[16] = static_cast<int>(descale(tmp12 + t1, n));
    w[40] = static_cast<int>(descale(tmp12 - t1, n));
    w[24] = static_cast<int>(descale(tmp13 + t0, n));
    w[32] = static_cast<int>(descale(tmp13 - t0, n));
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * fix(0.541196100);
    const int64_t tmp2 = z1 + z3 * -fix(1.847759065);
    const int64_t tmp3 = z1 + z2 * fix(0.765366865);
    const int64_t tmp0e = (int64_t{w[0]} + w[4]) * (1 << kConstBits);
    const int64_t tmp1e = (int64_t{w[0]} - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0e + tmp3, tmp13 = tmp0e - tmp3;
    const int64_t tmp11 = tmp1e + tmp2, tmp12 = tmp1e - tmp2;
    int64_t t0 = w[7], t1 = w[5], t2 = w[3], t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3;
    const int64_t z5 = (z3 + z4) * fix(1.175875602);
    t0 *= fix(0.298631336);
    t1 *= fix(2.053119869);
    t2 *= fix(3.072711026);
    t3 *= fix(1.501321110);
    z1 *= -fix(0.899976223);
    z2 *= -fix(2.562915447);
    z3 = z3 * -fix(1.961570560) + z5;
    z4 = z4 * -fix(0.390180644) + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + t3, n));
    o[7] = idct_limit(descale(tmp10 - t3, n));
    o[1] = idct_limit(descale(tmp11 + t2, n));
    o[6] = idct_limit(descale(tmp11 - t2, n));
    o[2] = idct_limit(descale(tmp12 + t1, n));
    o[5] = idct_limit(descale(tmp12 - t1, n));
    o[3] = idct_limit(descale(tmp13 + t0, n));
    o[4] = idct_limit(descale(tmp13 - t0, n));
  }
}

// jidctred.c jpeg_idct_4x4: 8x8 coefficients -> 4x4 samples.
inline void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out,
                     int stride) {
  int ws[32];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // column 4 is not used by the second pass
    const int16_t* i = in + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!i[8] && !i[16] && !i[24] && !i[40] && !i[48] && !i[56]) {
      const int dc = (i[0] * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 4; ++r) w[r * 8] = dc;
      continue;
    }
    const int64_t tmp0 = int64_t{i[0] * qq[0]} * (1 << (kConstBits + 1));
    const int64_t tmp2 = int64_t{i[16] * qq[16]} * fix(1.847759065) +
                         int64_t{i[48] * qq[48]} * -fix(0.765366865);
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = i[56] * qq[56], z2 = i[40] * qq[40];
    const int64_t z3 = i[24] * qq[24], z4 = i[8] * qq[8];
    const int64_t o0 = z1 * -fix(0.211164243) + z2 * fix(1.451774981) +
                       z3 * -fix(2.172734803) + z4 * fix(1.061594337);
    const int64_t o2 = z1 * -fix(0.509795579) + z2 * -fix(0.601344887) +
                       z3 * fix(0.899976223) + z4 * fix(2.562915447);
    const int n = kConstBits - kPass1Bits + 1;
    w[0] = static_cast<int>(descale(tmp10 + o2, n));
    w[24] = static_cast<int>(descale(tmp10 - o2, n));
    w[8] = static_cast<int>(descale(tmp12 + o0, n));
    w[16] = static_cast<int>(descale(tmp12 - o0, n));
  }
  const int n = kConstBits + kPass1Bits + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      std::memset(o, v, 4);
      continue;
    }
    const int64_t tmp0 = int64_t{w[0]} * (1 << (kConstBits + 1));
    const int64_t tmp2 =
        int64_t{w[2]} * fix(1.847759065) + int64_t{w[6]} * -fix(0.765366865);
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    const int64_t o0 = z1 * -fix(0.211164243) + z2 * fix(1.451774981) +
                       z3 * -fix(2.172734803) + z4 * fix(1.061594337);
    const int64_t o2 = z1 * -fix(0.509795579) + z2 * -fix(0.601344887) +
                       z3 * fix(0.899976223) + z4 * fix(2.562915447);
    o[0] = idct_limit(descale(tmp10 + o2, n));
    o[3] = idct_limit(descale(tmp10 - o2, n));
    o[1] = idct_limit(descale(tmp12 + o0, n));
    o[2] = idct_limit(descale(tmp12 - o0, n));
  }
}

// jidctred.c jpeg_idct_2x2: 8x8 coefficients -> 2x2 samples.
inline void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out,
                     int stride) {
  int ws[16];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t* i = in + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!i[8] && !i[24] && !i[40] && !i[56]) {
      const int dc = (i[0] * qq[0]) * (1 << kPass1Bits);
      w[0] = w[8] = dc;
      continue;
    }
    const int64_t tmp10 = int64_t{i[0] * qq[0]} * (1 << (kConstBits + 2));
    const int64_t tmp0 = int64_t{i[56] * qq[56]} * -fix(0.720959822) +
                         int64_t{i[40] * qq[40]} * fix(0.850430095) +
                         int64_t{i[24] * qq[24]} * -fix(1.272758580) +
                         int64_t{i[8] * qq[8]} * fix(3.624509785);
    const int n = kConstBits - kPass1Bits + 2;
    w[0] = static_cast<int>(descale(tmp10 + tmp0, n));
    w[8] = static_cast<int>(descale(tmp10 - tmp0, n));
  }
  const int n = kConstBits + kPass1Bits + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[3] && !w[5] && !w[7]) {
      o[0] = o[1] = idct_limit(descale(w[0], kPass1Bits + 3));
      continue;
    }
    const int64_t tmp10 = int64_t{w[0]} * (1 << (kConstBits + 2));
    const int64_t tmp0 =
        int64_t{w[7]} * -fix(0.720959822) + int64_t{w[5]} * fix(0.850430095) +
        int64_t{w[3]} * -fix(1.272758580) + int64_t{w[1]} * fix(3.624509785);
    o[0] = idct_limit(descale(tmp10 + tmp0, n));
    o[1] = idct_limit(descale(tmp10 - tmp0, n));
  }
}

// jidctred.c jpeg_idct_1x1: the DC term alone.
inline void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out,
                     int) {
  out[0] = idct_limit(descale(in[0] * q[0], 3));
}

// ---------------------------------------------------------------- colour

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kBits = 16;
    constexpr int64_t kHalf = int64_t{1} << (kBits - 1);
    auto f = [](double x) {
      return static_cast<int64_t>(x * (int64_t{1} << kBits) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((f(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = static_cast<int>((f(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = static_cast<int32_t>(-f(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-f(0.34414) * x + kHalf);
    }
  }
};

inline const YccTables& ycc_tables() {
  static const YccTables t;  // thread-safe initialisation (C++11)
  return t;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------- frame

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // Huffman tables of the current scan
  int bw = 0, bh = 0;  // blocks held (whole interleaved MCUs)
  int wib = 0, hib = 0;  // blocks a scan of this component alone covers
  int dc_pred = 0;
  bool latched = false;
  uint16_t q[64] = {};
  int8_t coef_bits[64];  // -1 never coded, else Al of the last scan
  std::vector<int16_t> coef;
};

inline int ceil_div(int64_t a, int64_t b) {
  return static_cast<int>((a + b - 1) / b);
}

class Decoder {
 public:
  int width = 0, height = 0;
  int orientation = 1;  // EXIF tag 0x0112 of the first APP1, else 1
  int kind = kSupported;
  int colour = kGrey;
  bool progressive = false;
  // Set before read(): the colour space to decode as, whatever the
  // markers say (-1: jdapimin.c's guess).
  int forced_colour = -1;

  // A tables-only stream (a TIFF's JPEGTables): its DQT and DHT segments
  // are kept for the abbreviated streams read() parses after it, as
  // jpeg_read_header(require_image = FALSE) keeps them.
  int read_tables(const uint8_t* data, size_t n) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) return kCorrupt;
    p += 2;
    while (true) {
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) return kOk;
      const int m = *p++;
      if (m == 0xD9) return kOk;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (end - p < 2) return kOk;
      const int len = (p[0] << 8) | p[1];
      if (len < 2 || end - p < len) return kCorrupt;
      if (m == 0xC4 && !read_dht(p + 2, len - 2)) return kCorrupt;
      if (m == 0xDB && !read_dqt(p + 2, len - 2)) return kCorrupt;
      if ((m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) ||
          m == 0xDA) {
        return kCorrupt;  // a frame or scan in what holds tables only
      }
      p += len;
    }
  }

  // The tables another decoder read (read_tables), as this one's start.
  void preload(const Decoder& t) {
    for (int i = 0; i < 4; ++i) {
      dc_[i] = t.dc_[i];
      ac_[i] = t.ac_[i];
      std::memcpy(qt_[i], t.qt_[i], sizeof(qt_[i]));
      qt_defined_[i] = t.qt_defined_[i];
    }
  }

  int components() const { return ncomp_; }
  int h_sampling(int c) const { return comp_[c].h; }
  int v_sampling(int c) const { return comp_[c].v; }

  // Parse `data`; with `decode` also decode every scan. Without it, stops
  // at the first scan of a sequential file and walks the scan headers of a
  // progressive one (to refuse unrefined files), skipping their data.
  // Returns kOk, kCorrupt, or kRefused with `kind` set.
  int read(const uint8_t* data, size_t n, bool decode) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) return kCorrupt;
    p += 2;
    bool seen_sof = false, seen_sos = false;
    while (true) {
      // next marker: skip anything up to 0xFF, then fill bytes
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) break;
      const int m = *p++;
      if (m == 0xD9) break;                               // EOI
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // standalone
      if (end - p < 2) break;
      const int len = (p[0] << 8) | p[1];
      if (len < 2) return kCorrupt;
      if (end - p < len) break;
      const uint8_t* seg = p + 2;
      const int slen = len - 2;
      p += len;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (seen_sof) return kCorrupt;
        seen_sof = true;
        const int st = read_sof(m, seg, slen);
        if (st != kOk) return st;
      } else if (m == 0xC3) {
        return refuse(kLossless);
      } else if (m >= 0xC5 && m <= 0xC7) {
        return refuse(kHierarchical);
      } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) ||
                 m == 0xCC) {
        return refuse(kArithmetic);
      } else if (m == 0xDE || m == 0xDF) {
        return refuse(kHierarchical);
      } else if (m == 0xC4) {
        if (!read_dht(seg, slen)) return kCorrupt;
      } else if (m == 0xDB) {
        if (!read_dqt(seg, slen)) return kCorrupt;
      } else if (m == 0xDD) {
        if (slen < 2) return kCorrupt;
        restart_interval_ = (seg[0] << 8) | seg[1];
      } else if (m == 0xE0) {
        if (slen >= 5 && !std::memcmp(seg, "JFIF", 5)) saw_jfif_ = true;
      } else if (m == 0xE1) {
        if (!seen_exif_ && slen >= 6 && !std::memcmp(seg, "Exif\0\0", 6)) {
          seen_exif_ = true;  // the first Exif APP1 (XMP may come first)
          orientation = exif_orientation(seg, slen);
        }
      } else if (m == 0xEE) {
        if (slen >= 12 && !std::memcmp(seg, "Adobe", 5)) {
          saw_adobe_ = true;
          adobe_transform_ = seg[11];
        }
      } else if (m == 0xDA) {
        if (!seen_sof) return kCorrupt;
        if (!seen_sos) {
          seen_sos = true;
          const int st = check_frame();
          if (st != kOk) return st;
          if (!decode && !progressive) return kOk;
        }
        Scan scan;
        if (!read_sos(seg, slen, &scan)) return kCorrupt;
        if (decode) {
          p = decode_scan(scan, p, end);
        } else {
          p = skip_entropy(p, end);
        }
      }
    }
    if (!seen_sof || !seen_sos) return kCorrupt;
    if (progressive) {
      for (int c = 0; c < ncomp_; ++c) {
        for (int k = 0; k < 64; ++k) {
          if (comp_[c].coef_bits[k] != 0) return refuse(kUnrefined);
        }
      }
    }
    return kOk;
  }

  // Output size at scale 1/denom (jdmaster.c jpeg_core_output_dimensions).
  int out_width(int denom) const { return ceil_div(width, denom); }
  int out_height(int denom) const { return ceil_div(height, denom); }

  // After read(decode = true): the RGB image at scale 1/denom, one row at a
  // time, as `sink(y, row)` with row (out_width, 3); (out_width,
  // components) of raw samples for kRaw.
  template <class Sink>
  void output(int denom, Sink&& sink) const {
    const int smin = 8 / denom;
    const int ow = out_width(denom), oh = out_height(denom);
    Plane pl[4];
    for (int c = 0; c < ncomp_; ++c) {
      const Component& cp = comp_[c];
      int s = smin;  // jpeg_calc_output_dimensions' DCT size rule
      while (s < 8 && (hmax_ * smin) % (cp.h * s * 2) == 0 &&
             (vmax_ * smin) % (cp.v * s * 2) == 0) {
        s *= 2;
      }
      Plane& P = pl[c];
      P.dw = ceil_div(int64_t{width} * cp.h * s, hmax_ * 8);
      P.dh = ceil_div(int64_t{height} * cp.v * s, vmax_ * 8);
      P.stride = cp.bw * s;
      P.px.resize(static_cast<size_t>(P.stride) * cp.bh * s);
      P.hr = hmax_ / (cp.h * s / smin);
      P.vr = vmax_ / (cp.v * s / smin);
      // jinit_upsampler: do_fancy is off at the 1/8 scale (min DCT size
      // 1); h2v1 and h2v2 also need a component wider than 2
      P.fancy = smin > 1 && (P.hr == 1 || P.dw > 2) &&
                ((P.hr == 2 && P.vr <= 2) || (P.hr == 1 && P.vr == 2));
      const int nbx = std::min(cp.bw, ceil_div(P.dw, s));
      const int nby = std::min(cp.bh, ceil_div(P.dh, s));
      auto idct = s == 8 ? idct_islow
                         : s == 4 ? idct_4x4 : s == 2 ? idct_2x2 : idct_1x1;
      for (int by = 0; by < nby; ++by) {
        for (int bx = 0; bx < nbx; ++bx) {
          idct(&cp.coef[(static_cast<size_t>(by) * cp.bw + bx) * 64], cp.q,
               &P.px[static_cast<size_t>(by) * s * P.stride + bx * s],
               P.stride);
        }
      }
    }
    std::vector<uint8_t> row(static_cast<size_t>(ow) * std::max(3, ncomp_));
    std::vector<uint8_t> up(static_cast<size_t>(ow) * ncomp_);
    int dwmax = 0;
    for (int c = 0; c < ncomp_; ++c) dwmax = std::max(dwmax, pl[c].dw);
    std::vector<int> colsum(dwmax);
    const YccTables& t = ycc_tables();
    for (int y = 0; y < oh; ++y) {
      const uint8_t* in[4];
      for (int c = 0; c < ncomp_; ++c) {
        in[c] = upsample_row(pl[c], y, ow, &up[static_cast<size_t>(c) * ow],
                             colsum.data());
      }
      if (colour == kRaw) {  // the samples, interleaved
        for (int x = 0; x < ow; ++x) {
          for (int c = 0; c < ncomp_; ++c) row[x * ncomp_ + c] = in[c][x];
        }
        sink(y, row.data());
        continue;
      }
      for (int x = 0; x < ow; ++x) {
        uint8_t* o = &row[x * 3];
        switch (colour) {
          case kGrey:
            o[0] = o[1] = o[2] = in[0][x];
            break;
          case kRGB:
            o[0] = in[0][x], o[1] = in[1][x], o[2] = in[2][x];
            break;
          case kYCbCr: {
            const int Y = in[0][x], b = in[1][x], r = in[2][x];
            o[0] = clamp255(Y + t.cr_r[r]);
            o[1] = clamp255(Y + ((t.cb_g[b] + t.cr_g[r]) >> 16));
            o[2] = clamp255(Y + t.cb_b[b]);
            break;
          }
          default: {  // CMYK, YCCK (ycck_cmyk_convert first)
            int c0 = in[0][x], c1 = in[1][x], c2 = in[2][x];
            const int k = in[3][x];
            if (colour == kYCCK) {
              const int Y = c0, b = c1, r = c2;
              c0 = clamp255(255 - (Y + t.cr_r[r]));
              c1 = clamp255(255 - (Y + ((t.cb_g[b] + t.cr_g[r]) >> 16)));
              c2 = clamp255(255 - (Y + t.cb_b[b]));
            }
            // icvCvt_CMYK2BGR_8u_C4C3R: red from C, green M, blue Y
            o[0] = static_cast<uint8_t>(k - (((255 - c0) * k) >> 8));
            o[1] = static_cast<uint8_t>(k - (((255 - c1) * k) >> 8));
            o[2] = static_cast<uint8_t>(k - (((255 - c2) * k) >> 8));
            break;
          }
        }
      }
      sink(y, row.data());
    }
  }

 private:
  struct Scan {
    int n = 0;
    int comps[4] = {};
    int ss = 0, se = 63, ah = 0, al = 0;
  };
  struct Plane {
    std::vector<uint8_t> px;
    int stride = 0, dw = 0, dh = 0, hr = 1, vr = 1;
    bool fancy = false;
  };

  Component comp_[4];
  int ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  Huffman dc_[4], ac_[4];
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  bool saw_jfif_ = false, saw_adobe_ = false, seen_exif_ = false;
  int adobe_transform_ = -1;
  int eobrun_ = 0;

  int refuse(int k) {
    kind = k;
    return kRefused;
  }

  // The orientation (1-8) in the TIFF IFD0 of an APP1 "Exif\0\0" body,
  // as cv2.imread reads it; 1 when it is missing or malformed.
  static int exif_orientation(const uint8_t* s, int n) {
    if (n < 14 || std::memcmp(s, "Exif\0\0", 6)) return 1;
    const uint8_t* t = s + 6;
    const int tn = n - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') {
      le = true;
    } else if (t[0] == 'M' && t[1] == 'M') {
      le = false;
    } else {
      return 1;
    }
    auto u16 = [&](int o) {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto u32 = [&](int o) -> uint32_t {
      return le ? t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                      (uint32_t{t[o + 3]} << 24)
                : (uint32_t{t[o]} << 24) | (t[o + 1] << 16) |
                      (t[o + 2] << 8) | t[o + 3];
    };
    if (u16(2) != 42) return 1;
    const uint32_t ifd = u32(4);
    if (ifd > static_cast<uint32_t>(tn) - 2 || tn < 2) return 1;
    const int count = u16(static_cast<int>(ifd));
    for (int e = 0; e < count; ++e) {
      const int64_t o = int64_t{ifd} + 2 + 12 * int64_t{e};
      if (o + 12 > tn) return 1;
      if (u16(static_cast<int>(o)) == 0x0112) {
        // read as a SHORT whatever the entry's type says, as OpenCV's
        // ExifReader reads it
        const int v = u16(static_cast<int>(o) + 8);
        return (v >= 1 && v <= 8) ? v : 1;
      }
    }
    return 1;
  }

  int read_sof(int m, const uint8_t* s, int n) {
    if (n < 6) return kCorrupt;
    if (s[0] != 8) return refuse(kPrecision);
    progressive = m == 0xC2;
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4) return refuse(kComponents);
    if (n < 6 + 3 * ncomp_ || width == 0 || height == 0) return kCorrupt;
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      cp.id = s[6 + 3 * c];
      cp.h = s[7 + 3 * c] >> 4;
      cp.v = s[7 + 3 * c] & 15;
      cp.tq = s[8 + 3 * c];
      if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3) {
        return kCorrupt;
      }
      hmax_ = std::max(hmax_, cp.h);
      vmax_ = std::max(vmax_, cp.v);
      std::memset(cp.coef_bits, -1, sizeof(cp.coef_bits));
    }
    // jdsample.c: every ratio to the largest factor is integral
    // (JERR_FRACT_SAMPLE_NOTIMPL); jdinput.c: an interleaved MCU holds at
    // most D_MAX_BLOCKS_IN_MCU = 10 blocks (JERR_BAD_MCU_SIZE)
    int blocks = 0;
    for (int c = 0; c < ncomp_; ++c) {
      const Component& cp = comp_[c];
      if (hmax_ % cp.h || vmax_ % cp.v) return refuse(kSampling);
      blocks += cp.h * cp.v;
    }
    if (ncomp_ > 1 && blocks > 10) return refuse(kSampling);
    return kOk;
  }

  // jdapimin.c default_decompress_parms' colour space guess; the buffers
  // are allocated here, once the frame is known.
  int check_frame() {
    if (ncomp_ == 1) {
      colour = kGrey;
    } else if (ncomp_ == 3) {
      bool rgb = false;
      if (saw_jfif_) {
        rgb = false;
      } else if (saw_adobe_) {
        rgb = adobe_transform_ == 0;
      } else {
        rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
      }
      colour = rgb ? kRGB : kYCbCr;
    } else {  // 4: an Adobe transform other than 0 is taken as YCCK
      colour = saw_adobe_ && adobe_transform_ != 0 ? kYCCK : kCMYK;
    }
    if (forced_colour >= 0) colour = forced_colour;
    mcux_ = ceil_div(width, 8 * hmax_);
    mcuy_ = ceil_div(height, 8 * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      cp.bw = mcux_ * cp.h;
      cp.bh = mcuy_ * cp.v;
      cp.wib = ceil_div(ceil_div(int64_t{width} * cp.h, hmax_), 8);
      cp.hib = ceil_div(ceil_div(int64_t{height} * cp.v, vmax_), 8);
    }
    return kOk;
  }

  void allocate() {
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      if (cp.coef.empty()) {
        cp.coef.assign(static_cast<size_t>(cp.bw) * cp.bh * 64, 0);
      }
    }
  }

  bool read_dht(const uint8_t* s, int n) {
    int o = 0;
    while (o < n) {
      if (n - o < 17) return false;
      const int tc = s[o] >> 4, th = s[o] & 15;
      if (tc > 1 || th > 3) return false;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[o + 1 + i];
      if (total > 256 || n - o < 17 + total) return false;
      // a DC symbol is a bit count: libjpeg refuses one above 15
      for (int i = 0; i < total && !tc; ++i) {
        if (s[o + 17 + i] > 15) return false;
      }
      Huffman& t = tc ? ac_[th] : dc_[th];
      if (!t.build(s + o + 1, s + o + 17)) return false;
      o += 17 + total;
    }
    return true;
  }

  bool read_dqt(const uint8_t* s, int n) {
    int o = 0;
    while (o < n) {
      const int pq = s[o] >> 4, tq = s[o] & 15;
      if (pq > 1 || tq > 3 || n - o < 1 + 64 * (pq + 1)) return false;
      for (int k = 0; k < 64; ++k) {
        qt_[tq][kNatural[k]] =
            pq ? static_cast<uint16_t>((s[o + 1 + 2 * k] << 8) |
                                       s[o + 2 + 2 * k])
               : s[o + 1 + k];
      }
      qt_defined_[tq] = true;
      o += 1 + 64 * (pq + 1);
    }
    return true;
  }

  bool read_sos(const uint8_t* s, int n, Scan* scan) {
    if (n < 1) return false;
    scan->n = s[0];
    if (scan->n < 1 || scan->n > ncomp_ || n < 4 + 2 * scan->n) return false;
    for (int i = 0; i < scan->n; ++i) {
      const int id = s[1 + 2 * i];
      int c = 0;
      while (c < ncomp_ && comp_[c].id != id) ++c;
      if (c == ncomp_) return false;
      scan->comps[i] = c;
      comp_[c].td = s[2 + 2 * i] >> 4;
      comp_[c].ta = s[2 + 2 * i] & 15;
      if (comp_[c].td > 3 || comp_[c].ta > 3) return false;
    }
    const uint8_t* t = s + 1 + 2 * scan->n;
    scan->ss = t[0];
    scan->se = t[1];
    scan->ah = t[2] >> 4;
    scan->al = t[2] & 15;
    if (progressive) {
      if (scan->ss == 0 ? scan->se != 0
                        : (scan->se < scan->ss || scan->se > 63 ||
                           scan->n != 1)) {
        return false;
      }
      if (scan->al > 13) return false;
      for (int i = 0; i < scan->n; ++i) {
        Component& cp = comp_[scan->comps[i]];
        for (int k = scan->ss; k <= scan->se; ++k) {
          cp.coef_bits[k] = static_cast<int8_t>(scan->al);
        }
      }
    } else {
      for (int i = 0; i < scan->n; ++i) {
        std::memset(comp_[scan->comps[i]].coef_bits, 0, 64);
      }
    }
    // quantisation tables latch at a component's first scan (jdinput.c)
    for (int i = 0; i < scan->n; ++i) {
      Component& cp = comp_[scan->comps[i]];
      if (!cp.latched) {
        if (!qt_defined_[cp.tq]) return false;
        std::memcpy(cp.q, qt_[cp.tq], sizeof(cp.q));
        cp.latched = true;
      }
    }
    return true;
  }

  static const uint8_t* skip_entropy(const uint8_t* p, const uint8_t* end) {
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] != 0 && !(p[1] >= 0xD0 && p[1] <= 0xD7) &&
          p[1] != 0xFF) {
        return p;
      }
      ++p;
    }
    return end;
  }

  // A table the file did not define: libjpeg-turbo's standard one
  // (jstdhuff.c) for indices 0 and 1.
  bool table(Huffman* set, int i, bool ac) {
    if (set[i].defined) return true;
    if (i > 1) return false;
    return ac ? set[i].build(kStdAcBits[i], kStdAcVals[i])
              : set[i].build(kStdDcBits[i], kStdDcVals);
  }

  static int16_t* block(Component& cp, int bx, int by) {
    return &cp.coef[(static_cast<size_t>(by) * cp.bw + bx) * 64];
  }

  const uint8_t* decode_scan(const Scan& sc, const uint8_t* p,
                             const uint8_t* end) {
    allocate();
    for (int i = 0; i < sc.n; ++i) {
      Component& cp = comp_[sc.comps[i]];
      const bool dc = !progressive || sc.ss == 0;
      const bool ac = !progressive || sc.ss > 0;
      if ((dc && sc.ah == 0 && !table(dc_, cp.td, false)) ||
          (ac && !table(ac_, cp.ta, true))) {
        return skip_entropy(p, end);
      }
      cp.dc_pred = 0;
    }
    eobrun_ = 0;
    Bits bits{p, end};
    const bool single = sc.n == 1;
    Component& c0 = comp_[sc.comps[0]];
    const int64_t mcus = single ? int64_t{c0.wib} * c0.hib
                                : int64_t{mcux_} * mcuy_;
    const int per_row = single ? c0.wib : mcux_;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
        restart(&bits);
        for (int i = 0; i < sc.n; ++i) comp_[sc.comps[i]].dc_pred = 0;
        eobrun_ = 0;
      }
      const int mx = static_cast<int>(m % per_row);
      const int my = static_cast<int>(m / per_row);
      if (single) {
        decode_block(sc, c0, block(c0, mx, my), &bits);
        continue;
      }
      for (int i = 0; i < sc.n; ++i) {
        Component& cp = comp_[sc.comps[i]];
        for (int v = 0; v < cp.v; ++v) {
          for (int h = 0; h < cp.h; ++h) {
            decode_block(sc, cp, block(cp, mx * cp.h + h, my * cp.v + v),
                         &bits);
          }
        }
      }
    }
    return skip_entropy(bits.p, end);
  }

  // Byte-align, then read the RSTn marker (jdhuff.c process_restart).
  static void restart(Bits* b) {
    b->buf = 0;
    b->cnt = 0;
    const uint8_t* p = b->p;
    while (p + 1 < b->end) {
      if (p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF) break;
      ++p;
    }
    if (p + 1 < b->end && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
    b->p = p;
    b->at_marker = false;
  }

  void decode_block(const Scan& sc, Component& cp, int16_t* blk, Bits* b) {
    if (!progressive) {
      const Huffman& dct = dc_[cp.td];
      const Huffman& act = ac_[cp.ta];
      int s = b->decode(dct);
      if (s) s = extend(b->get(s), s);
      cp.dc_pred += s;
      blk[0] = static_cast<int16_t>(cp.dc_pred);
      for (int k = 1; k < 64; ++k) {
        int rs = b->decode(act);
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(b->get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (sc.ss == 0) {  // DC scans (jdphuff.c decode_mcu_DC_first/_refine)
      if (sc.ah == 0) {
        int s = b->decode(dc_[cp.td]);
        if (s) s = extend(b->get(s), s);
        cp.dc_pred += s;
        blk[0] = static_cast<int16_t>(cp.dc_pred * (1 << sc.al));
      } else if (b->get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << sc.al));
      }
      return;
    }
    const Huffman& act = ac_[cp.ta];
    if (sc.ah == 0) {  // decode_mcu_AC_first
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = sc.ss; k <= sc.se; ++k) {
        const int rs = b->decode(act);
        int r = rs >> 4;
        const int s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] =
              static_cast<int16_t>(extend(b->get(s), s) * (1 << sc.al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += b->get(r);
          --eobrun_;
          break;
        }
      }
      return;
    }
    // decode_mcu_AC_refine
    const int p1 = 1 << sc.al;
    const int m1 = -1 * (1 << sc.al);
    int k = sc.ss;
    if (eobrun_ == 0) {
      for (; k <= sc.se; ++k) {
        const int rs = b->decode(act);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = b->get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += b->get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (b->get(1) && (*coef & p1) == 0) {
              *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
            }
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= sc.se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= sc.se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && b->get(1) && (*coef & p1) == 0) {
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
        }
      }
      --eobrun_;
    }
  }

  // One output row of a component's plane, upsampled to the output width
  // (jdsample.c): the plane's own row where it is full size, else `out`.
  // `colsum` holds plane.dw ints.
  static const uint8_t* upsample_row(const Plane& P, int y, int ow,
                                     uint8_t* out, int* colsum) {
    const int dw = P.dw;
    if (P.vr == 1 && P.hr == 1) {  // fullsize_upsample
      return &P.px[static_cast<size_t>(y) * P.stride];
    }
    const int iy = y / P.vr;
    const uint8_t* in = &P.px[static_cast<size_t>(iy) * P.stride];
    if (!P.fancy) {  // h2v1_upsample / h2v2_upsample / int_upsample
      for (int x = 0; x < ow; ++x) out[x] = in[x / P.hr];
      return out;
    }
    if (P.vr == 1) {  // h2v1_fancy_upsample
      for (int x = 0; x < ow; ++x) {
        const int i = x >> 1;
        out[x] = (x & 1)
                     ? static_cast<uint8_t>(
                           (in[i] * 3 + in[std::min(i + 1, dw - 1)] + 2) >> 2)
                     : static_cast<uint8_t>(
                           (in[i] * 3 + in[std::max(i - 1, 0)] + 1) >> 2);
      }
      return out;
    }
    // h2v2 / h1v2: the nearer input row weighs 3, the row above (even
    // output rows) or below (odd) 1; rows past the image repeat the edge
    // row (jdmainct.c context rows)
    const int ny = std::min(std::max((y & 1) ? iy + 1 : iy - 1, 0), P.dh - 1);
    const uint8_t* in1 = &P.px[static_cast<size_t>(ny) * P.stride];
    if (P.hr == 1) {  // h1v2_fancy_upsample
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < ow; ++x) {
        out[x] = static_cast<uint8_t>((in[x] * 3 + in1[x] + bias) >> 2);
      }
      return out;
    }
    // h2v2_fancy_upsample
    for (int i = 0; i < dw; ++i) colsum[i] = in[i] * 3 + in1[i];
    for (int x = 0; x < ow; ++x) {
      const int i = x >> 1;
      out[x] = (x & 1)
                   ? static_cast<uint8_t>(
                         (colsum[i] * 3 + colsum[std::min(i + 1, dw - 1)] +
                          7) >> 4)
                   : static_cast<uint8_t>(
                         (colsum[i] * 3 + colsum[std::max(i - 1, 0)] + 8) >>
                         4);
    }
    return out;
  }
};

}  // namespace etjpeg
