// JPEG decoder of the host loader core: the decode libjpeg-turbo 3.1 (8-bit
// API, its defaults, as cv2.imread calls it) gives, bit for bit, with no
// library. Included by loader_core.cpp only.
//
// Decodes baseline (SOF0), extended sequential (SOF1), progressive (SOF2)
// and lossless (SOF3) Huffman files and sequential (SOF9) and progressive
// (SOF10) arithmetic-coded ones, 8-bit (lossless: 2-8), of 1 component (grey), 3 (YCbCr,
// or RGB where the markers say so) or 4 (CMYK, YCCK), with any sampling
// factors libjpeg accepts (1-4 each, integral ratios, at most 10 blocks in
// an interleaved MCU), with restart intervals, at scale 1, 1/2, 1/4 or 1/8
// (a lossless file at full size whatever the scale, as libjpeg gives it).
// Damaged and truncated data decode as libjpeg decodes them. What libjpeg
// refuses as cv2.imread calls it (other precisions, hierarchical and
// arithmetic lossless frames, a lossless colour conversion) is refused
// with a Kind, from the headers, before any entropy-coded data is read.
//
// Reproduced libjpeg-turbo routines (names are its files and functions):
//   jdatasrc.c  fill_input_buffer   (past the end of the data the source
//                           gives a fake EOI: FF D9, again and again)
//   jdmarker.c  read_markers, next_marker, get_sof, get_sos, get_dac,
//               read_restart_marker, jpeg_resync_to_restart
//   jdhuff.c / jdphuff.c    Huffman decode; sequential, DC/AC first and
//                           refinement scans, EOB runs; a table the file
//                           never defines is the standard one (jstdhuff.c);
//                           jpeg_fill_bit_buffer's insufficient_data: the
//                           MCU in which the data runs out decodes on zero
//                           bits, every later one of the segment is
//                           skipped, a restart marker read clears it
//   jdarith.c   arith_decode (the QM decoder, jaricom.c's Qe table),
//               decode_mcu, decode_mcu_DC_first / _AC_first / _DC_refine /
//               _AC_refine, the statistics areas, DAC conditioning (L, U,
//               Kx), process_restart; zero data once the data ends
//   jdlhuff.c   decode_mcus (difference categories 0-16)
//   jdlossls.c  jpeg_undifference1-7, _first_row, simple_upscale (Pt)
//   jddiffct.c  decompress_data (restart rows, undifferencing per row)
//   jdcoefct.c  consume_data's last_good_iMCU_row, smoothing_ok and
//               decompress_smooth_data (block smoothing of progressive
//               files whose coefficients are not all refined: the
//               coefficient-bit latch of the last scan and the one before,
//               10 coefficients estimated from a 5x5 DC neighbourhood)
//   simd/x86_64 jidctint-avx2.asm jsimd_idct_islow_avx2, jidctred-sse2.asm
//               jsimd_idct_4x4_sse2 / _2x2_sse2   (the IDCTs cv2's build runs
//                           at scales 1, 1/2, 1/4: 13-bit constants,
//                           PASS1_BITS 2, 16-bit lanes, saturating packs)
//   jidctred.c  jpeg_idct_1x1 with jdmaster.c prepare_range_limit_table
//                           (the 1/8 scale: the C code's wrap, RANGE_MASK)
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
#include <memory>
#include <vector>

namespace etjpeg {

// Why a file is refused (0: it is decoded).
// Every kind is one libjpeg refuses too as cv2.imread calls it (cv2
// returns nothing).
enum Kind {
  kSupported = 0,
  kArithLossless = 1,  // arithmetic-coded lossless (SOF11)
  kPrecision = 2,      // a precision the 8-bit API does not read
  kLosslessColour = 3,  // lossless grey or YCbCr to be converted
  kHierarchical = 4,   // hierarchical / differential (SOF5-7, SOF13-15,
                       // DHP, EXP) or the reserved JPG marker
  kComponents = 5,     // neither 1, 3 nor 4 components
  kSampling = 6,       // sampling factors libjpeg does not decode
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
  int maxval = 0;  // the largest symbol (a DC table's largest category)
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
    maxval = 0;
    for (int i = 0; i < n; ++i) maxval = std::max<int>(maxval, vals[i]);
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

// The marker at p (0xFF, fill 0xFFs, its code): its code, with *after past
// it. Where the data ends first, the EOI libjpeg's source inserts there.
inline int marker_code(const uint8_t* p, const uint8_t* end,
                       const uint8_t** after) {
  const uint8_t* q = p + 1;
  while (q < end && *q == 0xFF) ++q;
  if (q >= end) {
    *after = end;
    return 0xD9;
  }
  *after = q + 1;
  return *q;
}

// jdmarker.c next_marker from p: the next 0xFF that starts a marker (not a
// stuffed FF 00), or the end of the data (the fake EOI).
inline const uint8_t* next_marker(const uint8_t* p, const uint8_t* end) {
  while (p < end) {
    if (*p != 0xFF) {
      ++p;
      continue;
    }
    const uint8_t* after;
    const int m = marker_code(p, end, &after);
    if (m != 0) return p;
    p = after;
  }
  return end;
}

// Entropy-coded bits, MSB first (jdhuff.c jpeg_fill_bit_buffer). At a
// marker, or where the data ends, it reads zeros from then on; taking a bit
// past the data sets `insufficient` (libjpeg's insufficient_data).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  int real = 0;  // the leading bits of buf that are data, not zero fill
  bool at_marker = false;  // p is at a marker (libjpeg's unread_marker)
  bool insufficient = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (*p != 0xFF) {
          b = *p++;
          real += 8;
        } else {
          const uint8_t* after;
          if (marker_code(p, end, &after) == 0) {  // FF (FF...) 00
            b = 0xFF;
            p = after;
            real += 8;
          } else {
            at_marker = true;
          }
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
    if (n > real) {
      insufficient = true;
      real = 0;
    } else {
      real -= n;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  int decode(const Huffman& t) {
    const uint32_t look = peek(17);
    const uint32_t top = look >> (17 - kLookBits);
    if (t.look_len[top]) {
      skip(t.look_len[top]);
      return t.look_val[top];
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(look >> (17 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xff];
      }
    }
    // jpeg_huff_decode: no code of 16 bits or fewer; 17 bits are taken,
    // libjpeg warns and yields 0
    skip(17);
    return 0;
  }
  // Drop what is buffered (a restart's byte alignment).
  void discard() {
    buf = 0;
    cnt = 0;
    real = 0;
  }
};

// ---------------------------------------------------------------- QM coder

// jaricom.c jpeg_aritab: per state, Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS (ITU T.81 Table D.3; the last entry is
// the fixed 0.5 estimate of T.851)
constexpr uint32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder registers and its arith_decode (T.81 D.2), reading
// the data at p; at a marker, or where the data ends, zero data.
struct Arith {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two initial bytes to read; -1: the scan's error
  bool at_marker = false;

  int byte() {
    if (at_marker) return 0;
    if (p >= end) {
      at_marker = true;
      return 0;
    }
    if (*p != 0xFF) return *p++;
    const uint8_t* after;
    if (marker_code(p, end, &after) == 0) {  // FF (FF...) 00: data FF
      p = after;
      return 0xFF;
    }
    at_marker = true;  // p stays at the marker
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
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

// libjpeg-turbo's x86-64 SIMD IDCTs (simd/x86_64/jidctint-avx2.asm,
// jidctred-sse2.asm), which cv2's build runs at scales 1, 1/2 and 1/4. They
// compute jidctint.c / jidctred.c's sums, but in SIMD lanes: coefficients
// are dequantised to 16 bits (pmullw), the even and odd inputs are summed
// in 16 bits (paddw), products are taken in pairs (pmaddwd), pass 1's
// outputs are saturated to 16 bits (packssdw), and the samples to 8 bits
// (packsswb, then + 128) where the C code wraps (RANGE_MASK). On valid
// data the two agree; on damaged data only this does.

inline int16_t w16(int64_t x) { return static_cast<int16_t>(x); }
inline int16_t sat16(int64_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}
inline int32_t w32(int64_t x) { return static_cast<int32_t>(x); }
// descale, then packssdw to 16 bits
inline int16_t pack_descale(int64_t x, int n) {
  return sat16(w32(w32(x) + (int32_t{1} << (n - 1))) >> n);
}
// descale, packssdw, packsswb, paddb CENTERJSAMPLE
inline uint8_t sample_descale(int64_t x, int n) {
  const int v = pack_descale(x, n);
  return static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
}

// One 8-point jpeg_idct_islow pass over inputs i[0..7] (16-bit lanes) ->
// its eight 32-bit sums before the descale.
inline void islow_pass(const int16_t* i, int64_t* o) {
  const int64_t z2 = i[2], z3 = i[6];
  const int64_t tmp3 = z2 * (fix(0.541196100) + fix(0.765366865)) +
                       z3 * fix(0.541196100);
  const int64_t tmp2 = z2 * fix(0.541196100) +
                       z3 * (fix(0.541196100) - fix(1.847759065));
  const int64_t tmp0 = int64_t{w16(i[0] + i[4])} * (1 << kConstBits);
  const int64_t tmp1 = int64_t{w16(i[0] - i[4])} * (1 << kConstBits);
  const int64_t tmp10 = w32(tmp0 + tmp3), tmp13 = w32(tmp0 - tmp3);
  const int64_t tmp11 = w32(tmp1 + tmp2), tmp12 = w32(tmp1 - tmp2);
  const int64_t in7 = i[7], in5 = i[5], in3 = i[3], in1 = i[1];
  const int64_t z3s = w16(in7 + in3), z4s = w16(in5 + in1);
  const int64_t f117 = fix(1.175875602);
  const int64_t z3o = z3s * (f117 - fix(1.961570560)) + z4s * f117;
  const int64_t z4o = z3s * f117 + z4s * (f117 - fix(0.390180644));
  const int64_t f089 = fix(0.899976223), f256 = fix(2.562915447);
  const int64_t t0 = w32(in7 * (fix(0.298631336) - f089) + in1 * -f089 + z3o);
  const int64_t t3 = w32(in7 * -f089 + in1 * (fix(1.501321110) - f089) + z4o);
  const int64_t t1 = w32(in5 * (fix(2.053119869) - f256) + in3 * -f256 + z4o);
  const int64_t t2 = w32(in5 * -f256 + in3 * (fix(3.072711026) - f256) + z3o);
  o[0] = tmp10 + t3, o[7] = tmp10 - t3;
  o[1] = tmp11 + t2, o[6] = tmp11 - t2;
  o[2] = tmp12 + t1, o[5] = tmp12 - t1;
  o[3] = tmp13 + t0, o[4] = tmp13 - t0;
}

// jsimd_idct_islow_avx2: 8x8 coefficients (natural order) x quant table ->
// 8x8 samples.
inline void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                       int stride) {
  int16_t ws[64];  // pass 1's output, transposed: ws[c * 8 + r]
  bool ac = false;
  for (int k = 8; k < 64 && !ac; ++k) ac = in[k] != 0;
  if (!ac) {  // rows 1-7 all zero: the DC, shifted in 16 bits
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = w16(int64_t{w16(in[c] * q[c])} * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[c * 8 + r] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t col[8];
      bool col_ac = false;
      for (int r = 0; r < 8; ++r) {
        col[r] = w16(in[r * 8 + c] * q[r * 8 + c]);
        col_ac = col_ac || (r && col[r]);
      }
      if (!col_ac) {  // the pass's sums reduce to the DC << PASS1_BITS
        const int16_t dc = sat16(int64_t{col[0]} * (1 << kPass1Bits));
        for (int r = 0; r < 8; ++r) ws[c * 8 + r] = dc;
        continue;
      }
      int64_t o[8];
      islow_pass(col, o);
      for (int r = 0; r < 8; ++r) {
        ws[c * 8 + r] = pack_descale(o[r], kConstBits - kPass1Bits);
      }
    }
  }
  for (int r = 0; r < 8; ++r) {
    int16_t row[8];
    bool row_ac = false;
    for (int c = 0; c < 8; ++c) {
      row[c] = ws[c * 8 + r];
      row_ac = row_ac || (c && row[c]);
    }
    uint8_t* dst = out + r * stride;
    if (!row_ac) {  // every sample is the descaled DC
      std::memset(dst, sample_descale(int64_t{row[0]} * (1 << kConstBits),
                                      kConstBits + kPass1Bits + 3),
                  8);
      continue;
    }
    int64_t o[8];
    islow_pass(row, o);
    for (int c = 0; c < 8; ++c) {
      dst[c] = sample_descale(o[c], kConstBits + kPass1Bits + 3);
    }
  }
}

// One 4-point jpeg_idct_4x4 pass over i[0..7] (i[4] unused) -> four sums.
inline void red4_pass(const int16_t* i, int64_t* o) {
  const int64_t tmp0 = int64_t{i[0]} * (1 << (kConstBits + 1));
  const int64_t tmp2 = int64_t{i[2]} * fix(1.847759065) +
                       int64_t{i[6]} * -fix(0.765366865);
  const int64_t tmp10 = w32(tmp0 + tmp2), tmp12 = w32(tmp0 - tmp2);
  const int64_t z1 = i[7], z2 = i[5], z3 = i[3], z4 = i[1];
  const int64_t t2 = w32(z4 * fix(2.562915447) + z3 * fix(0.899976223) +
                         z2 * -fix(0.601344887) + z1 * -fix(0.509795579));
  const int64_t t0 = w32(z4 * fix(1.061594337) + z3 * -fix(2.172734803) +
                         z2 * fix(1.451774981) + z1 * -fix(0.211164243));
  o[0] = tmp10 + t2, o[3] = tmp10 - t2;
  o[1] = tmp12 + t0, o[2] = tmp12 - t0;
}

// jsimd_idct_4x4_sse2: 8x8 coefficients -> 4x4 samples.
inline void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out,
                     int stride) {
  int16_t ws[8][4];  // pass 1: ws[column][row]
  bool ac = false;
  for (int r = 1; r < 8 && !ac; ++r) {
    if (r == 4) continue;
    for (int c = 0; c < 8 && !ac; ++c) ac = in[r * 8 + c] != 0;
  }
  for (int c = 0; c < 8; ++c) {
    if (!ac) {  // rows 1-3, 5-7 all zero
      const int16_t dc = w16(int64_t{w16(in[c] * q[c])} * (1 << kPass1Bits));
      for (int r = 0; r < 4; ++r) ws[c][r] = dc;
      continue;
    }
    int16_t col[8];
    for (int r = 0; r < 8; ++r) col[r] = w16(in[r * 8 + c] * q[r * 8 + c]);
    int64_t o[4];
    red4_pass(col, o);
    for (int r = 0; r < 4; ++r) {
      ws[c][r] = pack_descale(o[r], kConstBits - kPass1Bits + 1);
    }
  }
  for (int r = 0; r < 4; ++r) {
    int16_t row[8];
    for (int c = 0; c < 8; ++c) row[c] = ws[c][r];
    int64_t o[4];
    red4_pass(row, o);
    uint8_t* dst = out + r * stride;
    for (int c = 0; c < 4; ++c) {
      dst[c] = sample_descale(o[c], kConstBits + kPass1Bits + 3 + 1);
    }
  }
}

// jsimd_idct_2x2_sse2: 8x8 coefficients -> 2x2 samples. Pass 1 keeps
// column 0 in 32 bits (its even part) and packs the odd columns to 16.
inline void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out,
                     int stride) {
  int32_t ws[8][2];  // pass 1: ws[column][row], columns 0, 1, 3, 5, 7
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    auto dq = [&](int r) { return int64_t{w16(in[r * 8 + c] * q[r * 8 + c])}; };
    const int64_t tmp10 = dq(0) * (1 << (kConstBits + 2));
    const int64_t tmp0 = w32(dq(1) * fix(3.624509785) +
                             dq(3) * -fix(1.272758580) +
                             dq(5) * fix(0.850430095) +
                             dq(7) * -fix(0.720959822));
    const int n = kConstBits - kPass1Bits + 2;
    ws[c][0] = w32(w32(tmp10 + tmp0) + (int32_t{1} << (n - 1))) >> n;
    ws[c][1] = w32(w32(tmp10 - tmp0) + (int32_t{1} << (n - 1))) >> n;
  }
  for (int r = 0; r < 2; ++r) {
    const int64_t tmp10 = w32(int64_t{ws[0][r]} * (1 << (kConstBits + 2)));
    const int64_t tmp0 = w32(int64_t{sat16(ws[1][r])} * fix(3.624509785) +
                             int64_t{sat16(ws[3][r])} * -fix(1.272758580) +
                             int64_t{sat16(ws[5][r])} * fix(0.850430095) +
                             int64_t{sat16(ws[7][r])} * -fix(0.720959822));
    uint8_t* dst = out + r * stride;
    const int n = kConstBits + kPass1Bits + 3 + 2;
    dst[0] = sample_descale(tmp10 + tmp0, n);
    dst[1] = sample_descale(tmp10 - tmp0, n);
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
  int td = 0, ta = 0;  // entropy tables of the current scan
  int bw = 0, bh = 0;  // blocks held (whole interleaved MCUs); samples
                       // in a lossless frame
  int wib = 0, hib = 0;  // blocks a scan of this component alone covers
  int dc_pred = 0;
  int pt = 0;  // a lossless component's point transform (its scan's Al)
  bool latched = false;
  uint16_t q[64] = {};
  int8_t coef_bits[64];  // zigzag: -1 never coded, else Al of the last scan
  int8_t prev_bits[64];  // coef_bits before its latest scan (jdphuff.c)
  std::vector<int16_t> coef;
  std::vector<uint16_t> samples;  // lossless: the undifferenced samples
};

inline int ceil_div(int64_t a, int64_t b) {
  return static_cast<int>((a + b - 1) / b);
}

// Positions of the zigzag coefficients 1-9 that block smoothing estimates
// (jdcoefct.c Q01_POS ... Q30_POS).
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

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

  Decoder() {  // DAC's defaults (jdmarker.c get_soi)
    std::memset(dc_l_, 0, sizeof(dc_l_));
    std::memset(dc_u_, 1, sizeof(dc_u_));
    std::memset(ac_k_, 5, sizeof(ac_k_));
  }

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
  // libjpeg decodes a lossless file at full size whatever the scale asked.
  bool scalable() const { return !lossless_; }

  // Parse `data` as libjpeg reads a file (past its end, the fake EOIs of
  // jdatasrc.c); with `decode` also decode every scan. Without it, stops
  // at the first scan of a sequential file and walks the scan headers of a
  // progressive one (whose errors cv2 reports), skipping their data.
  // Returns kOk, kCorrupt, or kRefused with `kind` set.
  int read(const uint8_t* data, size_t n, bool decode) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    if (n < 2 || p[0] != 0xFF || p[1] != 0xD8) return kCorrupt;
    p += 2;
    bool seen_sof = false, seen_sos = false;
    std::vector<uint8_t> tail;
    while (true) {
      p = next_marker(p, end);  // jdmarker.c next_marker: garbage skipped
      const uint8_t* after;
      const int m = marker_code(p, end, &after);
      p = after;
      if (m == 0xD9) break;                               // EOI
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // standalone
      if ((m >= 0xC5 && m <= 0xC8) || (m >= 0xCD && m <= 0xCF) ||
          m == 0xDE || m == 0xDF) {
        return refuse(kHierarchical);  // JERR_SOF_UNSUPPORTED, DHP / EXP
      }
      const bool known = (m >= 0xC0 && m <= 0xCF) || m == 0xDA ||
                         m == 0xDB || m == 0xDC || m == 0xDD ||
                         (m >= 0xE0 && m <= 0xEF) || m == 0xFE;
      if (!known) return kCorrupt;  // SOI again, JPGn, RESn
      // the segment, its bytes past the data being the fake EOIs
      int len;
      const uint8_t* seg = segment(data, n, p, &len, &tail);
      const int adv = std::max(len, 2);  // a bogus length skips nothing
      // past the data the stream goes on as FF D9 FF D9 ...: a segment
      // that ends one byte into a fake EOI leaves its D9, which a scan
      // reads as data before the next fake EOI
      const bool d9_next = end - p < adv && ((p - end) + adv) % 2 == 1;
      p = (end - p >= adv) ? p + adv : end;
      const bool appn = (m >= 0xE0 && m <= 0xEF) || m == 0xFE;
      if (len < 2) {
        if (appn) continue;  // skip_variable: nothing to skip
        return kCorrupt;
      }
      const int slen = len - 2;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
          m == 0xCA || m == 0xCB) {
        if (seen_sof) return kCorrupt;
        seen_sof = true;
        const int st = read_sof(m, seg, slen);
        if (st != kOk) return st;
      } else if (m == 0xC4) {
        if (!read_dht(seg, slen)) return kCorrupt;
      } else if (m == 0xDB) {
        if (!read_dqt(seg, slen)) return kCorrupt;
      } else if (m == 0xCC) {
        if (!read_dac(seg, slen)) return kCorrupt;
      } else if (m == 0xDD) {
        if (slen != 2) return kCorrupt;
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
        Scan scan;
        if (!read_sos(seg, slen, &scan)) return kCorrupt;
        if (!seen_sos) {
          seen_sos = true;
          const int st = check_frame(scan);
          if (st != kOk) return st;
          if (!decode && !progressive) return kOk;
        }
        if (decode) {
          static const uint8_t kD9[1] = {0xD9};
          const uint8_t* q = d9_next ? kD9 : p;
          const int st = decode_scan(scan, &q, d9_next ? kD9 + 1 : end);
          if (!d9_next) p = q;
          if (st != kOk) return st;
          // a single-scan file is output from that scan; what follows it is
          // read only by jpeg_finish_decompress, after cv2 has the image
          if (!multi_scan_) return kOk;
        } else {
          p = next_marker(p, end);
        }
      }
    }
    if (!seen_sof || !seen_sos) return kCorrupt;
    return kOk;
  }

  // Output size at scale 1/denom (jdmaster.c jpeg_core_output_dimensions;
  // a lossless frame is never scaled).
  int out_width(int denom) const {
    return lossless_ ? width : ceil_div(width, denom);
  }
  int out_height(int denom) const {
    return lossless_ ? height : ceil_div(height, denom);
  }

  // After read(decode = true): the RGB image at scale 1/denom, one row at a
  // time, as `sink(y, row)` with row (out_width, 3); (out_width,
  // components) of raw samples for kRaw.
  template <class Sink>
  void output(int denom, Sink&& sink) const {
    if (lossless_) denom = 1;
    const int smin = lossless_ ? 1 : 8 / denom;
    const int ow = out_width(denom), oh = out_height(denom);
    int8_t latch[4][10], prev_latch[4][10];
    const bool smooth = smoothing_ok(latch, prev_latch);
    Plane pl[4];
    for (int c = 0; c < ncomp_; ++c) {
      const Component& cp = comp_[c];
      Plane& P = pl[c];
      if (lossless_) {  // samples << Pt, upsampled by replication
        P.dw = ceil_div(int64_t{width} * cp.h, hmax_);
        P.dh = ceil_div(int64_t{height} * cp.v, vmax_);
        P.stride = cp.bw;
        P.px.resize(static_cast<size_t>(cp.bw) * cp.bh);
        for (size_t i = 0; i < P.px.size(); ++i) {
          P.px[i] = static_cast<uint8_t>(cp.samples[i] << cp.pt);
        }
        P.hr = hmax_ / cp.h;
        P.vr = vmax_ / cp.v;
        continue;
      }
      int s = smin;  // jpeg_calc_output_dimensions' DCT size rule
      while (s < 8 && (hmax_ * smin) % (cp.h * s * 2) == 0 &&
             (vmax_ * smin) % (cp.v * s * 2) == 0) {
        s *= 2;
      }
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
        if (smooth) {
          smooth_row(cp, by, latch[c], prev_latch[c], idct, s, &P);
          continue;
        }
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
  int precision_ = 8;
  bool lossless_ = false, arith_ = false;
  bool multi_scan_ = false;  // jdinput.c has_multiple_scans
  int restart_interval_ = 0;
  int next_restart_ = 0;  // the RSTn expected next (jdmarker.c)
  int scans_ = 0;         // scans read (libjpeg's input_scan_number)
  int last_good_row_ = 0;  // jdcoefct.c last_good_iMCU_row
  Huffman dc_[4], ac_[4];
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  uint8_t dc_l_[16], dc_u_[16], ac_k_[16];  // DAC: L, U, Kx per table
  bool saw_jfif_ = false, saw_adobe_ = false, seen_exif_ = false;
  int adobe_transform_ = -1;
  int eobrun_ = 0;

  int refuse(int k) {
    kind = k;
    return kRefused;
  }

  // The body of the segment whose length bytes are at p (its length in
  // *len): in the data, or in `tail` where it runs past the data's end,
  // whose bytes are then the fake EOIs (FF D9 ...) the source gives there.
  static const uint8_t* segment(const uint8_t* data, size_t n,
                                const uint8_t* p, int* len,
                                std::vector<uint8_t>* tail) {
    const size_t at = static_cast<size_t>(p - data);
    auto byte = [&](size_t i) -> uint8_t {
      return i < n ? data[i] : ((i - n) & 1 ? 0xD9 : 0xFF);
    };
    *len = (byte(at) << 8) | byte(at + 1);
    if (at + std::max(*len, 2) <= n) return p + 2;
    tail->resize(static_cast<size_t>(std::max(*len - 2, 0)));
    for (size_t i = 0; i < tail->size(); ++i) (*tail)[i] = byte(at + 2 + i);
    return tail->data();
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

  // jdmarker.c get_sof and jdinput.c initial_setup's checks, and the 8-bit
  // API's precision (8, or 2-8 for a lossless frame, whose samples come
  // out unscaled).
  int read_sof(int m, const uint8_t* s, int n) {
    if (n < 6) return kCorrupt;
    progressive = m == 0xC2 || m == 0xCA;
    lossless_ = m == 0xC3 || m == 0xCB;
    arith_ = m >= 0xC9;
    precision_ = s[0];
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (width == 0 || height == 0 || ncomp_ == 0) return kCorrupt;
    if (n != 6 + 3 * ncomp_) return kCorrupt;
    if (m == 0xCB) return refuse(kArithLossless);
    if (lossless_ ? precision_ < 2 || precision_ > 8 : precision_ != 8) {
      return refuse(kPrecision);
    }
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4) return refuse(kComponents);
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
      std::memset(cp.prev_bits, 0, sizeof(cp.prev_bits));
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

  // At the first scan: jdapimin.c default_decompress_parms' colour space,
  // jdcolor.c's refusal of a lossless conversion, the MCU geometry.
  int check_frame(const Scan& first) {
    if (ncomp_ == 1) {
      colour = kGrey;
    } else if (ncomp_ == 3) {
      bool rgb = false;
      const bool rgb_ids =
          comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
      if (saw_jfif_) {
        rgb = false;
      } else if (saw_adobe_) {
        rgb = adobe_transform_ == 0;
      } else {
        // without markers a lossless frame is taken as RGB whatever its ids
        rgb = rgb_ids || lossless_;
      }
      colour = rgb ? kRGB : kYCbCr;
    } else {  // 4: an Adobe transform other than 0 is taken as YCCK
      colour = saw_adobe_ && adobe_transform_ != 0 ? kYCCK : kCMYK;
    }
    if (forced_colour >= 0) colour = forced_colour;
    if (lossless_ &&
        (colour == kGrey || colour == kYCbCr || colour == kYCCK)) {
      return refuse(kLosslessColour);
    }
    multi_scan_ = first.n < ncomp_ || progressive;
    const int unit = lossless_ ? 1 : 8;
    mcux_ = ceil_div(width, unit * hmax_);
    mcuy_ = ceil_div(height, unit * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      cp.bw = mcux_ * cp.h;
      cp.bh = mcuy_ * cp.v;
      cp.wib = ceil_div(ceil_div(int64_t{width} * cp.h, hmax_), unit);
      cp.hib = ceil_div(ceil_div(int64_t{height} * cp.v, vmax_), unit);
    }
    return kOk;
  }

  void allocate() {
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      const size_t n = static_cast<size_t>(cp.bw) * cp.bh;
      if (lossless_ && cp.samples.empty()) cp.samples.assign(n, 0);
      if (!lossless_ && cp.coef.empty()) cp.coef.assign(n * 64, 0);
    }
  }

  // jdmarker.c get_dht (a DC table's symbols are checked where a scan
  // uses it, as jpeg_make_d_derived_tbl checks them)
  bool read_dht(const uint8_t* s, int n) {
    int o = 0;
    while (o < n) {
      if (n - o < 17) return false;
      const int tc = s[o] >> 4, th = s[o] & 15;
      if (tc > 1 || th > 3) return false;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[o + 1 + i];
      if (total > 256 || n - o < 17 + total) return false;
      Huffman& t = tc ? ac_[th] : dc_[th];
      if (!t.build(s + o + 1, s + o + 17)) return false;
      o += 17 + total;
    }
    return true;
  }

  // libjpeg-turbo's jdmarker.c get_dqt: any precision nibble but 0 is
  // 16-bit; a table is always read whole, so one the segment cuts short
  // leaves its length negative (JERR_BAD_LENGTH)
  bool read_dqt(const uint8_t* s, int n) {
    int o = 0, length = n;
    while (length > 0) {
      --length;
      const int pq = s[o] >> 4, tq = s[o] & 15;
      ++o;
      if (tq > 3 || length < (pq ? 128 : 64)) return false;
      uint16_t* q = qt_[tq];
      for (int k = 0; k < 64; ++k) {
        q[kNatural[k]] = pq ? static_cast<uint16_t>((s[o] << 8) | s[o + 1])
                            : s[o];
        o += pq ? 2 : 1;
      }
      length -= pq ? 128 : 64;
      qt_defined_[tq] = true;
    }
    return length == 0;
  }

  // jdmarker.c get_dac
  bool read_dac(const uint8_t* s, int n) {
    int o = 0;
    for (; n - o >= 2; o += 2) {
      const int index = s[o], val = s[o + 1];
      if (index >= 32) return false;
      if (index >= 16) {
        ac_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_l_[index] = static_cast<uint8_t>(val & 15);
        dc_u_[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l_[index] > dc_u_[index]) return false;
      }
    }
    return o == n;
  }

  // jdmarker.c get_sos, and the checks each entropy decoder's start_pass
  // makes of the scan's parameters
  bool read_sos(const uint8_t* s, int n, Scan* scan) {
    if (n < 1) return false;
    scan->n = s[0];
    if (scan->n < 1 || scan->n > 4 || n != 4 + 2 * scan->n) return false;
    for (int i = 0; i < scan->n; ++i) {
      const int id = s[1 + 2 * i];
      int c = 0;
      while (c < ncomp_ && comp_[c].id != id) ++c;
      if (c == ncomp_) return false;
      for (int j = 0; j < i; ++j) {  // a component twice: JERR_BAD_COMPONENT_ID
        if (scan->comps[j] == c) return false;
      }
      scan->comps[i] = c;
      comp_[c].td = s[2 + 2 * i] >> 4;
      comp_[c].ta = s[2 + 2 * i] & 15;
    }
    const uint8_t* t = s + 1 + 2 * scan->n;
    scan->ss = t[0];
    scan->se = t[1];
    scan->ah = t[2] >> 4;
    scan->al = t[2] & 15;
    ++scans_;
    next_restart_ = 0;
    if (lossless_) {  // jdlossls.c: psv 1-7, Se 0, Ah 0, Pt < P
      if (scan->ss < 1 || scan->ss > 7 || scan->se != 0 || scan->ah != 0 ||
          scan->al >= precision_) {
        return false;
      }
      return true;  // no quantisation tables
    }
    if (progressive) {
      if (scan->ss == 0 ? scan->se != 0
                        : (scan->se < scan->ss || scan->se > 63 ||
                           scan->n != 1)) {
        return false;
      }
      if (scan->ah != 0 && scan->al != scan->ah - 1) return false;
      if (scan->al > 13) return false;
      for (int i = 0; i < scan->n; ++i) {
        Component& cp = comp_[scan->comps[i]];
        for (int k = std::min(scan->ss, 1); k <= std::max(scan->se, 9); ++k) {
          cp.prev_bits[k] = scans_ > 1 ? cp.coef_bits[k] : 0;
        }
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

  // A table the file did not define: libjpeg-turbo's standard one
  // (jstdhuff.c) for indices 0 and 1 in a sequential file (its
  // jinit_huff_decoder installs them for Motion-JPEG; the progressive
  // decoder does not: JERR_NO_HUFF_TABLE). `dc_max`: the largest DC
  // category jpeg_make_d_derived_tbl allows (0: an AC table).
  bool table(Huffman* set, int i, bool ac, int dc_max) {
    if (i > 3) return false;
    if (!set[i].defined) {
      if (i > 1 || progressive) return false;
      if (!(ac ? set[i].build(kStdAcBits[i], kStdAcVals[i])
               : set[i].build(kStdDcBits[i], kStdDcVals))) {
        return false;
      }
    }
    return ac || set[i].maxval <= dc_max;
  }

  static int16_t* block(Component& cp, int bx, int by) {
    return &cp.coef[(static_cast<size_t>(by) * cp.bw + bx) * 64];
  }

  // The iMCU row (jdcoefct.c input_iMCU_row) of MCU m of a scan.
  int imcu_row(const Scan& sc, int64_t m) const {
    if (sc.n > 1) return static_cast<int>(m / mcux_);
    const Component& cp = comp_[sc.comps[0]];
    return static_cast<int>(m / cp.wib / cp.v);
  }

  int decode_scan(const Scan& sc, const uint8_t** p, const uint8_t* end) {
    allocate();
    if (lossless_) return decode_lossless(sc, p, end);
    if (arith_) return decode_arith(sc, p, end);
    return decode_huffman(sc, p, end);
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart: past the
  // expected RSTn (at_marker cleared), or left at the marker where it is
  // one of the next two or not a restart at all.
  void read_restart_marker(const uint8_t** p, const uint8_t* end,
                           bool* at_marker) {
    if (!*at_marker) {
      *p = next_marker(*p, end);
      *at_marker = true;
    }
    const uint8_t* after;
    int m = marker_code(*p, end, &after);
    const int want = next_restart_;
    next_restart_ = (next_restart_ + 1) & 7;
    if (m == 0xD0 + want) {
      *p = after;
      *at_marker = false;
      return;
    }
    for (;;) {
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((want + 1) & 7) ||
                 m == 0xD0 + ((want + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((want - 1) & 7) ||
                 m == 0xD0 + ((want - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {  // taken as the one expected
        *p = after;
        *at_marker = false;
        return;
      }
      if (action == 3) return;
      *p = next_marker(after, end);  // skip it and look at the next
      m = marker_code(*p, end, &after);
    }
  }

  // Huffman scans (jdhuff.c decode_mcu, jdphuff.c decode_mcu_*).
  int decode_huffman(const Scan& sc, const uint8_t** p, const uint8_t* end) {
    for (int i = 0; i < sc.n; ++i) {
      Component& cp = comp_[sc.comps[i]];
      const bool dc = !progressive || (sc.ss == 0 && sc.ah == 0);
      const bool ac = !progressive || sc.ss > 0;
      if ((dc && !table(dc_, cp.td, false, 15)) ||
          (ac && !table(ac_, cp.ta, true, 0))) {
        return kCorrupt;
      }
      cp.dc_pred = 0;
    }
    eobrun_ = 0;
    Bits bits{*p, end};
    const bool single = sc.n == 1;
    Component& c0 = comp_[sc.comps[0]];
    const int64_t mcus = single ? int64_t{c0.wib} * c0.hib
                                : int64_t{mcux_} * mcuy_;
    const int per_row = single ? c0.wib : mcux_;
    int restarts_left = restart_interval_;
    for (int64_t m = 0; m < mcus; ++m) {
      if (!bits.insufficient) last_good_row_ = imcu_row(sc, m);
      if (restart_interval_ && restarts_left == 0) {  // process_restart
        bits.discard();
        read_restart_marker(&bits.p, end, &bits.at_marker);
        for (int i = 0; i < sc.n; ++i) comp_[sc.comps[i]].dc_pred = 0;
        eobrun_ = 0;
        restarts_left = restart_interval_;
        if (!bits.at_marker) bits.insufficient = false;
      }
      if (restart_interval_) --restarts_left;
      if (bits.insufficient) continue;  // the segment's data ran out
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
    *p = bits.at_marker ? bits.p : next_marker(bits.p, end);
    return kOk;
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


  // Arithmetic-coded scans (jdarith.c). Statistics areas are per table.
  struct ArithState {
    uint8_t dc[16][64];
    uint8_t ac[16][256];
    uint8_t fixed[4] = {113, 0, 0, 0};
    int last_dc[4] = {}, dc_context[4] = {};
  };

  int decode_arith(const Scan& sc, const uint8_t** p, const uint8_t* end) {
    const bool dc_stats = !progressive || (sc.ss == 0 && sc.ah == 0);
    const bool ac_stats = !progressive || sc.ss > 0;
    for (int i = 0; i < sc.n; ++i) {
      const Component& cp = comp_[sc.comps[i]];
      if ((dc_stats && cp.td > 15) || (ac_stats && cp.ta > 15)) {
        return kCorrupt;  // JERR_NO_ARITH_TABLE
      }
    }
    std::unique_ptr<ArithState> st(new ArithState());
    auto reset = [&]() {  // start_pass / process_restart
      for (int i = 0; i < sc.n; ++i) {
        const Component& cp = comp_[sc.comps[i]];
        if (dc_stats) {
          std::memset(st->dc[cp.td], 0, 64);
          st->last_dc[i] = 0;
          st->dc_context[i] = 0;
        }
        if (ac_stats) std::memset(st->ac[cp.ta], 0, 256);
      }
    };
    reset();
    Arith ar{*p, end};
    const bool single = sc.n == 1;
    Component& c0 = comp_[sc.comps[0]];
    const int64_t mcus = single ? int64_t{c0.wib} * c0.hib
                                : int64_t{mcux_} * mcuy_;
    const int per_row = single ? c0.wib : mcux_;
    int restarts_left = restart_interval_;
    for (int64_t m = 0; m < mcus; ++m) {
      last_good_row_ = imcu_row(sc, m);  // never short of data
      if (restart_interval_) {
        if (restarts_left == 0) {
          read_restart_marker(&ar.p, end, &ar.at_marker);
          reset();
          ar.c = 0;
          ar.a = 0;
          ar.ct = -16;
          restarts_left = restart_interval_;
        }
        --restarts_left;
      }
      const bool dc_refine = progressive && sc.ss == 0 && sc.ah != 0;
      if (ar.ct == -1 && !dc_refine) continue;  // an error: do nothing
      const int mx = static_cast<int>(m % per_row);
      const int my = static_cast<int>(m / per_row);
      bool stop = false;
      for (int i = 0; i < sc.n && !stop; ++i) {
        Component& cp = comp_[sc.comps[i]];
        const int bh = single ? 1 : cp.v, bw = single ? 1 : cp.h;
        for (int v = 0; v < bh && !stop; ++v) {
          for (int h = 0; h < bw && !stop; ++h) {
            int16_t* blk = single ? block(cp, mx, my)
                                  : block(cp, mx * cp.h + h, my * cp.v + v);
            stop = !arith_block(sc, i, cp, blk, &ar, st.get());
          }
        }
      }
    }
    *p = ar.at_marker ? ar.p : next_marker(ar.p, end);
    return kOk;
  }

  // One block's coefficients of an arithmetic scan; false once the scan's
  // error (ct -1: a magnitude or spectral overflow) stops the MCU.
  bool arith_block(const Scan& sc, int i, const Component& cp, int16_t* blk,
                   Arith* ar, ArithState* st) {
    if (progressive && sc.ss == 0 && sc.ah != 0) {  // decode_mcu_DC_refine
      if (ar->decode(st->fixed)) blk[0] = static_cast<int16_t>(blk[0] |
                                                               (1 << sc.al));
      return true;
    }
    const bool dc = !progressive || sc.ss == 0;
    const bool ac = !progressive || sc.ss > 0;
    if (dc) {  // decode_mcu / decode_mcu_DC_first
      const int tbl = cp.td;
      uint8_t* s = st->dc[tbl] + st->dc_context[i];
      if (ar->decode(s) == 0) {
        st->dc_context[i] = 0;
      } else {
        const int sign = ar->decode(s + 1);
        s += 2 + sign;
        int m = ar->decode(s);
        if (m != 0) {
          s = st->dc[tbl] + 20;
          while (ar->decode(s)) {
            if ((m <<= 1) == 0x8000) {
              ar->ct = -1;
              return false;
            }
            s += 1;
          }
        }
        if (m < ((1 << dc_l_[tbl]) >> 1)) {
          st->dc_context[i] = 0;
        } else if (m > ((1 << dc_u_[tbl]) >> 1)) {
          st->dc_context[i] = 12 + sign * 4;
        } else {
          st->dc_context[i] = 4 + sign * 4;
        }
        int v = m;
        s += 14;
        while (m >>= 1) {
          if (ar->decode(s)) v |= m;
        }
        v += 1;
        if (sign) v = -v;
        st->last_dc[i] = (st->last_dc[i] + v) & 0xffff;
      }
      blk[0] = static_cast<int16_t>(progressive
                                        ? st->last_dc[i] * (1 << sc.al)
                                        : st->last_dc[i]);
    }
    if (!ac) return true;
    const int tbl = cp.ta;
    const int ss = progressive ? sc.ss : 1, se = progressive ? sc.se : 63;
    const int al = progressive ? sc.al : 0;
    if (progressive && sc.ah != 0) {  // decode_mcu_AC_refine
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      int kex = se;
      for (; kex > 0; --kex) {
        if (blk[kNatural[kex]]) break;
      }
      for (int k = ss; k <= se; ++k) {
        uint8_t* s = st->ac[tbl] + 3 * (k - 1);
        if (k > kex && ar->decode(s)) break;  // EOB
        for (;;) {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {  // previously nonzero
            if (ar->decode(s + 2)) {
              *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
            }
            break;
          }
          if (ar->decode(s + 1)) {  // newly nonzero
            *coef = static_cast<int16_t>(ar->decode(st->fixed) ? m1 : p1);
            break;
          }
          s += 3;
          if (++k > se) {
            ar->ct = -1;
            return false;
          }
        }
      }
      return true;
    }
    // decode_mcu's AC part / decode_mcu_AC_first
    for (int k = ss; k <= se; ++k) {
      uint8_t* s = st->ac[tbl] + 3 * (k - 1);
      if (ar->decode(s)) break;  // EOB
      while (ar->decode(s + 1) == 0) {
        s += 3;
        if (++k > se) {
          ar->ct = -1;
          return false;
        }
      }
      const int sign = ar->decode(st->fixed);
      s += 2;
      int m = ar->decode(s);
      if (m != 0 && ar->decode(s)) {
        m <<= 1;
        s = st->ac[tbl] + (k <= ac_k_[tbl] ? 189 : 217);
        while (ar->decode(s)) {
          if ((m <<= 1) == 0x8000) {
            ar->ct = -1;
            return false;
          }
          s += 1;
        }
      }
      int v = m;
      s += 14;
      while (m >>= 1) {
        if (ar->decode(s)) v |= m;
      }
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(
          static_cast<int>(static_cast<unsigned>(v) << al));
    }
    return true;
  }

  // Lossless scans: jddiffct.c decompress_data over jdlhuff.c decode_mcus,
  // then jdlossls.c's undifferencing of each row.
  int decode_lossless(const Scan& sc, const uint8_t** p, const uint8_t* end) {
    for (int i = 0; i < sc.n; ++i) {
      if (!table(dc_, comp_[sc.comps[i]].td, false, 16)) return kCorrupt;
    }
    const bool single = sc.n == 1;
    Component& c0 = comp_[sc.comps[0]];
    const int per_row = single ? c0.wib : mcux_;
    if (restart_interval_ % per_row) return kCorrupt;  // JERR_BAD_RESTART
    const int restart_rows = restart_interval_ / per_row;
    Bits bits{*p, end};
    // one iMCU row of differences per component: v rows of bw samples
    std::vector<int> diff[4];
    for (int i = 0; i < sc.n; ++i) {
      Component& cp = comp_[sc.comps[i]];
      diff[i].assign(static_cast<size_t>(cp.v) * cp.bw, 0);
      cp.pt = sc.al;
    }
    bool first_row[4];  // predict_undifference[ci] is the first-row one
    auto start_pass = [&]() {
      for (int i = 0; i < 4; ++i) first_row[i] = true;
    };
    start_pass();
    int rows_left = restart_rows;
    const int initial = 1 << (precision_ - sc.al - 1);
    for (int r = 0; r < mcuy_; ++r) {
      const bool last = r == mcuy_ - 1;
      const int mcu_rows =
          !single ? 1
                  : (!last ? c0.v : (c0.hib % c0.v ? c0.hib % c0.v : c0.v));
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval_) {
          if (rows_left == 0) {  // process_restart
            bits.discard();
            read_restart_marker(&bits.p, end, &bits.at_marker);
            if (!bits.at_marker) bits.insufficient = false;
            start_pass();
            rows_left = restart_rows;
          }
        }
        if (bits.insufficient) {  // zero differences, the predictor reset
          for (int i = 0; i < sc.n; ++i) {
            const Component& cp = comp_[sc.comps[i]];
            const int rows = single ? 1 : cp.v;
            for (int k = 0; k < rows; ++k) {
              std::fill_n(&diff[i][static_cast<size_t>(y + k) * cp.bw],
                          single ? cp.wib : cp.bw, 0);
            }
          }
          start_pass();
        } else {
          for (int mx = 0; mx < per_row; ++mx) {
            for (int i = 0; i < sc.n; ++i) {
              const Component& cp = comp_[sc.comps[i]];
              const int bh = single ? 1 : cp.v, bw = single ? 1 : cp.h;
              for (int v = 0; v < bh; ++v) {
                for (int h = 0; h < bw; ++h) {
                  int s = bits.decode(dc_[cp.td]);
                  if (s == 16) {
                    s = 32768;
                  } else if (s) {
                    s = extend(bits.get(s), s);
                  }
                  const int row = single ? y : v;
                  const int col = single ? mx : mx * cp.h + h;
                  diff[i][static_cast<size_t>(row) * cp.bw + col] = s;
                }
              }
            }
          }
        }
        if (restart_interval_) --rows_left;
      }
      // undifference each component's rows of this iMCU row
      for (int i = 0; i < sc.n; ++i) {
        Component& cp = comp_[sc.comps[i]];
        const int rows =
            !last ? cp.v : (cp.hib % cp.v ? cp.hib % cp.v : cp.v);
        for (int y = 0; y < rows; ++y) {
          const int gy = r * cp.v + y;
          undifference(sc.ss, &diff[i][static_cast<size_t>(y) * cp.bw],
                       gy ? &cp.samples[static_cast<size_t>(gy - 1) * cp.bw]
                          : nullptr,
                       &cp.samples[static_cast<size_t>(gy) * cp.bw], cp.wib,
                       initial, &first_row[sc.comps[i]]);
        }
      }
    }
    *p = bits.at_marker ? bits.p : next_marker(bits.p, end);
    return kOk;
  }

  // jdlossls.c jpeg_undifference_first_row and jpeg_undifference1-7.
  static void undifference(int psv, const int* diff, const uint16_t* prev,
                           uint16_t* out, int width, int initial,
                           bool* first_row) {
    if (*first_row) {
      int ra = (diff[0] + initial) & 0xFFFF;
      out[0] = static_cast<uint16_t>(ra);
      for (int x = 1; x < width; ++x) {
        ra = (diff[x] + ra) & 0xFFFF;
        out[x] = static_cast<uint16_t>(ra);
      }
      *first_row = false;
      return;
    }
    int rb = prev[0];
    int ra = (diff[0] + rb) & 0xFFFF;
    out[0] = static_cast<uint16_t>(ra);
    for (int x = 1; x < width; ++x) {
      const int rc = rb;
      rb = prev[x];
      int pred;
      switch (psv) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;
      }
      ra = (diff[x] + pred) & 0xFFFF;
      out[x] = static_cast<uint16_t>(ra);
    }
  }

  // jdcoefct.c smoothing_ok: whether the progressive file is block-
  // smoothed, with each component's coefficient bits 0-9 latched from the
  // last scan and from the one before (prev_latch).
  bool smoothing_ok(int8_t latch[4][10], int8_t prev_latch[4][10]) const {
    if (!progressive) return false;
    bool useful = false;
    for (int c = 0; c < ncomp_; ++c) {
      const Component& cp = comp_[c];
      if (!cp.latched) return false;
      for (int k = 0; k < 10; ++k) {
        if (cp.q[kSmoothPos[k]] == 0) return false;
      }
      if (cp.coef_bits[0] < 0) return false;
      latch[c][0] = cp.coef_bits[0];
      for (int k = 1; k < 10; ++k) {
        prev_latch[c][k] = scans_ > 1 ? cp.prev_bits[k] : -1;
        latch[c][k] = cp.coef_bits[k];
        if (cp.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data for block row `by` of component cp:
  // each block's first AC coefficients (and, where no AC is known, its DC)
  // estimated from the DC values around it, then its IDCT into P.
  template <class Idct>
  void smooth_row(const Component& cp, int by, const int8_t* latch,
                  const int8_t* prev_latch, Idct idct, int s,
                  Plane* P) const {
    const int total = mcuy_;
    const int r = by / cp.v;  // the output iMCU row
    const int last = total - 1;
    const int block_rows =
        r < last ? cp.v : (cp.hib % cp.v ? cp.hib % cp.v : cp.v);
    const int br = by - r * cp.v;
    const int ibr = r * block_rows + br;  // libjpeg's image_block_row
    const int ibrs = block_rows * total;
    const int8_t* bits = r > last_good_row_ ? prev_latch : latch;
    // bits[0] of the previous-scan latch is never set: only 1-9 are read
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    const uint16_t* q = cp.q;
    const int64_t q00 = q[0], q01 = q[1], q10 = q[8], q20 = q[16],
                  q11 = q[9], q02 = q[2], q03 = q[3], q12 = q[10],
                  q21 = q[17], q30 = q[24];
    auto row_of = [&](int y) {
      return &cp.coef[static_cast<size_t>(y) * cp.bw * 64];
    };
    const int16_t* cur = row_of(by);
    const int16_t* prev = ibr > 0 ? row_of(by - 1) : cur;
    const int16_t* pprev = ibr > 1 ? row_of(by - 2) : prev;
    const int16_t* next = ibr < ibrs - 1 ? row_of(by + 1) : cur;
    const int16_t* nnext = ibr < ibrs - 2 ? row_of(by + 2) : next;
    const int16_t* rows[5] = {pprev, prev, cur, next, nnext};
    int dc[5][5];  // rows -2..2 x the sliding columns -2..2
    for (int y = 0; y < 5; ++y) {
      for (int x = 0; x < 5; ++x) dc[y][x] = rows[y][0];
    }
    const int last_col = cp.wib - 1;
    auto predict = [](int64_t num, int64_t qk, int al) {
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return static_cast<int16_t>(pred);
    };
    int16_t ws[64];
    for (int bx = 0; bx <= last_col; ++bx) {
      std::memcpy(ws, cur + static_cast<size_t>(bx) * 64, sizeof(ws));
      if (bx == 0 && bx < last_col) {
        for (int y = 0; y < 5; ++y) dc[y][3] = dc[y][4] = rows[y][64];
      }
      if (bx + 1 < last_col) {
        for (int y = 0; y < 5; ++y) {
          dc[y][4] = rows[y][static_cast<size_t>(bx + 2) * 64];
        }
      }
      // DCnn of libjpeg: row (nn - 1) / 5, column (nn - 1) % 5
#define DC(nn) static_cast<int64_t>(dc[((nn) - 1) / 5][((nn) - 1) % 5])
      int al;
      if ((al = bits[1]) != 0 && ws[1] == 0) {
        const int64_t num = q00 * (change_dc
            ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
               13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) -
               38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
               13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25))
            : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
        ws[1] = predict(num, q01, al);
      }
      if ((al = bits[2]) != 0 && ws[8] == 0) {
        const int64_t num = q00 * (change_dc
            ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) +
               13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) -
               13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
               3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25))
            : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
        ws[8] = predict(num, q10, al);
      }
      if ((al = bits[3]) != 0 && ws[16] == 0) {
        const int64_t num = q00 * (change_dc
            ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
               14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) +
               2 * DC(19) + DC(23))
            : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
        ws[16] = predict(num, q20, al);
      }
      if ((al = bits[4]) != 0 && ws[9] == 0) {
        const int64_t num = q00 * (change_dc
            ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
               9 * DC(19) + DC(21) - DC(25))
            : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) -
               DC(20) + DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) -
               10 * DC(9)));
        ws[9] = predict(num, q11, al);
      }
      if ((al = bits[5]) != 0 && ws[2] == 0) {
        const int64_t num = q00 * (change_dc
            ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
               14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) +
               2 * DC(19))
            : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) -
               DC(15)));
        ws[2] = predict(num, q02, al);
      }
      if (change_dc) {
        if ((al = bits[6]) != 0 && ws[3] == 0) {
          const int64_t num = q00 * (DC(7) - DC(9) + 2 * DC(12) -
                                     2 * DC(14) + DC(17) - DC(19));
          ws[3] = predict(num, q03, al);
        }
        if ((al = bits[7]) != 0 && ws[10] == 0) {
          const int64_t num = q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) +
                                     3 * DC(18) - DC(19));
          ws[10] = predict(num, q12, al);
        }
        if ((al = bits[8]) != 0 && ws[17] == 0) {
          const int64_t num = q00 * (DC(7) - DC(9) - 3 * DC(12) +
                                     3 * DC(14) + DC(17) - DC(19));
          ws[17] = predict(num, q21, al);
        }
        if ((al = bits[9]) != 0 && ws[24] == 0) {
          const int64_t num = q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) -
                                     2 * DC(18) - DC(19));
          ws[24] = predict(num, q30, al);
        }
        // the DC itself, through a Gaussian-like kernel
        const int64_t num = q00 * (
            -2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) -
            6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) -
            8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14) -
            8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) +
            6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) - 8 * DC(23) -
            6 * DC(24) - 2 * DC(25));
        ws[0] = predict(num, q00, 0);
      }
#undef DC
      idct(ws, q, &P->px[static_cast<size_t>(by) * s * P->stride + bx * s],
           P->stride);
      for (int y = 0; y < 5; ++y) {
        for (int x = 0; x < 4; ++x) dc[y][x] = dc[y][x + 1];
      }
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
