// Baseline JPEG writer of the host loader core, for test data: RGB in,
// JFIF YCbCr 4:2:0 out, with libjpeg's standard quantisation tables scaled
// as jcparam.c jpeg_quality_scaling scales them and the standard Huffman
// tables (jpeg_decode.h). The forward DCT is a plain float one, so the
// bytes differ from libjpeg's; any decoder reads the file. Included by
// loader_core.cpp only.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_decode.h"

namespace etjpeg {

// ITU T.81 K.1, natural order (jcparam.c std_luminance_quant_tbl, ...)
constexpr uint8_t kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

class Encoder {
 public:
  // `rgb` (h, w, 3) -> the bytes of a JPEG file at `quality` (1-100).
  std::vector<uint8_t> encode(const uint8_t* rgb, int w, int h,
                              int quality) {
    quality = std::min(std::max(quality, 1), 100);
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int t = 0; t < 2; ++t) {
      for (int k = 0; k < 64; ++k) {
        const long v = (long{kStdQuant[t][k]} * scale + 50) / 100;
        q_[t][k] = static_cast<int>(std::min(std::max(v, 1L), 255L));
      }
      build_codes(kStdDcBits[t], kStdDcVals, dc_[t]);
      build_codes(kStdAcBits[t], kStdAcVals[t], ac_[t]);
    }
    out_.clear();
    headers(w, h);
    // planes padded to whole 16 x 16 MCUs by repeating the edge pixels
    const int mw = (w + 15) / 16, mh = (h + 15) / 16;
    const int pw = mw * 16, ph = mh * 16;
    std::vector<float> Y(static_cast<size_t>(pw) * ph);
    std::vector<float> Cb(Y.size()), Cr(Y.size());
    for (int y = 0; y < ph; ++y) {
      const uint8_t* r = rgb + static_cast<size_t>(std::min(y, h - 1)) * w * 3;
      for (int x = 0; x < pw; ++x) {
        const uint8_t* px = r + std::min(x, w - 1) * 3;
        const float R = px[0], G = px[1], B = px[2];
        const size_t i = static_cast<size_t>(y) * pw + x;
        Y[i] = 0.299f * R + 0.587f * G + 0.114f * B - 128.f;
        Cb[i] = -0.168736f * R - 0.331264f * G + 0.5f * B;
        Cr[i] = 0.5f * R - 0.418688f * G - 0.081312f * B;
      }
    }
    int pred[3] = {0, 0, 0};
    float blk[64];
    for (int my = 0; my < mh; ++my) {
      for (int mx = 0; mx < mw; ++mx) {
        for (int b = 0; b < 4; ++b) {
          const int x0 = mx * 16 + (b & 1) * 8, y0 = my * 16 + (b >> 1) * 8;
          for (int i = 0; i < 64; ++i) {
            blk[i] = Y[static_cast<size_t>(y0 + i / 8) * pw + x0 + i % 8];
          }
          block(blk, 0, &pred[0]);
        }
        for (int c = 0; c < 2; ++c) {  // 2 x 2 means
          const std::vector<float>& P = c ? Cr : Cb;
          for (int i = 0; i < 64; ++i) {
            const size_t o = static_cast<size_t>(my * 16 + (i / 8) * 2) * pw +
                             mx * 16 + (i % 8) * 2;
            blk[i] = 0.25f * (P[o] + P[o + 1] + P[o + pw] + P[o + pw + 1]);
          }
          block(blk, 1, &pred[1 + c]);
        }
      }
    }
    put_bits(0x7F, 7);  // pad the last byte with ones
    out_.push_back(0xFF);
    out_.push_back(0xD9);
    return out_;
  }

 private:
  struct Code {
    uint16_t code[256];
    uint8_t len[256];
  };
  int q_[2][64];
  Code dc_[2], ac_[2];
  std::vector<uint8_t> out_;
  uint32_t acc_ = 0;
  int nacc_ = 0;

  static void build_codes(const uint8_t* bits, const uint8_t* vals, Code& c) {
    std::memset(c.len, 0, sizeof(c.len));
    int code = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        c.code[vals[p]] = static_cast<uint16_t>(code++);
        c.len[vals[p]] = static_cast<uint8_t>(l);
      }
      code <<= 1;
    }
  }

  void u8(int v) { out_.push_back(static_cast<uint8_t>(v)); }
  void u16(int v) {
    u8(v >> 8);
    u8(v & 0xFF);
  }

  void headers(int w, int h) {
    u16(0xFFD8);
    u16(0xFFE0);  // JFIF 1.01, no density
    u16(16);
    for (char ch : {'J', 'F', 'I', 'F', '\0'}) u8(ch);
    u8(1), u8(1), u8(0), u16(1), u16(1), u8(0), u8(0);
    for (int t = 0; t < 2; ++t) {
      u16(0xFFDB);
      u16(67);
      u8(t);
      for (int k = 0; k < 64; ++k) u8(q_[t][kNatural[k]]);
    }
    u16(0xFFC0);
    u16(17);
    u8(8), u16(h), u16(w), u8(3);
    u8(1), u8(0x22), u8(0);
    u8(2), u8(0x11), u8(1);
    u8(3), u8(0x11), u8(1);
    for (int t = 0; t < 2; ++t) {
      for (int ac = 0; ac < 2; ++ac) {
        const uint8_t* bits = ac ? kStdAcBits[t] : kStdDcBits[t];
        const uint8_t* vals = ac ? kStdAcVals[t] : kStdDcVals;
        int n = 0;
        for (int i = 0; i < 16; ++i) n += bits[i];
        u16(0xFFC4);
        u16(19 + n);
        u8((ac << 4) | t);
        for (int i = 0; i < 16; ++i) u8(bits[i]);
        for (int i = 0; i < n; ++i) u8(vals[i]);
      }
    }
    u16(0xFFDA);
    u16(12);
    u8(3);
    u8(1), u8(0x00), u8(2), u8(0x11), u8(3), u8(0x11);
    u8(0), u8(63), u8(0);
  }

  void put_bits(uint32_t v, int n) {
    acc_ = (acc_ << n) | (v & ((1u << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc_ >> (nacc_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);  // byte stuffing
      nacc_ -= 8;
    }
    acc_ &= (1u << nacc_) - 1;
  }

  static int magnitude(int v) {
    int a = v < 0 ? -v : v, s = 0;
    while (a) {
      a >>= 1;
      ++s;
    }
    return s;
  }

  void put_value(int v, int s) {
    if (s) put_bits(static_cast<uint32_t>(v < 0 ? v + (1 << s) - 1 : v), s);
  }

  // forward DCT (float, orthonormal as T.81 A.3.3), quantise, code
  void block(const float* px, int t, int* pred) {
    static const float* cosines = [] {
      static float c[64];
      for (int x = 0; x < 8; ++x) {
        for (int u = 0; u < 8; ++u) {
          c[x * 8 + u] = static_cast<float>(
              std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16) *
              (u ? 0.5 : 0.5 / std::sqrt(2.0)));
        }
      }
      return c;
    }();
    float tmp[64];
    for (int y = 0; y < 8; ++y) {
      for (int u = 0; u < 8; ++u) {
        float s = 0;
        for (int x = 0; x < 8; ++x) s += px[y * 8 + x] * cosines[x * 8 + u];
        tmp[y * 8 + u] = s;
      }
    }
    int zz[64];
    for (int k = 0; k < 64; ++k) {
      const int n = kNatural[k], v = n / 8, u = n % 8;
      float s = 0;
      for (int y = 0; y < 8; ++y) s += tmp[y * 8 + u] * cosines[y * 8 + v];
      // 11-bit DC differences and 10-bit AC values: the tables' range
      zz[k] = std::min(std::max(static_cast<int>(std::lround(s / q_[t][n])),
                                -1023), 1023);
    }
    const int diff = zz[0] - *pred;
    *pred = zz[0];
    const int ds = magnitude(diff);
    put_bits(dc_[t].code[ds], dc_[t].len[ds]);
    put_value(diff, ds);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      if (!zz[k]) {
        ++run;
        continue;
      }
      while (run > 15) {
        put_bits(ac_[t].code[0xF0], ac_[t].len[0xF0]);
        run -= 16;
      }
      const int s = magnitude(zz[k]);
      const int sym = (run << 4) | s;
      put_bits(ac_[t].code[sym], ac_[t].len[sym]);
      put_value(zz[k], s);
      run = 0;
    }
    if (run) put_bits(ac_[t].code[0], ac_[t].len[0]);
  }
};

}  // namespace etjpeg
