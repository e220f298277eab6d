// Pixel operations of the host augmentation (data/augment.py,
// data/autoaugment.py), each bit-equal to the cv2 5.0.0 call it replaces on
// 8-bit 3-channel images. Included by loader_core.cpp, which exports them.
//
// cv2 5.0.0 computes these in float32 with fused multiply-adds, and its
// vector loops and their scalar tails round differently, so each function
// below keeps cv2's split of a row into vector blocks and a tail:
//   - warpAffine / warpPerspective, INTER_LINEAR, BORDER_CONSTANT: the
//     inverse map in double, rounded to float; in blocks of 16 pixels the
//     source x is fma(M0, x, y*M1 + M2), in the tail fma(x, M0, y*M1) + M2
//     (the perspective divides X and Y by W, each formed the same way);
//     the bilinear blend is three fmas, rounded half to even;
//   - cvtColor BGR2HSV: OpenCV's 12-bit integer tables (exact everywhere);
//   - cvtColor HSV2BGR: float sectors, the interpolated channel through
//     fma(-s, h, 1); blocks of 32 pixels truncate, the tail rounds;
//   - cvtColor BGR2GRAY: 15-bit fixed point (9798, 19235, 3735);
//   - filter2D with an integer kernel over an odd divisor (op_sharpness's
//     [[1,1,1],[1,5,1],[1,1,1]] / 13), BORDER_REFLECT_101: cv2 sums in
//     float, but a sum of k/13 is never within float error of a half, so
//     the exact integer rounding equals it.
// The held cases are tests/test_torch_host_augment.py's.
//
// Images are (h, w, 3) rows `stride` bytes apart. `blue` is the channel of
// blue: 0 for cv2's BGR, 2 for the port's RGB (cv2's formula applied to the
// channels reversed).

#pragma once

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

#if defined(__x86_64__) && defined(__GNUC__)
// One clone with hardware FMA, one that calls libm's fmaf: same results.
#define ET_FMA_CLONES __attribute__((target_clones("fma", "default")))
#else
#define ET_FMA_CLONES
#endif

namespace etpix {

inline uint8_t sat_u8(float v) {
  return static_cast<uint8_t>(v <= 0.f ? 0 : v >= 255.f ? 255 : v);
}

// cv2's invertAffineTransform inside warpAffine (double).
inline void invert_affine(const double* m, double* out) {
  double d = m[0] * m[4] - m[1] * m[3];
  d = d != 0 ? 1.0 / d : 0.0;
  const double a11 = m[4] * d, a22 = m[0] * d;
  const double a12 = m[1] * -d, a21 = m[3] * -d;
  out[0] = a11;
  out[1] = a12;
  out[3] = a21;
  out[4] = a22;
  out[2] = -a11 * m[2] - a12 * m[5];
  out[5] = -a21 * m[2] - a22 * m[5];
  out[6] = 0.0;
  out[7] = 0.0;
  out[8] = 1.0;
}

// cv2::invert of a 3x3 (DECOMP_LU takes this closed form for n = 3).
inline bool invert3(const double* s, double* t) {
  auto S = [&](int i, int j) { return s[i * 3 + j]; };
  double d = S(0, 0) * (S(1, 1) * S(2, 2) - S(1, 2) * S(2, 1)) -
             S(0, 1) * (S(1, 0) * S(2, 2) - S(1, 2) * S(2, 0)) +
             S(0, 2) * (S(1, 0) * S(2, 1) - S(1, 1) * S(2, 0));
  if (d == 0.0) return false;
  d = 1.0 / d;
  t[0] = (S(1, 1) * S(2, 2) - S(1, 2) * S(2, 1)) * d;
  t[1] = (S(0, 2) * S(2, 1) - S(0, 1) * S(2, 2)) * d;
  t[2] = (S(0, 1) * S(1, 2) - S(0, 2) * S(1, 1)) * d;
  t[3] = (S(1, 2) * S(2, 0) - S(1, 0) * S(2, 2)) * d;
  t[4] = (S(0, 0) * S(2, 2) - S(0, 2) * S(2, 0)) * d;
  t[5] = (S(0, 2) * S(1, 0) - S(0, 0) * S(1, 2)) * d;
  t[6] = (S(1, 0) * S(2, 1) - S(1, 1) * S(2, 0)) * d;
  t[7] = (S(0, 1) * S(2, 0) - S(0, 0) * S(2, 1)) * d;
  t[8] = (S(0, 0) * S(1, 1) - S(0, 1) * S(1, 0)) * d;
  return true;
}

// One output pixel of warp_linear at source (sx, sy).
inline void warp_pixel(const uint8_t* src, int sw, int sh, size_t sstride,
                       float sx, float sy, const uint8_t* bval, uint8_t* o) {
  // beyond int range or NaN: every tap is outside
  if (!(sx > -2.f && sx < static_cast<float>(sw) + 1.f && sy > -2.f &&
        sy < static_cast<float>(sh) + 1.f)) {
    o[0] = bval[0];
    o[1] = bval[1];
    o[2] = bval[2];
    return;
  }
  const float fx0 = std::floor(sx), fy0 = std::floor(sy);
  const int ix = static_cast<int>(fx0), iy = static_cast<int>(fy0);
  const float a = sx - fx0, b = sy - fy0;
  float p[4][3];
  if (ix >= 0 && iy >= 0 && ix + 1 < sw && iy + 1 < sh) {
    const uint8_t* r0 = src + static_cast<size_t>(iy) * sstride + ix * 3;
    const uint8_t* r1 = r0 + sstride;
    for (int c = 0; c < 3; ++c) {
      p[0][c] = r0[c];
      p[1][c] = r0[3 + c];
      p[2][c] = r1[c];
      p[3][c] = r1[3 + c];
    }
  } else {
    for (int t = 0; t < 4; ++t) {
      const int tx = ix + (t & 1), ty = iy + (t >> 1);
      const bool in = tx >= 0 && tx < sw && ty >= 0 && ty < sh;
      const uint8_t* q = in ? src + static_cast<size_t>(ty) * sstride + tx * 3
                            : bval;
      for (int c = 0; c < 3; ++c) p[t][c] = q[c];
    }
  }
  for (int c = 0; c < 3; ++c) {
    const float f0 = std::fma(a, p[1][c] - p[0][c], p[0][c]);
    const float f1 = std::fma(a, p[3][c] - p[2][c], p[2][c]);
    o[c] = sat_u8(std::nearbyint(std::fma(b, f1 - f0, f0)));
  }
}

// dst (dh, dw, 3) = src sampled at the inverse map `m` (float, 3x3
// row-major; the last row unused unless `persp`).
ET_FMA_CLONES
void warp_linear(const uint8_t* src, int sw, int sh, size_t sstride,
                 uint8_t* dst, int dw, int dh, size_t dstride, const float* m,
                 bool persp, const uint8_t* bval) {
  const int vend = dw - dw % 16;
  for (int y = 0; y < dh; ++y) {
    const float fy = static_cast<float>(y);
    const float y1 = fy * m[1], y4 = fy * m[4], y7 = fy * m[7];
    const float mx = y1 + m[2], my = y4 + m[5], mw = y7 + m[8];
    uint8_t* out = dst + static_cast<size_t>(y) * dstride;
    for (int x = 0; x < vend; ++x) {  // cv2's vector blocks
      const float fx = static_cast<float>(x);
      float sx = std::fma(m[0], fx, mx), sy = std::fma(m[3], fx, my);
      if (persp) {
        const float w = std::fma(m[6], fx, mw);
        sx /= w;
        sy /= w;
      }
      warp_pixel(src, sw, sh, sstride, sx, sy, bval, out + x * 3);
    }
    for (int x = vend; x < dw; ++x) {  // its scalar tail
      const float fx = static_cast<float>(x);
      float sx = std::fma(fx, m[0], y1) + m[2];
      float sy = std::fma(fx, m[3], y4) + m[5];
      if (persp) {
        const float w = std::fma(fx, m[6], y7) + m[8];
        sx /= w;
        sy /= w;
      }
      warp_pixel(src, sw, sh, sstride, sx, sy, bval, out + x * 3);
    }
  }
}

struct HsvTables {
  int sdiv[256];
  int hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = static_cast<int>(std::nearbyint((255 << 12) / (1.0 * i)));
      hdiv[i] = static_cast<int>(std::nearbyint((180 << 12) / (6.0 * i)));
    }
  }
};

// cvtColor BGR2HSV (H in [0, 180)) of one pixel.
inline void bgr2hsv(int b, int g, int r, const HsvTables& t, int* h, int* s,
                    int* v) {
  int vmax = std::max(std::max(b, g), r);
  const int vmin = std::min(std::min(b, g), r);
  const int diff = vmax - vmin;
  const int vr = vmax == r ? -1 : 0, vg = vmax == g ? -1 : 0;
  *s = (diff * t.sdiv[vmax] + (1 << 11)) >> 12;
  int hh = (vr & (g - b)) +
           (~vr & ((vg & (b - r + 2 * diff)) + (~vg & (r - g + 4 * diff))));
  hh = (hh * t.hdiv[diff] + (1 << 11)) >> 12;
  hh += hh < 0 ? 180 : 0;
  *h = std::min(std::max(hh, 0), 255);
  *v = vmax;
}

// cvtColor HSV2BGR's per-value terms: for each hue its sector and
// fraction, for each saturation or value the float it scales to.
struct Hsv2BgrTerms {
  int sector[256];
  float frac[256], unit[256];
  Hsv2BgrTerms() {
    for (int i = 0; i < 256; ++i) {
      float h = static_cast<float>(i) * static_cast<float>(6.0 / 180.0);
      h = std::fmod(h, 6.f);
      int sec = static_cast<int>(std::floor(h));
      h -= static_cast<float>(sec);
      if (static_cast<unsigned>(sec) >= 6u) {
        sec = 0;
        h = 0.f;
      }
      sector[i] = sec;
      frac[i] = h;
      unit[i] = static_cast<float>(i) * (1.f / 255.f);
    }
  }
};

// cvtColor HSV2BGR of one pixel; `vec` is cv2's vector block (truncates,
// no grey special case), else its scalar tail (rounds).
inline void hsv2bgr(int hi, int si, int vi, bool vec, const Hsv2BgrTerms& t,
                    uint8_t* b, uint8_t* g, uint8_t* r) {
  static const int kSector[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                    {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float s = t.unit[si], v = t.unit[vi];
  float out[3];
  if (!vec && si == 0) {
    out[0] = out[1] = out[2] = v;
  } else {
    const float h = t.frac[hi];
    const int* sec = kSector[t.sector[hi]];
    const float tab[4] = {v, v * (1.f - s), v * std::fma(-s, h, 1.f),
                          v * std::fma(-s, 1.f - h, 1.f)};
    for (int k = 0; k < 3; ++k) out[k] = tab[sec[k]];
  }
  uint8_t* dst[3] = {b, g, r};
  for (int k = 0; k < 3; ++k) {
    const float x = out[k] * 255.f;
    *dst[k] = sat_u8(vec ? std::trunc(x) : std::nearbyint(x));
  }
}

// augment_hsv in place: BGR2HSV, the three LUTs, HSV2BGR (JAX
// data/augment.py:68-83).
ET_FMA_CLONES
void augment_hsv(uint8_t* img, int h, int w, size_t stride,
                 const uint8_t* lut_h, const uint8_t* lut_s,
                 const uint8_t* lut_v, int blue) {
  static const HsvTables tables;
  static const Hsv2BgrTerms terms;
  const int vend = w - w % 32;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = img + static_cast<size_t>(y) * stride;
    for (int x = 0; x < w; ++x) {
      uint8_t* p = row + x * 3;
      int hh, ss, vv;
      bgr2hsv(p[blue], p[1], p[2 - blue], tables, &hh, &ss, &vv);
      hsv2bgr(lut_h[hh], lut_s[ss], lut_v[vv], x < vend, terms, &p[blue],
              &p[1], &p[2 - blue]);
    }
  }
}

// cvtColor BGR2GRAY into out (h, w).
inline void bgr2gray(const uint8_t* img, int h, int w, size_t stride,
                     uint8_t* out, int blue) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = img + static_cast<size_t>(y) * stride;
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = row + x * 3;
      out[static_cast<size_t>(y) * w + x] = static_cast<uint8_t>(
          (p[2 - blue] * 9798 + p[1] * 19235 + p[blue] * 3735 + (1 << 14)) >>
          15);
    }
  }
}

// BORDER_REFLECT_101 index.
inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * n - 2 - i;
  return i;
}

// filter2D(img, -1, k / div) with an integer 3x3 kernel `k` and an odd
// divisor `div` > 0 (so no sum is a tie): per channel, rounded.
inline void filter3x3(const uint8_t* img, int h, int w, size_t stride,
                      const int* k, int div, uint8_t* out, size_t ostride) {
  std::vector<int> xs(static_cast<size_t>(w) + 2);
  for (int x = -1; x <= w; ++x) xs[x + 1] = reflect101(x, w);
  for (int y = 0; y < h; ++y) {
    const uint8_t* rows[3];
    for (int i = 0; i < 3; ++i) {
      rows[i] = img + static_cast<size_t>(reflect101(y + i - 1, h)) * stride;
    }
    uint8_t* o = out + static_cast<size_t>(y) * ostride;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        int n = 0;
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j < 3; ++j) {
            n += k[i * 3 + j] * rows[i][xs[x + j] * 3 + c];
          }
        }
        // round(n / div), half away from zero; never a tie for an odd div
        const int q = n >= 0 ? (2 * n + div) / (2 * div)
                             : -((-2 * n + div) / (2 * div));
        o[x * 3 + c] = static_cast<uint8_t>(q < 0 ? 0 : q > 255 ? 255 : q);
      }
    }
  }
}

}  // namespace etpix
