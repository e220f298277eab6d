// WebP writers for the host loader core. Not libwebp's encoders, whose
// output comes from heuristic searches that are not part of the format.
//
//   encode_vp8l  the lossless bitstream data/image_io.imwrite puts in a
//                `.webp` file (cv2.imwrite's default kind): subtract-green,
//                then the predictor transform with one mode per 16x16 tile
//                (the mode of the least absolute residual among the 14),
//                then the residuals as literals under one canonical prefix
//                code per channel (depths limited to 15 bits, the code
//                lengths coded with runs of zeros); no colour cache, no
//                LZ77. It reads back equal in any VP8L decoder.
//   encode_vp8   a lossy key frame at a quality 0-100 (cv2.imwrite's
//                IMWRITE_WEBP_QUALITY <= 100 kind; its quality scale is
//                this writer's own: the quantiser index is 127 * (100 -
//                quality) / 100): YUV 4:2:0, each macroblock's 16x16 luma
//                and its chroma predicted by the cheapest of DC, V, H and
//                TM, libwebp's forward DCT and WHT, rounding quantisation,
//                one token partition, the default coefficient
//                probabilities, the normal loop filter. What it decodes to
//                is what webp_decode.h (and libwebp) decodes.

#pragma once

#include <algorithm>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

#include "webp_decode.h"

namespace etwebp {

class BitWriter {
 public:
  void put(uint32_t v, int n) {  // n <= 32 bits, LSB first
    acc_ |= static_cast<uint64_t>(v) << used_;
    used_ += n;
    while (used_ >= 8) {
      out_.push_back(static_cast<uint8_t>(acc_));
      acc_ >>= 8;
      used_ -= 8;
    }
  }
  std::vector<uint8_t> finish() {
    if (used_ > 0) out_.push_back(static_cast<uint8_t>(acc_));
    acc_ = 0;
    used_ = 0;
    return std::move(out_);
  }

 private:
  std::vector<uint8_t> out_;
  uint64_t acc_ = 0;
  int used_ = 0;
};

// Code lengths (<= max_len) of a prefix code for `counts`: Huffman's,
// with the counts halved until the deepest code fits.
inline std::vector<int> code_lengths(std::vector<uint32_t> counts,
                                     int max_len) {
  const int n = static_cast<int>(counts.size());
  std::vector<int> len(n, 0);
  for (;;) {
    using Node = std::pair<uint64_t, int>;
    std::priority_queue<Node, std::vector<Node>, std::greater<Node>> heap;
    std::vector<int> parent;
    for (int s = 0; s < n; ++s) {
      if (counts[s]) {
        heap.push({counts[s], static_cast<int>(parent.size())});
        parent.push_back(-1);
      }
    }
    std::vector<int> leaf_of;  // node -> symbol for the leaves
    for (int s = 0; s < n; ++s) {
      if (counts[s]) leaf_of.push_back(s);
    }
    const int leaves = static_cast<int>(leaf_of.size());
    if (leaves <= 1) {
      for (int s : leaf_of) len[s] = 1;
      return len;
    }
    while (heap.size() > 1) {
      const Node a = heap.top();
      heap.pop();
      const Node b = heap.top();
      heap.pop();
      const int id = static_cast<int>(parent.size());
      parent.push_back(-1);
      parent[a.second] = id;
      parent[b.second] = id;
      heap.push({a.first + b.first, id});
    }
    int deepest = 0;
    for (int i = 0; i < leaves; ++i) {
      int d = 0;
      for (int p = i; parent[p] >= 0; p = parent[p]) ++d;
      len[leaf_of[i]] = d;
      deepest = std::max(deepest, d);
    }
    if (deepest <= max_len) return len;
    for (uint32_t& c : counts) {
      if (c) c = (c + 1) / 2;
    }
  }
}

// Canonical codes of `len`, bit-reversed for the LSB-first stream.
inline std::vector<uint32_t> canonical_codes(const std::vector<int>& len) {
  int count[16] = {0};
  for (int l : len) ++count[l];
  count[0] = 0;
  uint32_t next[16] = {0}, code = 0;
  for (int l = 1; l < 16; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  std::vector<uint32_t> out(len.size(), 0);
  for (size_t s = 0; s < len.size(); ++s) {
    const int l = len[s];
    if (!l) continue;
    uint32_t c = next[l]++, r = 0;
    for (int i = 0; i < l; ++i) r |= ((c >> i) & 1) << (l - 1 - i);
    out[s] = r;
  }
  return out;
}

// One prefix code: written to `bw`; returns its lengths and codes (a code
// of one symbol has length 0: no bits per symbol).
struct Code {
  std::vector<int> len;
  std::vector<uint32_t> bits;
  void emit(BitWriter* bw, int s) const {
    if (len[s]) bw->put(bits[s], len[s]);
  }
};

inline Code write_code(BitWriter* bw, const std::vector<uint32_t>& counts) {
  const int n = static_cast<int>(counts.size());
  Code c;
  int used = 0, first = 0;
  for (int s = n - 1; s >= 0; --s) {
    if (counts[s]) {
      ++used;
      first = s;
    }
  }
  if (used <= 1) {  // a simple code of one symbol (0 if none is used)
    bw->put(1, 1);
    bw->put(0, 1);
    if (first < 2) {
      bw->put(0, 1);
      bw->put(first, 1);
    } else {
      bw->put(1, 1);
      bw->put(first, 8);
    }
    c.len.assign(n, 0);
    c.bits.assign(n, 0);
    return c;
  }
  c.len = code_lengths(counts, kMaxCodeLength);
  c.bits = canonical_codes(c.len);
  // the lengths as code-length symbols: 0-15, 17 (3-10 zeros), 18 (11-138)
  std::vector<std::pair<int, int>> tokens;  // (symbol, extra)
  for (int s = 0; s < n;) {
    if (c.len[s] == 0) {
      int run = 1;
      while (s + run < n && c.len[s + run] == 0 && run < 138) ++run;
      if (run >= 11) {
        tokens.push_back({18, run - 11});
      } else if (run >= 3) {
        tokens.push_back({17, run - 3});
      } else {
        for (int k = 0; k < run; ++k) tokens.push_back({0, 0});
      }
      s += run;
    } else {
      tokens.push_back({c.len[s], 0});
      ++s;
    }
  }
  std::vector<uint32_t> cl_counts(19, 0);
  for (const auto& t : tokens) ++cl_counts[t.first];
  std::vector<int> cl_len = code_lengths(cl_counts, 7);
  int cl_used = 0;
  for (int l : cl_len) cl_used += l > 0;
  const std::vector<uint32_t> cl_bits = canonical_codes(cl_len);
  int num = 19;
  while (num > 4 && cl_len[kCodeLengthOrder[num - 1]] == 0) --num;
  bw->put(0, 1);  // not simple
  bw->put(num - 4, 4);
  for (int i = 0; i < num; ++i) bw->put(cl_len[kCodeLengthOrder[i]], 3);
  bw->put(0, 1);  // the lengths run to the alphabet's end
  for (const auto& t : tokens) {
    if (cl_used > 1) bw->put(cl_bits[t.first], cl_len[t.first]);
    if (t.first == 17) bw->put(t.second, 3);
    if (t.first == 18) bw->put(t.second, 7);
  }
  return c;
}

// An image's colour-cache bit, meta bit (level 0), its five codes and its
// pixels as literals.
inline void write_image(BitWriter* bw, const std::vector<uint32_t>& px,
                        bool level0) {
  bw->put(0, 1);  // no colour cache
  if (level0) bw->put(0, 1);  // one group of codes
  std::vector<uint32_t> hist[4] = {
      std::vector<uint32_t>(kNumLiteral + kNumLength, 0),
      std::vector<uint32_t>(kNumLiteral, 0),
      std::vector<uint32_t>(kNumLiteral, 0),
      std::vector<uint32_t>(kNumLiteral, 0)};
  for (uint32_t p : px) {
    ++hist[kGreen][(p >> 8) & 0xff];
    ++hist[kRed][(p >> 16) & 0xff];
    ++hist[kBlue][p & 0xff];
    ++hist[kAlpha][p >> 24];
  }
  Code codes[4];
  for (int k = 0; k < 4; ++k) codes[k] = write_code(bw, hist[k]);
  write_code(bw, std::vector<uint32_t>(kNumDistance, 0));
  for (uint32_t p : px) {
    codes[kGreen].emit(bw, (p >> 8) & 0xff);
    codes[kRed].emit(bw, (p >> 16) & 0xff);
    codes[kBlue].emit(bw, p & 0xff);
    codes[kAlpha].emit(bw, p >> 24);
  }
}

inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

// The RGB image (h, w, 3) -> a VP8L bitstream (the chunk's payload).
inline void encode_vp8l(const uint8_t* rgb, int w, int h,
                        std::vector<uint8_t>* out) {
  const size_t npix = static_cast<size_t>(w) * h;
  std::vector<uint32_t> argb(npix);
  for (size_t i = 0; i < npix; ++i) {  // subtract-green applied
    const uint32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    argb[i] = 0xff000000u | (((r - g) & 0xff) << 16) | (g << 8) |
              ((b - g) & 0xff);
  }
  constexpr int kBits = 4;
  const int tx = subsample(w, kBits), ty = subsample(h, kBits);
  std::vector<uint32_t> modes(static_cast<size_t>(tx) * ty);
  auto residual = [&](int m, int x, int y) {
    const uint32_t* p = argb.data() + static_cast<size_t>(y) * w + x;
    if (y == 0) return sub_pixels(*p, x == 0 ? 0xff000000u : p[-1]);
    if (x == 0) return sub_pixels(*p, p[-w]);
    return sub_pixels(*p, predict(m, p, w));
  };
  for (int j = 0; j < ty; ++j) {
    for (int i = 0; i < tx; ++i) {
      int best = 0;
      uint64_t best_cost = ~0ull;
      for (int m = 0; m < 14; ++m) {
        uint64_t cost = 0;
        for (int y = j << kBits; y < std::min(h, (j + 1) << kBits); ++y) {
          for (int x = i << kBits; x < std::min(w, (i + 1) << kBits); ++x) {
            const uint32_t r = residual(m, x, y);
            for (int s = 0; s < 24; s += 8) {
              const int v = (r >> s) & 0xff;
              cost += std::min(v, 256 - v);
            }
          }
        }
        if (cost < best_cost) {
          best_cost = cost;
          best = m;
        }
      }
      modes[static_cast<size_t>(j) * tx + i] =
          0xff000000u | (static_cast<uint32_t>(best) << 8);
    }
  }
  std::vector<uint32_t> res(npix);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int m = (modes[static_cast<size_t>(y >> kBits) * tx + (x >> kBits)]
                     >> 8) & 0xf;
      res[static_cast<size_t>(y) * w + x] = residual(m, x, y);
    }
  }
  BitWriter bw;
  bw.put(0x2f, 8);
  bw.put(w - 1, 14);
  bw.put(h - 1, 14);
  bw.put(0, 1);  // alpha unused
  bw.put(0, 3);  // version
  bw.put(1, 1);  // transform: subtract-green
  bw.put(kSubtractGreen, 2);
  bw.put(1, 1);  // transform: predictor
  bw.put(kPredictor, 2);
  bw.put(kBits - 2, 3);
  write_image(&bw, modes, false);
  bw.put(0, 1);  // no more transforms
  write_image(&bw, res, true);
  *out = bw.finish();
}

// ---------------------------------------------------------------- VP8

// RFC 6386 7.3's boolean entropy encoder.
class BoolWriter {
 public:
  void put(int bit, int prob) {
    const uint32_t split = 1 + (((range_ - 1) * static_cast<uint32_t>(prob)) >> 8);
    if (bit) {
      bottom_ += split;
      range_ -= split;
    } else {
      range_ = split;
    }
    while (range_ < 128) {
      range_ <<= 1;
      if (bottom_ & (1u << 31)) carry();
      bottom_ <<= 1;
      if (!--bit_count_) {
        out_.push_back(static_cast<uint8_t>(bottom_ >> 24));
        bottom_ &= (1u << 24) - 1;
        bit_count_ = 8;
      }
    }
  }
  void value(uint32_t v, int n) {
    while (n-- > 0) put((v >> n) & 1, 0x80);
  }
  std::vector<uint8_t> finish() {
    int c = bit_count_;
    uint32_t v = bottom_;
    if (v & (1u << (32 - c))) carry();
    v <<= c & 7;
    c >>= 3;
    while (--c >= 0) v <<= 8;
    for (c = 0; c < 4; ++c) {
      out_.push_back(static_cast<uint8_t>(v >> 24));
      v <<= 8;
    }
    return std::move(out_);
  }

 private:
  void carry() {
    size_t i = out_.size();
    while (i > 0 && out_[i - 1] == 255) out_[--i] = 0;
    if (i > 0) ++out_[i - 1];
  }
  std::vector<uint8_t> out_;
  uint32_t range_ = 255, bottom_ = 0;
  int bit_count_ = 24;
};

// libwebp's FTransform: src - ref (4x4, BPS apart) -> 16 coefficients.
inline void forward_dct(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1];
    const int d2 = src[2] - ref[2], d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = static_cast<int16_t>((a0 + a1 + 7) >> 4);
    out[4 + i] = static_cast<int16_t>(((a2 * 2217 + a3 * 5352 + 12000) >> 16) +
                                      (a3 != 0));
    out[8 + i] = static_cast<int16_t>((a0 - a1 + 7) >> 4);
    out[12 + i] = static_cast<int16_t>((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

// libwebp's FTransformWHT: the 16 DCs (in[16 * k]) -> Y2 coefficients.
inline void forward_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += 64) {
    const int a0 = in[0] + in[32], a1 = in[16] + in[48];
    const int a2 = in[16] - in[48], a3 = in[0] - in[32];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = static_cast<int16_t>((a0 + a1) >> 1);
    out[4 + i] = static_cast<int16_t>((a3 + a2) >> 1);
    out[8 + i] = static_cast<int16_t>((a3 - a2) >> 1);
    out[12 + i] = static_cast<int16_t>((a0 - a1) >> 1);
  }
}

class Vp8Encoder {
 public:
  Vp8Encoder(const uint8_t* rgb, int w, int h, int quality)
      : w_(w), h_(h), mb_w_((w + 15) >> 4), mb_h_((h + 15) >> 4) {
    q_ = std::min(127, std::max(0, (127 * (100 - quality) + 50) / 100));
    // the quantisers VP8ParseQuant derives from q_ (no deltas)
    y1_[0] = kDcTable[q_];
    y1_[1] = kAcTable[q_];
    y2_[0] = kDcTable[q_] * 2;
    y2_[1] = std::max(8, (kAcTable[q_] * 101581) >> 16);
    uv_[0] = kDcTable[std::min(q_, 117)];
    uv_[1] = kAcTable[q_];
    to_yuv(rgb);
  }

  std::vector<uint8_t> encode() {
    const int ys = mb_w_ * 16, us = mb_w_ * 8;
    ry_.assign(static_cast<size_t>(ys) * mb_h_ * 16, 0);
    ru_.assign(static_cast<size_t>(us) * mb_h_ * 8, 0);
    rv_.assign(static_cast<size_t>(us) * mb_h_ * 8, 0);
    top_nz_.assign(mb_w_, {});
    header();
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      left_nz_ = {};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) macroblock(mb_x, mb_y);
    }
    std::vector<uint8_t> p0 = part0_.finish(), p1 = tokens_.finish();
    std::vector<uint8_t> out;
    const uint32_t tag = (1u << 4) | (static_cast<uint32_t>(p0.size()) << 5);
    out.push_back(static_cast<uint8_t>(tag));
    out.push_back(static_cast<uint8_t>(tag >> 8));
    out.push_back(static_cast<uint8_t>(tag >> 16));
    const uint8_t start[7] = {0x9d, 0x01, 0x2a, static_cast<uint8_t>(w_),
                              static_cast<uint8_t>(w_ >> 8),
                              static_cast<uint8_t>(h_),
                              static_cast<uint8_t>(h_ >> 8)};
    out.insert(out.end(), start, start + 7);
    out.insert(out.end(), p0.begin(), p0.end());
    out.insert(out.end(), p1.begin(), p1.end());
    return out;
  }

 private:
  struct Nz {
    uint8_t y[4] = {0, 0, 0, 0}, u[2] = {0, 0}, v[2] = {0, 0}, dc = 0;
  };

  // RGB -> BT.601 limited-range YUV, chroma the mean of each 2x2 block;
  // the planes padded to whole macroblocks by repeating the last pixel.
  void to_yuv(const uint8_t* rgb) {
    const int pw = mb_w_ * 16, ph = mb_h_ * 16;
    sy_.resize(static_cast<size_t>(pw) * ph);
    su_.resize(static_cast<size_t>(pw / 2) * ph / 2);
    sv_.resize(su_.size());
    std::vector<int> cu(static_cast<size_t>(pw) * ph), cv(cu.size());
    for (int y = 0; y < ph; ++y) {
      for (int x = 0; x < pw; ++x) {
        const uint8_t* p = rgb + (static_cast<size_t>(std::min(y, h_ - 1)) * w_ +
                                  std::min(x, w_ - 1)) * 3;
        const int r = p[0], g = p[1], b = p[2];
        const size_t i = static_cast<size_t>(y) * pw + x;
        sy_[i] = clip8((16839 * r + 33059 * g + 6420 * b + (16 << 16) +
                        (1 << 15)) >> 16);
        cu[i] = -9719 * r - 19081 * g + 28800 * b;
        cv[i] = 28800 * r - 24116 * g - 4684 * b;
      }
    }
    for (int y = 0; y < ph / 2; ++y) {
      for (int x = 0; x < pw / 2; ++x) {
        const size_t i = static_cast<size_t>(2 * y) * pw + 2 * x;
        const int u = cu[i] + cu[i + 1] + cu[i + pw] + cu[i + pw + 1];
        const int v = cv[i] + cv[i + 1] + cv[i + pw] + cv[i + pw + 1];
        su_[static_cast<size_t>(y) * pw / 2 + x] =
            clip8((u + (128 << 18) + (1 << 17)) >> 18);
        sv_[static_cast<size_t>(y) * pw / 2 + x] =
            clip8((v + (128 << 18) + (1 << 17)) >> 18);
      }
    }
  }

  void flag_signed(int v, int n) {
    part0_.put(v != 0, 0x80);
    if (v) {
      part0_.value(std::abs(v), n);
      part0_.put(v < 0, 0x80);
    }
  }

  void header() {
    BoolWriter& e = part0_;
    e.value(0, 1);  // colour space
    e.value(0, 1);  // clamping type
    e.put(0, 0x80);  // no segments
    level_ = std::min(63, std::max(0, (q_ * 40 + 63) / 127));
    e.value(0, 1);  // the normal filter
    e.value(level_, 6);
    e.value(0, 3);  // sharpness
    e.put(0, 0x80);  // no loop-filter deltas
    e.value(0, 2);  // one token partition
    e.value(q_, 7);
    for (int i = 0; i < 5; ++i) flag_signed(0, 4);
    e.value(0, 1);  // refresh_entropy_probs
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b) {
        for (int c = 0; c < 3; ++c) {
          for (int p = 0; p < 11; ++p) e.put(0, kCoeffsUpdateProba[t][b][c][p]);
        }
      }
    }
    e.value(0, 1);  // no skip probability: every macroblock is coded
  }

  // The work buffer's borders for (mb_x, mb_y) from the reconstruction,
  // as the decoder sets them (left 129, top 127, top-left 127 / 129).
  void load_borders(int mb_x, int mb_y, uint8_t* work) {
    const int ys = mb_w_ * 16, us = mb_w_ * 8;
    uint8_t* y = work + Y_OFF;
    uint8_t* u = work + U_OFF;
    uint8_t* v = work + V_OFF;
    for (int j = 0; j < 16; ++j) {
      y[j * BPS - 1] = mb_x ? ry_[(static_cast<size_t>(mb_y) * 16 + j) * ys +
                                  mb_x * 16 - 1]
                            : 129;
    }
    for (int j = 0; j < 8; ++j) {
      const size_t at = (static_cast<size_t>(mb_y) * 8 + j) * us + mb_x * 8 - 1;
      u[j * BPS - 1] = mb_x ? ru_[at] : 129;
      v[j * BPS - 1] = mb_x ? rv_[at] : 129;
    }
    if (mb_y == 0) {
      std::memset(y - BPS - 1, 127, 21);
      std::memset(u - BPS - 1, 127, 9);
      std::memset(v - BPS - 1, 127, 9);
      return;
    }
    const size_t ty = (static_cast<size_t>(mb_y) * 16 - 1) * ys + mb_x * 16;
    const size_t tu = (static_cast<size_t>(mb_y) * 8 - 1) * us + mb_x * 8;
    std::memcpy(y - BPS, &ry_[ty], 16);
    std::memcpy(u - BPS, &ru_[tu], 8);
    std::memcpy(v - BPS, &rv_[tu], 8);
    y[-BPS - 1] = mb_x ? ry_[ty - 1] : 129;
    u[-BPS - 1] = mb_x ? ru_[tu - 1] : 129;
    v[-BPS - 1] = mb_x ? rv_[tu - 1] : 129;
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != DC_PRED) return mode;
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }

  // The cheapest of DC, TM, V, H for the block at dst against src (both
  // BPS apart); leaves its prediction in dst.
  static int best_mode(int mb_x, int mb_y, uint8_t* dst, const uint8_t* src,
                       int size) {
    int best = DC_PRED;
    long best_cost = -1;
    for (int mode : {DC_PRED, TM_PRED, V_PRED, H_PRED}) {
      predict_block(check_mode(mb_x, mb_y, mode), dst, size);
      long cost = 0;
      for (int j = 0; j < size; ++j) {
        for (int i = 0; i < size; ++i) {
          const int d = src[j * BPS + i] - dst[j * BPS + i];
          cost += d * d;
        }
      }
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = mode;
      }
    }
    predict_block(check_mode(mb_x, mb_y, best), dst, size);
    return best;
  }

  static int quantize(int c, int q) {
    const int level = (std::abs(c) + q / 2) / q;
    return std::min(level, 2047) * (c < 0 ? -1 : 1);
  }

  void write_large(int v, const uint8_t* p) {
    BoolWriter& e = tokens_;
    if (v <= 4) {
      e.put(0, p[3]);
      e.put(v != 2, p[4]);
      if (v != 2) e.put(v - 3, p[5]);
    } else if (v <= 10) {
      e.put(1, p[3]);
      e.put(0, p[6]);
      e.put(v > 6, p[7]);
      if (v <= 6) {
        e.put(v - 5, 159);
      } else {
        e.put((v - 7) >> 1, 165);
        e.put((v - 7) & 1, 145);
      }
    } else {
      e.put(1, p[3]);
      e.put(1, p[6]);
      const int cat = v < 19 ? 0 : v < 35 ? 1 : v < 67 ? 2 : 3;
      e.put(cat >> 1, p[8]);
      e.put(cat & 1, p[9 + (cat >> 1)]);
      const int extra = v - (3 + (8 << cat));
      int n = 0;
      while (kCat3456[cat][n]) ++n;
      for (int i = 0; i < n; ++i) {
        e.put((extra >> (n - 1 - i)) & 1, kCat3456[cat][i]);
      }
    }
  }

  // One block's tokens (levels in zigzag order from `first`); returns the
  // decoder's nz (the position after the last non-zero level).
  int write_block(int t, int ctx, int first, const int* lv) {
    int last = first - 1;
    for (int i = first; i < 16; ++i) {
      if (lv[i]) last = i;
    }
    const uint8_t* p = kCoeffsProba0[t][kBands[first]][ctx];
    for (int n = first; n < 16;) {
      if (n > last) {
        tokens_.put(0, p[0]);
        break;
      }
      tokens_.put(1, p[0]);
      while (!lv[n]) {
        tokens_.put(0, p[1]);
        p = kCoeffsProba0[t][kBands[++n]][0];
      }
      tokens_.put(1, p[1]);
      const int v = std::abs(lv[n]);
      int nctx = 1;
      if (v == 1) {
        tokens_.put(0, p[2]);
      } else {
        tokens_.put(1, p[2]);
        write_large(v, p);
        nctx = 2;
      }
      tokens_.put(lv[n] < 0, 0x80);
      ++n;
      p = kCoeffsProba0[t][kBands[n]][nctx];
    }
    return std::max(first, last + 1);
  }

  // Quantise coeffs (natural order) into zigzag levels and put the
  // dequantised values back into coeffs.
  static void quantize_block(int16_t* coeffs, const int* dq, int first,
                             int* lv) {
    for (int n = 0; n < 16; ++n) {
      const int k = kZigzag[n];
      if (n < first) {
        lv[n] = 0;
        continue;
      }
      lv[n] = quantize(coeffs[k], dq[n > 0]);
      coeffs[k] = static_cast<int16_t>(lv[n] * dq[n > 0]);
    }
  }

  void macroblock(int mb_x, int mb_y) {
    uint8_t work[kWorkSize];
    uint8_t src[kWorkSize];
    load_borders(mb_x, mb_y, work);
    const int pw = mb_w_ * 16;
    for (int j = 0; j < 16; ++j) {
      std::memcpy(src + Y_OFF + j * BPS,
                  &sy_[(static_cast<size_t>(mb_y) * 16 + j) * pw + mb_x * 16], 16);
    }
    for (int j = 0; j < 8; ++j) {
      const size_t at = (static_cast<size_t>(mb_y) * 8 + j) * pw / 2 + mb_x * 8;
      std::memcpy(src + U_OFF + j * BPS, &su_[at], 8);
      std::memcpy(src + V_OFF + j * BPS, &sv_[at], 8);
    }
    uint8_t* y = work + Y_OFF;
    uint8_t* u = work + U_OFF;
    uint8_t* v = work + V_OFF;
    const int ymode = best_mode(mb_x, mb_y, y, src + Y_OFF, 16);
    // chroma: U decides, V follows
    const int uvmode = best_mode(mb_x, mb_y, u, src + U_OFF, 8);
    predict_block(check_mode(mb_x, mb_y, uvmode), v, 8);
    // modes (partition 0): i16, then ymode and uvmode as libwebp parses
    part0_.put(1, 145);
    part0_.put(ymode == TM_PRED || ymode == H_PRED, 156);
    if (ymode == TM_PRED || ymode == H_PRED) {
      part0_.put(ymode == TM_PRED, 128);
    } else {
      part0_.put(ymode == V_PRED, 163);
    }
    part0_.put(uvmode != DC_PRED, 142);
    if (uvmode != DC_PRED) {
      part0_.put(uvmode != V_PRED, 114);
      if (uvmode != V_PRED) part0_.put(uvmode == TM_PRED, 183);
    }
    // residuals: 16 luma blocks (their DCs through Y2), 4 + 4 chroma
    int16_t coeffs[384];
    for (int n = 0; n < 16; ++n) {
      const int off = (n & 3) * 4 + (n >> 2) * 4 * BPS;
      forward_dct(src + Y_OFF + off, y + off, coeffs + n * 16);
    }
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      forward_dct(src + U_OFF + off, u + off, coeffs + 256 + n * 16);
      forward_dct(src + V_OFF + off, v + off, coeffs + 320 + n * 16);
    }
    int16_t y2[16];
    int lv[16];
    Nz& t = top_nz_[mb_x];
    forward_wht(coeffs, y2);
    quantize_block(y2, y2_, 0, lv);
    const int nz_dc = write_block(1, t.dc + left_nz_.dc, 0, lv);
    t.dc = left_nz_.dc = nz_dc > 0;
    int16_t dcs[256] = {0};
    transform_wht(y2, dcs);
    for (int n = 0; n < 16; ++n) {
      int16_t* c = coeffs + n * 16;
      quantize_block(c, y1_, 1, lv);
      c[0] = dcs[n * 16];
      const int nz = write_block(0, t.y[n & 3] + left_nz_.y[n >> 2], 1, lv);
      t.y[n & 3] = left_nz_.y[n >> 2] = nz > 1;
    }
    for (int ch = 0; ch < 2; ++ch) {
      for (int n = 0; n < 4; ++n) {
        int16_t* c = coeffs + 256 + ch * 64 + n * 16;
        quantize_block(c, uv_, 0, lv);
        uint8_t* tn = ch ? t.v : t.u;
        uint8_t* ln = ch ? left_nz_.v : left_nz_.u;
        const int nz = write_block(2, tn[n & 1] + ln[n >> 1], 0, lv);
        tn[n & 1] = ln[n >> 1] = nz > 0;
      }
    }
    // reconstruct as the decoder does (values within range: every
    // transform form agrees)
    for (int n = 0; n < 16; ++n) {
      transform_full(coeffs + n * 16, y + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      transform_full(coeffs + 256 + n * 16, u + off);
      transform_full(coeffs + 320 + n * 16, v + off);
    }
    const int ys = mb_w_ * 16, us = mb_w_ * 8;
    for (int j = 0; j < 16; ++j) {
      std::memcpy(&ry_[(static_cast<size_t>(mb_y) * 16 + j) * ys + mb_x * 16],
                  y + j * BPS, 16);
    }
    for (int j = 0; j < 8; ++j) {
      const size_t at = (static_cast<size_t>(mb_y) * 8 + j) * us + mb_x * 8;
      std::memcpy(&ru_[at], u + j * BPS, 8);
      std::memcpy(&rv_[at], v + j * BPS, 8);
    }
  }

  int w_, h_, mb_w_, mb_h_, q_ = 0, level_ = 0;
  int y1_[2], y2_[2], uv_[2];
  std::vector<uint8_t> sy_, su_, sv_, ry_, ru_, rv_;
  std::vector<Nz> top_nz_;
  Nz left_nz_;
  BoolWriter part0_, tokens_;
};

// The RGB image (h, w, 3) -> a VP8 key frame (the chunk's payload) at
// `quality` 0-100.
inline void encode_vp8(const uint8_t* rgb, int w, int h, int quality,
                       std::vector<uint8_t>* out) {
  *out = Vp8Encoder(rgb, w, h, quality).encode();
}

}  // namespace etwebp
