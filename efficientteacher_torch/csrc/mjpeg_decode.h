// MJPEG video decoder of the host loader core: the frames FFmpeg 8's
// `mjpeg` decoder (libavcodec 62.28, inside cv2 5.0's FFmpeg backend) gives
// for the JPEG frames of an MJPEG stream, bit for bit, with no library.
// Included by loader_core.cpp only.
//
// Not libjpeg's decode (jpeg_decode.h is cv2.imread's): FFmpeg dequantises
// while it decodes (the DC predictor is the dequantised DC, from 1024),
// runs its own simple IDCT (video_dsp.h) straight into yuvj420p / yuvj422p
// planes with no upsampling, and swscale converts those (full range) to
// BGR24. The Huffman tables and their build are jpeg_decode.h's (an AVI
// MJPEG frame may omit DHT: the standard tables are installed first, as
// FFmpeg's init_default_huffman_tables does).
//
// Decodes baseline and extended sequential Huffman frames, 8-bit, three
// components in one interleaved scan, luma sampled 2x2 or 2x1 against 1x1
// chroma, with restart intervals. What else a frame needs (progressive,
// arithmetic or lossless coding, another precision or component count,
// other sampling, AVI1 field pairs) is refused with a Kind from its
// headers.
//
// Reproduced FFmpeg routines (libavcodec/mjpegdec.c): find_marker (FF and
// a code in C0..FE), ff_mjpeg_find_marker (the SOS unescaping: FF 00 ->
// FF, RSTn kept, up to the next other marker), ff_mjpeg_decode_dqt / _dht
// / _sof / _sos, decode_block (AC levels times the quantiser stored as
// int16, the DC clipped to int16), mjpeg_decode_scan (each block put as it
// is decoded; at an MCU's start, data overread ends the scan), the restart
// marker skip, "EOI missing, emulating", the SOF's size check against the
// packet. A packet FFmpeg fails on stops cv2's reading there.

#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_decode.h"
#include "video_dsp.h"

namespace etmjpeg {

enum Kind {
  kDecoded = 0,
  kCoding = 1,      // progressive, arithmetic, lossless or hierarchical
  kPrecision = 2,   // not 8 bits
  kComponents = 3,  // not three components in one interleaved scan
  kSampling = 4,    // neither 4:2:0 nor 4:2:2
  kFields = 5,      // two fields per frame (AVI1 interlaced MJPEG)
};

enum Result { kFrame = 1, kNoFrame = 0, kBadData = -2, kUnsupported = -4,
              kNoScan = -6 };

// GetBitContext over the unescaped scan (the safe reader: zeros past the
// end, the index capped at the size plus 8 bits)
struct Bits {
  const uint8_t* d;
  int size_bits;
  int idx = 0;
  uint32_t show(int n) const {
    const int b = idx >> 3;
    const uint64_t v = (static_cast<uint64_t>(d[b]) << 32) |
                       (static_cast<uint64_t>(d[b + 1]) << 24) |
                       (static_cast<uint64_t>(d[b + 2]) << 16) |
                       (static_cast<uint64_t>(d[b + 3]) << 8) | d[b + 4];
    return static_cast<uint32_t>((v << (idx & 7)) >> (40 - n)) &
           ((n == 32) ? 0xffffffffu : ((1u << n) - 1));
  }
  void skip(int n) { idx = std::min(size_bits + 8, idx + n); }
  int get(int n) {
    if (!n) return 0;
    const int v = static_cast<int>(show(n));
    skip(n);
    return v;
  }
  int left() const { return size_bits - idx; }
  void align() { skip((-idx) & 7); }
  // a Huffman symbol; -1 for bits that are no code
  int decode(const etjpeg::Huffman& t) {
    const uint32_t look = show(16);
    const uint32_t top = look >> (16 - etjpeg::kLookBits);
    if (t.look_len[top]) {
      skip(t.look_len[top]);
      return t.look_val[top];
    }
    for (int l = etjpeg::kLookBits + 1; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(look >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xff];
      }
    }
    return -1;
  }
};

class Decoder {
 public:
  // the container's frame size (AVI strf): a JPEG under 3/4 of its height
  // is one field of an interlaced frame, which FFmpeg pairs
  explicit Decoder(int container_h = 0) : orig_h_(container_h) {
    for (int c = 0; c < 2; ++c) {
      dc_[c].build(etjpeg::kStdDcBits[c], etjpeg::kStdDcVals);
      ac_[c].build(etjpeg::kStdAcBits[c], etjpeg::kStdAcVals[c]);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int kind() const { return kind_; }

  int decode(const uint8_t* data, int n) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    bool got_picture = false, scanned = false;
    restart_ = 0;
    for (;;) {
      const int m = find_marker(&p, end);
      if (m < 0) break;
      // the segment after the marker (its length field included)
      const uint8_t* seg = p;
      if (m == 0xD8) {  // SOI
        got_picture = false;
        scanned = false;
        continue;
      }
      if (m == 0xD9) {  // EOI
        if (got_picture && scanned) return kFrame;
        continue;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0xDA) {
        if (!got_picture) continue;
        const int r = scan(seg, end, &p);
        if (r == kUnsupported) return r;
        if (r == 0) scanned = true;
        continue;
      }
      if (end - seg < 2) break;
      const int len = (seg[0] << 8) | seg[1];
      const uint8_t* body = seg + 2;
      const uint8_t* next = seg + std::max(len, 2);
      if (next > end) next = end;
      if (m == 0xDB) {
        if (!dqt(body, next)) return kBadData;
      } else if (m == 0xC4) {
        if (!dht(body, next)) return kBadData;
      } else if (m == 0xC0 || m == 0xC1) {
        const int r = sof(body, next, n);
        if (r < 0) return r;
        got_picture = true;
      } else if ((m >= 0xC2 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) ||
                 (m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
        kind_ = kCoding;
        return kUnsupported;
      } else if (m == 0xDD) {
        if (next - body >= 2) restart_ = (body[0] << 8) | body[1];
      }
      p = next;
    }
    if (got_picture && scanned) return kFrame;  // EOI missing, emulating
    return kBadData;
  }

  void to_bgr(uint8_t* out, int stride) const {
    etvideo::yuv_to_bgr(plane_[0].data(), stride_[0], plane_[1].data(),
                        plane_[2].data(), stride_[1], width_, height_,
                        vsamp_ == 2 ? 1 : 0, true, out, stride);
  }

 private:
  etjpeg::Huffman dc_[4], ac_[4];
  uint16_t quant_[4][64] = {};
  int orig_h_;
  int width_ = 0, height_ = 0, kind_ = kDecoded, restart_ = 0;
  int hsamp_ = 2, vsamp_ = 2;
  int comp_id_[3] = {}, comp_q_[3] = {};
  std::vector<uint8_t> plane_[3];
  int stride_[3] = {};
  std::vector<uint8_t> unescaped_;

  static int find_marker(const uint8_t** pp, const uint8_t* end) {
    const uint8_t* p = *pp;
    while (end - p > 1) {
      const uint8_t v = *p++;
      const int val = *p;
      if (v == 0xFF && val >= 0xC0 && val <= 0xFE && p < end) {
        *pp = p + 1;
        return val;
      }
    }
    *pp = end;
    return -1;
  }

  bool dqt(const uint8_t* p, const uint8_t* end) {
    while (end - p >= 1) {
      const int pr = p[0] >> 4, index = p[0] & 15;
      ++p;
      if (pr > 1 || index > 3) return false;
      if (end - p < (pr ? 128 : 64)) return false;
      for (int i = 0; i < 64; ++i) {
        quant_[index][i] = pr ? static_cast<uint16_t>((p[2 * i] << 8) |
                                                      p[2 * i + 1])
                              : p[i];
      }
      p += pr ? 128 : 64;
    }
    return true;
  }

  bool dht(const uint8_t* p, const uint8_t* end) {
    while (end - p >= 17) {
      const int cls = p[0] >> 4, index = p[0] & 15;
      if (cls > 1 || index > 3) return false;
      const uint8_t* bits = p + 1;
      int n = 0;
      for (int i = 0; i < 16; ++i) n += bits[i];
      if (n > 256 || end - p < 17 + n) return false;
      etjpeg::Huffman& t = cls ? ac_[index] : dc_[index];
      if (!t.build(bits, p + 17)) return false;
      p += 17 + n;
    }
    return true;
  }

  // `packet`: the packet's size (FFmpeg's buf_size)
  int sof(const uint8_t* p, const uint8_t* end, int packet) {
    if (end - p < 6) return kBadData;
    if (p[0] != 8) {
      kind_ = kPrecision;
      return kUnsupported;
    }
    const int h = (p[1] << 8) | p[2], w = (p[3] << 8) | p[4], nc = p[5];
    if (nc != 3) {
      kind_ = kComponents;
      return kUnsupported;
    }
    if (end - p < 6 + 3 * nc || !w || !h) return kBadData;
    // "a valid frame requires at least 1 bit for DC + 1 bit for AC for
    // each 8x8 block": a packet too small for that fails at its SOF
    if (int64_t{(w + 7) / 8} * ((h + 7) / 8) > int64_t{packet} * 4)
      return kBadData;
    int hs[3], vs[3];
    for (int c = 0; c < 3; ++c) {
      comp_id_[c] = p[6 + 3 * c];
      hs[c] = p[7 + 3 * c] >> 4;
      vs[c] = p[7 + 3 * c] & 15;
      comp_q_[c] = p[8 + 3 * c] & 3;
    }
    if (hs[1] != 1 || vs[1] != 1 || hs[2] != 1 || vs[2] != 1 || hs[0] != 2 ||
        (vs[0] != 2 && vs[0] != 1)) {
      kind_ = kSampling;
      return kUnsupported;
    }
    if (orig_h_ && h < orig_h_ * 3 / 4) {
      kind_ = kFields;
      return kUnsupported;
    }
    hsamp_ = hs[0];
    vsamp_ = vs[0];
    width_ = w;
    height_ = h;
    const int mbw = (w + 8 * hsamp_ - 1) / (8 * hsamp_);
    const int mbh = (h + 8 * vsamp_ - 1) / (8 * vsamp_);
    stride_[0] = mbw * 8 * hsamp_;
    stride_[1] = stride_[2] = mbw * 8;
    const size_t ny = static_cast<size_t>(stride_[0]) * mbh * 8 * vsamp_;
    const size_t nc8 = static_cast<size_t>(stride_[1]) * mbh * 8;
    if (plane_[0].size() != ny) plane_[0].assign(ny, 0);
    if (plane_[1].size() != nc8) plane_[1].assign(nc8, 0);
    if (plane_[2].size() != nc8) plane_[2].assign(nc8, 0);
    return 0;
  }

  // ff_mjpeg_find_marker's unescaping of the SOS segment from `seg`; the
  // position of the marker that ends it (or the end of the data)
  const uint8_t* unescape(const uint8_t* seg, const uint8_t* end) {
    unescaped_.clear();
    const uint8_t* src = seg;
    const uint8_t* ptr = seg;
    auto copy = [&](ptrdiff_t skip) {
      const ptrdiff_t length = (ptr - src) - skip;
      if (length > 0) {
        unescaped_.insert(unescaped_.end(), src, src + length);
        src = ptr;
      }
    };
    while (ptr < end) {
      uint8_t x = *ptr++;
      if (x == 0xff && ptr < end) {  // a last FF is data (held on cut scans)
        ptrdiff_t skip = 0;
        while (ptr < end && x == 0xff) {
          x = *ptr++;
          ++skip;
        }
        if (skip > 1) {
          copy(skip);
          --src;
        }
        if (x < 0xD0 || x > 0xD7) {
          copy(1);
          if (x) return ptr - 2;
        }
      }
    }
    if (src < ptr) copy(0);
    return end;
  }

  int scan(const uint8_t* seg, const uint8_t* end, const uint8_t** next) {
    *next = unescape(seg, end);
    const size_t n = unescaped_.size();
    unescaped_.resize(n + 64, 0);
    Bits b{unescaped_.data(), static_cast<int>(n) * 8};
    // SOS header (ff_mjpeg_decode_sos); a header it fails on is no scan
    const int len = b.get(16);
    const int nc = b.get(8);
    if (nc == 0 || nc > 4 || len != 6 + 2 * nc) return kNoScan;
    int dci[4], aci[4], order[4];
    for (int i = 0; i < nc; ++i) {
      const int id = b.get(8);
      order[i] = -1;
      for (int c = 2; c >= 0; --c)
        if (comp_id_[c] == id) order[i] = c;
      if (order[i] < 0) return kNoScan;
      dci[i] = b.get(4);
      aci[i] = b.get(4);
      if (dci[i] > 3 || aci[i] > 3 || !dc_[dci[i]].defined ||
          !ac_[aci[i]].defined)
        return kNoScan;
    }
    if (nc != 3) {
      kind_ = kComponents;
      return kUnsupported;
    }
    b.skip(24);  // Ss, Se, Ah / Al: a sequential scan reads them not
    int last_dc[3] = {1024, 1024, 1024};
    const int mbw = stride_[1] / 8;
    const int mbh = static_cast<int>(plane_[1].size()) / stride_[1] / 8;
    int restart_count = 0;
    int16_t block[64];
    for (int my = 0; my < mbh; ++my) {
      for (int mx = 0; mx < mbw; ++mx) {
        if (restart_ && !restart_count) restart_count = restart_;
        if (b.left() < 0) return 0;  // overread: the scan ends
        for (int i = 0; i < 3; ++i) {
          const int c = order[i];
          const int h = c == 0 ? hsamp_ : 1, v = c == 0 ? vsamp_ : 1;
          for (int y = 0; y < v; ++y) {
            for (int x = 0; x < h; ++x) {
              std::memset(block, 0, sizeof(block));
              if (!decode_block(b, block, &last_dc[i], dc_[dci[i]],
                                ac_[aci[i]], quant_[comp_q_[c]]))
                return 0;  // "error y=.. x=..": the scan ends
              uint8_t* dst = plane_[c].data() +
                             (static_cast<size_t>(v * my + y) * 8) *
                                 stride_[c] +
                             (h * mx + x) * 8;
              etvideo::idct_put(block, dst, stride_[c]);
            }
          }
        }
        if (restart_) {
          --restart_count;
          const int i = 8 + ((-b.idx) & 7);
          if (restart_count == 0 &&
              (b.show(i) == (1u << i) - 1 || b.show(i) == 0xFF)) {
            const int pos = b.idx;
            b.align();
            while (b.left() >= 8 && b.show(8) == 0xFF) b.skip(8);
            if (b.left() >= 8 && (b.get(8) & 0xF8) == 0xD0) {
              last_dc[0] = last_dc[1] = last_dc[2] = 1024;
            } else {
              b.idx = pos;
            }
          }
        }
      }
    }
    return 0;
  }

  static bool decode_block(Bits& b, int16_t* block, int* last_dc,
                           const etjpeg::Huffman& dc,
                           const etjpeg::Huffman& ac, const uint16_t* q) {
    const int code = b.decode(dc);
    if (code < 0 || code > 16) return false;
    int val = 0;
    if (code) {
      val = b.get(code);
      if (val < (1 << (code - 1))) val -= (1 << code) - 1;
    }
    val = static_cast<int>(static_cast<unsigned>(val) * q[0] +
                           static_cast<unsigned>(*last_dc));
    *last_dc = val;
    block[0] = static_cast<int16_t>(std::min(32767, std::max(-32768, val)));
    int i = 0;
    do {
      const int sym = b.decode(ac);
      if (sym < 0) return false;
      if (sym == 0) break;  // EOB
      i += (sym >> 4) + 1;
      const int size = sym & 15;
      if (size) {
        int level = b.get(size);
        if (level < (1 << (size - 1))) level -= (1 << size) - 1;
        if (i > 63) return false;
        block[etjpeg::kNatural[i]] = static_cast<int16_t>(level * q[i]);
      }
    } while (i < 63);
    return true;
  }
};

}  // namespace etmjpeg
