// Per-pixel work of the lossless image formats (PNG, BMP, TIFF) for the
// host loader core: the stages that run once per byte or pixel, so that no
// decode path loops over pixels in Python. Included by loader_core.cpp
// only; headers, chunks and IFDs are parsed in Python (data/image_io.py),
// and zlib's inflate is Python's (it releases the interpreter lock).
//
// Each routine reproduces what cv2.imread's codec does at that stage:
//   unpack_rows     samples of 1/2/4/8/16 bits, MSB first in a byte, into
//                   one byte each; 16-bit samples reduced as libpng's
//                   png_set_strip_16 (the high byte) or libtiff's
//                   Bitdepth16To8 ((v + 128) / 257) reduce them; TIFF's
//                   horizontal predictor (tif_predict.c horAcc8/16) undone
//                   first, at the sample's own width and byte order
//   png_decode      the five row filters (PNG section 9) and Adam7's
//                   seven passes, each filtered on its own
//   to_rgb          a 256-entry RGB table (palette, or a grey ramp) or
//                   three samples to RGB, with libtiff's premultiplication
//                   by an unassociated alpha (BuildMapUaToAa) where asked
//   bmp_decode      OpenCV's grfmt_bmp.cpp BmpDecoder::readData: palette
//                   rows, 5-5-5 and 5-6-5 words, 24 and 32 bits, and
//                   BI_RLE8 / BI_RLE4 with its end-of-line, delta and
//                   end-of-bitmap escapes (FillUniColor: skipped pixels
//                   take palette entry 0; its RLE4 loop fills only to a
//                   row's end, whatever the escape)
//   lzw_decode      TIFF LZW (tif_lzw.c LZWDecode: MSB first, 9-12 bit
//                   codes, the code width grows one code early; a stream
//                   that fails keeps what it decoded, zeros after)
//   lzw_encode      the same code stream as tif_lzw.c LZWEncode writes
//   packbits_decode tif_packbits.c PackBitsDecode (a run cut short is
//                   dropped; zeros after)
//   fax::Decoder    tif_fax3.c: CCITT modified Huffman, Group 3 (1-D and
//                   2-D) and Group 4, with libtiff's recovery from damage
//   thunder_decode  tif_thunder.c ThunderDecodeRow
//   sgilog_decode   tif_luv.c's SGILog and SGILog24 decoders with the
//                   8-bit conversions libtiff's RGBA interface asks for
//                   (L16toGry, Luv32toRGB, Luv24toRGB and uvcode.h)
//   tiff_decode     every strip or tile of an image into its place (the
//                   JPEG-in-TIFF streams through jpeg_decode.h, YCbCr
//                   blocks spread to their pixels)
//   tiff_colour     tif_getimage.c / tif_color.c: CMYK, YCbCr and CIELab
//                   to RGB
// Every routine writes into buffers the caller owns and keeps no state.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_decode.h"

namespace etraster {

enum Status { kOk = 0, kCorrupt = -2, kArgs = -5 };

// 16-bit reductions to 8 bits
enum Round16 { kHighByte = 0, kDiv257Round = 1, kRaw16Bytes = 2 };

// `rows` rows, `row_bytes` apart, each holding `width` pixels of `spp`
// samples of `bits` bits (MSB first; 16-bit samples big-endian when
// `big_endian`) -> out, (rows, width * spp) bytes, rows `out_stride` apart.
// Samples of up to 8 bits keep their value (0 .. 2^bits - 1). With
// `predictor` the row is first accumulated sample by sample (TIFF
// Predictor 2; 8 or 16 bits only).
inline int unpack_rows(const uint8_t* src, int rows, size_t row_bytes,
                       int width, int spp, int bits, bool big_endian,
                       bool predictor, int round16, uint8_t* out,
                       size_t out_stride) {
  const size_t n = static_cast<size_t>(width) * spp;
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8 && bits != 16) {
    return kArgs;
  }
  if ((n * bits + 7) / 8 > row_bytes) return kArgs;
  if (predictor && bits < 8) return kArgs;
  std::vector<uint16_t> acc(predictor && bits == 16 ? n : 0);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* r = src + static_cast<size_t>(y) * row_bytes;
    uint8_t* o = out + static_cast<size_t>(y) * out_stride;
    if (bits == 8) {
      if (!predictor) {
        std::memcpy(o, r, n);
        continue;
      }
      for (size_t i = 0; i < n; ++i) {
        o[i] = static_cast<uint8_t>(i >= static_cast<size_t>(spp)
                                        ? o[i - spp] + r[i] : r[i]);
      }
      continue;
    }
    if (bits == 16) {
      for (size_t i = 0; i < n; ++i) {
        uint16_t v = big_endian
                         ? static_cast<uint16_t>((r[2 * i] << 8) | r[2 * i + 1])
                         : static_cast<uint16_t>(r[2 * i] | (r[2 * i + 1] << 8));
        if (predictor) {
          if (i >= static_cast<size_t>(spp)) {
            v = static_cast<uint16_t>(v + acc[i - spp]);
          }
          acc[i] = v;
        }
        if (round16 == kRaw16Bytes) {
          o[2 * i] = static_cast<uint8_t>(v);
          o[2 * i + 1] = static_cast<uint8_t>(v >> 8);
        } else {
          o[i] = round16 == kDiv257Round
                     ? static_cast<uint8_t>((v + 128) / 257)
                     : static_cast<uint8_t>(v >> 8);
        }
      }
      continue;
    }
    const int per_byte = 8 / bits, mask = (1 << bits) - 1;
    for (size_t i = 0; i < n; ++i) {
      const int shift = 8 - bits * (1 + static_cast<int>(i % per_byte));
      o[i] = static_cast<uint8_t>((r[i / per_byte] >> shift) & mask);
    }
  }
  return kOk;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo PNG's row filters in place: `data` holds h rows of 1 filter byte +
// `row_bytes` bytes; `out` gets the (h, row_bytes) bytes. `bpp` is the
// filters' byte distance (bytes per pixel, at least 1).
inline int png_unfilter(const uint8_t* data, int h, int row_bytes, int bpp,
                        uint8_t* out) {
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
        default: return kCorrupt;
      }
      o[i] = static_cast<uint8_t>(v & 0xff);
    }
  }
  return kOk;
}

// Adam7: pass p covers the pixels (x0 + k * dx, y0 + j * dy).
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                              {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                              {0, 1, 1, 2}};

// The inflated IDAT stream of a (w, h) PNG of `spp` samples of `bits`
// bits -> out (h, w, spp) bytes: values of up to 8 bits as they are, 16
// bits as their high byte (png_set_strip_16). `interlaced`: Adam7, each
// pass filtered on its own; an empty pass has no rows and no filter bytes.
inline int png_decode(const uint8_t* data, size_t n, int w, int h, int bits,
                      int spp, bool interlaced, uint8_t* out) {
  const int bpp = std::max(1, bits * spp / 8);
  const size_t row_out = static_cast<size_t>(w) * spp;
  size_t pos = 0;
  const int passes = interlaced ? 7 : 1;
  std::vector<uint8_t> raw, px;
  for (int p = 0; p < passes; ++p) {
    const int x0 = interlaced ? kAdam7[p][0] : 0;
    const int y0 = interlaced ? kAdam7[p][1] : 0;
    const int dx = interlaced ? kAdam7[p][2] : 1;
    const int dy = interlaced ? kAdam7[p][3] : 1;
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t rb = (static_cast<size_t>(pw) * spp * bits + 7) / 8;
    const size_t need = static_cast<size_t>(ph) * (rb + 1);
    if (n - pos < need) return kCorrupt;
    raw.resize(static_cast<size_t>(ph) * rb);
    if (png_unfilter(data + pos, ph, static_cast<int>(rb), bpp, raw.data()) !=
        kOk) {
      return kCorrupt;
    }
    pos += need;
    const size_t pn = static_cast<size_t>(pw) * spp;
    if (!interlaced) {
      return unpack_rows(raw.data(), ph, rb, pw, spp, bits, true, false,
                         kHighByte, out, pn);
    }
    px.resize(static_cast<size_t>(ph) * pn);
    unpack_rows(raw.data(), ph, rb, pw, spp, bits, true, false, kHighByte,
                px.data(), pn);
    for (int j = 0; j < ph; ++j) {
      uint8_t* o = out + static_cast<size_t>(y0 + j * dy) * row_out;
      const uint8_t* s = px.data() + static_cast<size_t>(j) * pn;
      for (int k = 0; k < pw; ++k) {
        std::memcpy(o + static_cast<size_t>(x0 + k * dx) * spp, s + k * spp,
                    spp);
      }
    }
  }
  return kOk;
}

// n pixels of `spp` 8-bit samples -> RGB. With `lut` (256 x 3) the first
// sample indexes it (a palette, or a grey ramp); without, samples 0-2 are
// R, G, B. `alpha` >= 0: the sample at that index is an unassociated alpha
// each channel is premultiplied by, as libtiff's RGBA interface does
// ((v * a + 127) / 255).
inline void to_rgb(const uint8_t* src, size_t n, int spp, const uint8_t* lut,
                   int alpha, uint8_t* out) {
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* s = src + i * spp;
    uint8_t* o = out + i * 3;
    if (lut) {
      std::memcpy(o, lut + s[0] * 3, 3);
    } else {
      o[0] = s[0], o[1] = s[1], o[2] = s[2];
    }
    if (alpha >= 0) {
      const int a = s[alpha];
      for (int c = 0; c < 3; ++c) {
        o[c] = static_cast<uint8_t>((o[c] * a + 127) / 255);
      }
    }
  }
}

// ---------------------------------------------------------------- BMP

// Pixels of a BMP as OpenCV's BmpDecoder reads them. `data` is the whole
// file, the pixels start at `offset`; (w, h) with h > 0; `bottom_up` for a
// positive header height. `bpp`: 1, 4, 8 (palette), 15 (5-5-5), 16
// (5-6-5), 24, 32 (B, G, R, the fourth byte ignored); `rle` 0, 8 or 4.
// `palette` 256 x 3 RGB (entries past the file's are black). out (h, w,
// 3) RGB, top row first.
class BmpReader {
 public:
  BmpReader(const uint8_t* data, size_t n, size_t offset, int w, int h,
            bool bottom_up, const uint8_t* palette, uint8_t* out)
      : p_(data + std::min(offset, n)), end_(data + n), w_(w), h_(h),
        bottom_up_(bottom_up), pal_(palette), out_(out) {}

  int read(int bpp, int rle) {
    if (rle) return read_rle(rle);
    const size_t pitch =
        ((static_cast<size_t>(w_) * (bpp == 15 ? 16 : bpp) + 7) / 8 + 3) &
        ~size_t{3};
    if (static_cast<size_t>(end_ - p_) < pitch * h_) return kCorrupt;
    for (int y = 0; y < h_; ++y, p_ += pitch) {
      uint8_t* o = row(y);
      for (int x = 0; x < w_; ++x, o += 3) {
        switch (bpp) {
          case 1: index(o, (p_[x >> 3] >> (7 - (x & 7))) & 1); break;
          case 4: index(o, (p_[x >> 1] >> ((x & 1) ? 0 : 4)) & 15); break;
          case 8: index(o, p_[x]); break;
          case 15:
          case 16: {
            const int t = p_[2 * x] | (p_[2 * x + 1] << 8);
            // icvCvt_BGR5552BGR / BGR5652BGR: no low bits replicated
            o[2] = static_cast<uint8_t>((t << 3) & 0xf8);
            o[1] = static_cast<uint8_t>(bpp == 15 ? (t >> 2) & 0xf8
                                                  : (t >> 3) & 0xfc);
            o[0] = static_cast<uint8_t>(bpp == 15 ? (t >> 7) & 0xf8
                                                  : (t >> 8) & 0xf8);
            break;
          }
          default: {  // 24, 32: B, G, R
            const uint8_t* s = p_ + static_cast<size_t>(x) * (bpp / 8);
            o[0] = s[2], o[1] = s[1], o[2] = s[0];
          }
        }
      }
    }
    return kOk;
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  int w_, h_;
  bool bottom_up_;
  const uint8_t* pal_;
  uint8_t* out_;
  int x_ = 0, y_ = 0;  // the RLE position, rows in file order

  uint8_t* row(int y) {
    return out_ + static_cast<size_t>(bottom_up_ ? h_ - 1 - y : y) * w_ * 3;
  }
  void index(uint8_t* o, int i) { std::memcpy(o, pal_ + i * 3, 3); }

  bool byte(int* v) {
    if (p_ >= end_) return false;
    *v = *p_++;
    return true;
  }

  // FillUniColor: `count` pixels of palette entry `i` from the position
  // on, to the next row at each row's end; stops past the last row.
  void fill(int64_t count, int i) {
    do {
      const int64_t end = std::min<int64_t>(x_ + count, w_);
      count -= end - x_;
      for (; x_ < end; ++x_) index(row(y_) + x_ * 3, i);
      if (x_ >= w_) {
        x_ = 0;
        if (++y_ >= h_) break;
      }
    } while (count > 0);
  }

  // BmpDecoder::readData's BMP_RLE8 / BMP_RLE4 loops. A run past the row's
  // end is corrupt (decode_rle*_bad: cv2.imread returns nothing), as is
  // data that ends before the end-of-bitmap escape.
  int read_rle(int rle) {
    bool line_end_flag = false;  // RLE8: the last run closed its row
    for (;;) {
      int len, code;
      if (!byte(&len) || !byte(&code)) return kCorrupt;
      if (len) {  // encoded mode
        if (x_ + len > w_) return kCorrupt;
        if (rle == 8) {
          const int prev = y_;
          fill(len, code);
          line_end_flag = y_ != prev;
          if (y_ >= h_) break;
        } else {
          const int c[2] = {code >> 4, code & 15};
          for (int k = 0; k < len; ++k, ++x_) {
            index(row(y_) + x_ * 3, c[k & 1]);
          }
        }
      } else if (code > 2) {  // absolute mode, padded to 16 bits
        if (x_ + code > w_) return kCorrupt;
        const int sz = rle == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
        if (end_ - p_ < sz) return kCorrupt;
        for (int k = 0; k < code; ++k, ++x_) {
          index(row(y_) + x_ * 3,
                rle == 8 ? p_[k] : (p_[k >> 1] >> ((k & 1) ? 0 : 4)) & 15);
        }
        p_ += sz;
        line_end_flag = false;
      } else {  // 0 end of line, 1 end of bitmap, 2 delta
        int64_t dx = w_ - x_, dy = h_ - y_;
        if (rle == 4 || code || !line_end_flag || dx < w_) {
          if (code == 2) {
            int a, b;
            if (!byte(&a) || !byte(&b)) return kCorrupt;
            dx = a, dy = b;
          }
          if (y_ >= h_) break;
          // RLE8 fills past the rows a delta or the end of the bitmap
          // skips; RLE4 fills only to the row's end (or dx): its end of
          // bitmap acts as an end of line, and a delta ignores dy
          fill(rle == 8 && code ? dx + dy * w_ : dx, 0);
          if (y_ >= h_) break;
        }
        line_end_flag = false;
        if (y_ >= h_) break;
      }
    }
    return kOk;
  }
};

// ---------------------------------------------------------------- LZW

constexpr int kLzwClear = 256, kLzwEoi = 257, kLzwFirst = 258;
constexpr int kLzwMaxBits = 12;
// tif_lzw.c CSIZE: the decoder's table, past the 4096 entries a 12-bit
// code reaches; when it fills without a Clear, the next code fails
constexpr int kLzwTable = (1 << kLzwMaxBits) - 1 + 1024;

// TIFF LZW stream -> at most `cap` bytes into dst, as tif_lzw.c
// LZWDecode (libtiff 4.7) decodes it: a stream that starts without a
// Clear, a code not yet in the table, a full table, data that end without
// EOI, or an EOI before `cap` bytes fail. Returns the bytes written; where
// it fails, *failed is set and the bytes after those decoded are zero.
inline int64_t lzw_decode(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t cap, bool* failed) {
  std::vector<int> prefix(kLzwTable), length(kLzwTable);
  std::vector<uint8_t> suffix(kLzwTable), first(kLzwTable);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1, suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  size_t out = 0, pos = 0;
  uint64_t acc = 0;  // bits not yet taken, MSB first, `have` of them
  int have = 0;
  // next: the free entry; -1 before the first Clear and once the table
  // is full (LZWPreDecode's dec_free_entp = dec_codetab - 1)
  int nbits = 9, next = -1, prev = -1;
  auto fail = [&]() {
    std::memset(dst + out, 0, cap - out);
    *failed = true;
    return static_cast<int64_t>(out);
  };
  for (;;) {
    while (have < nbits && pos < n) {
      acc = (acc << 8) | src[pos++];
      have += 8;
    }
    if (have < nbits) return fail();  // "not terminated with EOI code"
    const int code = static_cast<int>((acc >> (have - nbits)) &
                                      ((1u << nbits) - 1));
    have -= nbits;
    if (code == kLzwEoi) break;
    if (code == kLzwClear) {
      nbits = 9, next = kLzwFirst, prev = -1;
      continue;
    }
    int entry;
    if (prev < 0) {  // the first code after a Clear
      if (next < 0 || code > 255) return fail();
      entry = code;
    } else {
      if (next < 0 || code > next) return fail();  // not yet in the table
      // the new entry: prev + the first byte of code's string (of prev's
      // own where code is the entry being made)
      prefix[next] = prev;
      suffix[next] = code == next ? first[prev] : first[code];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      entry = code;
      ++next;
      if (next >= (1 << nbits) - 1 && nbits < kLzwMaxBits) ++nbits;
      if (next >= kLzwTable) next = -1;
    }
    const int len = length[entry];
    if (out + len > cap) {  // more data than the strip holds: keep what fits
      std::vector<uint8_t> tmp(len);
      for (int e = entry, k = len - 1; k >= 0; e = prefix[e], --k) {
        tmp[k] = suffix[e];
      }
      std::memcpy(dst + out, tmp.data(), cap - out);
      return static_cast<int64_t>(cap);
    }
    for (int e = entry, k = len - 1; k >= 0; e = prefix[e], --k) {
      dst[out + k] = suffix[e];
    }
    out += len;
    prev = code;
    if (out == cap) return static_cast<int64_t>(out);
  }
  if (out < cap) *failed = true;  // "Not enough data at scanline"
  return static_cast<int64_t>(out);
}

// n bytes -> a TIFF LZW stream (Clear first, a Clear whenever the table
// fills, EOI last), appended to `dst`.
inline void lzw_encode(const uint8_t* src, size_t n,
                       std::vector<uint8_t>* dst) {
  uint64_t acc = 0;
  int acc_bits = 0, nbits = 9, next = kLzwFirst;
  auto put = [&](int code) {
    acc = (acc << nbits) | static_cast<uint64_t>(code);
    acc_bits += nbits;
    while (acc_bits >= 8) {
      dst->push_back(static_cast<uint8_t>(acc >> (acc_bits - 8)));
      acc_bits -= 8;
    }
  };
  // (prefix code, byte) -> code; a flat table per prefix
  std::vector<int16_t> table(static_cast<size_t>(1 << kLzwMaxBits) * 256, -1);
  auto grow = [&]() {  // after a new entry: tif_lzw.c LZWEncode
    if (++next == (1 << kLzwMaxBits) - 2) {
      put(kLzwClear);
      std::fill(table.begin(), table.end(), -1);
      next = kLzwFirst;
      nbits = 9;
    } else if (next > (1 << nbits) - 1) {
      ++nbits;
    }
  };
  put(kLzwClear);
  if (n) {
    int ent = src[0];
    for (size_t i = 1; i < n; ++i) {
      const int c = src[i];
      int16_t& slot = table[static_cast<size_t>(ent) * 256 + c];
      if (slot >= 0) {
        ent = slot;
        continue;
      }
      put(ent);
      slot = static_cast<int16_t>(next);
      ent = c;
      grow();
    }
    put(ent);
    grow();  // LZWPostEncode counts the last code as an entry
  }
  put(kLzwEoi);
  if (acc_bits) dst->push_back(static_cast<uint8_t>(acc << (8 - acc_bits)));
}

// PackBits -> at most `cap` bytes, as tif_packbits.c PackBitsDecode: a
// run the data cut short is dropped whole; fewer than `cap` bytes fail
// (*failed) with zeros after. Returns the bytes written.
inline int64_t packbits_decode(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t cap, bool* failed) {
  size_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = static_cast<int8_t>(src[i++]);
    if (c >= 0) {
      const size_t k = std::min<size_t>(static_cast<size_t>(c) + 1,
                                        cap - out);
      if (n - i < k) break;  // "Terminating ... due to lack of data"
      std::memcpy(dst + out, src + i, k);
      i += k;
      out += k;
    } else if (c != -128) {
      if (i >= n) break;
      const size_t k = std::min<size_t>(1 - c, cap - out);
      std::memset(dst + out, src[i++], k);
      out += k;
    }
  }
  if (out < cap) {
    std::memset(dst + out, 0, cap - out);
    *failed = true;
  }
  return static_cast<int64_t>(out);
}

// ---------------------------------------------------------------- CCITT

// TIFF's CCITT codecs as libtiff's tif_fax3.c decodes them: modified
// Huffman (Compression 2, rows byte-aligned; 32771, rows aligned to 16-bit
// words), T.4 Group 3 one- and two-dimensional (3) and T.6 Group 4 (4).
// The decoder keeps libtiff's recovery from damaged data: a bad code word
// ends the row (its pixels to the end white), a row that runs long is cut,
// a short one filled white, and at the end of the data the partial row is
// kept and the rows after it are left as they were (white). Code tables
// are T.4's (tables 1-4), indexed by the next 7, 12 or 13 bits taken
// least significant bit first, as libtiff's mkg3states builds them.
namespace fax {

enum State : uint8_t {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW,
  kMakeUpB, kMakeUp, kEol
};

struct Ent {
  uint8_t state = kNull, width = 0;
  uint16_t param = 0;
};

struct Code {
  const char* bits;  // MSB first, as the standard prints it
  int param;
};

// T.4 table 1: terminating codes, white then black (run 0-63)
constexpr const char* kTermWhite[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
constexpr const char* kTermBlack[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
// T.4 table 2: make-up codes of 64-1728, white then black
constexpr const char* kMakeWhite[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
constexpr const char* kMakeBlack[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
// T.4 table 3: make-up codes of 1792-2560, either colour
constexpr const char* kMakeBoth[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

struct Tables {
  Ent main[1 << 7], white[1 << 12], black[1 << 13];

  // mkg3states.c FillTable: every index whose low `len` bits are the code
  // (least significant bit first) decodes to it
  static void fill(Ent* t, int size, const char* bits, int state,
                   int param) {
    const int len = static_cast<int>(std::strlen(bits));
    int code = 0;
    for (int i = 0; i < len; ++i) code |= (bits[i] == '1') << i;
    for (int c = code; c < (1 << size); c += 1 << len) {
      t[c].state = static_cast<uint8_t>(state);
      t[c].width = static_cast<uint8_t>(len);
      t[c].param = static_cast<uint16_t>(param);
    }
  }

  Tables() {
    // T.4 table 4 (two-dimensional modes); 7 zero bits begin an EOL
    fill(main, 7, "0001", kPass, 0);
    fill(main, 7, "001", kHoriz, 0);
    fill(main, 7, "1", kV0, 0);
    fill(main, 7, "011", kVR, 1);
    fill(main, 7, "000011", kVR, 2);
    fill(main, 7, "0000011", kVR, 3);
    fill(main, 7, "010", kVL, 1);
    fill(main, 7, "000010", kVL, 2);
    fill(main, 7, "0000010", kVL, 3);
    fill(main, 7, "0000001", kExt, 0);
    fill(main, 7, "0000000", kEol, 0);
    for (int i = 0; i < 27; ++i) {
      fill(white, 12, kMakeWhite[i], kMakeUpW, 64 * (i + 1));
      fill(black, 13, kMakeBlack[i], kMakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      fill(white, 12, kMakeBoth[i], kMakeUp, 1792 + 64 * i);
      fill(black, 13, kMakeBoth[i], kMakeUp, 1792 + 64 * i);
    }
    for (int i = 0; i < 64; ++i) {
      fill(white, 12, kTermWhite[i], kTermW, i);
      fill(black, 13, kTermBlack[i], kTermB, i);
    }
    // 11 zero bits: an EOL, of which only the zeros are taken
    fill(white, 12, "00000000000", kEol, 0);
    fill(black, 13, "00000000000", kEol, 0);
  }
};

inline const Tables& tables() {
  static const Tables t;
  return t;
}

enum Scheme { kRle = 2, kG3 = 3, kG4 = 4, kRleW = 32771 };

// One strip or tile: `rows` rows of `width` pixels, `row_bytes` apart,
// into out (MSB first, 1 = black as stored: the photometric maps it).
// `msb_first`: FillOrder 1. `g3_2d`: Group3Options bit 0. `word_base`:
// the file offset of the data (RLEW aligns to words of the file).
// The image's state that outlives a chunk, as libtiff's codec state does:
// `no_eol`, Group 3 data without EOLs (the first chunk found to lack them
// sets it for every chunk after it), and the run arrays, whose entries
// past a row's runs a later row's reference line may reach.
struct ImageState {
  bool no_eol = false;
  std::vector<uint32_t> runs;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n, int scheme, bool msb_first,
          bool g3_2d, uint64_t word_base, int width, ImageState* state)
      : cp_(data), ep_(data + n), base_(data), word_base_(word_base),
        scheme_(scheme), msb_(msb_first), two_d_(scheme == kG4 || g3_2d),
        lastx_(width), no_eol_(&state->no_eol) {
    // tif_fax3.c Fax3SetupState: nruns = roundup(width + 1, 32), twice
    // that with a reference line; two arrays of nruns, zeroed, once per
    // image
    nruns_ = ((width + 1 + 31) / 32) * 32 * (two_d_ ? 2 : 1);
    if (state->runs.empty()) {
      state->runs.assign(static_cast<size_t>(nruns_) * 2 + 2, 0);
    }
    cur_ = state->runs.data();
    if (two_d_) {  // Fax3PreDecode: the reference line starts white
      ref_ = cur_ + nruns_;
      ref_[0] = static_cast<uint32_t>(width);
      ref_[1] = 0;
    }
  }

  void decode(uint8_t* out, int rows, size_t row_bytes) {
    for (int y = 0; y < rows; ++y) {
      uint8_t* row = out + static_cast<size_t>(y) * row_bytes;
      a0_ = 0;
      run_ = 0;
      pa_ = this_ = cur_;
      int st;
      if (scheme_ == kG4) {
        pb_ = ref_;
        b1_ = static_cast<int>(*pb_++);
        st = expand2d();
        if (st == kFatal) return;
        if (st == kEof || eolcnt_) {  // EOFB, or the data ended
          fill_row(row);
          return;
        }
        fill_row(row);
        if (setvalue(0) == kFatal) return;
        std::swap(cur_, ref_);
        continue;
      }
      if (scheme_ == kRle || scheme_ == kRleW) {
        st = expand1d();
        if (st == kFatal) return;
        fill_row(row);
        if (st == kEof) return;
        if (scheme_ == kRle) {
          clear(avail_ % 8);
        } else {
          clear(avail_ % 16);
          if (avail_ == 0 && ((word_base_ + (cp_ - base_)) & 1)) ++cp_;
        }
        continue;
      }
      // Group 3: an EOL before every row, then (2-D) the row's tag bit.
      // Data that ends while zeros are skipped past an EOL has none:
      // libtiff then reads the chunk again from its start without EOLs,
      // and so every chunk after it
      bool synced = true;
      if (!*no_eol_) {
        const int r = sync_eol();
        if (r == kNoEol) {
          *no_eol_ = true;
          cp_ = base_;
          acc_ = 0;
          avail_ = 0;
          eolcnt_ = 0;
        } else {
          synced = r == kDone;
        }
      }
      if (!synced || (two_d_ && !need8(1))) {
        if (cleanup() == kFatal) return;
        fill_row(row);
        return;
      }
      bool one_d = true;
      if (two_d_) {
        one_d = bits(1);
        clear(1);
        pb_ = ref_;
        b1_ = static_cast<int>(*pb_++);
      }
      st = one_d ? expand1d() : expand2d();
      if (st == kFatal) return;
      fill_row(row);
      if (st == kEof) return;
      if (two_d_) {
        if (pa_ < this_ + nruns_ && setvalue(0) == kFatal) return;
        std::swap(cur_, ref_);
      }
    }
  }

 private:
  enum Result { kDone, kEof, kFatal };

  const uint8_t* cp_;
  const uint8_t* ep_;
  const uint8_t* base_;
  uint64_t word_base_;
  int scheme_;
  bool msb_, two_d_;
  int lastx_, nruns_ = 0;
  uint32_t acc_ = 0;
  int avail_ = 0, eolcnt_ = 0;
  bool* no_eol_;
  int a0_ = 0, run_ = 0, b1_ = 0;
  uint32_t* cur_ = nullptr;
  uint32_t* ref_ = nullptr;
  uint32_t* this_ = nullptr;
  uint32_t* pa_ = nullptr;
  uint32_t* pb_ = nullptr;

  uint32_t next_byte() {
    const uint8_t b = *cp_++;
    if (!msb_) return b;
    uint32_t r = 0;
    for (int i = 0; i < 8; ++i) r |= ((b >> i) & 1u) << (7 - i);
    return r;
  }

  // NeedBits8 / NeedBits16: false when no valid bit is left; at the end
  // of the data what is left is padded with zeros
  bool need8(int n) {
    if (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) return false;
        avail_ = n;
      } else {
        acc_ |= next_byte() << avail_;
        avail_ += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) return false;
        avail_ = n;
      } else {
        acc_ |= next_byte() << avail_;
        if ((avail_ += 8) < n) {
          if (cp_ >= ep_) {
            avail_ = n;
          } else {
            acc_ |= next_byte() << avail_;
            avail_ += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t bits(int n) const { return acc_ & ((1u << n) - 1); }
  void clear(int n) {
    avail_ -= n;
    acc_ >>= n;
  }
  bool lookup(int width, const Ent* table, const Ent** e, bool sixteen) {
    if (!(sixteen ? need16(width) : need8(width))) return false;
    *e = table + bits(width);
    clear((*e)->width);
    return true;
  }

  int setvalue(int x) {
    if (pa_ >= this_ + nruns_) return kFatal;  // "Buffer overflow"
    *pa_++ = static_cast<uint32_t>(run_ + x);
    a0_ += x;
    run_ = 0;
    return kDone;
  }

  // CLEANUP_RUNS: the row's runs made to cover exactly its width
  int cleanup() {
    if (run_ && setvalue(0) == kFatal) return kFatal;
    if (a0_ != lastx_) {
      while (a0_ > lastx_ && pa_ > this_) a0_ -= static_cast<int>(*--pa_);
      if (a0_ < lastx_) {
        if (a0_ < 0) a0_ = 0;
        if (((pa_ - this_) & 1) && setvalue(0) == kFatal) return kFatal;
        if (setvalue(lastx_ - a0_) == kFatal) return kFatal;
      } else if (a0_ > lastx_) {
        if (setvalue(lastx_) == kFatal || setvalue(0) == kFatal) {
          return kFatal;
        }
      }
    }
    return kDone;
  }

  int finish(int result) {
    if (cleanup() == kFatal) return kFatal;
    return result;
  }

  // SYNC_EOL: skip to just past the next EOL. kEof where the data ends
  // in the search for its zeros, kNoEol where it ends in the zeros after
  enum { kNoEol = 3 };
  int sync_eol() {
    if (eolcnt_ == 0) {
      for (;;) {
        if (!need16(11)) return kEof;
        if (bits(11) == 0) break;
        clear(1);
      }
    }
    for (;;) {
      if (!need8(8)) return kNoEol;
      if (bits(8)) break;
      clear(8);
    }
    while (bits(1) == 0) clear(1);
    clear(1);
    eolcnt_ = 0;
    return kDone;
  }

  // one colour's run: make-up codes then a terminating code. kDone with
  // `term` when it ended, else the row ends (EOL, bad code) or the data
  enum Run { kRunTerm, kRunEol, kRunBad, kRunEof, kRunFatal };
  int colour_run(bool white) {
    const Tables& t = tables();
    for (;;) {
      const Ent* e;
      if (!lookup(white ? 12 : 13, white ? t.white : t.black, &e, true)) {
        return kRunEof;
      }
      if (e->state == kEol) return kRunEol;
      if (e->state == (white ? kTermW : kTermB)) {
        return setvalue(e->param) == kFatal ? kRunFatal : kRunTerm;
      }
      if (e->state == (white ? kMakeUpW : kMakeUpB) || e->state == kMakeUp) {
        a0_ += e->param;
        run_ += e->param;
        continue;
      }
      return kRunBad;
    }
  }

  // EXPAND1D
  int expand1d() {
    for (;;) {
      for (int colour = 0; colour < 2; ++colour) {
        const int r = colour_run(colour == 0);
        if (r == kRunFatal) return kFatal;
        if (r == kRunEof) return finish(kEof);
        if (r == kRunEol) {
          eolcnt_ = 1;
          return finish(kDone);
        }
        if (r == kRunBad) return finish(kDone);
        if (a0_ >= lastx_) return finish(kDone);
      }
      if (pa_[-1] == 0 && pa_[-2] == 0) pa_ -= 2;
    }
  }

  // CHECK_b1: b1 to the first change on the reference line past a0
  bool check_b1() {
    if (pa_ != this_) {
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_ + nruns_) return false;
        b1_ += static_cast<int>(pb_[0] + pb_[1]);
        pb_ += 2;
      }
    }
    return true;
  }

  // EXPAND2D
  int expand2d() {
    const Tables& t = tables();
    while (a0_ < lastx_) {
      if (pa_ >= this_ + nruns_) return kFatal;
      const Ent* e;
      if (!lookup(7, t.main, &e, false)) return finish(kEof);
      switch (e->state) {
        case kPass:
          if (!check_b1() || pb_ + 1 >= ref_ + nruns_) return kFatal;
          b1_ += static_cast<int>(*pb_++);
          run_ += b1_ - a0_;
          a0_ = b1_;
          b1_ += static_cast<int>(*pb_++);
          break;
        case kHoriz: {
          const bool black_first = (pa_ - this_) & 1;
          for (int k = 0; k < 2; ++k) {
            const int r = colour_run(black_first == (k == 1));
            if (r == kRunFatal) return kFatal;
            if (r == kRunEof) return finish(kEof);
            if (r != kRunTerm) return finish(kDone);  // bad code (EOL too)
          }
          if (!check_b1()) return kFatal;
          break;
        }
        case kV0:
        case kVR:
          if (!check_b1()) return kFatal;
          if (setvalue(b1_ - a0_ + (e->state == kVR ? e->param : 0)) ==
              kFatal) {
            return kFatal;
          }
          if (pb_ >= ref_ + nruns_) return kFatal;
          b1_ += static_cast<int>(*pb_++);
          break;
        case kVL:
          if (!check_b1()) return kFatal;
          if (b1_ < a0_ + e->param) return finish(kDone);
          if (setvalue(b1_ - a0_ - e->param) == kFatal) return kFatal;
          b1_ -= static_cast<int>(*--pb_);
          break;
        case kExt:
          *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
          return finish(kDone);
        case kEol:
          *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
          if (!need8(4)) return finish(kEof);
          clear(4);
          eolcnt_ = 1;
          return finish(kDone);
        default:
          return finish(kDone);
      }
    }
    if (run_) {
      if (run_ + a0_ < lastx_) {  // expect a final V0
        if (!need8(1)) return finish(kEof);
        if (!bits(1)) return finish(kDone);
        clear(1);
      }
      if (setvalue(0) == kFatal) return kFatal;
    }
    return finish(kDone);
  }

  // _TIFFFax3fillruns: white runs clear bits, black runs set them; runs
  // past the width are cut in place (the next row's reference sees that)
  void fill_row(uint8_t* buf) {
    uint32_t* runs = this_;
    uint32_t* erun = pa_;
    const uint32_t lastx = static_cast<uint32_t>(lastx_);
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
      for (int c = 0; c < 2; ++c) {
        uint32_t run = runs[c];
        if (x + run > lastx || run > lastx) run = runs[c] = lastx - x;
        for (uint32_t i = 0; i < run; ++i, ++x) {
          const uint8_t bit = static_cast<uint8_t>(0x80 >> (x & 7));
          if (c) {
            buf[x >> 3] |= bit;
          } else {
            buf[x >> 3] &= static_cast<uint8_t>(~bit);
          }
        }
      }
    }
  }
};

}  // namespace fax

// ---------------------------------------------------------- ThunderScan

// tif_thunder.c ThunderDecodeRow: `rows` rows of `width` 4-bit pixels,
// `row_bytes` apart, from one strip. Each byte is a run of the last pixel
// (its low 6 bits the count), three 2-bit or two 3-bit deltas, or a raw
// pixel (a run past the row's end writes nothing). A row whose data ends
// early, or whose run overshoots it, ends the strip: from the byte being
// filled on, the row is zeroed, and the rows after it are left as they
// are (zero).
inline void thunder_decode(const uint8_t* src, size_t n, uint8_t* out,
                           int rows, size_t row_bytes, int width) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const uint8_t* bp = src;
  size_t cc = n;
  for (int y = 0; y < rows; ++y) {
    uint8_t* op = out + static_cast<size_t>(y) * row_bytes;
    const int64_t maxpixels = width;
    int64_t npixels = 0;
    unsigned lastpixel = 0;
    auto set = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1) {
          *op++ |= static_cast<uint8_t>(lastpixel);
        } else {
          op[0] = static_cast<uint8_t>(lastpixel << 4);
        }
      }
    };
    while (cc > 0 && npixels < maxpixels) {
      int c = *bp++;
      --cc;
      switch (c & 0xc0) {
        case 0x00: {  // a run of the last pixel
          int k = c;
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(lastpixel);
            lastpixel = *op++;
            ++npixels;
            --k;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels <= maxpixels) {
            for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(lastpixel);
          }
          if (k == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        }
        case 0x40:  // three 2-bit deltas, 2 skips
          for (int sh = 4; sh >= 0; sh -= 2) {
            const int d = (c >> sh) & 3;
            if (d != 2) set(static_cast<unsigned>(lastpixel + two[d]));
          }
          break;
        case 0x80:  // two 3-bit deltas, 4 skips
          for (int sh = 3; sh >= 0; sh -= 3) {
            const int d = (c >> sh) & 7;
            if (d != 4) set(static_cast<unsigned>(lastpixel + three[d]));
          }
          break;
        default:  // a raw pixel
          set(static_cast<unsigned>(c));
      }
    }
    if (npixels != maxpixels) {  // libtiff zeroes the rest of the row
      uint8_t* end = out + static_cast<size_t>(y) * row_bytes +
                     (maxpixels + 1) / 2;
      if (op < end) std::memset(op, 0, static_cast<size_t>(end - op));
      return;
    }
  }
}

// ------------------------------------------------------------- SGILog

// tif_luv.c as libtiff's RGBA interface drives it: SGILOGDATAFMT_8BIT, so
// a LogL pixel decodes to one grey byte (L16toGry) and a LogLuv pixel to
// three RGB bytes (Luv32toRGB, Luv24toRGB), in double as libtiff computes
// them. Rows are decoded one by one from the chunk's bytes (LogL16Decode,
// LogLuvDecode32: a run-length byte plane per byte of the pixel, high byte
// first; LogLuvDecode24: three bytes a pixel). A row whose data run out
// ends the chunk: it and the rows after it stay zero.

enum SgiLogKind { kLogL16 = 1, kLogLuv32 = 2, kLogLuv24 = 3 };

namespace sgilog {

// uvcode.h's uv_row (ustart, nus, ncum) of libtiff 4.7.1: the (u', v')
// cells of LogLuv24's 14-bit colour index
struct UvRow {
  float ustart;
  int16_t nus, ncum;
};
constexpr int kUvNvs = 163, kUvNdivs = 16289;
constexpr float kUvSqsiz = 0.0035f, kUvVstart = 0.01694f;
constexpr double kUNeu = 0.210526316, kVNeu = 0.473684211;
constexpr double kLn2 = 0.69314718055994530942;  // M_LN2
constexpr double kUvScale = 410.;
inline const UvRow* uv_row() {
  static const UvRow rows[kUvNvs] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10},
    {0.237874f, 9, 17}, {0.235906f, 10, 26}, {0.232153f, 12, 36},
    {0.228352f, 14, 48}, {0.226259f, 15, 62}, {0.222371f, 17, 77},
    {0.22041f, 18, 94}, {0.21471f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204},
    {0.199245f, 29, 231}, {0.195525f, 31, 260}, {0.19356f, 32, 291},
    {0.189878f, 34, 323}, {0.186216f, 36, 357}, {0.186216f, 36, 393},
    {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637},
    {0.168612f, 46, 683}, {0.163575f, 49, 729}, {0.158642f, 52, 778},
    {0.158642f, 52, 830}, {0.158642f, 52, 882}, {0.153815f, 55, 934},
    {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284},
    {0.13827f, 65, 1346}, {0.13827f, 65, 1411}, {0.13827f, 65, 1476},
    {0.132166f, 69, 1541}, {0.132166f, 69, 1610}, {0.126204f, 73, 1679},
    {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129},
    {0.112962f, 82, 2206}, {0.112962f, 82, 2288}, {0.112962f, 82, 2370},
    {0.10745f, 86, 2452}, {0.10745f, 86, 2538}, {0.10745f, 86, 2624},
    {0.10745f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164},
    {0.095126f, 95, 3259}, {0.095126f, 95, 3354}, {0.088276f, 100, 3449},
    {0.088276f, 100, 3549}, {0.088276f, 100, 3649}, {0.088276f, 100, 3749},
    {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379},
    {0.074861f, 110, 4489}, {0.074861f, 110, 4599}, {0.06829f, 115, 4709},
    {0.06829f, 115, 4824}, {0.06829f, 115, 4939}, {0.06829f, 115, 5054},
    {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769},
    {0.057219f, 124, 5893}, {0.057219f, 124, 6017}, {0.050985f, 129, 6141},
    {0.050985f, 129, 6270}, {0.050985f, 129, 6399}, {0.050985f, 129, 6528},
    {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322},
    {0.040571f, 138, 7460}, {0.040571f, 138, 7598}, {0.040571f, 138, 7736},
    {0.036339f, 142, 7874}, {0.036339f, 142, 8016}, {0.036339f, 142, 8158},
    {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026},
    {0.027947f, 150, 9176}, {0.027947f, 150, 9326}, {0.023739f, 154, 9476},
    {0.023739f, 154, 9630}, {0.023739f, 154, 9784}, {0.023739f, 154, 9938},
    {0.019504f, 158, 10092}, {0.019504f, 158, 10250},
    {0.019504f, 158, 10408}, {0.016976f, 161, 10566},
    {0.016976f, 161, 10727}, {0.016976f, 161, 10888},
    {0.016976f, 161, 11049}, {0.012639f, 165, 11210},
    {0.012639f, 165, 11375}, {0.012639f, 165, 11540},
    {0.009991f, 168, 11705}, {0.009991f, 168, 11873},
    {0.009991f, 168, 12041}, {0.009016f, 170, 12209},
    {0.009016f, 170, 12379}, {0.009016f, 170, 12549},
    {0.006217f, 173, 12719}, {0.006217f, 173, 12892},
    {0.005097f, 175, 13065}, {0.005097f, 175, 13240},
    {0.005097f, 175, 13415}, {0.003909f, 177, 13590},
    {0.003909f, 177, 13767}, {0.00234f, 177, 13944}, {0.002389f, 170, 14121},
    {0.001068f, 164, 14291}, {0.001653f, 157, 14455},
    {0.000717f, 150, 14612}, {0.001614f, 143, 14762}, {0.00027f, 136, 14905},
    {0.000484f, 129, 15041}, {0.001103f, 123, 15170},
    {0.001242f, 115, 15293}, {0.001188f, 109, 15408},
    {0.001011f, 103, 15517}, {0.000709f, 97, 15620}, {0.000301f, 89, 15717},
    {0.002416f, 82, 15806}, {0.003251f, 76, 15888}, {0.003246f, 69, 15964},
    {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.01049f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268}
  };
  return rows;
}

inline double logl16_to_y(int p16) {
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = std::exp(kLn2 / 256. * (le + .5) - kLn2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

inline double logl10_to_y(int p10) {
  if (p10 == 0) return 0.;
  return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

inline int uv_decode(double* up, double* vp, int c) {
  if (c < 0 || c >= kUvNdivs) return -1;
  const UvRow* rows = uv_row();
  int lower = 0, upper = kUvNvs;
  while (upper - lower > 1) {
    const int vi = (lower + upper) >> 1;
    const int ui = c - rows[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  const int vi = lower, ui = c - rows[vi].ncum;
  *up = rows[vi].ustart + (ui + .5) * kUvSqsiz;
  *vp = kUvVstart + (vi + .5) * kUvSqsiz;
  return 0;
}

inline uint8_t gamma2(double v) {
  return static_cast<uint8_t>(v <= 0. ? 0 : v >= 1. ? 255
                                             : static_cast<int>(256. * std::sqrt(v)));
}

// (L, u, v) -> XYZ as LogLuv32toXYZ / LogLuv24toXYZ end, then XYZtoRGB24
inline void luv_to_rgb(double l, double u, double v, uint8_t* rgb) {
  float xyz[3] = {0.f, 0.f, 0.f};
  if (l > 0.) {
    const double s = 1. / (6. * u - 16. * v + 12.);
    const double x = 9. * u * s, y = 4. * v * s;
    xyz[0] = static_cast<float>(x / y * l);
    xyz[1] = static_cast<float>(l);
    xyz[2] = static_cast<float>((1. - x - y) / y * l);
  }
  const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma2(r);
  rgb[1] = gamma2(g);
  rgb[2] = gamma2(b);
}

inline void luv32_to_rgb(uint32_t p, uint8_t* rgb) {
  const double l = logl16_to_y(static_cast<int32_t>(p) >> 16);
  const double u = 1. / kUvScale * ((p >> 8 & 0xff) + .5);
  const double v = 1. / kUvScale * ((p & 0xff) + .5);
  luv_to_rgb(l, u, v, rgb);
}

inline void luv24_to_rgb(uint32_t p, uint8_t* rgb) {
  const double l = logl10_to_y(p >> 14 & 0x3ff);
  double u = 0., v = 0.;
  if (l > 0. && uv_decode(&u, &v, static_cast<int>(p & 0x3fff)) < 0) {
    u = kUNeu;
    v = kVNeu;
  }
  luv_to_rgb(l, u, v, rgb);
}

}  // namespace sgilog

// `rows` rows of `width` pixels, `row_bytes` apart in `out`, from one
// SGILog chunk of `kind`.
inline void sgilog_decode(const uint8_t* src, size_t n, uint8_t* out,
                          int rows, size_t row_bytes, int width, int kind) {
  const uint8_t* bp = src;
  int64_t cc = static_cast<int64_t>(n);
  std::vector<uint32_t> tp(static_cast<size_t>(width));
  const int top = kind == kLogL16 ? 8 : 24;
  for (int y = 0; y < rows; ++y) {
    uint8_t* op = out + static_cast<size_t>(y) * row_bytes;
    const int64_t npixels = width;
    int64_t i = 0;
    if (kind == kLogLuv24) {
      for (; i < npixels && cc >= 3; ++i) {
        tp[i] = static_cast<uint32_t>(bp[0]) << 16 | bp[1] << 8 | bp[2];
        bp += 3;
        cc -= 3;
      }
      if (i != npixels) return;
      for (int64_t k = 0; k < npixels; ++k) {
        sgilog::luv24_to_rgb(tp[k], op + 3 * k);
      }
      continue;
    }
    std::fill(tp.begin(), tp.end(), 0u);
    for (int shft = top; shft >= 0; shft -= 8) {
      for (i = 0; i < npixels && cc > 0;) {
        if (*bp >= 128) {  // a run
          if (cc < 2) break;
          int rc = *bp++ + (2 - 128);
          const uint32_t b = static_cast<uint32_t>(*bp++) << shft;
          cc -= 2;
          while (rc-- && i < npixels) tp[i++] |= b;
        } else {  // literal bytes (a count of 0 is a no-op)
          int rc = *bp++;
          while (--cc && rc-- && i < npixels) {
            tp[i++] |= static_cast<uint32_t>(*bp++) << shft;
          }
        }
      }
      if (i != npixels) return;
    }
    for (int64_t k = 0; k < npixels; ++k) {
      if (kind == kLogL16) {
        const double v = sgilog::logl16_to_y(static_cast<int16_t>(tp[k]));
        op[k] = v <= 0. ? 0 : v >= 1. ? 255
                                      : static_cast<uint8_t>(
                                            static_cast<int>(256. * std::sqrt(v)));
      } else {
        sgilog::luv32_to_rgb(tp[k], op + 3 * k);
      }
    }
  }
}

// ---------------------------------------------------------------- TIFF

// Sample stage flags of tiff_decode
enum TiffFlags {
  kBigEndian = 1,    // 16-bit samples big-endian
  kPredictor = 2,    // Predictor 2 (horizontal differencing)
  kDiv257 = 4,       // 16-bit samples to 8 bits as (v + 128) / 257
  kRaw16 = 8,        // 16-bit samples kept whole: two bytes, low first
  kFaxMsbFirst = 16  // CCITT data of FillOrder 1
};

// The layout of a TIFF's first image. Chunks (strips or tiles) run plane
// by plane, then row by row of chunks, then across. Each holds `ch` rows
// (a strip at the image's foot fewer; a tile is whole) of `cw` pixels of
// `per_chunk` samples, `bits` each, rows padded to bytes. A YCbCr file
// stored subsampled (sub_h, sub_v > 0) holds blocks of sub_h x sub_v Y
// samples then Cb and Cr instead of rows of pixels.
struct TiffLayout {
  int w, h, cw, ch, tiled, planes, per_chunk, spp, bits, flags;
  int g3_2d;        // Group3Options bit 0
  int sub_h, sub_v;  // subsampled YCbCr blocks (0: pixels)
  // JPEG (Compression 7): the colour space libjpeg is asked for
  // (etjpeg::kYCbCr converts to RGB with libjpeg's default, fancy,
  // upsampling; etjpeg::kRaw keeps the components), and component 0's
  // sampling that libtiff expects (0: the first chunk's own, libtiff's
  // JPEGFixupTagsSubsampling)
  int jpeg_colour, jpeg_h, jpeg_v;
};

// YCbCr blocks of one chunk -> (rows, cw, 3) pixels of (Y, Cb, Cr), each
// pixel with its block's chroma (tif_getimage.c putcontig8bitYCbCr*tile:
// partial blocks at the right and at the foot are cut).
inline void ycbcr_unblock(const uint8_t* raw, const TiffLayout& L, int rows,
                          uint8_t* px) {
  const int bw = (L.cw + L.sub_h - 1) / L.sub_h;
  const int block = L.sub_h * L.sub_v + 2;
  for (int by = 0; by * L.sub_v < rows; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      const uint8_t* b =
          raw + (static_cast<size_t>(by) * bw + bx) * block;
      for (int j = 0; j < L.sub_v; ++j) {
        const int y = by * L.sub_v + j;
        if (y >= rows) break;
        for (int i = 0; i < L.sub_h; ++i) {
          const int x = bx * L.sub_h + i;
          if (x >= L.cw) break;
          uint8_t* o = px + (static_cast<size_t>(y) * L.cw + x) * 3;
          o[0] = b[j * L.sub_h + i];
          o[1] = b[block - 2];
          o[2] = b[block - 1];
        }
      }
    }
  }
}

// tif_predict.c on subsampled YCbCr: the decoded bytes `n` are cut into
// TIFFScanlineSize pieces (a block row's bytes over sub_v) and each is
// accumulated at a stride of 3 bytes (horAcc8), as if they were rows of
// pixels; where either does not divide, libtiff stops with the bytes as
// they are.
inline void ycbcr_predictor(uint8_t* raw, size_t n, const TiffLayout& L) {
  const size_t row = static_cast<size_t>((L.cw + L.sub_h - 1) / L.sub_h) *
                     (L.sub_h * L.sub_v + 2) / L.sub_v;
  if (row == 0 || n % row || row % 3) return;
  for (size_t o = 0; o < n; o += row) {
    for (size_t i = 3; i < row; ++i) {
      raw[o + i] = static_cast<uint8_t>(raw[o + i] + raw[o + i - 3]);
    }
  }
}

// One JPEG chunk (an abbreviated stream after `tables`, libtiff's
// JPEGPreDecode and JPEGDecode) -> px (rows, cw, per_chunk), as libjpeg
// gives it to libtiff; with px null only its headers are read and checked.
// kCorrupt where libtiff's checks fail or libjpeg refuses the stream's
// kind (cv2.imread then returns nothing).
inline int jpeg_chunk(const etjpeg::Decoder* tables, const uint8_t* src,
                      size_t n, const TiffLayout& L, int rows,
                      bool last_strip, int* want_h, int* want_v,
                      uint8_t* px) {
  etjpeg::Decoder d;
  if (tables) d.preload(*tables);
  d.forced_colour = L.jpeg_colour;
  const int st = d.read(src, n, px != nullptr);
  if (st != etjpeg::kOk || d.components() != L.per_chunk) return kCorrupt;
  if (*want_h == 0) {  // the first chunk decides
    *want_h = d.h_sampling(0);
    *want_v = d.v_sampling(0);
  }
  const bool taller_last = d.width == L.cw && d.height > rows &&
                           last_strip && !L.tiled;
  if (d.width > L.cw || (d.height > rows && !taller_last)) return kCorrupt;
  for (int c = 0; c < d.components(); ++c) {
    const int hw = c ? 1 : *want_h, vw = c ? 1 : *want_v;
    if (d.h_sampling(c) != hw || d.v_sampling(c) != vw) return kCorrupt;
  }
  const int out_c = L.jpeg_colour == etjpeg::kRaw ? d.components() : 3;
  if (out_c != L.per_chunk) return kCorrupt;
  if (!px) return kOk;
  const size_t stride = static_cast<size_t>(L.cw) * out_c;
  const size_t take = static_cast<size_t>(d.width) * out_c;
  d.output(1, [&](int y, const uint8_t* row) {
    if (y < rows) std::memcpy(px + y * stride, row, take);
  });
  return kOk;
}

// Every strip or tile of a TIFF's first image -> out (h, w, spp) bytes
// (two per sample with kRaw16). Chunk k is `counts[k]` bytes at
// `offsets[k]` of `data`, compressed by `compression`: 1 none, 8 Deflate
// (inflated by the caller; a count ~k: zlib failed after k bytes), 5 LZW,
// 32773 PackBits, 2 / 32771 CCITT modified Huffman, 3 Group 3, 4 Group 4,
// 32809 ThunderScan, 34676 SGILog (LogL with one sample per pixel, else
// LogLuv) and 34677 SGILog24, both decoded to 8-bit samples (`bits` 8),
// 7 JPEG (`tables`: the JPEGTables stream, or null), or 0 for a scheme
// libtiff has no decoder of (its samples stay zero, as libtiff's buffer
// does). CCITT never fails: damaged data decodes as libtiff decodes it.
// With `out` null, only what libtiff checks before it decodes a chunk is
// checked: that every chunk lies in the data, and a JPEG chunk's headers.
inline int tiff_decode(const uint8_t* data, size_t n, const int64_t* offsets,
                       const int64_t* counts, int nchunks, int compression,
                       const TiffLayout& L, const uint8_t* tables,
                       size_t ntables, uint8_t* out) {
  const bool raw16 = L.flags & kRaw16;
  const int ob = raw16 ? 2 : 1;  // output bytes per sample
  const bool ycc = L.sub_h > 0;
  const int across = (L.w + L.cw - 1) / L.cw;
  const int down = (L.h + L.ch - 1) / L.ch;
  if (nchunks < across * down * L.planes) return kCorrupt;
  // bytes of one row (a block row of sub_v rows for subsampled YCbCr)
  const size_t row_bytes =
      ycc ? static_cast<size_t>((L.cw + L.sub_h - 1) / L.sub_h) *
                (L.sub_h * L.sub_v + 2)
          : (static_cast<size_t>(L.cw) * L.per_chunk * L.bits + 7) / 8;
  const int rows_per_unit = ycc ? L.sub_v : 1;
  std::vector<uint8_t> raw(row_bytes * ((L.ch + rows_per_unit - 1) /
                                        rows_per_unit));
  const size_t px_row = static_cast<size_t>(L.cw) * L.per_chunk * ob;
  std::vector<uint8_t> px(static_cast<size_t>(L.ch) * px_row);
  etjpeg::Decoder jt;
  if (compression == 7 && tables &&
      jt.read_tables(tables, ntables) != etjpeg::kOk) {
    return kCorrupt;
  }
  int want_h = L.jpeg_h, want_v = L.jpeg_v;
  fax::ImageState fax_state;
  int k = 0;
  for (int plane = 0; plane < L.planes; ++plane) {
    for (int cy = 0; cy < down; ++cy) {
      for (int cx = 0; cx < across; ++cx, ++k) {
        const int rows = L.tiled ? L.ch : std::min(L.ch, L.h - cy * L.ch);
        // TIFFFillStrip: a chunk of no bytes, or past the file, fails
        // (Deflate's chunks come inflated, a count ~k marking a failure)
        const bool short_inflate = compression == 8 && counts[k] < 0;
        const int64_t stored = short_inflate ? ~counts[k] : counts[k];
        if (offsets[k] < 0 || stored < 0 || (stored == 0 && !short_inflate) ||
            static_cast<uint64_t>(offsets[k]) + stored > n) {
          return kCorrupt;
        }
        const uint8_t* src = data + offsets[k];
        const size_t count = static_cast<size_t>(stored);
        if (!out) {
          if (compression != 7) continue;
          const int st = jpeg_chunk(tables ? &jt : nullptr, src, count, L,
                                    rows, cy == down - 1, &want_h, &want_v,
                                    nullptr);
          if (st != kOk) return st;
          continue;
        }
        if (compression == 7) {
          std::fill(px.begin(), px.end(), 0);
          const int st = jpeg_chunk(tables ? &jt : nullptr, src, count, L,
                                    rows, cy == down - 1, &want_h, &want_v,
                                    px.data());
          if (st != kOk) return st;
        } else {
          const int units = (rows + rows_per_unit - 1) / rows_per_unit;
          const size_t need = row_bytes * units;
          // a strip of subsampled YCbCr is read as rows rounded up to
          // whole blocks times TIFFScanlineSize (a block row's bytes over
          // sub_v, rounded down): the bytes past that stay zero
          const size_t limit =
              ycc && !L.tiled
                  ? std::min(need, static_cast<size_t>(units) * L.sub_v *
                                       (row_bytes / L.sub_v))
                  : need;
          std::fill(raw.begin(), raw.begin() + need, 0);
          // a strip whose decode fails is put as it decoded, zeros after
          // (TIFFReadRGBAStrip runs with stop_on_error 0), and without
          // the predictor, which libtiff applies after a decode succeeds
          bool failed = false;
          if (compression == 1 || compression == 8) {
            // none (DumpModeDecode: too few bytes decode nothing), or
            // Deflate inflated by the caller (a count ~k: zlib failed
            // after k bytes, ZIPDecode keeping them)
            failed = short_inflate || count < limit;
            if (compression == 8 || count >= limit) {
              std::memcpy(raw.data(), src, std::min(count, limit));
            }
          } else if (compression == 5) {
            lzw_decode(src, count, raw.data(), limit, &failed);
          } else if (compression == 32773) {
            packbits_decode(src, count, raw.data(), limit, &failed);
          } else if (compression == 2 || compression == 3 ||
                     compression == 4 || compression == 32771) {
            fax::Decoder(src, count, compression, L.flags & kFaxMsbFirst,
                         L.g3_2d != 0, static_cast<uint64_t>(offsets[k]),
                         L.cw, &fax_state)
                .decode(raw.data(), rows, row_bytes);
          } else if (compression == 32809) {
            thunder_decode(src, count, raw.data(), rows, row_bytes, L.w);
          } else if (compression == 34676 || compression == 34677) {
            sgilog_decode(src, count, raw.data(), rows, row_bytes, L.cw,
                          compression == 34677 ? kLogLuv24
                          : L.per_chunk == 1  ? kLogL16
                                              : kLogLuv32);
          } else if (compression != 0) {
            return kArgs;
          }
          const bool predict = (L.flags & kPredictor) && !failed;
          if (ycc) {
            if (predict) ycbcr_predictor(raw.data(), limit, L);
            ycbcr_unblock(raw.data(), L, rows, px.data());
          } else {
            const int st = unpack_rows(
                raw.data(), rows, row_bytes, L.cw, L.per_chunk, L.bits,
                L.flags & kBigEndian, predict,
                raw16 ? kRaw16Bytes
                      : (L.flags & kDiv257) ? kDiv257Round : kHighByte,
                px.data(), px_row);
            if (st != kOk) return st;
          }
        }
        const int y0 = cy * L.ch, x0 = cx * L.cw;
        const int y1 = std::min(y0 + rows, L.h), x1 = std::min(x0 + L.cw, L.w);
        const size_t pix = static_cast<size_t>(L.spp) * ob;
        for (int y = y0; y < y1; ++y) {
          const uint8_t* s = px.data() + static_cast<size_t>(y - y0) * px_row;
          uint8_t* o = out + (static_cast<size_t>(y) * L.w + x0) * pix;
          if (L.per_chunk == L.spp) {
            std::memcpy(o, s, static_cast<size_t>(x1 - x0) * pix);
          } else {
            for (int x = 0; x < x1 - x0; ++x) {
              std::memcpy(o + x * pix + plane * ob, s + x * ob, ob);
            }
          }
        }
      }
    }
  }
  return kOk;
}

// ----------------------------------------------------- TIFF colour spaces

// tif_color.c TIFFYCbCrToRGBInit: the tables of the YCbCr -> RGB
// conversion for YCbCrCoefficients `luma` and ReferenceBlackWhite `rbw`,
// with libtiff's float and fixed-point roundings.
struct YCbCrTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];

  static int32_t fix(float x) {  // FIX(x): (x) * (1L << 16) + 0.5
    return static_cast<int32_t>(static_cast<double>(x * 65536.0f) + 0.5);
  }
  static float clamp2(float f) { return f < 0.0f ? 0.0f : f > 2.0f ? 2.0f : f; }
  // Code2V(c, RB, RW, CR), then CLAMPw to +-4096 and truncated
  static int32_t code2v(int c, float rb, float rw, int cr) {
    const float range = (rw - rb) != 0 ? (rw - rb) : 1.0f;
    const float v = static_cast<float>(c - static_cast<int32_t>(rb)) *
                    static_cast<float>(cr) / range;
    const float lo = -128.0f * 32, hi = 128.0f * 32;
    return static_cast<int32_t>(v < lo ? lo : v > hi ? hi : v);
  }

  YCbCrTables(const float* luma, const float* rbw) {
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clamp2(f1));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clamp2(f2));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clamp2(f3));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clamp2(f4));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127);
      const int32_t cb = code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127);
      cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
      cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y[i] = code2v(x + 128, rbw[0], rbw[1], 255);
    }
  }

  // TIFFYCbCrtoRGB
  void rgb(int Y, int cb, int cr, uint8_t* o) const {
    auto c255 = [](int32_t v) {
      return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    o[0] = c255(y[Y] + cr_r[cr]);
    o[1] = c255(y[Y] + ((cb_g[cb] + cr_g[cr]) >> 16));
    o[2] = c255(y[Y] + cb_b[cb]);
  }
};

// tif_color.c TIFFCIELabToRGBInit / TIFFCIELab16ToXYZ / TIFFXYZToRGB with
// tif_getimage.c's display_sRGB, in float as libtiff computes them.
class CieLab {
 public:
  // `white`: the WhitePoint chromaticity (x, y)
  explicit CieLab(const float* white) {
    const float ref1 = 100.0f;
    x0_ = white[0] / white[1] * ref1;
    y0_ = ref1;
    z0_ = (1.0f - white[0] - white[1]) / white[1] * ref1;
    step_ = (kYC - kY0) / kRange;
    const double gamma = 1.0 / static_cast<double>(2.4f);
    for (int i = 0; i <= kRange; ++i) {
      table_[i] = 255.0f * static_cast<float>(
                               std::pow(static_cast<double>(i) / kRange,
                                        gamma));
    }
  }

  // L (0-65535 for 0-100), a and b in 1/256 units (TIFFCIELab16ToXYZ)
  void rgb16(uint32_t l, int32_t a, int32_t b, uint8_t* o) const {
    const float L = static_cast<float>(l) * 100.0f / 65535.0f;
    float X, Y, Z, cby, tmp;
    if (L < 8.856f) {
      Y = (L * y0_) / 903.292f;
      cby = 7.787f * (Y / y0_) + 16.0f / 116.0f;
    } else {
      cby = (L + 16.0f) / 116.0f;
      Y = y0_ * cby * cby * cby;
    }
    tmp = static_cast<float>(a) / 256.0f / 500.0f + cby;
    X = tmp < 0.2069f ? x0_ * (tmp - 0.13793f) / 7.787f
                      : x0_ * tmp * tmp * tmp;
    tmp = cby - static_cast<float>(b) / 256.0f / 200.0f;
    Z = tmp < 0.2069f ? z0_ * (tmp - 0.13793f) / 7.787f
                      : z0_ * tmp * tmp * tmp;
    o[0] = gun(3.2410f * X + -1.5374f * Y + -0.4986f * Z);
    o[1] = gun(-0.9692f * X + 1.8760f * Y + 0.0416f * Z);
    o[2] = gun(0.0556f * X + -0.2040f * Y + 1.0570f * Z);
  }

 private:
  static constexpr int kRange = 1500;  // CIELABTORGB_TABLE_RANGE
  static constexpr float kY0 = 1.0f, kYC = 100.0f;
  float x0_, y0_, z0_, step_;
  float table_[kRange + 1];

  // one gun of TIFFXYZToRGB: clip, the table, RINT, clip to 255
  uint8_t gun(float v) const {
    v = std::max(v, kY0);
    v = std::min(v, kYC);
    int i = static_cast<int>((v - kY0) / step_);
    i = std::min(kRange, i);
    const float t = table_[i];
    uint32_t r = static_cast<uint32_t>(t > 0 ? t + 0.5 : t - 0.5);
    return static_cast<uint8_t>(std::min<uint32_t>(r, 255));
  }
};

// n pixels of a TIFF's colour samples -> RGB, as the RGBA interface
// converts them. `kind` 1: CMYK (4 samples of 8 bits; putRGBcontig8bitCMYK
// tile: (255 - k) * (255 - c) / 255); 2: YCbCr (params: luma[3], then
// ReferenceBlackWhite[6]); 3: CIELab of 8 bits (params: the WhitePoint
// x, y; a* and b* signed); 4: CIELab of 16 bits, each sample two bytes,
// low first.
inline int tiff_colour(const uint8_t* src, size_t n, int spp, int kind,
                       const float* params, uint8_t* out) {
  if (kind == 1) {
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* s = src + i * spp;
      const int k = 255 - s[3];
      for (int c = 0; c < 3; ++c) {
        out[i * 3 + c] = static_cast<uint8_t>(k * (255 - s[c]) / 255);
      }
    }
    return kOk;
  }
  if (kind == 2) {
    const YCbCrTables t(params, params + 3);
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* s = src + i * spp;
      t.rgb(s[0], s[1], s[2], out + i * 3);
    }
    return kOk;
  }
  if (kind == 3 || kind == 4) {
    const CieLab lab(params);
    for (size_t i = 0; i < n; ++i) {
      if (kind == 3) {
        const uint8_t* s = src + i * spp;
        lab.rgb16(s[0] * 257u, static_cast<int8_t>(s[1]) * 256,
                  static_cast<int8_t>(s[2]) * 256, out + i * 3);
      } else {
        const uint8_t* s = src + i * spp * 2;
        lab.rgb16(s[0] | (s[1] << 8),
                  static_cast<int16_t>(s[2] | (s[3] << 8)),
                  static_cast<int16_t>(s[4] | (s[5] << 8)), out + i * 3);
      }
    }
    return kOk;
  }
  return kArgs;
}

}  // namespace etraster
