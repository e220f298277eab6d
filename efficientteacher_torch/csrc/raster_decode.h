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
//   lzw_decode      TIFF LZW (tif_lzw.c: MSB first, 9-12 bit codes, the
//                   code width grows one code early)
//   lzw_encode      the same code stream as tif_lzw.c LZWEncode writes
//   packbits_decode tif_packbits.c PackBitsDecode
//   tiff_decode     every strip or tile of an image into its place
// Every routine writes into buffers the caller owns and keeps no state.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace etraster {

enum Status { kOk = 0, kCorrupt = -2, kArgs = -5 };

// 16-bit reductions to 8 bits
enum Round16 { kHighByte = 0, kDiv257 = 1 };

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
        o[i] = round16 == kDiv257 ? static_cast<uint8_t>((v + 128) / 257)
                                  : static_cast<uint8_t>(v >> 8);
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

// TIFF LZW stream -> at most `cap` bytes into dst; returns the bytes
// written, or kCorrupt for a code the table does not hold.
inline int64_t lzw_decode(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t cap) {
  std::vector<int> prefix(1 << kLzwMaxBits), length(1 << kLzwMaxBits);
  std::vector<uint8_t> suffix(1 << kLzwMaxBits), first(1 << kLzwMaxBits);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1, suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  size_t out = 0, pos = 0;
  uint64_t acc = 0;  // bits not yet taken, MSB first, `have` of them
  int have = 0;
  int nbits = 9, next = kLzwFirst, prev = -1;
  for (;;) {
    while (have < nbits && pos < n) {
      acc = (acc << 8) | src[pos++];
      have += 8;
    }
    if (have < nbits) break;  // the data ends without EOI
    const int code = static_cast<int>((acc >> (have - nbits)) &
                                      ((1u << nbits) - 1));
    have -= nbits;
    if (code == kLzwEoi) break;
    if (code == kLzwClear) {
      nbits = 9, next = kLzwFirst, prev = -1;
      continue;
    }
    int entry;
    if (prev < 0) {
      if (code > 255) return kCorrupt;
      entry = code;
    } else {
      if (code > next || next >= (1 << kLzwMaxBits)) return kCorrupt;
      // the new entry: prev + the first byte of code's string (of prev's
      // own where code is the entry being made)
      prefix[next] = prev;
      suffix[next] = code == next ? first[prev] : first[code];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      entry = code;
      ++next;
      if (next >= (1 << nbits) - 1 && nbits < kLzwMaxBits) ++nbits;
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
  }
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

// PackBits -> at most `cap` bytes; returns the bytes written.
inline int64_t packbits_decode(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t cap) {
  size_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = static_cast<int8_t>(src[i++]);
    if (c >= 0) {
      const size_t k = std::min<size_t>(static_cast<size_t>(c) + 1,
                                        std::min(n - i, cap - out));
      std::memcpy(dst + out, src + i, k);
      i += static_cast<size_t>(c) + 1;
      out += k;
    } else if (c != -128) {
      if (i >= n) break;
      const size_t k = std::min<size_t>(1 - c, cap - out);
      std::memset(dst + out, src[i++], k);
      out += k;
    }
  }
  return static_cast<int64_t>(out);
}

// ---------------------------------------------------------------- TIFF

// The strips or tiles of a TIFF's first image. Chunk k is `counts[k]`
// bytes at `offsets[k]` of `data`, compressed by `compression` (1 none,
// 5 LZW, 32773 PackBits); chunks run plane by plane, then row by row of
// chunks, then across. Each holds `ch` rows (a strip at the image's foot
// fewer; a tile is whole) of `cw` pixels of `per_chunk` samples, `bits`
// each, rows padded to bytes. `flags` as unpack_rows': 1 big-endian, 2
// predictor, 4 16-bit samples by (v + 128) / 257. out: (h, w, spp).
struct TiffLayout {
  int w, h, cw, ch, tiled, planes, per_chunk, spp, bits, flags;
};

inline int tiff_decode(const uint8_t* data, size_t n, const int64_t* offsets,
                       const int64_t* counts, int nchunks, int compression,
                       const TiffLayout& L, uint8_t* out) {
  const size_t row_bytes =
      (static_cast<size_t>(L.cw) * L.per_chunk * L.bits + 7) / 8;
  const int across = (L.w + L.cw - 1) / L.cw;
  const int down = (L.h + L.ch - 1) / L.ch;
  if (nchunks < across * down * L.planes) return kCorrupt;
  std::vector<uint8_t> raw(row_bytes * L.ch);
  std::vector<uint8_t> px(static_cast<size_t>(L.ch) * L.cw * L.per_chunk);
  int k = 0;
  for (int plane = 0; plane < L.planes; ++plane) {
    for (int cy = 0; cy < down; ++cy) {
      for (int cx = 0; cx < across; ++cx, ++k) {
        const int rows = L.tiled ? L.ch : std::min(L.ch, L.h - cy * L.ch);
        const size_t need = row_bytes * rows;
        if (offsets[k] < 0 || counts[k] < 0 ||
            static_cast<uint64_t>(offsets[k]) + counts[k] > n) {
          return kCorrupt;
        }
        const uint8_t* src = data + offsets[k];
        const size_t count = static_cast<size_t>(counts[k]);
        int64_t got = static_cast<int64_t>(count);
        if (compression == 5) {
          got = lzw_decode(src, count, raw.data(), need);
          src = raw.data();
        } else if (compression == 32773) {
          got = packbits_decode(src, count, raw.data(), need);
          src = raw.data();
        } else if (compression != 1) {
          return kArgs;
        }
        if (got < static_cast<int64_t>(need)) return kCorrupt;
        const int st = unpack_rows(src, rows, row_bytes, L.cw, L.per_chunk,
                                   L.bits, L.flags & 1, L.flags & 2,
                                   (L.flags & 4) ? kDiv257 : kHighByte,
                                   px.data(),
                                   static_cast<size_t>(L.cw) * L.per_chunk);
        if (st != kOk) return st;
        const int y0 = cy * L.ch, x0 = cx * L.cw;
        const int y1 = std::min(y0 + rows, L.h), x1 = std::min(x0 + L.cw, L.w);
        for (int y = y0; y < y1; ++y) {
          const uint8_t* s =
              px.data() + static_cast<size_t>(y - y0) * L.cw * L.per_chunk;
          uint8_t* o = out + (static_cast<size_t>(y) * L.w + x0) * L.spp;
          if (L.per_chunk == L.spp) {
            std::memcpy(o, s, static_cast<size_t>(x1 - x0) * L.spp);
          } else {
            for (int x = 0; x < x1 - x0; ++x) o[x * L.spp + plane] = s[x];
          }
        }
      }
    }
  }
  return kOk;
}

}  // namespace etraster
