// MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder of the host loader core:
// the frames FFmpeg 8's `mpeg4` decoder (libavcodec 62.28, inside cv2 5.0's
// FFmpeg backend) gives, bit for bit, with no library. Included by
// loader_core.cpp only.
//
// Decodes the simple-profile tools and what FFmpeg's and Xvid's encoders
// write: VOS / VO / VOL / GOV / user-data headers, I- and P-VOPs, N-VOPs
// (no picture), intra DC / AC prediction, H.263 and MPEG quantisation
// (default and custom matrices), half-pel motion compensation with the VOP
// rounding type, unrestricted motion vectors (edge clamping), 4MV, intra
// macroblocks in P-VOPs, dquant, resync markers / video packets. A VOP that
// needs a tool it does not decode (B- and S-VOPs, quarter-pel, GMC /
// sprites, interlaced coding, data partitioning, shapes other than
// rectangular, scalability, complexity estimation, NEWPRED, reduced
// resolution, another bit depth) is refused with a Tool code from its
// headers, before any macroblock is read.
//
// Reproduced FFmpeg routines (libavcodec; names are its files and
// functions):
//   mpeg4videodec.c  ff_mpeg4_decode_picture_header (the start-code scan),
//       decode_vol_header, decode_user_information (the Lavc / XviD / DivX
//       builds), ff_mpeg4_workaround_bugs (FF_BUG_EDGE, FF_BUG_DC_CLIP; the
//       Xvid IDCT is not reproduced and refused: Tool kXvidIdct),
//       decode_vop_header, mpeg4_decode_mb, mpeg4_decode_block (the
//       three escapes, third-escape levels clipped to -2048..2047),
//       mpeg4_decode_dc, mpeg4_pred_dc / mpeg4_get_level_dc (prediction
//       from 1024 outside the slice, stored DC clipped to 0..2047),
//       ff_mpeg4_pred_ac (rescaled by the neighbour's qscale),
//       mpeg4_is_resync, ff_mpeg4_decode_video_packet_header,
//       ff_mpeg4_clean_buffers
//   h263.c / h263dec.c  ff_h263_pred_motion (the first-slice-line cases),
//       ff_h263_decode_motion (modulo 5 + f_code bits), decode_slice,
//       ff_h263_resync, ff_h263_update_motion_val
//   mpegvideo_dec.c / mpegvideo_motion.c  dct_unquantize_h263_intra,
//       dct_unquantize_mpeg2_intra / _inter (the mismatch control of the
//       inter one), mpeg_motion (the chroma vector of 1MV), hpel_motion
//       and chroma_4mv_motion (their clips to the picture size),
//       ff_h263_round_chroma; edges at the macroblock-aligned size
//   GetBitContext's safe reader: past the end it reads the zero padding.
//   error_resilience.c  where a slice's data fails (a packet cut short, a
//       damaged one), ff_er_add_slice / ff_er_frame_end as the default
//       error_concealment (guess MVs, deblock) runs them: the backward (50
//       macroblocks) and forward marking, is_intra_more_likely (16x16 SADs
//       against the last picture for an I-VOP, intra counts for a P-VOP),
//       guess_mv (zero MVs where at most max(w, h) / 2 macroblocks are
//       whole, else the blocklist passes over mean / median / zero / last
//       predictors scored on the boundary pixels), the pixel DCs, guess_dc
//       (inverse-distance weights from four directions), filter181, put_dc
//       and the h / v block filters (with FFmpeg's |mv_y + mv_y'| test).
//       Where ER is not needed nothing of it runs.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

#include "video_dsp.h"

namespace etmpeg4 {

// What a stream needs that the decoder does not decode (0: decoded).
enum Tool {
  kDecoded = 0,
  kBVop = 1,
  kSVop = 2,          // sprite / GMC VOPs
  kQpel = 3,
  kInterlaced = 4,
  kPartitioned = 5,   // data partitioning (and RVLC)
  kShape = 6,         // binary / grey shape
  kScalable = 7,
  kComplexity = 8,    // complexity estimation headers
  kNewPred = 9,
  kReducedRes = 10,
  kBitDepth = 11,     // not 8 bits per pixel
  kXvidIdct = 12,     // an Xvid stream: FFmpeg runs its Xvid IDCT
  kSprite = 13,       // vol_sprite_usage static / GMC
};

enum Result { kFrame = 1, kNoFrame = 0, kBadHeader = -2, kUnsupported = -4 };

// error_resilience.h's status bits, and the macroblock types ER reads
constexpr uint8_t kVpStart = 1, kErAcError = 2, kErDcError = 4,
                  kErMvError = 8, kErAcEnd = 16, kErDcEnd = 32,
                  kErMvEnd = 64;
constexpr uint8_t kErMbError = kErAcError | kErDcError | kErMvError;
constexpr uint8_t kErMbEnd = kErAcEnd | kErDcEnd | kErMvEnd;
enum MbType : uint8_t { kTypeInter16, kTypeInter8, kTypeSkip, kTypeIntra };

// ------------------------------------------------------------ bits

// GetBitContext with the safe reader: the index never passes the size plus
// 8 bits; past the data it reads the zero padding.
struct Bits {
  const uint8_t* d;
  int size_bits;
  int idx = 0;
  Bits(const uint8_t* data, int nbytes) : d(data), size_bits(nbytes * 8) {}
  uint32_t show32() const {
    const int b = idx >> 3;
    const uint32_t v = (static_cast<uint32_t>(d[b]) << 24) |
                       (static_cast<uint32_t>(d[b + 1]) << 16) |
                       (static_cast<uint32_t>(d[b + 2]) << 8) | d[b + 3];
    const uint32_t next = d[b + 4];
    const int s = idx & 7;
    return s ? (v << s) | (next >> (8 - s)) : v;
  }
  uint32_t show(int n) const { return n ? show32() >> (32 - n) : 0; }
  void skip(int n) { idx = std::min(size_bits + 8, idx + n); }
  uint32_t get(int n) {
    const uint32_t v = show(n);
    skip(n);
    return v;
  }
  int get1() { return static_cast<int>(get(1)); }
  int left() const { return size_bits - idx; }
  void align() { skip((-idx) & 7); }
  // get_xbits: n bits, the first 0 meaning a negative value
  int xbits(int n) {
    const int v = static_cast<int>(get(n));
    return (v >> (n - 1)) ? v : v - (1 << n) + 1;
  }
  int sbits(int n) {
    const int v = static_cast<int>(get(n));
    return (v ^ (1 << (n - 1))) - (1 << (n - 1));
  }
};

// A VLC as a direct lookup of kMaxLen bits: symbol and length (0: no code).
struct Vlc {
  static constexpr int kMaxLen = 13;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  // the codes' symbols are their indices in `codes`
  void build(const uint16_t (*codes)[2], int n) {
    sym.assign(1 << kMaxLen, -1);
    len.assign(1 << kMaxLen, 0);
    for (int i = 0; i < n; ++i) {
      const int l = codes[i][1];
      if (!l) continue;
      const int lo = codes[i][0] << (kMaxLen - l);
      for (int j = 0; j < (1 << (kMaxLen - l)); ++j) {
        sym[lo + j] = static_cast<int16_t>(i);
        len[lo + j] = static_cast<uint8_t>(l);
      }
    }
  }
  // -1 for a code not in the table
  int read(Bits& b) const {
    const uint32_t v = b.show(kMaxLen);
    if (!len[v]) return -1;
    b.skip(len[v]);
    return sym[v];
  }
};

// ------------------------------------------------------------ tables

// H.263 / MPEG-4 inter TCOEF (ff_inter_vlc: Table B-17), then the escape
constexpr uint16_t kInterVlc[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},
    {0x24, 9},  {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11},
    {0x6, 3},   {0x14, 6},  {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12},
    {0xe, 4},   {0x1d, 8},  {0xe, 10},  {0x51, 12}, {0xd, 5},   {0x23, 9},
    {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12}, {0xb, 5},   {0xc, 10},
    {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},  {0xa, 10},
    {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},
    {0x1f, 9},  {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},
    {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},
    {0x5, 11},  {0xf, 6},   {0x4, 11},  {0xe, 6},   {0xd, 6},   {0xc, 6},
    {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},  {0x1a, 8},  {0x19, 8},
    {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},  {0x13, 8},
    {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},
    {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7}};
constexpr int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3,
    4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
constexpr int kInterNotLast = 58;

// MPEG-4 intra TCOEF (ff_mpeg4_intra_vlc: Table B-16), then the escape
constexpr uint16_t kIntraVlc[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},
    {0x13, 6},  {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},
    {0x25, 9},  {0x24, 9},  {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10},
    {0xf, 10},  {0xe, 10},  {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},   {0x14, 6},  {0x16, 7},
    {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},
    {0xa, 10},  {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},
    {0x54, 12}, {0x14, 7},  {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},
    {0x18, 8},  {0x23, 11}, {0x17, 8},  {0x19, 9},  {0x18, 9},  {0x7, 10},
    {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},  {0x17, 9},  {0x6, 10},
    {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},  {0x5, 10},
    {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},
    {0x1a, 8},  {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7}};
constexpr int8_t kIntraLevel[102] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 1,  2,  3,  4,  5,  6,  7,
    8,  9,  10, 1,  2,  3,  4,  5,  1,  2,  3,  4,  1,  2,  3,  1,  2,
    3,  1,  2,  3,  1,  2,  3,  1,  2,  1,  2,  1,  1,  1,  1,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  1,  2,  3,  1,  2,  1,  2,  1,  2,  1,
    2,  1,  2,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1};
constexpr int kIntraNotLast = 67;

// I-VOP MCBPC (index: type 3 cbpc 0-3, type 4 cbpc 0-3, stuffing)
constexpr uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3},
                                        {1, 4}, {1, 6}, {2, 6}, {3, 6},
                                        {1, 9}};
// P-VOP MCBPC (index: cbpc | 4 intra | 8 dquant | 16 4MV; 20 stuffing)
constexpr uint16_t kInterMcbpc[28][2] = {
    {1, 1},  {3, 4},  {2, 4},   {5, 6},   {3, 5},  {4, 8},  {3, 8},
    {3, 7},  {3, 3},  {7, 7},   {6, 7},   {5, 9},  {4, 6},  {4, 9},
    {3, 9},  {2, 9},  {2, 3},   {5, 7},   {4, 7},  {5, 8},  {1, 9},
    {0, 0},  {0, 0},  {0, 0},   {2, 11},  {12, 13}, {14, 13}, {15, 13}};
constexpr uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4},
                                   {3, 5}, {7, 4}, {2, 6}, {11, 4},
                                   {2, 5}, {3, 6}, {5, 4}, {10, 4},
                                   {4, 4}, {8, 4}, {6, 4}, {3, 2}};
constexpr uint16_t kMv[33][2] = {
    {1, 1},  {1, 2},  {1, 3},  {1, 4},  {3, 6},  {5, 7},  {4, 7},
    {3, 7},  {11, 9}, {10, 9}, {9, 9},  {17, 10}, {16, 10}, {15, 10},
    {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10},
    {7, 10}, {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11}, {5, 11},
    {4, 11}, {3, 11}, {2, 11}, {3, 12}, {2, 12}};
constexpr uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                                    {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                                    {1, 9}, {1, 10}, {1, 11}};
constexpr uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},
                                      {1, 4}, {1, 5}, {1, 6}, {1, 7},
                                      {1, 8}, {1, 9}, {1, 10}, {1, 11},
                                      {1, 12}};
constexpr uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
constexpr uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
constexpr uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// ff_mpeg4_default_intra_matrix / _non_intra_matrix (raster order)
constexpr uint16_t kDefaultIntra[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
constexpr uint16_t kDefaultInter[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};
constexpr int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};

inline int y_dc_scale(int q) {
  return q < 5 ? 8 : (q < 9 ? 2 * q : (q < 25 ? q + 8 : 2 * q - 16));
}
inline int c_dc_scale(int q) {
  return q < 5 ? 8 : (q < 25 ? (q + 13) / 2 : q - 6);
}
inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// A run-level table: its VLC (symbol = entry index, 102 = escape), with
// run / level / last per entry and ff_rl_init's max_level / max_run.
struct RunLevel {
  Vlc vlc;
  int run[102], level[102], last[102];
  int max_level[2][64], max_run[2][65];
  void build(const uint16_t (*codes)[2], const int8_t* levels, int not_last) {
    vlc.build(codes, 103);
    std::memset(max_level, 0, sizeof(max_level));
    std::memset(max_run, 0, sizeof(max_run));
    int r = -1;
    for (int i = 0; i < 102; ++i) {
      if (i == not_last) r = -1;
      if (levels[i] == 1) ++r;
      run[i] = r;
      level[i] = levels[i];
      last[i] = i >= not_last;
      int& ml = max_level[last[i]][r];
      ml = std::max(ml, level[i]);
      int& mr = max_run[last[i]][level[i]];
      mr = std::max(mr, r);
    }
  }
};

struct Tables {
  RunLevel intra, inter;
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  Tables() {
    intra.build(kIntraVlc, kIntraLevel, kIntraNotLast);
    inter.build(kInterVlc, kInterLevel, kInterNotLast);
    intra_mcbpc.build(kIntraMcbpc, 9);
    inter_mcbpc.build(kInterMcbpc, 28);
    cbpy.build(kCbpy, 16);
    mv.build(kMv, 33);
    dc_lum.build(kDcLum, 13);
    dc_chrom.build(kDcChrom, 13);
  }
};

inline const Tables& tables() {
  static const Tables t;
  return t;
}

inline int av_log2(unsigned v) {
  int n = 0;
  while (v >>= 1) ++n;
  return n;
}

// ------------------------------------------------------------ decoder

class Decoder {
 public:
  // `xvid_tag`: the container's fourcc is XVID / XVIX / RMP4 / ZMP4 / SIPP
  // (FFmpeg takes such a stream without user data for an Xvid one);
  // `divx_tag`: it is DIVX.
  Decoder(bool xvid_tag, bool divx_tag) : xvid_tag_(xvid_tag),
                                          divx_tag_(divx_tag) {}

  int width() const { return width_; }
  int height() const { return height_; }
  int tool() const { return tool_; }

  // The decoder's extradata (MP4's esds DecoderSpecificInfo): headers only.
  // FFmpeg ignores what fails here; a tool refused is refused at decode.
  int headers(const uint8_t* data, int n) {
    std::vector<uint8_t> buf(data, data + n);
    buf.resize(n + 64, 0);
    Bits b(buf.data(), n);
    const int r = picture_header(b, true);
    return r == kHeadersOnly ? 0 : r;
  }

  // One packet. kFrame: the picture is in the planes (read them with
  // to_bgr); kNoFrame: no picture (an N-VOP, an empty packet); kBadHeader:
  // FFmpeg's decode fails on this packet (cv2 stops reading there);
  // kUnsupported: tool() says what is needed.
  int decode(const uint8_t* data, int n) {
    if (tool_ != kDecoded) return kUnsupported;  // refused in the extradata
    if (n == 0) return kNoFrame;
    std::vector<uint8_t> buf(data, data + n);
    buf.resize(n + 64, 0);
    Bits b(buf.data(), n);
    const int r = picture_header(b, false);
    if (r != kVop) return r;
    if (!width_ || !height_) return kBadHeader;
    // FFmpeg refuses a VOP with less than half a bit per macroblock left
    // after its header (a packet cut short there fails: cv2 stops)
    alloc();
    if (b.left() < mb_w_ * mb_h_ / 2) return kBadHeader;
    return decode_picture(b);
  }

  // The picture as BGR24 (width x height, rows of `stride` bytes).
  void to_bgr(uint8_t* out, int stride) const {
    etvideo::yuv_to_bgr(cur_[0].data(), lw_, cur_[1].data(), cur_[2].data(),
                        cw_, width_, height_, 1, false, out, stride);
  }

 private:
  static constexpr int kVop = 2, kHeadersOnly = 3, kSkipped = 4;

  bool xvid_tag_, divx_tag_;
  // VOL
  bool have_vol_ = false;
  int vo_type_ = 0, vol_control_ = 0, time_inc_bits_ = 0;
  int width_ = 0, height_ = 0, quant_precision_ = 5, mpeg_quant_ = 0;
  int resync_marker_ = 0;
  uint16_t intra_matrix_[64], inter_matrix_[64];
  // user data
  int lavc_build_ = -1, xvid_build_ = -1, divx_version_ = -1;
  int divx_build_ = -1;
  bool bug_edge_ = false, bug_dc_clip_ = false;
  int tool_ = kDecoded;
  // VOP
  int pict_p_ = 0, no_rounding_ = 0, dc_threshold_ = 99, qscale_ = 1;
  int f_code_ = 1;
  // geometry and pictures
  int mb_w_ = 0, mb_h_ = 0, lw_ = 0, cw_ = 0;
  std::vector<uint8_t> cur_[3], ref_[3];
  bool have_ref_ = false;
  // per-macroblock state of the picture
  std::vector<int16_t> dc_[3];     // DC predictors (luma per 8x8 block)
  std::vector<int16_t> ac_[3];     // 16 per block: [1..7] left column,
                                   // [9..15] top row
  std::vector<int16_t> mv_;        // 2 per 8x8 block
  std::vector<int16_t> prev_mv_;   // the last picture's
  std::vector<int8_t> qs_;         // qscale per macroblock
  // error resilience: per macroblock its status (ER_* bits), its type and
  // whether it was skipped; FFmpeg's error_count
  std::vector<uint8_t> status_, mbtype_, skip_;
  int64_t error_count_ = 0;
  // FFmpeg's padding_bug_score and FF_BUG_NO_PADDING, kept across VOPs
  int64_t padding_score_ = 0;
  bool no_padding_ = false;
  bool intra_only_ = true;         // no picture before this one
  // slice state
  int mb_x_ = 0, mb_y_ = 0, resync_x_ = 0, resync_y_ = 0;
  bool first_line_ = true;
  int16_t block_[6][64];
  int last_[6];
  int mb_intra_ = 0, ac_pred_ = 0, use_dc_vlc_ = 1, mv4_ = 0;
  int mv_x_[4], mv_y_[4];

  // ---------------------------------------------------------- headers

  int unsupported(int t) {
    tool_ = t;
    return kUnsupported;
  }

  int picture_header(Bits& b, bool header) {
    b.align();
    uint32_t code = 0xff;
    bool vol = false;
    for (;;) {
      if (b.idx >= b.size_bits) {
        if (b.size_bits == 8 && (divx_version_ >= 0 || xvid_build_ >= 0))
          return kNoFrame;  // the DivX / Xvid one-byte skipped frame
        if (header && b.idx == b.size_bits) return kHeadersOnly;
        return kBadHeader;
      }
      code = ((code << 8) | b.get(8)) & 0xffffffffu;
      if ((code & 0xFFFFFF00u) != 0x100) continue;
      if (code >= 0x120 && code <= 0x12F) {
        if (vol) continue;
        vol = true;
        const int r = vol_header(b);
        if (r) return r;
      } else if (code == 0x1B2) {
        user_data(b);
      } else if (code == 0x1B6) {
        break;
      }
      b.align();
      code = 0xff;
    }
    if (!have_vol_) return kBadHeader;
    return vop_header(b);
  }

  int vol_header(Bits& b) {
    b.skip(1);  // random access
    vo_type_ = static_cast<int>(b.get(8));
    int ver = 1;
    if (b.get1()) {
      ver = static_cast<int>(b.get(4));
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // extended pixel aspect
    vol_control_ = b.get1();
    if (vol_control_) {
      b.skip(2);  // chroma format: FFmpeg decodes 4:2:0 whatever it says
      b.skip(1);  // low delay
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);
    }
    const int shape = static_cast<int>(b.get(2));
    if (shape != 0) return unsupported(kShape);
    b.skip(1);  // marker
    const int rate = static_cast<int>(b.get(16));
    if (!rate) return kBadHeader;
    time_inc_bits_ = std::max(1, av_log2(rate - 1) + 1);
    b.skip(1);
    if (b.get1()) b.skip(time_inc_bits_);  // fixed_vop_rate
    b.skip(1);
    const int w = static_cast<int>(b.get(13));
    b.skip(1);
    const int h = static_cast<int>(b.get(13));
    b.skip(1);
    if (b.get1()) return unsupported(kInterlaced);  // interlaced
    b.skip(1);  // obmc disable
    const int sprite = ver == 1 ? b.get1() : static_cast<int>(b.get(2));
    if (sprite) return unsupported(kSprite);
    if (b.get1()) return unsupported(kBitDepth);  // not_8_bit
    quant_precision_ = 5;
    mpeg_quant_ = b.get1();
    std::memcpy(intra_matrix_, kDefaultIntra, sizeof(intra_matrix_));
    std::memcpy(inter_matrix_, kDefaultInter, sizeof(inter_matrix_));
    if (mpeg_quant_) {
      for (uint16_t* m : {intra_matrix_, inter_matrix_}) {
        if (!b.get1()) continue;
        int last = 0, i = 0;
        for (; i < 64; ++i) {
          if (b.left() < 8) return kBadHeader;
          const int v = static_cast<int>(b.get(8));
          if (v == 0) break;
          last = v;
          m[kZigzag[i]] = static_cast<uint16_t>(v);
        }
        for (; i < 64; ++i) m[kZigzag[i]] = static_cast<uint16_t>(last);
      }
    }
    if (ver != 1 && b.get1()) return unsupported(kQpel);
    if (b.left() < 4) return kBadHeader;
    if (!b.get1()) return unsupported(kComplexity);
    resync_marker_ = !b.get1();
    if (b.get1()) return unsupported(kPartitioned);
    if (ver != 1) {
      if (b.get1()) return unsupported(kNewPred);
      if (b.get1()) return unsupported(kReducedRes);
    }
    if (b.get1()) return unsupported(kScalable);
    if (w && h) {
      if (w != width_ || h != height_) have_ref_ = false;
      width_ = w;
      height_ = h;
    }
    have_vol_ = true;
    return 0;
  }

  void user_data(Bits& b) {
    char buf[256];
    int i = 0;
    for (; i < 255 && b.idx < b.size_bits; ++i) {
      if (b.show(23) == 0) break;
      buf[i] = static_cast<char>(b.get(8));
    }
    buf[i] = 0;
    int ver = 0, ver2 = 0, ver3 = 0, build = 0;
    char last = 0;
    int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      divx_version_ = ver;
      divx_build_ = build;
    }
    e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4)
      e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver,
                      &ver2, &ver3, &build);
    if (e != 4) {
      e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) {
        if (ver > 0xFF || ver2 > 0xFF || ver3 > 0xFF) {
          e = 1;
        } else {
          build = (ver << 16) + (ver2 << 8) + ver3;
        }
      }
    }
    if (e != 4 && std::strcmp(buf, "ffmpeg") == 0) lavc_build_ = 4600;
    if (e == 4) lavc_build_ = build;
    if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build_ = build;
  }

  // ff_mpeg4_workaround_bugs, for the tools decoded here
  int workarounds() {
    if (xvid_build_ == -1 && divx_version_ == -1 && lavc_build_ == -1) {
      if (xvid_tag_) xvid_build_ = 0;
      if (divx_tag_ && vo_type_ == 0 && vol_control_ == 0)
        divx_version_ = 400;
    }
    if (xvid_build_ >= 0 && divx_version_ >= 0) divx_version_ = -1;
    const auto u = [](int v) { return static_cast<unsigned>(v); };
    bug_edge_ = u(xvid_build_) <= 12u || u(lavc_build_) < 4670u ||
                u(divx_version_) < 500u;
    bug_dc_clip_ = u(xvid_build_) <= 32u || u(lavc_build_) <= 4712u;
    if (static_cast<unsigned>(xvid_build_) <= 3u ||
        (divx_version_ == 501 && divx_build_ == 20020416))
      padding_score_ = int64_t{256} * 256 * 256 * 64;
    if (xvid_build_ >= 0) return unsupported(kXvidIdct);
    return 0;
  }

  int vop_header(Bits& b) {
    const int type = static_cast<int>(b.get(2));
    if (type == 2) return unsupported(kBVop);
    if (type == 3) return unsupported(kSVop);
    while (b.get1()) {
    }
    b.skip(1);  // marker
    if (!(b.show(time_inc_bits_ + 1) & 1)) {
      // FFmpeg guesses the time increment's width from the bits that follow
      for (time_inc_bits_ = 1; time_inc_bits_ < 16; ++time_inc_bits_) {
        if (type == 1) {
          if ((b.show(time_inc_bits_ + 6) & 0x37) == 0x30) break;
        } else if ((b.show(time_inc_bits_ + 5) & 0x1F) == 0x18) {
          break;
        }
      }
    }
    b.skip(time_inc_bits_);
    b.skip(1);  // marker
    if (!b.get1()) return kNoFrame;  // vop_coded 0: FFmpeg's FRAME_SKIPPED
    pict_p_ = type == 1;
    no_rounding_ = pict_p_ ? b.get1() : 0;
    dc_threshold_ = kDcThreshold[b.get(3)];
    qscale_ = static_cast<int>(b.get(quant_precision_));
    if (!qscale_) return kBadHeader;
    f_code_ = 1;
    if (pict_p_) {
      f_code_ = static_cast<int>(b.get(3));
      if (!f_code_) return kBadHeader;
    }
    const int r = workarounds();
    if (r) return r;
    return kVop;
  }

  // ---------------------------------------------------------- picture

  void alloc() {
    mb_w_ = (width_ + 15) / 16;
    mb_h_ = (height_ + 15) / 16;
    lw_ = mb_w_ * 16;
    cw_ = mb_w_ * 8;
    const size_t ls = static_cast<size_t>(lw_) * mb_h_ * 16;
    const size_t cs = static_cast<size_t>(cw_) * mb_h_ * 8;
    for (int p = 0; p < 3; ++p) {
      const size_t n = p ? cs : ls;
      if (cur_[p].size() != n) {
        cur_[p].assign(n, 0);
        ref_[p].assign(n, 0);
        have_ref_ = false;
      }
    }
    const size_t nmb = static_cast<size_t>(mb_w_) * mb_h_;
    dc_[0].assign(nmb * 4, 1024);
    dc_[1].assign(nmb, 1024);
    dc_[2].assign(nmb, 1024);
    ac_[0].assign(nmb * 4 * 16, 0);
    ac_[1].assign(nmb * 16, 0);
    ac_[2].assign(nmb * 16, 0);
    if (mv_.size() != nmb * 8) prev_mv_.assign(nmb * 8, 0);
    mv_.assign(nmb * 4 * 2, 0);
    qs_.assign(nmb, 0);
    status_.assign(nmb, kErMbError | kVpStart | kErMbEnd);
    mbtype_.assign(nmb, kTypeIntra);
    skip_.assign(nmb, 0);
    error_count_ = 3 * static_cast<int64_t>(nmb);
  }

  int decode_picture(Bits& b) {
    alloc();
    if (pict_p_ && !have_ref_) {
      // a P-VOP with no reference: FFmpeg predicts from a grey picture
      for (int p = 0; p < 3; ++p) std::fill(ref_[p].begin(), ref_[p].end(),
                                            static_cast<uint8_t>(0x80));
    }
    if (pict_p_) {
      // MBs no slice reaches keep the reference's pixels
      for (int p = 0; p < 3; ++p) cur_[p] = ref_[p];
    } else {
      for (int p = 0; p < 3; ++p) std::fill(cur_[p].begin(), cur_[p].end(),
                                            static_cast<uint8_t>(0));
    }
    mb_x_ = mb_y_ = 0;
    decode_slice(b);
    while (mb_y_ < mb_h_) {
      if (resync(b) < 0) break;
      clean_buffers();
      decode_slice(b);
    }
    if (error_count_) conceal();
    for (int p = 0; p < 3; ++p) ref_[p] = cur_[p];
    prev_mv_ = mv_;
    have_ref_ = true;
    intra_only_ = false;
    return kFrame;
  }

  enum { kSliceOk = 0, kSliceEnd = -30, kSliceError = -1 };

  // decode_slice: 0 at the slice's end, < 0 where its data fails
  int decode_slice(Bits& b) {
    last_resync_idx_ = b.idx;
    first_line_ = true;
    resync_x_ = mb_x_;
    resync_y_ = mb_y_;
    set_qscale(qscale_);
    for (; mb_y_ < mb_h_; ++mb_y_) {
      for (; mb_x_ < mb_w_; ++mb_x_) {
        if (resync_x_ == mb_x_ && resync_y_ + 1 == mb_y_) first_line_ = false;
        const int ret = decode_mb(b);
        update_motion_val();
        if (ret < 0) {
          if (ret == kSliceEnd) {
            reconstruct();
            add_slice(resync_x_, resync_y_, mb_x_, mb_y_, kErMbEnd);
            --padding_score_;
            if (++mb_x_ >= mb_w_) {
              mb_x_ = 0;
              ++mb_y_;
            }
            return 0;
          }
          add_slice(resync_x_, resync_y_, mb_x_, mb_y_, kErMbError);
          return -1;
        }
        reconstruct();
      }
      mb_x_ = 0;
    }
    // every macroblock read and no slice end seen: FFmpeg's padding-bug
    // detection from the bits left, then FF_BUG_NO_PADDING's end
    if (b.left() >= 48 && b.show(24) == 0x4010) padding_score_ += 32;
    if (b.left() >= 0 && b.left() < 137) {
      const int count = b.idx, bits_left = b.size_bits - count;
      if (bits_left == 0) {
        padding_score_ += 16;
      } else if (bits_left != 1) {
        int v = static_cast<int>(b.show(8));
        v |= 0x7F >> (7 - (count & 7));
        if (v == 0x7F && bits_left <= 8) {
          --padding_score_;
        } else if (v == 0x7F && ((count + 8) & 8) && bits_left <= 16) {
          padding_score_ += 4;
        } else {
          ++padding_score_;
        }
      }
    }
    no_padding_ = padding_score_ > -2;
    if (no_padding_) {
      if (b.left() >= 0)
        add_slice(resync_x_, resync_y_, mb_x_ - 1, mb_y_, kErMbEnd);
      return 0;
    }
    // "slice end not reached but screenspace end"
    add_slice(resync_x_, resync_y_, mb_x_, mb_y_, kErMbEnd);
    return -1;
  }

  void set_qscale(int q) { qscale_ = std::min(31, std::max(1, q)); }

  int mb_num_bits() const { return av_log2(mb_w_ * mb_h_ - 1) + 1; }
  int prefix_length() const { return pict_p_ ? f_code_ + 15 : 16; }

  // mpeg4_is_resync: the macroblock number of the next video packet (the
  // picture's count at its end), 0 where none starts here
  int is_resync(Bits& b) {
    if (no_padding_ && !resync_marker_) return 0;
    int bits_count = b.idx;
    uint32_t v = b.show(16);
    const int pict_type = pict_p_ ? 2 : 1;
    while (v <= 0xFF) {
      if ((v >> (8 - pict_type)) != 1) break;
      b.skip(8 + pict_type);
      bits_count += 8 + pict_type;
      v = b.show(16);
    }
    if (bits_count + 8 >= b.size_bits) {
      v >>= 8;
      v |= 0x7F >> (7 - (bits_count & 7));
      if (v == 0x7F) return mb_w_ * mb_h_;
    } else {
      static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                         0x7000, 0x6000, 0x4000, 0x0000};
      if (v == prefix[bits_count & 7]) {
        Bits g = b;
        g.skip(1);
        g.align();
        int len = 0;
        for (; len < 32; ++len)
          if (g.get1()) break;
        int mb_num = static_cast<int>(g.get(mb_num_bits()));
        if (!mb_num || mb_num > mb_w_ * mb_h_ || g.idx + 6 > g.size_bits)
          mb_num = -1;
        if (len >= prefix_length()) return mb_num;
      }
    }
    return 0;
  }

  int video_packet_header(Bits& b) {
    if (b.idx > b.size_bits - 20) return -1;
    int len = 0;
    for (; len < 32; ++len)
      if (b.get1()) break;
    if (len != prefix_length()) return -1;
    const int mb_num = static_cast<int>(b.get(mb_num_bits()));
    if (mb_num >= mb_w_ * mb_h_ || !mb_num) return -1;
    mb_x_ = mb_num % mb_w_;
    mb_y_ = mb_num / mb_w_;
    const int q = static_cast<int>(b.get(quant_precision_));
    if (q) qscale_ = q;
    if (b.get1()) {  // header extension
      while (b.get1()) {
      }
      b.skip(1);
      b.skip(time_inc_bits_);
      b.skip(1);
      b.skip(2);
      b.skip(3);
      if (pict_p_) b.skip(3);
    }
    return 0;
  }

  // ff_h263_resync
  int resync(Bits& b) {
    b.skip(1);
    b.align();
    if (b.show(16) == 0) {
      Bits g = b;
      if (video_packet_header(g) >= 0) {
        b = g;
        return 0;
      }
    }
    b.idx = last_resync_idx_;
    b.align();
    for (int left = b.left(); left > 16 + 1 + 5 + 5; left -= 8) {
      if (b.show(16) == 0) {
        Bits g = b;
        if (video_packet_header(g) >= 0) {
          b = g;
          return 0;
        }
      }
      b.skip(8);
    }
    return -1;
  }
  int last_resync_idx_ = 0;

  // ff_mpeg4_clean_buffers: AC predictors of the row above (from the
  // macroblock left of the new slice's first) and of that left one
  void clean_buffers() {
    const int start = (mb_y_ - 1) * mb_w_ + mb_x_ - 1;
    for (int i = 0; i <= mb_w_ + 0; ++i) {
      const int m = start + i;
      if (m < 0 || m >= mb_w_ * mb_h_) continue;
      std::fill(ac_[0].begin() + m * 64, ac_[0].begin() + m * 64 + 64, 0);
      std::fill(ac_[1].begin() + m * 16, ac_[1].begin() + m * 16 + 16, 0);
      std::fill(ac_[2].begin() + m * 16, ac_[2].begin() + m * 16 + 16, 0);
    }
  }

  // ---------------------------------------------------------- macroblocks

  int mb_index() const { return mb_y_ * mb_w_ + mb_x_; }

  int decode_mb(Bits& b) {
    const Tables& t = tables();
    int cbpc = 0, dquant = 0;
    mv4_ = 0;
    for (auto& l : last_) l = -1;
    if (pict_p_) {
      do {
        if (b.get1()) {  // not coded
          mb_intra_ = 0;
          mv_x_[0] = mv_y_[0] = 0;
          skipped_ = true;
          mbtype_[mb_index()] = kTypeSkip;
          return end_of_mb(b);
        }
        cbpc = t.inter_mcbpc.read(b);
        if (cbpc < 0) return kSliceError;
      } while (cbpc == 20);
      skipped_ = false;
      dquant = cbpc & 8;
      mb_intra_ = (cbpc & 4) != 0;
      if (!mb_intra_) {
        std::memset(block_, 0, sizeof(block_));
        int cbpy = t.cbpy.read(b);
        if (cbpy < 0) return kSliceError;
        cbpy ^= 0xF;
        int cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) set_qscale(qscale_ + kDquant[b.get(2)]);
        mbtype_[mb_index()] = (cbpc & 16) ? kTypeInter8 : kTypeInter16;
        if (!(cbpc & 16)) {
          int px, py;
          pred_motion(0, &px, &py);
          const int mx = decode_motion(b, px);
          if (mx >= 0xffff) return kSliceError;
          const int my = decode_motion(b, py);
          if (my >= 0xffff) return kSliceError;
          mv_x_[0] = mx;
          mv_y_[0] = my;
        } else {
          mv4_ = 1;
          for (int i = 0; i < 4; ++i) {
            int px, py;
            int16_t* mv = pred_motion(i, &px, &py);
            const int mx = decode_motion(b, px);
            if (mx >= 0xffff) return kSliceError;
            const int my = decode_motion(b, py);
            if (my >= 0xffff) return kSliceError;
            mv_x_[i] = mx;
            mv_y_[i] = my;
            mv[0] = static_cast<int16_t>(mx);
            mv[1] = static_cast<int16_t>(my);
          }
        }
        for (int i = 0; i < 6; ++i) {
          if (decode_block(b, i, cbp & 32, false) < 0) return kSliceError;
          cbp += cbp;
        }
        return end_of_mb(b);
      }
    } else {
      do {
        cbpc = t.intra_mcbpc.read(b);
        if (cbpc < 0) return kSliceError;
      } while (cbpc == 8);
      skipped_ = false;
      dquant = cbpc & 4;
      mb_intra_ = 1;
    }
    // intra
    mbtype_[mb_index()] = kTypeIntra;
    ac_pred_ = b.get1();
    const int cbpy = t.cbpy.read(b);
    if (cbpy < 0) return kSliceError;
    int cbp = (cbpc & 3) | (cbpy << 2);
    use_dc_vlc_ = qscale_ < dc_threshold_;
    if (dquant) set_qscale(qscale_ + kDquant[b.get(2)]);
    std::memset(block_, 0, sizeof(block_));
    for (int i = 0; i < 6; ++i) {
      if (decode_block(b, i, cbp & 32, true) < 0) return kSliceError;
      cbp += cbp;
    }
    return end_of_mb(b);
  }
  static constexpr int kDquant[4] = {-1, -2, 1, 2};
  bool skipped_ = false;

  // the per-macroblock end-of-slice check: any resync marker or the
  // stuffing at the data's end ends the slice (FFmpeg compares the
  // macroblock numbers only for B-VOPs and with AV_EF_AGGRESSIVE)
  int end_of_mb(Bits& b) {
    return is_resync(b) ? kSliceEnd : kSliceOk;
  }

  int decode_motion(Bits& b, int pred) {
    const int code = tables().mv.read(b);
    if (code == 0) return pred;
    if (code < 0) return 0xffff;
    const int sign = b.get1();
    const int shift = f_code_ - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= static_cast<int>(b.get(shift));
      ++val;
    }
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + f_code_;
    val = static_cast<int>(static_cast<uint32_t>(val) << (32 - bits)) >>
          (32 - bits);
    return val;
  }

  // motion_val of 8x8 block (bx, by) in the picture's block grid; outside
  // it (left of column 0, right of the last, above row 0) the zero that
  // FFmpeg's border entries hold
  int16_t* mv_at(int bx, int by) {
    static int16_t zero[2];
    if (bx < 0 || by < 0 || bx >= 2 * mb_w_) {
      zero[0] = zero[1] = 0;
      return zero;
    }
    return &mv_[(static_cast<size_t>(by) * 2 * mb_w_ + bx) * 2];
  }

  // ff_h263_pred_motion for block `n` of the current macroblock
  int16_t* pred_motion(int n, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    const int bx = 2 * mb_x_ + (n & 1), by = 2 * mb_y_ + (n >> 1);
    int16_t* cur = mv_at(bx, by);
    int16_t* A = mv_at(bx - 1, by);
    if (first_line_ && n < 3) {
      if (n == 0) {
        if (mb_x_ == resync_x_) {
          *px = *py = 0;
        } else if (mb_x_ + 1 == resync_x_) {
          const int16_t* C = mv_at(bx + off[n], by - 1);
          if (mb_x_ == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid_pred(A[0], 0, C[0]);
            *py = mid_pred(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (n == 1) {
        if (mb_x_ + 1 == resync_x_) {
          const int16_t* C = mv_at(bx + off[n], by - 1);
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        const int16_t* B = mv_at(bx, by - 1);
        const int16_t* C = mv_at(bx + off[n], by - 1);
        // FFmpeg zeroes the stored vector of the previous slice's block
        // (the deblocking of error concealment reads it later)
        if (mb_x_ == resync_x_) A[0] = A[1] = 0;
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      const int16_t* B = mv_at(bx, by - 1);
      const int16_t* C = mv_at(bx + off[n], by - 1);
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
    return cur;
  }

  void update_motion_val() {
    if (mv4_) return;
    const int x = mb_intra_ ? 0 : mv_x_[0], y = mb_intra_ ? 0 : mv_y_[0];
    for (int i = 0; i < 4; ++i) {
      int16_t* m = mv_at(2 * mb_x_ + (i & 1), 2 * mb_y_ + (i >> 1));
      m[0] = static_cast<int16_t>(x);
      m[1] = static_cast<int16_t>(y);
    }
  }

  // DC / AC predictor storage of block n of the current macroblock, and of
  // its neighbours (dx, dy in blocks of that plane); outside the picture
  // the defaults
  int16_t dc_at(int n, int dx, int dy) const {
    int bx, by, w, p;
    if (n < 4) {
      bx = 2 * mb_x_ + (n & 1) + dx;
      by = 2 * mb_y_ + (n >> 1) + dy;
      w = 2 * mb_w_;
      p = 0;
    } else {
      bx = mb_x_ + dx;
      by = mb_y_ + dy;
      w = mb_w_;
      p = n - 3;
    }
    if (bx < 0 || by < 0 || bx >= w) return 1024;
    return dc_[p][static_cast<size_t>(by) * w + bx];
  }
  int16_t* dc_ptr(int n) {
    if (n < 4)
      return &dc_[0][static_cast<size_t>(2 * mb_y_ + (n >> 1)) * 2 * mb_w_ +
                     2 * mb_x_ + (n & 1)];
    return &dc_[n - 3][static_cast<size_t>(mb_y_) * mb_w_ + mb_x_];
  }
  int16_t* ac_ptr(int n, int dx, int dy) {
    static int16_t zero[16];
    int bx, by, w, p;
    if (n < 4) {
      bx = 2 * mb_x_ + (n & 1) + dx;
      by = 2 * mb_y_ + (n >> 1) + dy;
      w = 2 * mb_w_;
      p = 0;
    } else {
      bx = mb_x_ + dx;
      by = mb_y_ + dy;
      w = mb_w_;
      p = n - 3;
    }
    if (bx < 0 || by < 0 || bx >= w) {
      std::memset(zero, 0, sizeof(zero));
      return zero;
    }
    return &ac_[p][(static_cast<size_t>(by) * w + bx) * 16];
  }
  int qs_at(int dx, int dy) const {
    return qs_[static_cast<size_t>(mb_y_ + dy) * mb_w_ + mb_x_ + dx];
  }

  // mpeg4_pred_dc: the predictor and its direction (0 left, 1 top)
  int pred_dc(int n, int* dir) const {
    int a = dc_at(n, -1, 0), b = dc_at(n, -1, -1), c = dc_at(n, 0, -1);
    if (first_line_ && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x_ == resync_x_) b = a = 1024;
    }
    if (mb_x_ == resync_x_ && mb_y_ == resync_y_ + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    if (std::abs(a - b) < std::abs(b - c)) {
      *dir = 1;
      return c;
    }
    *dir = 0;
    return a;
  }

  int dc_scale(int n) const {
    return n < 4 ? y_dc_scale(qscale_) : c_dc_scale(qscale_);
  }

  // mpeg4_get_level_dc
  int level_dc(int n, int pred, int level) {
    const int scale = dc_scale(n);
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    const int ret = level;
    level *= scale;
    if (level & ~2047) {
      if (level < 0) {
        level = 0;
      } else if (!bug_dc_clip_) {
        level = 2047;
      }
    }
    *dc_ptr(n) = static_cast<int16_t>(level);
    return ret;
  }

  int decode_block(Bits& b, int n, int coded, bool intra) {
    const Tables& t = tables();
    int16_t* block = block_[n];
    int i, dir = 0, pred = 0, qmul, qadd;
    const uint8_t* scan = kZigzag;
    const RunLevel* rl;
    if (intra) {
      if (use_dc_vlc_) {
        const int code = (n < 4 ? t.dc_lum : t.dc_chrom).read(b);
        if (code < 0 || code > 9) return -1;
        int level = 0;
        if (code) {
          level = b.xbits(code);
          if (code > 8) b.skip(1);  // marker
        }
        pred = pred_dc(n, &dir);
        block[0] = static_cast<int16_t>(level_dc(n, pred, level));
        i = 0;
      } else {
        i = -1;
        pred = pred_dc(n, &dir);
      }
      rl = &t.intra;
      if (ac_pred_) scan = dir == 0 ? kAltVertical : kAltHorizontal;
      qmul = 1;
      qadd = 0;
    } else {
      i = -1;
      if (!coded) {
        last_[n] = -1;
        return 0;
      }
      rl = &t.inter;
      if (mpeg_quant_) {
        qmul = 1;
        qadd = 0;
      } else {
        qmul = qscale_ << 1;
        qadd = (qscale_ - 1) | 1;
      }
    }
    if (coded) {
      for (;;) {
        int e = rl->vlc.read(b);
        if (e < 0) return -1;
        int run, level, last;
        if (e == 102) {  // escape
          if (!b.get1()) {
            e = rl->vlc.read(b);
            if (e < 0 || e == 102) return -1;
            run = rl->run[e];
            last = rl->last[e];
            level = (rl->level[e] + rl->max_level[last][run]) * qmul + qadd;
            if (b.get1()) level = -level;
          } else if (!b.get1()) {
            e = rl->vlc.read(b);
            if (e < 0 || e == 102) return -1;
            last = rl->last[e];
            level = rl->level[e] * qmul + qadd;
            run = rl->run[e] + rl->max_run[last][rl->level[e]] + 1;
            if (b.get1()) level = -level;
          } else {
            last = b.get1();
            run = static_cast<int>(b.get(6));
            if (!b.get1()) return -1;  // "1. marker bit missing in 3. esc"
            level = b.sbits(12);
            if (!b.get1()) return -1;  // "2. marker bit missing in 3. esc"
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (static_cast<unsigned>(level + 2048) > 4095)
              level = level < 0 ? -2048 : 2047;
          }
        } else {
          run = rl->run[e];
          last = rl->last[e];
          level = rl->level[e] * qmul + qadd;
          if (b.get1()) level = -level;
        }
        i += run + 1;
        if (i > 63 || (!last && i > 62)) return -1;  // ac-tex damaged
        if (last) {
          block[scan[i]] = static_cast<int16_t>(level);
          break;
        }
        block[scan[i]] = static_cast<int16_t>(level);
      }
    }
    if (intra) {
      if (!use_dc_vlc_) {
        block[0] = static_cast<int16_t>(level_dc(n, pred, block[0]));
        if (i < 0) i = 0;
      }
      pred_ac(block, n, dir);
      if (ac_pred_) i = 63;
    }
    last_[n] = i;
    return 0;
  }

  static int rounded_div(int a, int b) {
    return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b;
  }

  // ff_mpeg4_pred_ac on the quantised levels; stores this block's
  void pred_ac(int16_t* block, int n, int dir) {
    int16_t* self = ac_ptr(n, 0, 0);
    if (ac_pred_) {
      if (dir == 0) {
        const int16_t* ac = ac_ptr(n, -1, 0);
        const bool same = mb_x_ == 0 || n == 1 || n == 3 ||
                          qscale_ == qs_at(-1, 0);
        for (int k = 1; k < 8; ++k)
          block[k << 3] = static_cast<int16_t>(
              block[k << 3] +
              (same ? ac[k] : rounded_div(ac[k] * qs_at(-1, 0), qscale_)));
      } else {
        const int16_t* ac = ac_ptr(n, 0, -1);
        const bool same = mb_y_ == 0 || n == 2 || n == 3 ||
                          qscale_ == qs_at(0, -1);
        for (int k = 1; k < 8; ++k)
          block[k] = static_cast<int16_t>(
              block[k] +
              (same ? ac[k + 8] : rounded_div(ac[k + 8] * qs_at(0, -1),
                                              qscale_)));
      }
    }
    for (int k = 1; k < 8; ++k) self[k] = block[k << 3];
    for (int k = 1; k < 8; ++k) self[8 + k] = block[k];
  }

  // ---------------------------------------------------------- reconstruct

  uint8_t* dest(int n) {
    if (n < 4)
      return cur_[0].data() + (mb_y_ * 16 + (n >> 1) * 8) * lw_ +
             mb_x_ * 16 + (n & 1) * 8;
    return cur_[n - 3].data() + mb_y_ * 8 * cw_ + mb_x_ * 8;
  }

  // ff_mpv_reconstruct_mb for the picture's current macroblock
  void reconstruct() {
    qs_[mb_index()] = static_cast<int8_t>(qscale_);
    skip_[mb_index()] = skipped_ && !mb_intra_;
    if (!mb_intra_) {
      // ff_clean_intra_table_entries
      for (int n = 0; n < 6; ++n) {
        *dc_ptr(n) = 1024;
        std::memset(ac_ptr(n, 0, 0), 0, 16 * sizeof(int16_t));
      }
      motion();
      for (int n = 0; n < 6; ++n) {
        if (last_[n] < 0) continue;
        if (mpeg_quant_) unquantize_mpeg2_inter(block_[n], last_[n]);
        etvideo::idct_add(block_[n], dest(n), n < 4 ? lw_ : cw_);
      }
      return;
    }
    for (int n = 0; n < 6; ++n) {
      if (mpeg_quant_) {
        unquantize_mpeg2_intra(block_[n], n);
      } else {
        unquantize_h263_intra(block_[n], n);
      }
      etvideo::idct_put(block_[n], dest(n), n < 4 ? lw_ : cw_);
    }
  }

  void unquantize_h263_intra(int16_t* block, int n) {
    const int qmul = qscale_ << 1, qadd = (qscale_ - 1) | 1;
    block[0] = static_cast<int16_t>(block[0] * dc_scale(n));
    for (int i = 1; i < 64; ++i) {
      const int level = block[i];
      if (level)
        block[i] = static_cast<int16_t>(level < 0 ? level * qmul - qadd
                                                  : level * qmul + qadd);
    }
  }

  void unquantize_mpeg2_intra(int16_t* block, int n) {
    const int q = qscale_ << 1;
    block[0] = static_cast<int16_t>(block[0] * dc_scale(n));
    for (int i = 1; i < 64; ++i) {
      const int level = block[i];
      if (!level) continue;
      const int v = (std::abs(level) * q * intra_matrix_[i]) >> 4;
      block[i] = static_cast<int16_t>(level < 0 ? -v : v);
    }
  }

  void unquantize_mpeg2_inter(int16_t* block, int last) {
    const int q = qscale_ << 1;
    int sum = -1;
    for (int k = 0; k <= last; ++k) {
      const int j = kZigzag[k];
      const int level = block[j];
      if (!level) continue;
      int v = (((std::abs(level) << 1) + 1) * q * inter_matrix_[j]) >> 5;
      if (level < 0) v = -v;
      block[j] = static_cast<int16_t>(v);
      sum += v;
    }
    block[63] = static_cast<int16_t>(block[63] ^ (sum & 1));
  }

  etvideo::RefPlane ref_plane(int p) const {
    const bool luma = p == 0;
    const int ew = bug_edge_ ? (luma ? width_ : width_ >> 1)
                             : (luma ? lw_ : cw_);
    const int eh = bug_edge_ ? (luma ? height_ : height_ >> 1)
                             : (luma ? mb_h_ * 16 : mb_h_ * 8);
    return {ref_[p].data(), luma ? lw_ : cw_, ew, eh};
  }

  void motion() {
    const bool nr = no_rounding_ != 0;
    const etvideo::RefPlane ry = ref_plane(0), ru = ref_plane(1),
                            rv = ref_plane(2);
    if (!mv4_) {
      const int mx = mb_intra_ ? 0 : mv_x_[0], my = mv_y_[0];
      const int dxy = ((my & 1) << 1) | (mx & 1);
      const int sx = mb_x_ * 16 + (mx >> 1), sy = mb_y_ * 16 + (my >> 1);
      etvideo::hpel_put(ry, sx, sy, dxy, nr, dest(0), lw_, 16, 16);
      const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      const int ux = sx >> 1, uy = sy >> 1;
      etvideo::hpel_put(ru, ux, uy, uvdxy, nr, dest(4), cw_, 8, 8);
      etvideo::hpel_put(rv, ux, uy, uvdxy, nr, dest(5), cw_, 8, 8);
      return;
    }
    int sum_x = 0, sum_y = 0;
    for (int i = 0; i < 4; ++i) {
      const int mx = mv_x_[i], my = mv_y_[i];
      int sx = mb_x_ * 16 + (i & 1) * 8 + (mx >> 1);
      int sy = mb_y_ * 16 + (i >> 1) * 8 + (my >> 1);
      int dxy = 0;
      sx = std::min(std::max(sx, -16), width_);
      if (sx != width_) dxy |= mx & 1;
      sy = std::min(std::max(sy, -16), height_);
      if (sy != height_) dxy |= (my & 1) << 1;
      etvideo::hpel_put(ry, sx, sy, dxy, nr, dest(i), lw_, 8, 8);
      sum_x += mx;
      sum_y += my;
    }
    static const uint8_t roundtab[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                         1, 1, 1, 1, 1, 1, 2, 2};
    int mx = roundtab[sum_x & 0xf] + ((sum_x >> 3) & ~1);
    int my = roundtab[sum_y & 0xf] + ((sum_y >> 3) & ~1);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int sx = mb_x_ * 8 + mx, sy = mb_y_ * 8 + my;
    sx = std::min(std::max(sx, -8), width_ >> 1);
    if (sx == (width_ >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), height_ >> 1);
    if (sy == (height_ >> 1)) dxy &= ~2;
    etvideo::hpel_put(ru, sx, sy, dxy, nr, dest(4), cw_, 8, 8);
    etvideo::hpel_put(rv, sx, sy, dxy, nr, dest(5), cw_, 8, 8);
  }
  // ---------------------------------------------------------- concealment

  // ff_er_add_slice (macroblock indices are raster positions here)
  void add_slice(int sx, int sy, int ex, int ey, uint8_t status) {
    const int num = mb_w_ * mb_h_;
    const int start = std::min(std::max(sx + sy * mb_w_, 0), num - 1);
    const int end = std::min(std::max(ex + ey * mb_w_, 0), num);
    if (start > end) return;
    int mask = ~kVpStart;
    if (status & (kErAcError | kErAcEnd)) {
      mask &= ~(kErAcError | kErAcEnd);
      error_count_ += start - end - 1;
    }
    if (status & (kErDcError | kErDcEnd)) {
      mask &= ~(kErDcError | kErDcEnd);
      error_count_ += start - end - 1;
    }
    if (status & (kErMvError | kErMvEnd)) {
      mask &= ~(kErMvError | kErMvEnd);
      error_count_ += start - end - 1;
    }
    if (status & kErMbError) error_count_ = INT32_MAX;
    for (int i = start; i < end; ++i)
      status_[i] = static_cast<uint8_t>(status_[i] & mask);
    if (end == num) {
      error_count_ = INT32_MAX;
    } else {
      status_[end] = static_cast<uint8_t>((status_[end] & mask) | status);
    }
    status_[start] |= kVpStart;
    if (start > 0) {
      const int prev = status_[start - 1] & ~kVpStart;
      if (prev != kErMbEnd) error_count_ = INT32_MAX;
    }
  }

  bool intra(int m) const { return mbtype_[m] == kTypeIntra; }

  // ER's decode_mb: the 16x16 prediction of macroblock (x, y) from the last
  // picture with vector (mx, my), no residual
  void er_mc(int x, int y, int mx, int my) {
    mb_x_ = x;
    mb_y_ = y;
    mv4_ = 0;
    mb_intra_ = 0;
    mv_x_[0] = mx;
    mv_y_[0] = my;
    motion();
  }

  static int sad16(const uint8_t* a, const uint8_t* b, int stride) {
    int s = 0;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x)
        s += std::abs(a[y * stride + x] - b[y * stride + x]);
    return s;
  }

  bool intra_more_likely() const {
    if (intra_only_) return true;
    const int num = mb_w_ * mb_h_;
    int undamaged = 0;
    for (int i = 0; i < num; ++i)
      if (!((status_[i] & kErDcError) && (status_[i] & kErMvError)))
        ++undamaged;
    if (undamaged < 5) return false;
    const int skip_amount = std::max(undamaged / 50, 1);
    int likely = 0, j = 0;
    for (int y = 0; y < mb_h_ - 1; ++y) {
      for (int x = 0; x < mb_w_; ++x) {
        const int m = y * mb_w_ + x;
        if ((status_[m] & kErDcError) && (status_[m] & kErMvError)) continue;
        ++j;
        if (j % skip_amount) continue;
        if (!pict_p_) {
          const uint8_t* cur = cur_[0].data() + y * 16 * lw_ + x * 16;
          const uint8_t* last = ref_[0].data() + y * 16 * lw_ + x * 16;
          likely += sad16(last, cur, lw_);
          likely -= sad16(last, last + lw_ * 16, lw_);
        } else {
          likely += intra(m) ? 1 : -1;
        }
      }
    }
    return likely > 0;
  }

  int16_t* mv0(int x, int y) { return mv_at(2 * x, 2 * y); }

  void guess_mv() {
    enum { kListed = 1, kUnchanged = 2, kChanged = 4, kFrozen = 8 };
    const int num = mb_w_ * mb_h_;
    std::vector<uint8_t> fixed(num, 0);
    int avail = 0;
    for (int m = 0; m < num; ++m) {
      int f = 0;
      if (intra(m) || !(status_[m] & kErMvError)) f = kFrozen;
      fixed[m] = static_cast<uint8_t>(f);
      if (f == kFrozen) {
        ++avail;
      } else if (!intra_only_) {
        const int x = m % mb_w_, y = m / mb_w_;
        const int16_t* p = &prev_mv_[(static_cast<size_t>(2 * y) * 2 * mb_w_ +
                                      2 * x) * 2];
        mv0(x, y)[0] = p[0];
        mv0(x, y)[1] = p[1];
      }
    }
    if (avail <= std::max(mb_w_, mb_h_) / 2) {
      for (int y = 0; y < mb_h_; ++y)
        for (int x = 0; x < mb_w_; ++x) {
          const int m = y * mb_w_ + x;
          if (intra(m) || !(status_[m] & kErMvError)) continue;
          er_mc(x, y, 0, 0);
        }
      return;
    }
    std::vector<std::pair<int, int>> list, next;
    auto add = [&](std::vector<std::pair<int, int>>& l, int x, int y) {
      const int m = y * mb_w_ + x;
      if (fixed[m]) return;
      fixed[m] = kListed;
      l.emplace_back(x, y);
    };
    auto neighbours = [&](std::vector<std::pair<int, int>>& l, int x,
                          int y) {
      if (x) add(l, x - 1, y);
      if (y) add(l, x, y - 1);
      if (x + 1 < mb_w_) add(l, x + 1, y);
      if (y + 1 < mb_h_) add(l, x, y + 1);
    };
    for (int y = 0; y < mb_h_; ++y)
      for (int x = 0; x < mb_w_; ++x)
        if (fixed[y * mb_w_ + x] == kFrozen) neighbours(list, x, y);
    for (;;) {
      bool none_left = true;
      int changed = 1;
      for (int pass = 0; (changed || pass < 2) && pass < 10; ++pass) {
        changed = 0;
        for (const auto& xy : list) {
          const int x = xy.first, y = xy.second, m = y * mb_w_ + x;
          if ((x ^ y ^ pass) & 1) continue;
          int j = 0;
          if (x > 0) j |= fixed[m - 1];
          if (x + 1 < mb_w_) j |= fixed[m + 1];
          if (y > 0) j |= fixed[m - mb_w_];
          if (y + 1 < mb_h_) j |= fixed[m + mb_w_];
          if (!(j & kChanged) && pass > 1) continue;
          none_left = false;
          int pred[8][2], n = 0;
          if (x > 0 && fixed[m - 1] > 1) {
            pred[n][0] = mv0(x - 1, y)[0];
            pred[n++][1] = mv0(x - 1, y)[1];
          }
          if (x + 1 < mb_w_ && fixed[m + 1] > 1) {
            pred[n][0] = mv0(x + 1, y)[0];
            pred[n++][1] = mv0(x + 1, y)[1];
          }
          if (y > 0 && fixed[m - mb_w_] > 1) {
            pred[n][0] = mv0(x, y - 1)[0];
            pred[n++][1] = mv0(x, y - 1)[1];
          }
          if (y + 1 < mb_h_ && fixed[m + mb_w_] > 1) {
            pred[n][0] = mv0(x, y + 1)[0];
            pred[n++][1] = mv0(x, y + 1)[1];
          }
          if (n == 0) continue;
          if (n > 1) {
            int sx = 0, sy = 0;
            for (int k = 0; k < n; ++k) {
              sx += pred[k][0];
              sy += pred[k][1];
            }
            pred[n][0] = sx / n;  // mean
            pred[n][1] = sy / n;
            int minx, miny, maxx, maxy;
            if (n >= 3) {
              minx = miny = 99999;
              maxx = maxy = -99999;
            } else {
              minx = miny = maxx = maxy = 0;
            }
            for (int k = 0; k < n; ++k) {
              maxx = std::max(maxx, pred[k][0]);
              maxy = std::max(maxy, pred[k][1]);
              minx = std::min(minx, pred[k][0]);
              miny = std::min(miny, pred[k][1]);
            }
            pred[n + 1][0] = sx - maxx - minx;  // median
            pred[n + 1][1] = sy - maxy - miny;
            if (n == 4) {
              pred[n + 1][0] /= 2;
              pred[n + 1][1] /= 2;
            }
            n += 2;
          }
          pred[n][0] = pred[n][1] = 0;  // zero
          ++n;
          const int prev_x = mv0(x, y)[0], prev_y = mv0(x, y)[1];
          pred[n][0] = prev_x;  // last
          pred[n][1] = prev_y;
          ++n;
          int best = 0, best_score = 256 * 256 * 256 * 64;
          const uint8_t* src = cur_[0].data() + y * 16 * lw_ + x * 16;
          for (int k = 0; k < n; ++k) {
            mv0(x, y)[0] = static_cast<int16_t>(pred[k][0]);
            mv0(x, y)[1] = static_cast<int16_t>(pred[k][1]);
            er_mc(x, y, pred[k][0], pred[k][1]);
            int score = 0;
            if (x > 0 && fixed[m - 1] > 1)
              for (int r = 0; r < 16; ++r)
                score += std::abs(src[r * lw_ - 1] - src[r * lw_]);
            if (x + 1 < mb_w_ && fixed[m + 1] > 1)
              for (int r = 0; r < 16; ++r)
                score += std::abs(src[r * lw_ + 15] - src[r * lw_ + 16]);
            if (y > 0 && fixed[m - mb_w_] > 1)
              for (int c = 0; c < 16; ++c)
                score += std::abs(src[c - lw_] - src[c]);
            if (y + 1 < mb_h_ && fixed[m + mb_w_] > 1)
              for (int c = 0; c < 16; ++c)
                score += std::abs(src[c + lw_ * 15] - src[c + lw_ * 16]);
            if (score <= best_score) {
              best_score = score;
              best = k;
            }
          }
          for (int i = 0; i < 4; ++i) {
            int16_t* v = mv_at(2 * x + (i & 1), 2 * y + (i >> 1));
            v[0] = static_cast<int16_t>(pred[best][0]);
            v[1] = static_cast<int16_t>(pred[best][1]);
          }
          er_mc(x, y, pred[best][0], pred[best][1]);
          if (pred[best][0] != prev_x || pred[best][1] != prev_y) {
            fixed[m] = kChanged;
            ++changed;
          } else {
            fixed[m] = kUnchanged;
          }
        }
      }
      if (none_left) return;
      next.clear();
      for (const auto& xy : list) {
        const int x = xy.first, y = xy.second, m = y * mb_w_ + x;
        if (fixed[m] & (kChanged | kUnchanged | kFrozen)) {
          fixed[m] = kFrozen;
          neighbours(next, x, y);
        }
      }
      std::swap(list, next);
    }
  }

  // guess_dc over a grid of w x h blocks (luma: 2 per macroblock side)
  void guess_dc(std::vector<int>& dc, int w, int h, int shift) {
    std::vector<int> col(static_cast<size_t>(w) * h * 4);
    std::vector<int> dist(col.size());
    auto ok = [&](int bx, int by) {
      const int m = (bx >> shift) + (by >> shift) * mb_w_;
      return !intra(m) || !(status_[m] & kErDcError);
    };
    for (int by = 0; by < h; ++by) {
      int color = 1024, d = -1;
      for (int bx = 0; bx < w; ++bx) {
        if (ok(bx, by)) {
          color = dc[by * w + bx];
          d = bx;
        }
        col[(by * w + bx) * 4 + 1] = color;
        dist[(by * w + bx) * 4 + 1] = d >= 0 ? bx - d : 9999;
      }
      color = 1024;
      d = -1;
      for (int bx = w - 1; bx >= 0; --bx) {
        if (ok(bx, by)) {
          color = dc[by * w + bx];
          d = bx;
        }
        col[(by * w + bx) * 4 + 0] = color;
        dist[(by * w + bx) * 4 + 0] = d >= 0 ? d - bx : 9999;
      }
    }
    for (int bx = 0; bx < w; ++bx) {
      int color = 1024, d = -1;
      for (int by = 0; by < h; ++by) {
        if (ok(bx, by)) {
          color = dc[by * w + bx];
          d = by;
        }
        col[(by * w + bx) * 4 + 3] = color;
        dist[(by * w + bx) * 4 + 3] = d >= 0 ? by - d : 9999;
      }
      color = 1024;
      d = -1;
      for (int by = h - 1; by >= 0; --by) {
        if (ok(bx, by)) {
          color = dc[by * w + bx];
          d = by;
        }
        col[(by * w + bx) * 4 + 2] = color;
        dist[(by * w + bx) * 4 + 2] = d >= 0 ? d - by : 9999;
      }
    }
    for (int by = 0; by < h; ++by) {
      for (int bx = 0; bx < w; ++bx) {
        const int m = (bx >> shift) + (by >> shift) * mb_w_;
        if (!intra(m) || !(status_[m] & kErDcError)) continue;
        int64_t guess = 0, weight_sum = 0;
        for (int j = 0; j < 4; ++j) {
          const int64_t weight =
              int64_t{256 * 256 * 256 * 16} /
              std::max(dist[(by * w + bx) * 4 + j], 1);
          guess += weight * col[(by * w + bx) * 4 + j];
          weight_sum += weight;
        }
        dc[by * w + bx] = static_cast<int>((guess + weight_sum / 2) /
                                           weight_sum);
      }
    }
  }

  static void filter181(std::vector<int>& dc, int w, int h) {
    auto f = [](int v) {
      v = std::min(std::max(v, INT32_MIN / 10923),
                   INT32_MAX / 10923 - 32768);
      return (v * 10923 + 32768) >> 16;
    };
    for (int y = 1; y < h - 1; ++y) {
      int prev = dc[y * w];
      for (int x = 1; x < w - 1; ++x) {
        const int v = f(-prev + dc[y * w + x] * 8 - dc[y * w + x + 1]);
        prev = dc[y * w + x];
        dc[y * w + x] = static_cast<int16_t>(v);
      }
    }
    for (int x = 1; x < w - 1; ++x) {
      int prev = dc[x];
      for (int y = 1; y < h - 1; ++y) {
        const int v = f(-prev + dc[y * w + x] * 8 - dc[(y + 1) * w + x]);
        prev = dc[y * w + x];
        dc[y * w + x] = static_cast<int16_t>(v);
      }
    }
  }

  // h_block_filter (vertical = false) / v_block_filter (true) of a plane
  void block_filter(uint8_t* dst, int stride, int w, int h, int shift,
                    bool vertical) {
    const int wn = vertical ? w : w - 1, hn = vertical ? h - 1 : h;
    for (int by = 0; by < hn; ++by) {
      for (int bx = 0; bx < wn; ++bx) {
        const int bx2 = vertical ? bx : bx + 1, by2 = vertical ? by + 1 : by;
        const int ma = (bx >> shift) + (by >> shift) * mb_w_;
        const int mb = (bx2 >> shift) + (by2 >> shift) * mb_w_;
        const bool da = status_[ma] & kErMbError, db = status_[mb] & kErMbError;
        if (!da && !db) continue;
        // the block's vector: luma per 8x8 block, chroma the macroblock's
        const int16_t* va = shift ? mv_at(bx, by) : mv0(bx, by);
        const int16_t* vb = shift ? mv_at(bx2, by2) : mv0(bx2, by2);
        if (!intra(ma) && !intra(mb) &&
            std::abs(va[0] - vb[0]) + std::abs(va[1] + vb[1]) < 2)
          continue;
        const int step = vertical ? stride : 1;   // across the edge
        const int along = vertical ? 1 : stride;  // along it
        uint8_t* o = dst + bx * 8 + by * stride * 8;
        for (int k = 0; k < 8; ++k) {
          uint8_t* p = o + k * along;
          const int a = p[7 * step] - p[6 * step];
          const int b = p[8 * step] - p[7 * step];
          const int c = p[9 * step] - p[8 * step];
          int d = std::abs(b) - ((std::abs(a) + std::abs(c) + 1) >> 1);
          d = std::max(d, 0);
          if (b < 0) d = -d;
          if (d == 0) continue;
          if (!(da && db)) d = d * 16 / 9;
          if (da) {
            p[7 * step] = etvideo::clip_u8(p[7 * step] + ((d * 7) >> 4));
            p[6 * step] = etvideo::clip_u8(p[6 * step] + ((d * 5) >> 4));
            p[5 * step] = etvideo::clip_u8(p[5 * step] + ((d * 3) >> 4));
            p[4 * step] = etvideo::clip_u8(p[4 * step] + ((d * 1) >> 4));
          }
          if (db) {
            p[8 * step] = etvideo::clip_u8(p[8 * step] - ((d * 7) >> 4));
            p[9 * step] = etvideo::clip_u8(p[9 * step] - ((d * 5) >> 4));
            p[10 * step] = etvideo::clip_u8(p[10 * step] - ((d * 3) >> 4));
            p[11 * step] = etvideo::clip_u8(p[11 * step] - ((d * 1) >> 4));
          }
        }
      }
    }
  }

  // ff_er_frame_end
  void conceal() {
    const int num = mb_w_ * mb_h_;
    // overlapping slices
    for (int t = 1; t <= 3; ++t) {
      bool end_ok = false;
      for (int i = num - 1; i >= 0; --i) {
        const int e = status_[i];
        if (e & (1 << t)) end_ok = true;
        if (e & (8 << t)) end_ok = true;
        if (!end_ok) status_[i] |= static_cast<uint8_t>(1 << t);
        if (e & kVpStart) end_ok = false;
      }
    }
    // backward marking
    int distance = 9999999;
    for (int t = 1; t <= 3; ++t) {
      for (int i = num - 1; i >= 0; --i) {
        const int e = status_[i];
        if (!skip_[i]) ++distance;
        if (e & (1 << t)) distance = 0;
        if (distance < 50) status_[i] |= static_cast<uint8_t>(1 << t);
        if (e & kVpStart) distance = 9999999;
      }
    }
    // forward marking
    int err = 0;
    for (int i = 0; i < num; ++i) {
      const int old = status_[i];
      if (old & kVpStart) {
        err = old & kErMbError;
      } else {
        err |= old & kErMbError;
        status_[i] |= static_cast<uint8_t>(err);
      }
    }
    for (int i = 0; i < num; ++i)
      if (status_[i] & kErMbError) status_[i] |= kErMbError;
    const bool likely_intra = intra_more_likely();
    for (int i = 0; i < num; ++i)
      if ((status_[i] & kErDcError) && (status_[i] & kErMvError))
        mbtype_[i] = likely_intra ? kTypeIntra : kTypeInter16;
    if (intra_only_)
      for (int i = 0; i < num; ++i) mbtype_[i] = kTypeIntra;
    guess_mv();
    // the pixel DC of every block (8 x its mean, rounded)
    std::vector<int> dc[3];
    dc[0].assign(static_cast<size_t>(num) * 4, 0);
    dc[1].assign(num, 0);
    dc[2].assign(num, 0);
    const int bw = 2 * mb_w_;
    for (int y = 0; y < mb_h_; ++y) {
      for (int x = 0; x < mb_w_; ++x) {
        for (int n = 0; n < 4; ++n) {
          const uint8_t* p = cur_[0].data() + (y * 16 + (n >> 1) * 8) * lw_ +
                             x * 16 + (n & 1) * 8;
          int sum = 0;
          for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c) sum += p[r * lw_ + c];
          dc[0][(2 * y + (n >> 1)) * bw + 2 * x + (n & 1)] = (sum + 4) >> 3;
        }
        for (int pl = 1; pl < 3; ++pl) {
          const uint8_t* p = cur_[pl].data() + y * 8 * cw_ + x * 8;
          int sum = 0;
          for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c) sum += p[r * cw_ + c];
          dc[pl][y * mb_w_ + x] = (sum + 4) >> 3;
        }
      }
    }
    guess_dc(dc[0], bw, 2 * mb_h_, 1);
    guess_dc(dc[1], mb_w_, mb_h_, 0);
    guess_dc(dc[2], mb_w_, mb_h_, 0);
    for (auto& v : dc[0]) v = static_cast<int16_t>(v);
    filter181(dc[0], bw, 2 * mb_h_);
    // put_dc: intra macroblocks with damaged AC become flat
    auto clip_dc = [](int v) { return std::min(std::max(v, 0), 2040) / 8; };
    for (int y = 0; y < mb_h_; ++y) {
      for (int x = 0; x < mb_w_; ++x) {
        const int m = y * mb_w_ + x;
        if (!intra(m) || !(status_[m] & kErAcError)) continue;
        for (int n = 0; n < 4; ++n) {
          const uint8_t v = static_cast<uint8_t>(
              clip_dc(dc[0][(2 * y + (n >> 1)) * bw + 2 * x + (n & 1)]));
          uint8_t* p = cur_[0].data() + (y * 16 + (n >> 1) * 8) * lw_ +
                       x * 16 + (n & 1) * 8;
          for (int r = 0; r < 8; ++r) std::memset(p + r * lw_, v, 8);
        }
        for (int pl = 1; pl < 3; ++pl) {
          const uint8_t v = static_cast<uint8_t>(clip_dc(dc[pl][m]));
          uint8_t* p = cur_[pl].data() + y * 8 * cw_ + x * 8;
          for (int r = 0; r < 8; ++r) std::memset(p + r * cw_, v, 8);
        }
      }
    }
    block_filter(cur_[0].data(), lw_, bw, 2 * mb_h_, 1, false);
    block_filter(cur_[0].data(), lw_, bw, 2 * mb_h_, 1, true);
    block_filter(cur_[1].data(), cw_, mb_w_, mb_h_, 0, false);
    block_filter(cur_[2].data(), cw_, mb_w_, mb_h_, 0, false);
    block_filter(cur_[1].data(), cw_, mb_w_, mb_h_, 0, true);
    block_filter(cur_[2].data(), cw_, mb_w_, mb_h_, 0, true);
  }
};

}  // namespace etmpeg4
