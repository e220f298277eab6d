// H.264 (ITU-T H.264 | ISO/IEC 14496-10) video of the host loader core, as
// the FFmpeg 8 (libavcodec 62.28) inside cv2 5.0's FFmpeg backend decodes
// it: progressive frames of I and P slices, CAVLC and CABAC, 8-bit 4:2:0,
// Baseline / Main / High profile tools (the 8x8 transform, I8x8 and the
// scaling matrices). Decoding is normative, so every picture is the
// standard's; what is FFmpeg's own is around it: a packet is one access
// unit, a picture goes out as soon as it is decoded (the stream's output
// order must be its decoding order, checked from the picture order counts
// as FFmpeg counts them), the SPS cropping is applied as av_frame_apply_cropping does it,
// and the frame becomes BGR24 through video_dsp.h's swscale formula (full
// range and the matrix where the VUI says so). A left crop that is not a
// multiple of 64 luma columns is refused: av_frame_apply_cropping (without
// AV_FRAME_CROP_UNALIGNED) rounds it down, the frame comes out wider than
// the stream's width, and cv2 scales it to that width with swscale's
// bicubic filter.
//
// What is not decoded refuses the picture before it is decoded (Tool):
// B / SP / SI slices, field and MBAFF coding, slice groups, data
// partitioning, other chroma formats and bit depths, the lossless
// transform bypass, gaps in frame_num, a stream that starts without an IDR
// picture, an output order other than the decoding order, a packet that is
// not one whole picture, that left crop, and a VUI colour matrix FFmpeg 8's
// swscale does not convert. Damaged or cut slice data refuses the
// picture too (FFmpeg would conceal it).
//
// The sections follow the standard's clauses: 7.3 / 7.4 syntax and
// semantics (NAL units, SPS, PPS, slice header, macroblock layer), 8.2
// picture order count and reference lists / marking, 8.3 intra prediction,
// 8.4 inter prediction, 8.5 transforms, 8.7 the deblocking filter, 9.2
// CAVLC, 9.3 CABAC.

#pragma once

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#include "h264_tables.h"
#include "video_dsp.h"

namespace eth264 {

// What refuses a picture (et_video_decode's info[2]; data/video_io.py
// names each).
enum Tool : int {
  kDecoded = 0,
  kBSlices = 1,
  kInterlaced = 2,
  kSliceGroups = 3,
  kSwitching = 4,
  kPartitioned = 5,
  kChromaFormat = 6,
  kBitDepth = 7,
  kLossless = 8,
  kFrameNumGap = 9,
  kDamaged = 10,
  kNoIdrStart = 11,
  kReordered = 12,
  kPacking = 13,
  kLeftCrop = 14,
  kMatrix = 15,
};

constexpr int kFrame = 1, kNoFrame = 0, kUnsupported = -4;

struct Refuse {
  int tool;
};

inline int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}
inline uint8_t clip1(int v) { return etvideo::clip_u8(v); }

// ------------------------------------------------------------ bits

// An RBSP (emulation prevention removed), read MSB first. The buffer holds
// 32 zero bytes past its end; reading far past the end is damage.
class Bits {
 public:
  Bits(const uint8_t* p, size_t nbytes) : p_(p), n_(nbytes * 8) {}

  uint32_t peek(int k) const {
    if (k == 0) return 0;
    const uint8_t* q = p_ + (pos_ >> 3);
    uint64_t w = 0;
    for (int i = 0; i < 8; ++i) w = (w << 8) | q[i];
    return static_cast<uint32_t>((w << (pos_ & 7)) >> (64 - k));
  }
  uint32_t u(int k) {
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  void skip(int k) {
    pos_ += k;
    if (pos_ > n_ + 128) throw Refuse{kDamaged};
  }
  int bit() { return static_cast<int>(u(1)); }
  // No syntax element read as ue(v) can exceed 2^24 (the largest,
  // first_mb_in_slice, stays below 139,264), so a longer code reads as
  // kUeMax: it fails every caller's bound check, and the int arithmetic
  // that callers do on it cannot overflow or turn negative.
  static constexpr uint32_t kUeMax = uint32_t{1} << 24;
  uint32_t ue() {
    int zeros = 0;
    while (peek(1) == 0) {
      skip(1);
      if (++zeros > 31) throw Refuse{kDamaged};
    }
    skip(1);
    if (!zeros) return 0;
    const uint32_t v = (uint32_t{1} << zeros) - 1 + u(zeros);
    return v < kUeMax ? v : kUeMax;
  }
  int se() {
    const uint32_t k = ue();
    return (k & 1) ? static_cast<int>((k + 1) >> 1)
                   : -static_cast<int>(k >> 1);
  }
  size_t pos() const { return pos_; }
  size_t size() const { return n_; }
  bool overread() const { return pos_ > n_; }
  bool aligned() const { return (pos_ & 7) == 0; }
  void align() { pos_ = (pos_ + 7) & ~size_t{7}; }
  // more_rbsp_data(): bits left before the rbsp_stop_one_bit
  bool more_rbsp_data() const {
    size_t end = n_;
    while (end >= 8 && p_[(end >> 3) - 1] == 0) end -= 8;
    if (end == 0) return false;
    const uint8_t last = p_[(end >> 3) - 1];
    int tz = 0;
    while (!((last >> tz) & 1)) ++tz;
    const size_t stop = end - 1 - tz;     // the stop bit's position
    return pos_ < stop;
  }

 private:
  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
};

// the RBSP of a NAL unit (header byte dropped), padded with zeros
inline std::vector<uint8_t> unescape(const uint8_t* p, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n + 32);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && p[i] == 3) {
      zeros = 0;
      continue;
    }
    zeros = p[i] == 0 ? zeros + 1 : 0;
    out.push_back(p[i]);
  }
  return out;
}

// ------------------------------------------------------------ VLC tables

// A prefix code read through one 16-bit peek: entry = (length << 8) | value.
struct Vlc {
  std::vector<uint16_t> table = std::vector<uint16_t>(1 << 16, 0);
  void add(int len, int code, int value) {
    if (len == 0) return;
    const int lo = code << (16 - len), hi = (code + 1) << (16 - len);
    for (int i = lo; i < hi; ++i) {
      table[i] = static_cast<uint16_t>((len << 8) | value);
    }
  }
  int read(Bits& b) const {
    const uint16_t e = table[b.peek(16)];
    if (!e) throw Refuse{kDamaged};
    b.skip(e >> 8);
    return e & 0xFF;
  }
};

struct CavlcTables {
  Vlc coeff_token[5];   // nC classes 0..3, chroma DC
  Vlc total_zeros[15];
  Vlc chroma_dc_total_zeros[3];
  Vlc run_before[7];
  CavlcTables() {
    for (int t = 0; t < 4; ++t) {
      for (int i = 0; i < 68; ++i) {
        coeff_token[t].add(kCoeffTokenLen[t][i], kCoeffTokenBits[t][i], i);
      }
    }
    for (int i = 0; i < 20; ++i) {
      coeff_token[4].add(kChromaDcCoeffTokenLen[i], kChromaDcCoeffTokenBits[i],
                         i);
    }
    for (int t = 0; t < 15; ++t) {
      for (int i = 0; i < 16; ++i) {
        total_zeros[t].add(kTotalZerosLen[t][i], kTotalZerosBits[t][i], i);
      }
    }
    for (int t = 0; t < 3; ++t) {
      for (int i = 0; i < 4; ++i) {
        chroma_dc_total_zeros[t].add(kChromaDcTotalZerosLen[t][i],
                                     kChromaDcTotalZerosBits[t][i], i);
      }
    }
    for (int t = 0; t < 7; ++t) {
      for (int i = 0; i < 16; ++i) {
        run_before[t].add(kRunLen[t][i], kRunBits[t][i], i);
      }
    }
  }
};

inline const CavlcTables& cavlc_tables() {
  static const CavlcTables t;
  return t;
}

// ------------------------------------------------------------ CABAC engine

class Cabac {
 public:
  void start(Bits* b) {
    b_ = b;
    range_ = 510;
    offset_ = b->u(9);
  }
  void init_contexts(int table, int qp) {
    const int q = clip3(0, 51, qp);
    for (int i = 0; i < 460; ++i) {
      const int m = kCabacInit[table][i][0], n = kCabacInit[table][i][1];
      const int pre = clip3(1, 126, ((m * q) >> 4) + n);
      state_[i] = pre <= 63 ? static_cast<uint8_t>((63 - pre) << 1)
                            : static_cast<uint8_t>(((pre - 64) << 1) | 1);
    }
  }
  int decision(int ctx) {
    uint8_t& s = state_[ctx];
    int st = s >> 1, mps = s & 1;
    const uint32_t lps = kRangeLps[st][(range_ >> 6) & 3];
    range_ -= lps;
    int bin;
    if (offset_ >= range_) {
      bin = !mps;
      offset_ -= range_;
      range_ = lps;
      if (st == 0) mps = 1 - mps;
      st = kTransLps[st];
    } else {
      bin = mps;
      if (st < 62) ++st;
    }
    s = static_cast<uint8_t>((st << 1) | mps);
    renorm();
    return bin;
  }
  int bypass() {
    offset_ = (offset_ << 1) | b_->u(1);
    if (offset_ >= range_) {
      offset_ -= range_;
      return 1;
    }
    return 0;
  }
  int terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    renorm();
    return 0;
  }

 private:
  void renorm() {
    if (range_ < 256) {
      const int sh = __builtin_clz(range_) - 23;
      range_ <<= sh;
      offset_ = (offset_ << sh) | b_->u(sh);
    }
  }
  Bits* b_ = nullptr;
  uint32_t range_ = 0, offset_ = 0;
  uint8_t state_[460];
};

// ------------------------------------------------------------ parameter sets

struct Sps {
  int profile = 0, chroma_format = 1, bit_depth_luma = 8, bit_depth_chroma = 8;
  bool lossless = false, scaling_present = false;
  uint8_t scaling4[6][16], scaling8[2][64];     // zigzag order
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom = 0;
  std::vector<int> offset_for_ref_frame;
  int max_num_ref_frames = 0;
  bool gaps_allowed = false;
  int mb_w = 0, mb_h = 0;
  bool frame_mbs_only = true, direct_8x8_inference = false;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;
  bool full_range = false;
  int matrix = 2;                   // VUI matrix_coefficients
};

struct Pps {
  int sps_id = 0;
  bool cabac = false, bottom_field_pic_order = false;
  int num_slice_groups = 1;
  int num_ref_idx_default[2] = {1, 1};
  bool weighted_pred = false;
  int weighted_bipred = 0, init_qp = 26;
  int chroma_qp_offset[2] = {0, 0};
  bool deblocking_control = false, constrained_intra = false;
  bool redundant_pic_cnt = false, transform_8x8 = false;
  uint8_t scaling4[6][16], scaling8[2][64];     // as used (after fall-back)
};

inline void scaling_list(Bits& b, uint8_t* list, int n, bool* use_default) {
  int last = 8, next = 8;
  *use_default = false;
  for (int j = 0; j < n; ++j) {
    if (next != 0) {
      const int delta = b.se();
      if (delta < -128 || delta > 127) throw Refuse{kDamaged};
      next = (last + delta + 256) % 256;
      *use_default = j == 0 && next == 0;
    }
    list[j] = static_cast<uint8_t>(next == 0 ? last : next);
    last = list[j];
  }
}

// The eight 4:2:0 lists (six 4x4, two 8x8; n8 of the 8x8 ones present) with
// fall-back rule A (fallback4/8 the defaults) or B (the SPS's lists).
inline void scaling_matrices(Bits& b, int n8, const uint8_t (*fb4)[16],
                             const uint8_t (*fb8)[64], uint8_t (*s4)[16],
                             uint8_t (*s8)[64]) {
  for (int i = 0; i < 6 + n8; ++i) {
    const bool present = b.bit();
    bool use_default = false;
    if (i < 6) {
      if (present) scaling_list(b, s4[i], 16, &use_default);
      if (present && use_default) {
        std::memcpy(s4[i], kDefault4x4[i < 3 ? 0 : 1], 16);
      } else if (!present) {
        if (i == 0 || i == 3) {
          std::memcpy(s4[i], fb4[i == 0 ? 0 : 1], 16);
        } else {
          std::memcpy(s4[i], s4[i - 1], 16);
        }
      }
    } else {
      uint8_t* l = s8[i - 6];
      if (present) scaling_list(b, l, 64, &use_default);
      if (present && use_default) {
        std::memcpy(l, kDefault8x8[i - 6], 64);
      } else if (!present) {
        std::memcpy(l, fb8[i - 6], 64);
      }
    }
  }
}

inline void hrd(Bits& b) {
  const uint32_t cpb_cnt = b.ue() + 1;
  if (cpb_cnt > 32) throw Refuse{kDamaged};
  b.u(8);
  for (uint32_t i = 0; i < cpb_cnt; ++i) {
    b.ue();
    b.ue();
    b.bit();
  }
  b.u(20);
}

inline void vui(Bits& b, Sps* s) {
  if (b.bit()) {                    // aspect_ratio_info_present_flag
    if (b.u(8) == 255) b.u(32);
  }
  if (b.bit()) b.bit();             // overscan
  if (b.bit()) {                    // video_signal_type_present_flag
    b.u(3);
    s->full_range = b.bit();
    if (b.bit()) {                  // colour primaries, transfer, matrix
      b.u(16);
      s->matrix = static_cast<int>(b.u(8));
    }
  }
  if (b.bit()) {                    // chroma_loc_info_present_flag
    b.ue();
    b.ue();
  }
  if (b.bit()) {                    // timing_info_present_flag
    b.u(32);
    b.u(32);
    b.bit();
  }
  const bool nal_hrd = b.bit();
  if (nal_hrd) hrd(b);
  const bool vcl_hrd = b.bit();
  if (vcl_hrd) hrd(b);
  if (nal_hrd || vcl_hrd) b.bit();  // low_delay_hrd_flag
  b.bit();                          // pic_struct_present_flag
  if (b.bit()) {                    // bitstream_restriction_flag
    b.bit();
    for (int i = 0; i < 6; ++i) b.ue();
  }
}

// 7.3.2.1.1; the tools refused are recorded in *tool (the SPS is kept: a
// picture that uses it is refused).
inline bool parse_sps(Bits& b, Sps* s, int* id, int* tool) {
  *tool = kDecoded;
  s->profile = static_cast<int>(b.u(8));
  b.u(16);                          // constraint flags, level_idc
  *id = static_cast<int>(b.ue());
  if (*id > 31) return false;
  for (int i = 0; i < 6; ++i) std::memset(s->scaling4[i], 16, 16);
  for (int i = 0; i < 2; ++i) std::memset(s->scaling8[i], 16, 64);
  switch (s->profile) {
    case 100: case 110: case 122: case 244: case 44: case 83: case 86:
    case 118: case 128: case 138: case 139: case 134: case 135: {
      s->chroma_format = static_cast<int>(b.ue());
      if (s->chroma_format > 3) return false;
      if (s->chroma_format == 3) b.bit();     // separate_colour_plane_flag
      s->bit_depth_luma = static_cast<int>(b.ue()) + 8;
      s->bit_depth_chroma = static_cast<int>(b.ue()) + 8;
      s->lossless = b.bit();
      s->scaling_present = b.bit();
      if (s->scaling_present) {
        if (s->chroma_format == 3) {
          *tool = kChromaFormat;
          return true;
        }
        scaling_matrices(b, 2, kDefault4x4, kDefault8x8, s->scaling4,
                         s->scaling8);
      }
      break;
    }
    default:
      break;
  }
  s->log2_max_frame_num = static_cast<int>(b.ue()) + 4;
  if (s->log2_max_frame_num > 16) return false;
  s->poc_type = static_cast<int>(b.ue());
  if (s->poc_type == 0) {
    s->log2_max_poc_lsb = static_cast<int>(b.ue()) + 4;
    if (s->log2_max_poc_lsb > 16) return false;
  } else if (s->poc_type == 1) {
    s->delta_pic_order_always_zero = b.bit();
    s->offset_for_non_ref_pic = b.se();
    s->offset_for_top_to_bottom = b.se();
    const uint32_t n = b.ue();
    if (n > 255) return false;
    s->offset_for_ref_frame.resize(n);
    for (auto& v : s->offset_for_ref_frame) v = b.se();
  } else if (s->poc_type != 2) {
    return false;
  }
  s->max_num_ref_frames = static_cast<int>(b.ue());
  if (s->max_num_ref_frames > 16) return false;
  s->gaps_allowed = b.bit();
  s->mb_w = static_cast<int>(b.ue()) + 1;
  s->mb_h = static_cast<int>(b.ue()) + 1;
  s->frame_mbs_only = b.bit();
  if (!s->frame_mbs_only) b.bit();
  s->direct_8x8_inference = b.bit();
  if (b.bit()) {
    s->crop_left = static_cast<int>(b.ue());
    s->crop_right = static_cast<int>(b.ue());
    s->crop_top = static_cast<int>(b.ue());
    s->crop_bottom = static_cast<int>(b.ue());
  }
  if (b.bit()) vui(b, s);
  // the largest frame of any level (139,264 macroblocks, level 6.2)
  if (s->mb_w > 1024 || s->mb_h > 1024 || s->mb_w * s->mb_h > 139264) {
    return false;
  }
  if (!s->frame_mbs_only) {
    *tool = kInterlaced;
  } else if (s->chroma_format != 1) {
    *tool = kChromaFormat;
  } else if (s->bit_depth_luma != 8 || s->bit_depth_chroma != 8) {
    *tool = kBitDepth;
  } else if (s->lossless) {
    *tool = kLossless;
  }
  if (*tool == kDecoded) {
    const int cw = 2, ch = 2;       // CropUnitX / Y for 4:2:0 frames
    if ((s->crop_left + s->crop_right) * cw >= s->mb_w * 16 ||
        (s->crop_top + s->crop_bottom) * ch >= s->mb_h * 16) {
      return false;
    }
  }
  return true;
}

// 7.3.2.2, with the SPS it names (for the scaling fall-back)
inline bool parse_pps(Bits& b, const Sps* const* sps, Pps* p, int* id,
                      int* tool) {
  *tool = kDecoded;
  *id = static_cast<int>(b.ue());
  if (*id > 255) return false;
  p->sps_id = static_cast<int>(b.ue());
  if (p->sps_id > 31 || !sps[p->sps_id]) return false;
  const Sps& s = *sps[p->sps_id];
  p->cabac = b.bit();
  p->bottom_field_pic_order = b.bit();
  p->num_slice_groups = static_cast<int>(b.ue()) + 1;
  if (p->num_slice_groups > 1) {
    *tool = kSliceGroups;
    return true;
  }
  p->num_ref_idx_default[0] = static_cast<int>(b.ue()) + 1;
  p->num_ref_idx_default[1] = static_cast<int>(b.ue()) + 1;
  if (p->num_ref_idx_default[0] > 32 || p->num_ref_idx_default[1] > 32) {
    return false;
  }
  p->weighted_pred = b.bit();
  p->weighted_bipred = static_cast<int>(b.u(2));
  p->init_qp = 26 + b.se();
  b.se();                           // pic_init_qs_minus26
  p->chroma_qp_offset[0] = b.se();
  p->deblocking_control = b.bit();
  p->constrained_intra = b.bit();
  p->redundant_pic_cnt = b.bit();
  p->transform_8x8 = false;
  std::memcpy(p->scaling4, s.scaling4, sizeof p->scaling4);
  std::memcpy(p->scaling8, s.scaling8, sizeof p->scaling8);
  p->chroma_qp_offset[1] = p->chroma_qp_offset[0];
  if (b.more_rbsp_data()) {
    p->transform_8x8 = b.bit();
    if (b.bit()) {                  // pic_scaling_matrix_present_flag
      uint8_t fb4[2][16], fb8[2][64];
      if (s.scaling_present) {      // fall-back rule B
        std::memcpy(fb4[0], s.scaling4[0], 16);
        std::memcpy(fb4[1], s.scaling4[3], 16);
        std::memcpy(fb8, s.scaling8, sizeof fb8);
      } else {                      // rule A
        std::memcpy(fb4, kDefault4x4, sizeof fb4);
        std::memcpy(fb8, kDefault8x8, sizeof fb8);
      }
      scaling_matrices(b, p->transform_8x8 ? 2 : 0, fb4, fb8, p->scaling4,
                       p->scaling8);
    }
    p->chroma_qp_offset[1] = b.se();
  }
  if (p->init_qp < 0 || p->init_qp > 51 ||
      p->chroma_qp_offset[0] < -12 || p->chroma_qp_offset[0] > 12 ||
      p->chroma_qp_offset[1] < -12 || p->chroma_qp_offset[1] > 12) {
    return false;
  }
  return true;
}

// ------------------------------------------------------------ pictures

struct Frame {
  std::vector<uint8_t> plane[3];
  int frame_num = 0, long_idx = -1, poc = 0, id = 0;
  bool short_ref = false, long_ref = false;
  bool ref() const { return short_ref || long_ref; }
};

enum Kind : uint8_t { kI4x4, kI8x8, kI16x16, kIPcm, kPInter, kPSkip };

// What later macroblocks and the deblocking filter read of a macroblock.
struct MbInfo {
  int slice = -1;               // slice number in the picture; -1 not yet
  uint8_t kind = kPSkip;
  bool intra = false, t8x8 = false;
  uint8_t cbp = 0;              // luma bits 0..3, chroma (0..2) << 4
  uint8_t chroma_mode = 0;
  uint8_t dc_cbf = 0;           // coded_block_flag: 1 luma DC, 2 Cb, 4 Cr
  int8_t qp = 0, qp_deb = 0;
  int8_t ipred[16];             // Intra4x4 / 8x8 modes per 4x4 (-1: none)
  uint8_t nnz[16];              // per luma 4x4 (raster): coefficients coded
  uint8_t nnzc[2][4];           // per chroma AC 4x4 (raster)
  uint8_t nzdeb[16];            // the luma 4x4 holds coefficients (8x8 too)
  int8_t ref[4];                // ref_idx_l0 per 8x8 (-1 intra)
  int refpic[4];                // the reference picture's id per 8x8
  int16_t mv[16][2];
  uint8_t mvd[16][2];           // |mvd|, clipped (CABAC contexts)
};

struct SliceParams {
  int disable_deblock = 0, alpha = 0, beta = 0;
};

struct SliceHeader {
  int first_mb = 0, type = 2, pps_id = 0, frame_num = 0;
  bool idr = false;
  int nal_ref_idc = 0;
  int poc_lsb = 0, delta_bottom = 0, delta_poc[2] = {0, 0};
  int redundant = 0;
  int num_ref = 0;
  std::vector<std::pair<int, int>> mods;
  int luma_log2 = 0, chroma_log2 = 0;
  int lw[32], lo[32], cw[32][2], co[32][2];
  bool long_term_ref = false, adaptive = false;
  std::vector<std::array<int, 3>> mmco;
  int cabac_init = 0, qp = 26;
  SliceParams deblock;
};

inline int blk_idx(int bx, int by) {      // luma4x4BlkIdx of a raster block
  return (by >> 1) * 8 + (bx >> 1) * 4 + (by & 1) * 2 + (bx & 1);
}

// ------------------------------------------------------------ decoder

class Decoder {
 public:
  int width() const { return width_; }
  int height() const { return height_; }
  int tool() const { return tool_; }

  // The decoder's extradata: an avcC record (its parameter sets, and the
  // NAL length size packets use), or Annex B parameter sets.
  void headers(const uint8_t* p, int n) {
    if (n >= 7 && p[0] == 1) {
      nal_len_ = (p[4] & 3) + 1;
      int at = 5;
      for (int set = 0; set < 2; ++set) {
        if (at >= n) return;
        int count = set == 0 ? (p[at] & 31) : p[at];
        ++at;
        for (; count > 0 && at + 2 <= n; --count) {
          const int len = (p[at] << 8) | p[at + 1];
          at += 2;
          if (at + len > n) return;
          try {
            nal(p + at, len, nullptr);
          } catch (const Refuse&) {
          }
          at += len;
        }
      }
      return;
    }
    int dummy = 0;
    try {
      annexb(p, n, &dummy);
    } catch (const Refuse&) {
    }
  }

  // One packet (an access unit): kFrame, the picture to convert with
  // to_bgr; kNoFrame; kUnsupported, tool() says why.
  int decode(const uint8_t* p, int n) {
    if (tool_ != kDecoded) return kUnsupported;
    int frames = 0;
    try {
      if (nal_len_) {
        int at = 0;
        while (at + nal_len_ <= n) {
          int64_t len = 0;
          for (int i = 0; i < nal_len_; ++i) len = (len << 8) | p[at + i];
          at += nal_len_;
          if (len > n - at) throw Refuse{kDamaged};
          if (len > 0) nal(p + at, static_cast<int>(len), &frames);
          at += static_cast<int>(len);
        }
      } else {
        annexb(p, n, &frames);
      }
      if (in_picture_) {
        if (decoded_mbs_ != mb_w_ * mb_h_) throw Refuse{kDamaged};
        finish_picture();
        ++frames;
      }
    } catch (const Refuse& r) {
      tool_ = r.tool;
      in_picture_ = false;
      return kUnsupported;
    }
    if (frames > 1) {
      tool_ = kPacking;
      return kUnsupported;
    }
    return frames ? kFrame : kNoFrame;
  }

  // The picture as BGR24 (width x height, rows of `stride` bytes).
  void to_bgr(uint8_t* out, int stride) const {
    const Frame* f = out_;
    const int ys = mb_w_ * 16, cs = mb_w_ * 8;
    const uint8_t* y = f->plane[0].data() + crop_y_ * ys + crop_x_;
    const uint8_t* u = f->plane[1].data() + (crop_y_ / 2) * cs + crop_x_ / 2;
    const uint8_t* v = f->plane[2].data() + (crop_y_ / 2) * cs + crop_x_ / 2;
    etvideo::yuv_to_bgr(y, ys, u, v, cs, width_, height_, 1, full_range_,
                        out, stride, matrix_);
  }

 private:
  // ---------------------------------------------------------- NAL units

  void annexb(const uint8_t* p, int n, int* frames) {
    int i = 0;
    auto next_start = [&](int from) {
      for (int k = from; k + 2 < n; ++k) {
        if (p[k] == 0 && p[k + 1] == 0 && p[k + 2] == 1) return k;
      }
      return n;
    };
    i = next_start(0);
    while (i < n) {
      const int s = i + 3;
      int e = next_start(s);
      const int next = e;
      while (e > s && p[e - 1] == 0) --e;     // trailing_zero_8bits
      if (e > s) nal(p + s, e - s, frames);
      i = next;
    }
  }

  void nal(const uint8_t* p, int n, int* frames) {
    const int type = p[0] & 31, ref_idc = (p[0] >> 5) & 3;
    if (type == 2 || type == 3 || type == 4) throw Refuse{kPartitioned};
    if (type != 1 && type != 5 && type != 7 && type != 8) return;
    std::vector<uint8_t> rbsp = unescape(p + 1, n - 1);
    const size_t len = rbsp.size();
    rbsp.resize(len + 32, 0);
    Bits b(rbsp.data(), len);
    if (type == 7) {
      auto s = std::make_unique<Sps>();
      int id = 0, tool = 0;
      if (parse_sps(b, s.get(), &id, &tool)) {
        sps_[id] = std::move(s);
        sps_tool_[id] = tool;
      }
      return;
    }
    if (type == 8) {
      auto q = std::make_unique<Pps>();
      int id = 0, tool = 0;
      const Sps* table[32];
      for (int k = 0; k < 32; ++k) table[k] = sps_[k].get();
      if (parse_pps(b, table, q.get(), &id, &tool)) {
        pps_[id] = std::move(q);
        pps_tool_[id] = tool;
      }
      return;
    }
    if (!frames) return;              // a slice in the extradata
    SliceHeader h;
    slice_header(b, type, ref_idc, &h);
    if (h.redundant > 0) return;      // FFmpeg drops redundant slices
    if (!in_picture_) {
      if (h.first_mb != 0) throw Refuse{kDamaged};
      if (*frames > 0) throw Refuse{kPacking};
      start_picture(h);
    } else if (h.first_mb == 0 || h.frame_num != pic_.frame_num ||
               h.pps_id != pic_.pps_id || h.idr != pic_.idr) {
      // a second picture in the packet: FFmpeg keeps one picture per packet
      finish_check();
      throw Refuse{kPacking};
    }
    slice_data(b, h);
  }

  void finish_check() {
    if (decoded_mbs_ != mb_w_ * mb_h_) throw Refuse{kDamaged};
  }

  // ---------------------------------------------------------- slice header

  void slice_header(Bits& b, int nal_type, int ref_idc, SliceHeader* h) {
    h->first_mb = static_cast<int>(b.ue());
    int st = static_cast<int>(b.ue());
    if (st > 9) throw Refuse{kDamaged};
    st %= 5;
    if (st == 1) throw Refuse{kBSlices};
    if (st == 3 || st == 4) throw Refuse{kSwitching};
    h->type = st;
    h->pps_id = static_cast<int>(b.ue());
    if (h->pps_id > 255 || !pps_[h->pps_id]) throw Refuse{kDamaged};
    if (pps_tool_[h->pps_id]) throw Refuse{pps_tool_[h->pps_id]};
    const Pps& p = *pps_[h->pps_id];
    if (!sps_[p.sps_id]) throw Refuse{kDamaged};
    if (sps_tool_[p.sps_id]) throw Refuse{sps_tool_[p.sps_id]};
    const Sps& s = *sps_[p.sps_id];
    h->nal_ref_idc = ref_idc;
    h->idr = nal_type == 5;
    h->frame_num = static_cast<int>(b.u(s.log2_max_frame_num));
    if (h->idr) b.ue();               // idr_pic_id
    if (s.poc_type == 0) {
      h->poc_lsb = static_cast<int>(b.u(s.log2_max_poc_lsb));
      if (p.bottom_field_pic_order) h->delta_bottom = b.se();
    } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
      h->delta_poc[0] = b.se();
      if (p.bottom_field_pic_order) h->delta_poc[1] = b.se();
    }
    if (p.redundant_pic_cnt) h->redundant = static_cast<int>(b.ue());
    const bool inter = h->type == 0;
    if (inter) {
      h->num_ref = p.num_ref_idx_default[0];
      if (b.bit()) h->num_ref = static_cast<int>(b.ue()) + 1;
      if (h->num_ref > 16) throw Refuse{kDamaged};
      if (b.bit()) {                  // ref_pic_list_modification_flag_l0
        for (;;) {
          const int idc = static_cast<int>(b.ue());
          if (idc == 3) break;
          if (idc > 2 || h->mods.size() > 64) throw Refuse{kDamaged};
          h->mods.emplace_back(idc, static_cast<int>(b.ue()));
        }
      }
    }
    if (inter && p.weighted_pred) {
      h->luma_log2 = static_cast<int>(b.ue());
      h->chroma_log2 = static_cast<int>(b.ue());
      if (h->luma_log2 > 7 || h->chroma_log2 > 7) throw Refuse{kDamaged};
      for (int i = 0; i < h->num_ref; ++i) {
        h->lw[i] = 1 << h->luma_log2;
        h->lo[i] = 0;
        if (b.bit()) {                // luma_weight_l0_flag
          h->lw[i] = b.se();
          h->lo[i] = b.se();
        }
        const bool chroma_w = b.bit();
        for (int c = 0; c < 2; ++c) {
          h->cw[i][c] = 1 << h->chroma_log2;
          h->co[i][c] = 0;
          if (chroma_w) {
            h->cw[i][c] = b.se();
            h->co[i][c] = b.se();
          }
        }
      }
    }
    if (ref_idc) {
      if (h->idr) {
        b.bit();                      // no_output_of_prior_pics_flag
        h->long_term_ref = b.bit();
      } else {
        h->adaptive = b.bit();
        if (h->adaptive) {
          for (;;) {
            const int op = static_cast<int>(b.ue());
            if (op == 0) break;
            if (op > 6 || h->mmco.size() > 66) throw Refuse{kDamaged};
            int a = 0, c = 0;
            if (op == 1 || op == 3) a = static_cast<int>(b.ue());
            if (op == 2) a = static_cast<int>(b.ue());
            if (op == 3 || op == 6) c = static_cast<int>(b.ue());
            if (op == 4) a = static_cast<int>(b.ue());
            h->mmco.push_back({op, a, c});
          }
        }
      }
    }
    if (p.cabac && inter) {
      h->cabac_init = static_cast<int>(b.ue());
      if (h->cabac_init > 2) throw Refuse{kDamaged};
    }
    h->qp = p.init_qp + b.se();
    if (h->qp < 0 || h->qp > 51) throw Refuse{kDamaged};
    if (p.deblocking_control) {
      h->deblock.disable_deblock = static_cast<int>(b.ue());
      if (h->deblock.disable_deblock > 2) throw Refuse{kDamaged};
      if (h->deblock.disable_deblock != 1) {
        h->deblock.alpha = b.se() * 2;
        h->deblock.beta = b.se() * 2;
        if (std::abs(h->deblock.alpha) > 12 ||
            std::abs(h->deblock.beta) > 12) {
          throw Refuse{kDamaged};
        }
      }
    }
  }

  // ---------------------------------------------------------- pictures

  void start_picture(const SliceHeader& h) {
    const Pps& p = *pps_[h.pps_id];
    const Sps& s = *sps_[p.sps_id];
    if (!started_ && !h.idr) throw Refuse{kNoIdrStart};
    if ((s.crop_left * 2) % 64) throw Refuse{kLeftCrop};
    // YCgCo, BT.2020 constant luminance, SMPTE 2085, ICtCp and the rest:
    // FFmpeg 8's swscale refuses the conversion and cv2 returns what it had
    if (s.matrix == 8 || s.matrix >= 10) throw Refuse{kMatrix};
    sp_ = &s;
    pp_ = &p;
    const int max_frame_num = 1 << s.log2_max_frame_num;
    if (!h.idr && h.frame_num != prev_ref_frame_num_ &&
        h.frame_num != (prev_ref_frame_num_ + 1) % max_frame_num) {
      throw Refuse{kFrameNumGap};
    }
    // FFmpeg outputs a picture whose POC is not above the last one's only
    // after an IDR picture or right after MMCO 5 (it drops or reorders
    // the others, by its own heuristics)
    const int poc = picture_order_count(h);
    if (!h.idr && !after_reset_ && poc <= last_poc_) throw Refuse{kReordered};
    if (s.mb_w != mb_w_ || s.mb_h != mb_h_) {
      mb_w_ = s.mb_w;
      mb_h_ = s.mb_h;
      dpb_.clear();
      mbs_.assign(static_cast<size_t>(mb_w_) * mb_h_, MbInfo());
    }
    // cropping, as cv2 sees it (av_frame_apply_cropping, aligned)
    const int left = s.crop_left * 2, right = s.crop_right * 2;
    const int top = s.crop_top * 2, bottom = s.crop_bottom * 2;
    width_ = mb_w_ * 16 - left - right;
    height_ = mb_h_ * 16 - top - bottom;
    crop_x_ = left;
    crop_y_ = top;
    full_range_ = s.full_range;
    matrix_ = s.matrix;
    // a free frame buffer
    cur_ = nullptr;
    for (auto& f : dpb_) {
      if (!f->ref() && f.get() != out_) {
        cur_ = f.get();
        break;
      }
    }
    if (!cur_) {
      if (dpb_.size() > 40) throw Refuse{kDamaged};
      dpb_.push_back(std::make_unique<Frame>());
      cur_ = dpb_.back().get();
      const size_t ny = static_cast<size_t>(mb_w_) * mb_h_ * 256;
      cur_->plane[0].assign(ny, 0);
      cur_->plane[1].assign(ny / 4, 0);
      cur_->plane[2].assign(ny / 4, 0);
    }
    cur_->frame_num = h.frame_num;
    cur_->poc = poc;
    cur_->id = ++next_id_;
    cur_->short_ref = cur_->long_ref = false;
    cur_->long_idx = -1;
    for (auto& m : mbs_) m.slice = -1;
    slices_.clear();
    decoded_mbs_ = 0;
    in_picture_ = true;
    pic_ = h;
    pic_poc_ = poc;
    build_scales();
  }

  // 8.2.1, the frame's PicOrderCnt (min of its two fields)
  int picture_order_count(const SliceHeader& h) {
    const Sps& s = *sp_;
    const int max_frame_num = 1 << s.log2_max_frame_num;
    if (s.poc_type == 0) {
      int prev_msb = prev_poc_msb_, prev_lsb = prev_poc_lsb_;
      if (h.idr) prev_msb = prev_lsb = 0;
      const int max_lsb = 1 << s.log2_max_poc_lsb;
      int msb;
      if (h.poc_lsb < prev_lsb && prev_lsb - h.poc_lsb >= max_lsb / 2) {
        msb = prev_msb + max_lsb;
      } else if (h.poc_lsb > prev_lsb && h.poc_lsb - prev_lsb > max_lsb / 2) {
        msb = prev_msb - max_lsb;
      } else {
        msb = prev_msb;
      }
      poc_msb_ = msb;
      const int topc = msb + h.poc_lsb;
      return std::min(topc, topc + h.delta_bottom);
    }
    int offset;
    if (h.idr) {
      offset = 0;
    } else if (prev_frame_num_ > h.frame_num) {
      offset = prev_frame_num_offset_ + max_frame_num;
    } else {
      offset = prev_frame_num_offset_;
    }
    frame_num_offset_ = offset;
    if (s.poc_type == 2) {
      if (h.idr) return 0;
      return h.nal_ref_idc ? 2 * (offset + h.frame_num)
                           : 2 * (offset + h.frame_num) - 1;
    }
    const int n = static_cast<int>(s.offset_for_ref_frame.size());
    int abs_frame = n ? offset + h.frame_num : 0;
    if (!h.nal_ref_idc && abs_frame > 0) --abs_frame;
    int expected = 0;
    if (abs_frame > 0) {
      int delta_cycle = 0;
      for (int v : s.offset_for_ref_frame) delta_cycle += v;
      const int cycle = (abs_frame - 1) / n, in_cycle = (abs_frame - 1) % n;
      expected = cycle * delta_cycle;
      for (int i = 0; i <= in_cycle; ++i) {
        expected += s.offset_for_ref_frame[i];
      }
    }
    if (!h.nal_ref_idc) expected += s.offset_for_non_ref_pic;
    const int topc = expected + h.delta_poc[0];
    const int bot = topc + s.offset_for_top_to_bottom + h.delta_poc[1];
    return std::min(topc, bot);
  }

  void finish_picture() {
    in_picture_ = false;
    deblock();
    const SliceHeader& h = pic_;
    const int max_frame_num = 1 << sp_->log2_max_frame_num;
    bool mmco5 = false;
    if (h.nal_ref_idc) {
      if (h.idr) {
        for (auto& f : dpb_) f->short_ref = f->long_ref = false;
        if (h.long_term_ref) {
          cur_->long_ref = true;
          cur_->long_idx = 0;
          max_long_idx_ = 0;
        } else {
          cur_->short_ref = true;
          max_long_idx_ = -1;
        }
      } else {
        bool cur_long = false;
        if (h.adaptive) {
          for (const auto& m : h.mmco) {
            const int op = m[0];
            if (op == 1 || op == 3) {
              const int pic_num = h.frame_num - (m[1] + 1);
              Frame* f = short_by_pic_num(pic_num, max_frame_num);
              if (!f) continue;
              if (op == 1) {
                f->short_ref = false;
              } else {
                for (auto& g : dpb_) {
                  if (g->long_ref && g->long_idx == m[2] && g.get() != f) {
                    g->long_ref = false;
                  }
                }
                f->short_ref = false;
                f->long_ref = true;
                f->long_idx = m[2];
              }
            } else if (op == 2) {
              for (auto& g : dpb_) {
                if (g->long_ref && g->long_idx == m[1]) g->long_ref = false;
              }
            } else if (op == 4) {
              max_long_idx_ = m[1] - 1;
              for (auto& g : dpb_) {
                if (g->long_ref && g->long_idx > max_long_idx_) {
                  g->long_ref = false;
                }
              }
            } else if (op == 5) {
              for (auto& g : dpb_) g->short_ref = g->long_ref = false;
              max_long_idx_ = -1;
              mmco5 = true;
            } else if (op == 6) {
              for (auto& g : dpb_) {
                if (g->long_ref && g->long_idx == m[2]) g->long_ref = false;
              }
              cur_->long_ref = true;
              cur_->long_idx = m[2];
              cur_long = true;
            }
          }
        } else {
          int n_short = 0, n_long = 0;
          Frame* oldest = nullptr;
          int oldest_wrap = 0;
          for (auto& g : dpb_) {
            if (g.get() == cur_) continue;
            if (g->short_ref) {
              ++n_short;
              const int wrap = g->frame_num > h.frame_num
                                   ? g->frame_num - max_frame_num
                                   : g->frame_num;
              if (!oldest || wrap < oldest_wrap) {
                oldest = g.get();
                oldest_wrap = wrap;
              }
            }
            if (g->long_ref) ++n_long;
          }
          if (n_short + n_long >= std::max(sp_->max_num_ref_frames, 1) &&
              oldest) {
            oldest->short_ref = false;
          }
        }
        if (!cur_long) cur_->short_ref = true;
      }
    }
    // the state the next picture's POC and frame_num checks read, as
    // FFmpeg keeps it: after MMCO 5 frame_num counts from 0, but the POC
    // goes on from this picture's own (the standard restarts it at 0)
    if (h.nal_ref_idc) {
      prev_poc_msb_ = poc_msb_;
      prev_poc_lsb_ = h.poc_lsb;
      prev_ref_frame_num_ = mmco5 ? 0 : h.frame_num;
    }
    prev_frame_num_offset_ = frame_num_offset_;
    prev_frame_num_ = mmco5 ? 0 : h.frame_num;
    if (mmco5) cur_->frame_num = 0;
    after_reset_ = mmco5;
    if (h.idr) {
      prev_frame_num_offset_ = 0;
      prev_frame_num_ = h.frame_num;
    }
    last_poc_ = pic_poc_;
    started_ = true;
    out_ = cur_;
  }

  Frame* short_by_pic_num(int pic_num, int max_frame_num) {
    for (auto& g : dpb_) {
      if (!g->short_ref || g.get() == cur_) continue;
      const int wrap = g->frame_num > pic_.frame_num
                           ? g->frame_num - max_frame_num
                           : g->frame_num;
      if (wrap == pic_num) return g.get();
    }
    return nullptr;
  }

  // 8.2.4: RefPicList0 of a P slice
  void ref_list(const SliceHeader& h) {
    const int max_frame_num = 1 << sp_->log2_max_frame_num;
    std::vector<std::pair<int, Frame*>> shorts, longs;
    for (auto& g : dpb_) {
      if (g.get() == cur_) continue;
      if (g->short_ref) {
        const int wrap = g->frame_num > h.frame_num
                             ? g->frame_num - max_frame_num
                             : g->frame_num;
        shorts.emplace_back(-wrap, g.get());
      } else if (g->long_ref) {
        longs.emplace_back(g->long_idx, g.get());
      }
    }
    std::sort(shorts.begin(), shorts.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    std::sort(longs.begin(), longs.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    const int n = h.num_ref;
    Frame* list[34] = {};
    int k = 0;
    for (auto& e : shorts) {
      if (k < n) list[k++] = e.second;
    }
    for (auto& e : longs) {
      if (k < n) list[k++] = e.second;
    }
    // modification (8.2.4.3)
    int pred = h.frame_num;
    int idx = 0;
    for (const auto& m : h.mods) {
      if (idx >= n) throw Refuse{kDamaged};
      Frame* pic = nullptr;
      bool is_long = false;
      int num = 0;
      if (m.first < 2) {
        const int diff = m.second + 1;
        if (diff > max_frame_num) throw Refuse{kDamaged};
        int no_wrap;
        if (m.first == 0) {
          no_wrap = pred - diff;
          if (no_wrap < 0) no_wrap += max_frame_num;
        } else {
          no_wrap = pred + diff;
          if (no_wrap >= max_frame_num) no_wrap -= max_frame_num;
        }
        pred = no_wrap;
        num = no_wrap > h.frame_num ? no_wrap - max_frame_num : no_wrap;
        pic = short_by_pic_num(num, max_frame_num);
      } else {
        num = m.second;
        is_long = true;
        for (auto& g : dpb_) {
          if (g->long_ref && g->long_idx == num && g.get() != cur_) {
            pic = g.get();
          }
        }
      }
      if (!pic) throw Refuse{kDamaged};
      for (int c = n; c > idx; --c) list[c] = list[c - 1];
      list[idx++] = pic;
      int nidx = idx;
      for (int c = idx; c <= n; ++c) {
        Frame* f = list[c];
        const bool same = f && (is_long ? (f->long_ref && f->long_idx == num)
                                        : (f == pic && f->short_ref));
        if (!same) list[nidx++] = f;
      }
    }
    for (int i = 0; i < n; ++i) refs_[i] = list[i];
    num_refs_ = n;
  }

  // ---------------------------------------------------------- scaling

  void build_scales() {
    const Pps& p = *pp_;
    for (int l = 0; l < 6; ++l) {
      for (int m = 0; m < 6; ++m) {
        for (int k = 0; k < 16; ++k) {
          const int r = kZigzag4x4[k], i = r >> 2, j = r & 3;
          const int cls = (i % 2 == 0 && j % 2 == 0) ? 0
                          : (i % 2 == 1 && j % 2 == 1) ? 1 : 2;
          ls4_[l][m][r] = p.scaling4[l][k] * kNorm4x4[m][cls];
        }
      }
    }
    for (int l = 0; l < 2; ++l) {
      for (int m = 0; m < 6; ++m) {
        for (int k = 0; k < 64; ++k) {
          const int r = kZigzag8x8[k], i = r >> 3, j = r & 7;
          int cls;
          if (i % 4 == 0 && j % 4 == 0) cls = 0;
          else if (i % 2 == 1 && j % 2 == 1) cls = 1;
          else if (i % 4 == 2 && j % 4 == 2) cls = 2;
          else if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0))
            cls = 3;
          else if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0))
            cls = 4;
          else cls = 5;
          ls8_[l][m][r] = p.scaling8[l][k] * kNorm8x8[m][cls];
        }
      }
    }
  }

  // ---------------------------------------------------------- slice data

  // the MB holding luma 4x4 block (bx, by) relative to the current MB
  // (bx, by in -1..4), its raster block index in *idx; -1: not available
  int blk_nb(int bx, int by, int* idx) const {
    *idx = 0;
    int m;
    if (bx < 0) {
      if (by < 0) m = nb_d_;
      else if (by < 4) m = nb_a_;
      else return -1;
    } else if (bx < 4) {
      if (by < 0) m = nb_b_;
      else if (by < 4) m = mba_;
      else return -1;
    } else {
      if (by < 0) m = nb_c_;
      else return -1;
    }
    *idx = ((by + 4) & 3) * 4 + ((bx + 4) & 3);
    return m;
  }
  // the same for a chroma 4x4 block (cx, cy in -1..2)
  int cblk_nb(int cx, int cy, int* idx) const {
    int m;
    if (cx < 0) m = cy < 0 ? -1 : nb_a_;
    else if (cy < 0) m = nb_b_;
    else m = mba_;
    *idx = ((cy + 2) & 1) * 2 + ((cx + 2) & 1);
    return m;
  }

  void set_mb(int addr, int slice) {
    mba_ = addr;
    mbx_ = addr % mb_w_;
    mby_ = addr / mb_w_;
    auto avail = [&](int x, int y) {
      if (x < 0 || y < 0 || x >= mb_w_) return -1;
      const int a = y * mb_w_ + x;
      return mbs_[a].slice == slice ? a : -1;
    };
    nb_a_ = avail(mbx_ - 1, mby_);
    nb_b_ = avail(mbx_, mby_ - 1);
    nb_c_ = avail(mbx_ + 1, mby_ - 1);
    nb_d_ = avail(mbx_ - 1, mby_ - 1);
    const bool ci = pp_->constrained_intra;
    auto iav = [&](int m) { return m >= 0 && (!ci || mbs_[m].intra); };
    ia_ = iav(nb_a_);
    ib_ = iav(nb_b_);
    ic_ = iav(nb_c_);
    id_ = iav(nb_d_);
    MbInfo& m = mbs_[addr];
    m = MbInfo();
    m.slice = slice;
    std::memset(m.ipred, -1, sizeof m.ipred);
    std::memset(m.nnz, 0, sizeof m.nnz);
    std::memset(m.nnzc, 0, sizeof m.nnzc);
    std::memset(m.nzdeb, 0, sizeof m.nzdeb);
    std::memset(m.ref, 0, sizeof m.ref);
    std::memset(m.refpic, 0, sizeof m.refpic);
    std::memset(m.mv, 0, sizeof m.mv);
    std::memset(m.mvd, 0, sizeof m.mvd);
    decoded_mask_ = 0;
  }

  void slice_data(Bits& b, const SliceHeader& h) {
    if (h.type == 0) ref_list(h);
    sh_ = &h;
    const int slice = static_cast<int>(slices_.size());
    slices_.push_back(h.deblock);
    const int total = mb_w_ * mb_h_;
    int addr = h.first_mb;
    qp_ = h.qp;
    last_dqp_ = 0;
    Cabac cabac;
    cabac_ = pp_->cabac ? &cabac : nullptr;
    if (cabac_) {
      while (!b.aligned()) {
        if (!b.bit()) throw Refuse{kDamaged};    // cabac_alignment_one_bit
      }
      cabac.init_contexts(h.type == 2 ? 0 : h.cabac_init + 1, h.qp);
      cabac.start(&b);
    }
    for (;;) {
      if (!cabac_ && h.type == 0) {
        const uint32_t run = b.ue();
        if (run > static_cast<uint32_t>(total - addr)) throw Refuse{kDamaged};
        for (uint32_t i = 0; i < run; ++i) {
          begin_mb(addr++, slice);
          skip_mb();
        }
        if (run > 0 && !b.more_rbsp_data()) break;
      }
      begin_mb(addr++, slice);
      if (cabac_ && h.type == 0 && cabac.decision(11 + skip_ctx())) {
        skip_mb();
      } else {
        macroblock(b);
      }
      if (b.overread()) throw Refuse{kDamaged};
      if (cabac_) {
        if (cabac.terminate()) break;
      } else if (!b.more_rbsp_data()) {
        break;
      }
    }
    if (b.overread()) throw Refuse{kDamaged};
  }

  void begin_mb(int addr, int slice) {
    if (addr >= mb_w_ * mb_h_ || mbs_[addr].slice >= 0) throw Refuse{kDamaged};
    set_mb(addr, slice);
    ++decoded_mbs_;
  }

  int skip_ctx() const {
    return (nb_a_ >= 0 && mbs_[nb_a_].kind != kPSkip) +
           (nb_b_ >= 0 && mbs_[nb_b_].kind != kPSkip);
  }

  // ---------------------------------------------------------- motion

  struct Nb {
    bool avail;
    int ref;
    int mv[2];
  };

  Nb nb_part(int x, int y) const {
    int idx;
    const int m = blk_nb(x >> 2, y >> 2, &idx);
    if (m < 0 || (m == mba_ && !((decoded_mask_ >> idx) & 1))) {
      return {false, -1, {0, 0}};
    }
    const MbInfo& n = mbs_[m];
    if (n.intra) return {true, -1, {0, 0}};
    const int b8 = ((idx >> 3) << 1) | ((idx & 3) >> 1);
    return {true, n.ref[b8], {n.mv[idx][0], n.mv[idx][1]}};
  }

  // 8.4.1.3; shape 1/2: 16x8 upper / lower, 3/4: 8x16 left / right
  void mvp(int x, int y, int w, int ref, int shape, int* out) const {
    Nb a = nb_part(x - 1, y), bb = nb_part(x, y - 1);
    Nb c = nb_part(x + w, y - 1);
    if (!c.avail) c = nb_part(x - 1, y - 1);
    const Nb* pick = nullptr;
    if (shape == 1 && bb.ref == ref) pick = &bb;
    if (shape == 2 && a.ref == ref) pick = &a;
    if (shape == 3 && a.ref == ref) pick = &a;
    if (shape == 4 && c.ref == ref) pick = &c;
    if (!pick) {
      if (!bb.avail && !c.avail && a.avail) {
        bb = a;
        c = a;
      }
      const int match = (a.ref == ref) + (bb.ref == ref) + (c.ref == ref);
      if (match == 1) {
        pick = a.ref == ref ? &a : (bb.ref == ref ? &bb : &c);
      } else {
        for (int k = 0; k < 2; ++k) {
          const int p = a.mv[k], q = bb.mv[k], r = c.mv[k];
          out[k] = std::max(std::min(p, q), std::min(std::max(p, q), r));
        }
        return;
      }
    }
    out[0] = pick->mv[0];
    out[1] = pick->mv[1];
  }

  // store a partition's motion (4x4 units) and mark it decoded; a vector
  // far past any level's range is damage
  void set_motion(int x, int y, int w, int h, const int* mv, const int* mvd) {
    if (std::abs(mv[0]) > 16384 || std::abs(mv[1]) > 16384) {
      throw Refuse{kDamaged};
    }
    MbInfo& m = mbs_[mba_];
    for (int j = y >> 2; j < (y + h) >> 2; ++j) {
      for (int i = x >> 2; i < (x + w) >> 2; ++i) {
        const int idx = j * 4 + i;
        m.mv[idx][0] = static_cast<int16_t>(mv[0]);
        m.mv[idx][1] = static_cast<int16_t>(mv[1]);
        m.mvd[idx][0] = static_cast<uint8_t>(std::min(std::abs(mvd[0]), 70));
        m.mvd[idx][1] = static_cast<uint8_t>(std::min(std::abs(mvd[1]), 70));
        decoded_mask_ |= 1u << idx;
      }
    }
  }

  void skip_mb() {
    MbInfo& m = mbs_[mba_];
    m.kind = kPSkip;
    m.qp = static_cast<int8_t>(qp_);
    m.qp_deb = m.qp;
    last_dqp_ = 0;
    const Nb a = nb_part(-1, 0), bb = nb_part(0, -1);
    int mv[2] = {0, 0};
    if (a.avail && bb.avail &&
        !(a.ref == 0 && a.mv[0] == 0 && a.mv[1] == 0) &&
        !(bb.ref == 0 && bb.mv[0] == 0 && bb.mv[1] == 0)) {
      mvp(0, 0, 16, 0, 0, mv);
    }
    const int zero[2] = {0, 0};
    set_motion(0, 0, 16, 16, mv, zero);
    Frame* r = ref_pic(0);
    for (int k = 0; k < 4; ++k) m.refpic[k] = r->id;
    inter_pred(0, 0, 16, 16, 0, mv);
  }

  Frame* ref_pic(int ref) const {
    if (ref < 0 || ref >= num_refs_ || !refs_[ref]) throw Refuse{kDamaged};
    return refs_[ref];
  }

  // ---------------------------------------------------------- syntax

  // mb_type: 0..4 the P types, 5 + the I type (0 I_NxN, 1..24 I_16x16,
  // 25 I_PCM)
  int mb_type(Bits& b) {
    if (!cabac_) {
      const int v = static_cast<int>(b.ue());
      const int t = sh_->type == 2 ? v + 5 : v;
      if (t > 30) throw Refuse{kDamaged};
      return t;
    }
    Cabac& c = *cabac_;
    if (sh_->type == 0) {
      if (!c.decision(14)) {
        if (!c.decision(15)) return c.decision(16) ? 3 : 0;
        return c.decision(17) ? 1 : 2;
      }
      return 5 + intra_type(17, false);
    }
    return 5 + intra_type(3, true);
  }

  int intra_type(int base, bool islice) {
    Cabac& c = *cabac_;
    int inc = 0;
    if (islice) {
      auto not_nxn = [&](int m) {
        return m >= 0 && (mbs_[m].kind == kI16x16 || mbs_[m].kind == kIPcm);
      };
      inc = not_nxn(nb_a_) + not_nxn(nb_b_);
    }
    if (!c.decision(base + inc)) return 0;
    if (c.terminate()) return 25;
    const int s = islice ? base + 3 : base + 1;   // cbp luma's context
    int t = 1 + 12 * c.decision(s);
    if (c.decision(s + 1)) t += 4 + 4 * c.decision(s + (islice ? 2 : 1));
    t += 2 * c.decision(islice ? base + 6 : base + 3);
    t += c.decision(islice ? base + 7 : base + 3);
    return t;
  }

  int sub_mb_type(Bits& b) {
    if (!cabac_) {
      const int v = static_cast<int>(b.ue());
      if (v > 3) throw Refuse{kDamaged};
      return v;
    }
    Cabac& c = *cabac_;
    if (c.decision(21)) return 0;
    if (!c.decision(22)) return 1;
    return c.decision(23) ? 2 : 3;
  }

  int ref_idx(Bits& b, int x, int y) {
    const int n = sh_->num_ref;
    if (!cabac_) {
      const int v = n == 2 ? !b.bit() : static_cast<int>(b.ue());
      if (v >= n) throw Refuse{kDamaged};
      return v;
    }
    const Nb a = nb_ref(x - 1, y), bb = nb_ref(x, y - 1);
    int ctx = (a.ref > 0) + 2 * (bb.ref > 0);
    int v = 0;
    while (cabac_->decision(54 + ctx)) {
      ++v;
      ctx = v == 1 ? 4 : 5;
      if (v >= n) throw Refuse{kDamaged};
    }
    return v;
  }

  // a neighbour's ref_idx as the CABAC context reads it (skip: 0)
  Nb nb_ref(int x, int y) const {
    int idx;
    const int m = blk_nb(x >> 2, y >> 2, &idx);
    if (m < 0) return {false, -1, {0, 0}};
    const MbInfo& n = mbs_[m];
    if (n.intra || n.kind == kPSkip) return {true, -1, {0, 0}};
    const int b8 = ((idx >> 3) << 1) | ((idx & 3) >> 1);
    return {true, n.ref[b8], {0, 0}};
  }

  int mvd(Bits& b, int x, int y, int comp) {
    if (!cabac_) return b.se();
    int sum = 0;
    for (int k = 0; k < 2; ++k) {
      int idx;
      const int m = k == 0 ? blk_nb((x - 1) >> 2, y >> 2, &idx)
                           : blk_nb(x >> 2, (y - 1) >> 2, &idx);
      if (m >= 0) sum += mbs_[m].mvd[idx][comp];
    }
    Cabac& c = *cabac_;
    const int base = comp ? 47 : 40;
    if (!c.decision(base + (sum < 3 ? 0 : (sum > 32 ? 2 : 1)))) return 0;
    int v = 1;
    while (v < 9 && c.decision(base + (v < 4 ? v + 2 : 6))) ++v;
    if (v >= 9) v += exp_golomb(3);
    return c.bypass() ? -v : v;
  }

  int exp_golomb(int k) {
    int v = 0;
    while (cabac_->bypass()) {
      v += 1 << k;
      if (++k > 24) throw Refuse{kDamaged};
    }
    while (k--) v += cabac_->bypass() << k;
    return v;
  }

  int cbp(Bits& b, bool intra_nxn) {
    if (!cabac_) {
      const uint32_t v = b.ue();
      if (v > 47) throw Refuse{kDamaged};
      return intra_nxn ? kIntraCbp[v] : kInterCbp[v];
    }
    Cabac& c = *cabac_;
    const int ca = nb_a_ >= 0 ? mbs_[nb_a_].cbp : 0x0F;
    const int cb = nb_b_ >= 0 ? mbs_[nb_b_].cbp : 0x0F;
    int v = 0;
    for (int b8 = 0; b8 < 4; ++b8) {
      const int a = (b8 & 1) ? (v >> (b8 - 1)) & 1 : (ca >> (b8 + 1)) & 1;
      const int t = (b8 & 2) ? (v >> (b8 - 2)) & 1 : (cb >> (b8 + 2)) & 1;
      v |= c.decision(73 + !a + 2 * !t) << b8;
    }
    const int cha = nb_a_ >= 0 ? mbs_[nb_a_].cbp >> 4 : 0;
    const int chb = nb_b_ >= 0 ? mbs_[nb_b_].cbp >> 4 : 0;
    if (c.decision(77 + (cha > 0) + 2 * (chb > 0))) {
      v |= (1 + c.decision(77 + 4 + (cha == 2) + 2 * (chb == 2))) << 4;
    }
    return v;
  }

  int dqp(Bits& b) {
    if (!cabac_) return b.se();
    Cabac& c = *cabac_;
    if (!c.decision(60 + (last_dqp_ != 0))) return 0;
    int k = 1;
    while (c.decision(k == 1 ? 62 : 63)) {
      if (++k > 104) throw Refuse{kDamaged};
    }
    return (k & 1) ? (k + 1) / 2 : -(k / 2);
  }

  int t8x8_flag(Bits& b) {
    if (!cabac_) return b.bit();
    const int inc = (nb_a_ >= 0 && mbs_[nb_a_].t8x8) +
                    (nb_b_ >= 0 && mbs_[nb_b_].t8x8);
    return cabac_->decision(399 + inc);
  }

  int intra_mode(Bits& b, int pred) {
    int flag, rem = 0;
    if (!cabac_) {
      flag = b.bit();
      if (!flag) rem = static_cast<int>(b.u(3));
    } else {
      flag = cabac_->decision(68);
      if (!flag) {
        rem = cabac_->decision(69);
        rem |= cabac_->decision(69) << 1;
        rem |= cabac_->decision(69) << 2;
      }
    }
    if (flag) return pred;
    return rem < pred ? rem : rem + 1;
  }

  int chroma_mode(Bits& b) {
    if (!cabac_) {
      const uint32_t v = b.ue();
      if (v > 3) throw Refuse{kDamaged};
      return static_cast<int>(v);
    }
    auto cond = [&](int m) {
      return m >= 0 && mbs_[m].intra && mbs_[m].kind != kIPcm &&
             mbs_[m].chroma_mode != 0;
    };
    Cabac& c = *cabac_;
    if (!c.decision(64 + cond(nb_a_) + cond(nb_b_))) return 0;
    if (!c.decision(67)) return 1;
    return c.decision(67) ? 3 : 2;
  }

  int pred_intra_mode(int bx, int by) const {
    int ia, ib;
    const int ma = blk_nb(bx - 1, by, &ia), mb = blk_nb(bx, by - 1, &ib);
    if (ma < 0 || mb < 0) return 2;
    if (pp_->constrained_intra && (!mbs_[ma].intra || !mbs_[mb].intra)) {
      return 2;
    }
    const int a = mbs_[ma].ipred[ia] < 0 ? 2 : mbs_[ma].ipred[ia];
    const int c = mbs_[mb].ipred[ib] < 0 ? 2 : mbs_[mb].ipred[ib];
    return std::min(a, c);
  }

  // ---------------------------------------------------------- macroblock

  void macroblock(Bits& b) {
    MbInfo& m = mbs_[mba_];
    const int t = mb_type(b);
    if (t >= 5) {
      intra_mb(b, t - 5);
      return;
    }
    m.kind = kPInter;
    m.intra = false;
    const int n = sh_->num_ref;
    struct Part {
      int x, y, w, h, ref;
      int mv[2];
    };
    Part parts[16];
    int np = 0;
    bool small = false;
    if (t < 3) {
      const int cnt = t == 0 ? 1 : 2;
      int refs[2] = {0, 0};
      for (int i = 0; i < cnt; ++i) {
        const int x = t == 2 ? 8 * i : 0, y = t == 1 ? 8 * i : 0;
        if (n > 1) refs[i] = ref_idx(b, x, y);
        for (int k = 0; k < 4; ++k) {
          const int kx = (k & 1) * 8, ky = (k >> 1) * 8;
          const bool in = kx >= x && ky >= y && kx < x + (t == 2 ? 8 : 16) &&
                          ky < y + (t == 1 ? 8 : 16);
          if (in) m.ref[k] = static_cast<int8_t>(refs[i]);
        }
      }
      for (int i = 0; i < cnt; ++i) {
        const int w = t == 2 ? 8 : 16, h = t == 1 ? 8 : 16;
        const int x = t == 2 ? 8 * i : 0, y = t == 1 ? 8 * i : 0;
        int d[2];
        d[0] = mvd(b, x, y, 0);
        d[1] = mvd(b, x, y, 1);
        int p[2];
        const int shape = t == 1 ? 1 + i : (t == 2 ? 3 + i : 0);
        mvp(x, y, w, refs[i], shape, p);
        Part& q = parts[np++];
        q = {x, y, w, h, refs[i], {p[0] + d[0], p[1] + d[1]}};
        set_motion(x, y, w, h, q.mv, d);
      }
    } else {
      int sub[4];
      for (int k = 0; k < 4; ++k) {
        sub[k] = sub_mb_type(b);
        if (sub[k]) small = true;
      }
      for (int k = 0; k < 4; ++k) {
        m.ref[k] = static_cast<int8_t>(
            (n > 1 && t == 3) ? ref_idx(b, (k & 1) * 8, (k >> 1) * 8) : 0);
      }
      for (int k = 0; k < 4; ++k) {
        const int x0 = (k & 1) * 8, y0 = (k >> 1) * 8;
        const int s = sub[k];
        const int cnt = s == 0 ? 1 : (s == 3 ? 4 : 2);
        const int w = (s == 0 || s == 1) ? 8 : 4;
        const int h = (s == 0 || s == 2) ? 8 : 4;
        for (int j = 0; j < cnt; ++j) {
          const int x = x0 + (s == 2 || s == 3 ? (j & 1) * 4 : 0);
          const int y = y0 + (s == 1 ? j * 4 : (s == 3 ? (j >> 1) * 4 : 0));
          int d[2];
          d[0] = mvd(b, x, y, 0);
          d[1] = mvd(b, x, y, 1);
          int p[2];
          mvp(x, y, w, m.ref[k], 0, p);
          Part& q = parts[np++];
          q = {x, y, w, h, m.ref[k], {p[0] + d[0], p[1] + d[1]}};
          set_motion(x, y, w, h, q.mv, d);
        }
      }
    }
    for (int k = 0; k < 4; ++k) m.refpic[k] = ref_pic(m.ref[k])->id;
    m.cbp = static_cast<uint8_t>(cbp(b, false));
    if ((m.cbp & 15) && pp_->transform_8x8 && !small) {
      m.t8x8 = t8x8_flag(b);
    }
    for (int i = 0; i < np; ++i) {
      inter_pred(parts[i].x, parts[i].y, parts[i].w, parts[i].h, parts[i].ref,
                 parts[i].mv);
    }
    residual_and_add(b, m, false);
  }

  void intra_mb(Bits& b, int it) {
    MbInfo& m = mbs_[mba_];
    m.intra = true;
    if (it == 25) {
      pcm(b, m);
      return;
    }
    if (it == 0) {
      if (pp_->transform_8x8) m.t8x8 = t8x8_flag(b);
      m.kind = m.t8x8 ? kI8x8 : kI4x4;
      if (m.t8x8) {
        for (int b8 = 0; b8 < 4; ++b8) {
          const int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
          const int mode = intra_mode(b, pred_intra_mode(bx, by));
          for (int k = 0; k < 4; ++k) {
            m.ipred[(by + (k >> 1)) * 4 + bx + (k & 1)] =
                static_cast<int8_t>(mode);
          }
        }
      } else {
        for (int i = 0; i < 16; ++i) {
          const int bx = ((i >> 2) & 1) * 2 + (i & 1);
          const int by = (i >> 3) * 2 + ((i >> 1) & 1);
          m.ipred[by * 4 + bx] =
              static_cast<int8_t>(intra_mode(b, pred_intra_mode(bx, by)));
        }
      }
      m.chroma_mode = static_cast<uint8_t>(chroma_mode(b));
      m.cbp = static_cast<uint8_t>(cbp(b, true));
    } else {
      m.kind = kI16x16;
      i16_mode_ = (it - 1) % 4;
      const int chroma = ((it - 1) / 4) % 3;
      m.cbp = static_cast<uint8_t>((it >= 13 ? 15 : 0) | (chroma << 4));
      m.chroma_mode = static_cast<uint8_t>(chroma_mode(b));
    }
    residual_and_add(b, m, true);
  }

  void pcm(Bits& b, MbInfo& m) {
    m.kind = kIPcm;
    b.align();
    uint8_t* y = cur_->plane[0].data() + mby_ * 16 * ys() + mbx_ * 16;
    for (int r = 0; r < 16; ++r) {
      for (int c = 0; c < 16; ++c) {
        y[r * ys() + c] = static_cast<uint8_t>(b.u(8));
      }
    }
    for (int p = 1; p < 3; ++p) {
      uint8_t* d = cur_->plane[p].data() + mby_ * 8 * cs() + mbx_ * 8;
      for (int r = 0; r < 8; ++r) {
        for (int c = 0; c < 8; ++c) {
          d[r * cs() + c] = static_cast<uint8_t>(b.u(8));
        }
      }
    }
    m.qp = static_cast<int8_t>(qp_);
    m.qp_deb = 0;
    m.cbp = 0x2F;
    m.dc_cbf = 7;
    std::memset(m.nnz, 16, sizeof m.nnz);
    std::memset(m.nnzc, 16, sizeof m.nnzc);
    std::memset(m.nzdeb, 1, sizeof m.nzdeb);
    last_dqp_ = 0;
    if (cabac_) cabac_->start(&b);
  }

  int ys() const { return mb_w_ * 16; }
  int cs() const { return mb_w_ * 8; }

  // ---------------------------------------------------------- residual

  int nc_luma(int bx, int by) const {
    int ia, ib;
    const int ma = blk_nb(bx - 1, by, &ia), mb = blk_nb(bx, by - 1, &ib);
    const int na = ma >= 0 ? mbs_[ma].nnz[ia] : 0;
    const int nb = mb >= 0 ? mbs_[mb].nnz[ib] : 0;
    if (ma >= 0 && mb >= 0) return (na + nb + 1) >> 1;
    return ma >= 0 ? na : (mb >= 0 ? nb : 0);
  }
  int nc_chroma(int c, int cx, int cy) const {
    int ia, ib;
    const int ma = cblk_nb(cx - 1, cy, &ia), mb = cblk_nb(cx, cy - 1, &ib);
    const int na = ma >= 0 ? mbs_[ma].nnzc[c][ia] : 0;
    const int nb = mb >= 0 ? mbs_[mb].nnzc[c][ib] : 0;
    if (ma >= 0 && mb >= 0) return (na + nb + 1) >> 1;
    return ma >= 0 ? na : (mb >= 0 ? nb : 0);
  }

  // coded_block_flag's condTermFlagN from a neighbour's data (or, where it
  // is not available, from whether the current MB is intra)
  int cbf_luma_inc(int bx, int by) const {
    int ia, ib;
    const int ma = blk_nb(bx - 1, by, &ia), mb = blk_nb(bx, by - 1, &ib);
    const bool intra = mbs_[mba_].intra;
    auto cond = [&](int m, int idx) {
      if (m < 0) return intra ? 1 : 0;
      const MbInfo& n = mbs_[m];
      const int b8 = ((idx >> 3) << 1) | ((idx & 3) >> 1);
      if (!((n.cbp >> b8) & 1)) return 0;
      return n.nnz[idx] > 0 ? 1 : 0;
    };
    return cond(ma, ia) + 2 * cond(mb, ib);
  }
  int cbf_dc_inc(int bit) const {
    const bool intra = mbs_[mba_].intra;
    auto cond = [&](int m) {
      if (m < 0) return intra ? 1 : 0;
      return (mbs_[m].dc_cbf >> bit) & 1;
    };
    return cond(nb_a_) + 2 * cond(nb_b_);
  }
  int cbf_chroma_inc(int c, int cx, int cy) const {
    int ia, ib;
    const int ma = cblk_nb(cx - 1, cy, &ia), mb = cblk_nb(cx, cy - 1, &ib);
    const bool intra = mbs_[mba_].intra;
    auto cond = [&](int m, int idx) {
      if (m < 0) return intra ? 1 : 0;
      const MbInfo& n = mbs_[m];
      if ((n.cbp >> 4) != 2) return 0;
      return n.nnzc[c][idx] > 0 ? 1 : 0;
    };
    return cond(ma, ia) + 2 * cond(mb, ib);
  }

  // one block's levels, in scan order, into lv[0..max); the coded count
  int cavlc_block(Bits& b, int nc, int max, int* lv) {
    const CavlcTables& t = cavlc_tables();
    const int tab = nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
    const int tok = t.coeff_token[tab].read(b);
    const int total = tok >> 2, t1 = tok & 3;
    for (int i = 0; i < max; ++i) lv[i] = 0;
    if (total == 0) return 0;
    if (total > max) throw Refuse{kDamaged};
    int level[16];
    int suffix = (total > 10 && t1 < 3) ? 1 : 0;
    for (int i = 0; i < total; ++i) {
      if (i < t1) {
        level[i] = b.bit() ? -1 : 1;
        continue;
      }
      int prefix = 0;
      while (!b.bit()) {
        if (++prefix > 31) throw Refuse{kDamaged};
      }
      int code = std::min(15, prefix) << suffix;
      const int size = (prefix == 14 && suffix == 0) ? 4
                       : (prefix >= 15 ? prefix - 3 : suffix);
      if ((suffix > 0 || prefix >= 14) && size > 0) {
        code += static_cast<int>(b.u(size));
      }
      if (prefix >= 15 && suffix == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      level[i] = (code % 2 == 0) ? (code + 2) >> 1 : (-code - 1) >> 1;
      if (suffix == 0) suffix = 1;
      if (std::abs(level[i]) > (3 << (suffix - 1)) && suffix < 6) ++suffix;
    }
    int zeros = 0;
    if (total < max) {
      zeros = max == 4 ? t.chroma_dc_total_zeros[total - 1].read(b)
                       : t.total_zeros[total - 1].read(b);
    }
    int pos = total - 1 + zeros;
    if (pos >= max) throw Refuse{kDamaged};
    for (int i = 0; i < total; ++i) {
      lv[pos] = level[i];
      int run = 0;
      if (i < total - 1 && zeros > 0) {
        run = t.run_before[std::min(zeros, 7) - 1].read(b);
        zeros -= run;
        if (zeros < 0) throw Refuse{kDamaged};
      }
      pos -= run + 1;
    }
    return total;
  }

  int cabac_block(int cat, int inc, int max, int* lv) {
    static const int kCbfOff[5] = {0, 4, 8, 12, 16};
    static const int kSigOff[5] = {0, 15, 29, 44, 47};
    static const int kAbsOff[5] = {0, 10, 20, 30, 39};
    Cabac& c = *cabac_;
    for (int i = 0; i < max; ++i) lv[i] = 0;
    if (cat != 5 && !c.decision(85 + kCbfOff[cat] + inc)) return 0;
    int sig[64];
    int n = 0;
    bool last = false;
    for (int i = 0; i < max - 1; ++i) {
      int sctx, lctx;
      if (cat == 5) {
        sctx = 402 + kSig8x8[i];
        lctx = 417 + kLast8x8[i];
      } else if (cat == 3) {
        sctx = 105 + 44 + std::min(i, 2);
        lctx = 166 + 44 + std::min(i, 2);
      } else {
        sctx = 105 + kSigOff[cat] + i;
        lctx = 166 + kSigOff[cat] + i;
      }
      if (c.decision(sctx)) {
        sig[n++] = i;
        if (c.decision(lctx)) {
          last = true;
          break;
        }
      }
    }
    if (!last) sig[n++] = max - 1;
    int gt1 = 0, eq1 = 0;
    const int base = cat == 5 ? 426 : 227 + kAbsOff[cat];
    for (int k = n - 1; k >= 0; --k) {
      int v;
      if (!c.decision(base + (gt1 ? 0 : std::min(4, 1 + eq1)))) {
        v = 1;
      } else {
        const int ctx = base + 5 + std::min(4 - (cat == 3 ? 1 : 0), gt1);
        int prefix = 1;
        while (prefix < 14 && c.decision(ctx)) ++prefix;
        v = prefix + 1;
        if (prefix == 14) v += exp_golomb(0);
      }
      if (v == 1) ++eq1; else ++gt1;
      lv[sig[k]] = c.bypass() ? -v : v;
    }
    return n;
  }

  static int deq4(int c, int ls, int qp) {
    return qp >= 24 ? c * ls * (1 << (qp / 6 - 4))
                    : (c * ls + (1 << (3 - qp / 6))) >> (4 - qp / 6);
  }
  static int deq8(int c, int ls, int qp) {
    return qp >= 36 ? c * ls * (1 << (qp / 6 - 6))
                    : (c * ls + (1 << (5 - qp / 6))) >> (6 - qp / 6);
  }

  void residual_and_add(Bits& b, MbInfo& m, bool intra) {
    const bool i16 = m.kind == kI16x16;
    const int cbp_l = m.cbp & 15, cbp_c = m.cbp >> 4;
    if (cbp_l || cbp_c || i16) {
      const int d = dqp(b);
      if (d < -26 || d > 25) throw Refuse{kDamaged};
      qp_ = (qp_ + d + 52) % 52;
      last_dqp_ = d;
    } else {
      last_dqp_ = 0;
    }
    m.qp = static_cast<int8_t>(qp_);
    m.qp_deb = m.qp;
    const int qp = qp_;
    const int list = intra ? 0 : 3;
    int32_t coef[16][16];
    bool any[16];
    int32_t coef8[4][64];
    std::memset(any, 0, sizeof any);
    int lv[64];
    // luma DC of Intra_16x16
    int32_t dc[16] = {0};
    if (i16) {
      const int n = cabac_ ? cabac_block(0, cbf_dc_inc(0), 16, lv)
                           : cavlc_block(b, nc_luma(0, 0), 16, lv);
      if (n) m.dc_cbf |= 1;
      if (n) {
        int c[16];
        for (int k = 0; k < 16; ++k) c[kZigzag4x4[k]] = lv[k];
        int f[16], g[16];
        for (int i = 0; i < 4; ++i) {       // rows
          const int* r = c + 4 * i;
          const int e0 = r[0] + r[1], e1 = r[0] - r[1];
          const int e2 = r[2] + r[3], e3 = r[2] - r[3];
          f[4 * i + 0] = e0 + e2;
          f[4 * i + 1] = e0 - e2;
          f[4 * i + 2] = e1 - e3;
          f[4 * i + 3] = e1 + e3;
        }
        for (int j = 0; j < 4; ++j) {       // columns
          const int e0 = f[j] + f[4 + j], e1 = f[j] - f[4 + j];
          const int e2 = f[8 + j] + f[12 + j], e3 = f[8 + j] - f[12 + j];
          g[j] = e0 + e2;
          g[4 + j] = e0 - e2;
          g[8 + j] = e1 - e3;
          g[12 + j] = e1 + e3;
        }
        const int ls = ls4_[0][qp % 6][0];
        for (int k = 0; k < 16; ++k) {
          dc[k] = qp >= 36 ? g[k] * ls * (1 << (qp / 6 - 6))
                           : (g[k] * ls + (1 << (5 - qp / 6))) >> (6 - qp / 6);
        }
      }
    }
    // luma blocks
    std::memset(coef, 0, sizeof coef);
    for (int b8 = 0; b8 < 4; ++b8) {
      const int bx0 = (b8 & 1) * 2, by0 = (b8 >> 1) * 2;
      const bool coded = (cbp_l >> b8) & 1;
      if (m.t8x8) {
        std::memset(coef8[b8], 0, sizeof coef8[b8]);
        int cnt = 0;
        if (coded) {
          if (cabac_) {
            cnt = cabac_block(5, 0, 64, lv);
            for (int k = 0; k < 4; ++k) {
              m.nnz[(by0 + (k >> 1)) * 4 + bx0 + (k & 1)] =
                  static_cast<uint8_t>(cnt);
            }
          } else {
            int all[64] = {0};
            for (int s = 0; s < 4; ++s) {
              const int bx = bx0 + (s & 1), by = by0 + (s >> 1);
              int part[16];
              const int n = cavlc_block(b, nc_luma(bx, by), 16, part);
              m.nnz[by * 4 + bx] = static_cast<uint8_t>(n);
              cnt += n;
              for (int i = 0; i < 16; ++i) all[4 * i + s] = part[i];
            }
            std::memcpy(lv, all, sizeof all);
          }
          const int l8 = intra ? 0 : 1;
          for (int k = 0; k < 64; ++k) {
            if (lv[k]) {
              const int r = kZigzag8x8[k];
              coef8[b8][r] = deq8(lv[k], ls8_[l8][qp % 6][r], qp);
            }
          }
        }
        for (int k = 0; k < 4; ++k) {
          m.nzdeb[(by0 + (k >> 1)) * 4 + bx0 + (k & 1)] = cnt > 0;
        }
        continue;
      }
      for (int s = 0; s < 4; ++s) {
        const int bx = bx0 + (s & 1), by = by0 + (s >> 1);
        const int idx = by * 4 + bx;
        int n = 0;
        if (coded) {
          if (i16) {
            n = cabac_ ? cabac_block(1, cbf_luma_inc(bx, by), 15, lv)
                       : cavlc_block(b, nc_luma(bx, by), 15, lv);
            for (int k = 0; k < 15; ++k) {
              if (lv[k]) {
                const int r = kZigzag4x4[k + 1];
                coef[idx][r] = deq4(lv[k], ls4_[0][qp % 6][r], qp);
              }
            }
          } else {
            n = cabac_ ? cabac_block(2, cbf_luma_inc(bx, by), 16, lv)
                       : cavlc_block(b, nc_luma(bx, by), 16, lv);
            for (int k = 0; k < 16; ++k) {
              if (lv[k]) {
                const int r = kZigzag4x4[k];
                coef[idx][r] = deq4(lv[k], ls4_[list][qp % 6][r], qp);
              }
            }
          }
        }
        m.nnz[idx] = static_cast<uint8_t>(n);
        m.nzdeb[idx] = n > 0;
        any[idx] = n > 0;
      }
    }
    if (i16) {
      for (int k = 0; k < 16; ++k) {
        coef[k][0] = dc[k];
        any[k] = true;
      }
    }
    // chroma
    int32_t cac[2][4][16];
    std::memset(cac, 0, sizeof cac);
    bool cany[2][4] = {};
    int cqp[2];
    for (int c = 0; c < 2; ++c) {
      cqp[c] = kChromaQp[clip3(0, 51, qp + pp_->chroma_qp_offset[c])];
    }
    if (cbp_c) {
      for (int c = 0; c < 2; ++c) {
        int v[4];
        const int n = cabac_ ? cabac_block(3, cbf_dc_inc(1 + c), 4, v)
                             : cavlc_block(b, -1, 4, v);
        if (n) {
          m.dc_cbf |= static_cast<uint8_t>(2 << c);
          const int f0 = v[0] + v[1], f1 = v[0] - v[1];
          const int f2 = v[2] + v[3], f3 = v[2] - v[3];
          const int g[4] = {f0 + f2, f1 + f3, f0 - f2, f1 - f3};
          const int ls = ls4_[list + 1 + c][cqp[c] % 6][0];
          for (int k = 0; k < 4; ++k) {
            cac[c][k][0] = (g[k] * ls * (1 << (cqp[c] / 6))) >> 5;
            cany[c][k] = true;
          }
        }
      }
    }
    if (cbp_c == 2) {
      for (int c = 0; c < 2; ++c) {
        for (int k = 0; k < 4; ++k) {
          const int cx = k & 1, cy = k >> 1;
          const int n = cabac_ ? cabac_block(4, cbf_chroma_inc(c, cx, cy), 15,
                                             lv)
                               : cavlc_block(b, nc_chroma(c, cx, cy), 15, lv);
          m.nnzc[c][k] = static_cast<uint8_t>(n);
          for (int i = 0; i < 15; ++i) {
            if (lv[i]) {
              const int r = kZigzag4x4[i + 1];
              cac[c][k][r] = deq4(lv[i], ls4_[list + 1 + c][cqp[c] % 6][r],
                                  cqp[c]);
              cany[c][k] = true;
            }
          }
        }
      }
    }
    // reconstruction
    uint8_t* py = cur_->plane[0].data() + mby_ * 16 * ys() + mbx_ * 16;
    if (m.kind == kI4x4) {
      for (int i = 0; i < 16; ++i) {
        const int bx = ((i >> 2) & 1) * 2 + (i & 1);
        const int by = (i >> 3) * 2 + ((i >> 1) & 1);
        intra4x4(bx, by, m.ipred[by * 4 + bx]);
        if (any[by * 4 + bx]) {
          idct4_add(coef[by * 4 + bx], py + by * 4 * ys() + bx * 4, ys());
        }
      }
    } else if (m.kind == kI8x8) {
      for (int b8 = 0; b8 < 4; ++b8) {
        const int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
        intra8x8(b8, m.ipred[by * 4 + bx]);
        if (m.nzdeb[by * 4 + bx]) {
          idct8_add(coef8[b8], py + by * 4 * ys() + bx * 4, ys());
        }
      }
    } else {
      if (m.kind == kI16x16) intra16x16(i16_mode_);
      if (m.t8x8) {
        for (int b8 = 0; b8 < 4; ++b8) {
          const int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
          if (m.nzdeb[by * 4 + bx]) {
            idct8_add(coef8[b8], py + by * 4 * ys() + bx * 4, ys());
          }
        }
      } else {
        for (int idx = 0; idx < 16; ++idx) {
          if (any[idx]) {
            idct4_add(coef[idx], py + (idx >> 2) * 4 * ys() + (idx & 3) * 4,
                      ys());
          }
        }
      }
    }
    if (intra) intra_chroma(m.chroma_mode);
    for (int c = 0; c < 2; ++c) {
      uint8_t* pc = cur_->plane[1 + c].data() + mby_ * 8 * cs() + mbx_ * 8;
      for (int k = 0; k < 4; ++k) {
        if (cany[c][k]) {
          idct4_add(cac[c][k], pc + (k >> 1) * 4 * cs() + (k & 1) * 4, cs());
        }
      }
    }
  }

  // ---------------------------------------------------------- transforms

  static void idct4_add(const int32_t* d, uint8_t* dst, int stride) {
    int f[16];
    for (int i = 0; i < 4; ++i) {
      const int* r = d + 4 * i;
      const int e0 = r[0] + r[2], e1 = r[0] - r[2];
      const int e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
      f[4 * i + 0] = e0 + e3;
      f[4 * i + 1] = e1 + e2;
      f[4 * i + 2] = e1 - e2;
      f[4 * i + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; ++j) {
      const int g0 = f[j], g1 = f[4 + j], g2 = f[8 + j], g3 = f[12 + j];
      const int e0 = g0 + g2, e1 = g0 - g2;
      const int e2 = (g1 >> 1) - g3, e3 = g1 + (g3 >> 1);
      const int h[4] = {e0 + e3, e1 + e2, e1 - e2, e0 - e3};
      for (int i = 0; i < 4; ++i) {
        uint8_t& p = dst[i * stride + j];
        p = clip1(p + ((h[i] + 32) >> 6));
      }
    }
  }

  static void idct8_1d(const int* in, int step, int* out, int ostep) {
    const int d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step];
    const int d4 = in[4 * step], d5 = in[5 * step], d6 = in[6 * step],
              d7 = in[7 * step];
    const int a0 = d0 + d4, a4 = d0 - d4;
    const int a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
    const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
    const int a1 = -d3 + d5 - d7 - (d7 >> 1);
    const int a3 = d1 + d7 - d3 - (d3 >> 1);
    const int a5 = -d1 + d7 + d5 + (d5 >> 1);
    const int a7 = d3 + d5 + d1 + (d1 >> 1);
    const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
    const int b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
    out[0] = b0 + b7;
    out[ostep] = b2 + b5;
    out[2 * ostep] = b4 + b3;
    out[3 * ostep] = b6 + b1;
    out[4 * ostep] = b6 - b1;
    out[5 * ostep] = b4 - b3;
    out[6 * ostep] = b2 - b5;
    out[7 * ostep] = b0 - b7;
  }

  static void idct8_add(const int32_t* d, uint8_t* dst, int stride) {
    int f[64], g[64];
    for (int i = 0; i < 8; ++i) idct8_1d(d + 8 * i, 1, f + 8 * i, 1);
    for (int j = 0; j < 8; ++j) idct8_1d(f + j, 8, g + j, 8);
    for (int i = 0; i < 8; ++i) {
      for (int j = 0; j < 8; ++j) {
        uint8_t& p = dst[i * stride + j];
        p = clip1(p + ((g[8 * i + j] + 32) >> 6));
      }
    }
  }

  // ---------------------------------------------------------- intra

  // The N x N directional predictions of 8.3.1.2 / 8.3.2.2 from the
  // (filtered, for 8x8) references: t[-1..2N-1] above (t[-1] the corner),
  // l[-1..N-1] to the left (l[-1] the corner).
  template <int N>
  static void pred_nxn(int mode, const int* t, const int* l, bool ht, bool hl,
                       uint8_t* dst, int stride) {
    auto P = [&](int x, int y) { return y < 0 ? t[x] : l[y]; };
    for (int y = 0; y < N; ++y) {
      for (int x = 0; x < N; ++x) {
        int v = 0;
        switch (mode) {
          case 0: v = P(x, -1); break;
          case 1: v = P(-1, y); break;
          case 2: {
            int s = 0;
            if (ht && hl) {
              for (int k = 0; k < N; ++k) s += t[k] + l[k];
              v = (s + N) / (2 * N);
            } else if (ht) {
              for (int k = 0; k < N; ++k) s += t[k];
              v = (s + N / 2) / N;
            } else if (hl) {
              for (int k = 0; k < N; ++k) s += l[k];
              v = (s + N / 2) / N;
            } else {
              v = 128;
            }
            break;
          }
          case 3:
            v = (x == N - 1 && y == N - 1)
                    ? (P(2 * N - 2, -1) + 3 * P(2 * N - 1, -1) + 2) >> 2
                    : (P(x + y, -1) + 2 * P(x + y + 1, -1) + P(x + y + 2, -1) +
                       2) >> 2;
            break;
          case 4:
            if (x > y) {
              v = (P(x - y - 2, -1) + 2 * P(x - y - 1, -1) + P(x - y, -1) +
                   2) >> 2;
            } else if (x < y) {
              v = (P(-1, y - x - 2) + 2 * P(-1, y - x - 1) + P(-1, y - x) +
                   2) >> 2;
            } else {
              v = (P(0, -1) + 2 * P(-1, -1) + P(-1, 0) + 2) >> 2;
            }
            break;
          case 5: {
            const int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) {
              v = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1) >> 1;
            } else if (z >= 0) {
              v = (P(x - (y >> 1) - 2, -1) + 2 * P(x - (y >> 1) - 1, -1) +
                   P(x - (y >> 1), -1) + 2) >> 2;
            } else if (z == -1) {
              v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
            } else {
              v = (P(-1, y - 2 * x - 1) + 2 * P(-1, y - 2 * x - 2) +
                   P(-1, y - 2 * x - 3) + 2) >> 2;
            }
            break;
          }
          case 6: {
            const int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) {
              v = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1) >> 1;
            } else if (z >= 0) {
              v = (P(-1, y - (x >> 1) - 2) + 2 * P(-1, y - (x >> 1) - 1) +
                   P(-1, y - (x >> 1)) + 2) >> 2;
            } else if (z == -1) {
              v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
            } else {
              v = (P(x - 2 * y - 1, -1) + 2 * P(x - 2 * y - 2, -1) +
                   P(x - 2 * y - 3, -1) + 2) >> 2;
            }
            break;
          }
          case 7:
            v = !(y & 1)
                    ? (P(x + (y >> 1), -1) + P(x + (y >> 1) + 1, -1) + 1) >> 1
                    : (P(x + (y >> 1), -1) + 2 * P(x + (y >> 1) + 1, -1) +
                       P(x + (y >> 1) + 2, -1) + 2) >> 2;
            break;
          default: {
            const int z = x + 2 * y;
            if (z < 2 * N - 3 && !(z & 1)) {
              v = (P(-1, y + (x >> 1)) + P(-1, y + (x >> 1) + 1) + 1) >> 1;
            } else if (z < 2 * N - 3) {
              v = (P(-1, y + (x >> 1)) + 2 * P(-1, y + (x >> 1) + 1) +
                   P(-1, y + (x >> 1) + 2) + 2) >> 2;
            } else if (z == 2 * N - 3) {
              v = (P(-1, N - 2) + 3 * P(-1, N - 1) + 2) >> 2;
            } else {
              v = P(-1, N - 1);
            }
          }
        }
        dst[y * stride + x] = static_cast<uint8_t>(v);
      }
    }
  }

  static void need(int mode, bool ht, bool hl, bool htl) {
    bool ok = true;
    switch (mode) {
      case 0: case 3: case 7: ok = ht; break;
      case 1: case 8: ok = hl; break;
      case 4: case 5: case 6: ok = ht && hl && htl; break;
      default: break;
    }
    if (!ok) throw Refuse{kDamaged};
  }

  void intra4x4(int bx, int by, int mode) {
    const int s = ys();
    uint8_t* dst = cur_->plane[0].data() + (mby_ * 16 + by * 4) * s +
                   mbx_ * 16 + bx * 4;
    const bool hl = bx > 0 || ia_, ht = by > 0 || ib_;
    const bool htl = (bx > 0 && by > 0) ||
                     (bx == 0 && by == 0 ? id_ : (bx == 0 ? ia_ : ib_));
    bool htr;
    if (by == 0) htr = bx < 3 ? ib_ : ic_;
    else if (bx == 3) htr = false;
    else htr = blk_idx(bx + 1, by - 1) < blk_idx(bx, by);
    need(mode, ht, hl, htl);
    int tb[9], lb[5];
    int* t = tb + 1;
    int* l = lb + 1;
    t[-1] = l[-1] = htl ? dst[-s - 1] : 0;
    for (int k = 0; k < 4; ++k) {
      t[k] = ht ? dst[-s + k] : 0;
      t[4 + k] = ht ? (htr ? dst[-s + 4 + k] : dst[-s + 3]) : 0;
      l[k] = hl ? dst[k * s - 1] : 0;
    }
    pred_nxn<4>(mode, t, l, ht, hl, dst, s);
  }

  void intra8x8(int b8, int mode) {
    const int s = ys();
    const int x8 = b8 & 1, y8 = b8 >> 1;
    uint8_t* dst = cur_->plane[0].data() + (mby_ * 16 + y8 * 8) * s +
                   mbx_ * 16 + x8 * 8;
    const bool hl = x8 > 0 || ia_, ht = y8 > 0 || ib_;
    const bool htl = (x8 && y8) ||
                     (!x8 && !y8 ? id_ : (!x8 ? ia_ : ib_));
    const bool htr = b8 == 0 ? ib_ : (b8 == 1 ? ic_ : b8 == 2);
    need(mode, ht, hl, htl);
    int p[17], q[9];                  // unfiltered top (-1..15), left (-1..7)
    int* pt = p + 1;
    int* pl = q + 1;
    pt[-1] = pl[-1] = htl ? dst[-s - 1] : 0;
    for (int k = 0; k < 8; ++k) {
      pt[k] = ht ? dst[-s + k] : 0;
      pt[8 + k] = ht ? (htr ? dst[-s + 8 + k] : dst[-s + 7]) : 0;
      pl[k] = hl ? dst[k * s - 1] : 0;
    }
    int tb[17], lb[9];
    int* t = tb + 1;
    int* l = lb + 1;
    if (ht) {
      t[0] = htl ? (pt[-1] + 2 * pt[0] + pt[1] + 2) >> 2
                 : (3 * pt[0] + pt[1] + 2) >> 2;
      for (int x = 1; x < 15; ++x) {
        t[x] = (pt[x - 1] + 2 * pt[x] + pt[x + 1] + 2) >> 2;
      }
      t[15] = (pt[14] + 3 * pt[15] + 2) >> 2;
    }
    if (htl) {
      if (ht && hl) {
        t[-1] = (pt[0] + 2 * pt[-1] + pl[0] + 2) >> 2;
      } else if (ht) {
        t[-1] = (3 * pt[-1] + pt[0] + 2) >> 2;
      } else if (hl) {
        t[-1] = (3 * pt[-1] + pl[0] + 2) >> 2;
      } else {
        t[-1] = pt[-1];
      }
      l[-1] = t[-1];
    }
    if (hl) {
      l[0] = htl ? (pl[-1] + 2 * pl[0] + pl[1] + 2) >> 2
                 : (3 * pl[0] + pl[1] + 2) >> 2;
      for (int y = 1; y < 7; ++y) {
        l[y] = (pl[y - 1] + 2 * pl[y] + pl[y + 1] + 2) >> 2;
      }
      l[7] = (pl[6] + 3 * pl[7] + 2) >> 2;
    }
    pred_nxn<8>(mode, t, l, ht, hl, dst, s);
  }

  void intra16x16(int mode) {
    const int s = ys();
    uint8_t* dst = cur_->plane[0].data() + mby_ * 16 * s + mbx_ * 16;
    const bool ht = ib_, hl = ia_, htl = id_;
    if ((mode == 0 && !ht) || (mode == 1 && !hl) ||
        (mode == 3 && !(ht && hl && htl))) {
      throw Refuse{kDamaged};
    }
    plane_pred(dst, s, 16, mode == 0 ? 2 : mode == 1 ? 1 : mode == 2 ? 0 : 3,
               ht, hl);
  }

  void intra_chroma(int mode) {
    const bool ht = ib_, hl = ia_, htl = id_;
    if ((mode == 1 && !hl) || (mode == 2 && !ht) ||
        (mode == 3 && !(ht && hl && htl))) {
      throw Refuse{kDamaged};
    }
    for (int c = 1; c < 3; ++c) {
      uint8_t* dst = cur_->plane[c].data() + mby_ * 8 * cs() + mbx_ * 8;
      if (mode != 0) {
        plane_pred(dst, cs(), 8, mode, ht, hl);
        continue;
      }
      // DC per 4x4 (8.3.4.1-3)
      for (int k = 0; k < 4; ++k) {
        const int xo = (k & 1) * 4, yo = (k >> 1) * 4;
        uint8_t* d = dst + yo * cs() + xo;
        int st = 0, sl = 0;
        for (int i = 0; i < 4; ++i) {      // the MB's neighbours
          if (ht) st += dst[-cs() + xo + i];
          if (hl) sl += dst[(yo + i) * cs() - 1];
        }
        int v;
        const bool corner = (xo == 0 && yo == 0) || (xo > 0 && yo > 0);
        if (corner) {
          v = ht && hl ? (st + sl + 4) >> 3
              : hl     ? (sl + 2) >> 2
              : ht     ? (st + 2) >> 2 : 128;
        } else if (xo > 0) {
          v = ht ? (st + 2) >> 2 : hl ? (sl + 2) >> 2 : 128;
        } else {
          v = hl ? (sl + 2) >> 2 : ht ? (st + 2) >> 2 : 128;
        }
        for (int y = 0; y < 4; ++y) {
          std::memset(d + y * cs(), v, 4);
        }
      }
    }
  }

  // Intra_16x16 / chroma prediction of an n x n block (n 16 or 8); kind:
  // 0 DC (16x16 only), 1 horizontal, 2 vertical, 3 plane
  static void plane_pred(uint8_t* dst, int s, int n, int kind, bool ht,
                         bool hl) {
    if (kind == 2) {
      for (int y = 0; y < n; ++y) std::memcpy(dst + y * s, dst - s, n);
    } else if (kind == 1) {
      for (int y = 0; y < n; ++y) std::memset(dst + y * s, dst[y * s - 1], n);
    } else if (kind == 0) {
      int sum = 0, v;
      for (int k = 0; k < n; ++k) {
        if (ht) sum += dst[-s + k];
        if (hl) sum += dst[k * s - 1];
      }
      v = ht && hl ? (sum + 16) >> 5 : (ht || hl) ? (sum + 8) >> 4 : 128;
      for (int y = 0; y < n; ++y) std::memset(dst + y * s, v, n);
    } else {
      const int h2 = n / 2;
      int hh = 0, vv = 0;
      for (int k = 0; k < h2; ++k) {
        hh += (k + 1) * (dst[-s + h2 + k] - dst[-s + h2 - 2 - k]);
        vv += (k + 1) * (dst[(h2 + k) * s - 1] - dst[(h2 - 2 - k) * s - 1]);
      }
      const int a = 16 * (dst[(n - 1) * s - 1] + dst[-s + n - 1]);
      const int b = n == 16 ? (5 * hh + 32) >> 6 : (34 * hh + 32) >> 6;
      const int c = n == 16 ? (5 * vv + 32) >> 6 : (34 * vv + 32) >> 6;
      const int o = h2 - 1;
      for (int y = 0; y < n; ++y) {
        for (int x = 0; x < n; ++x) {
          dst[y * s + x] = clip1((a + b * (x - o) + c * (y - o) + 16) >> 5);
        }
      }
    }
  }

  // ---------------------------------------------------------- inter

  // the w x h luma block at (x, y) in the MB with motion mv from ref, and
  // its chroma, weighted when the PPS says so
  void inter_pred(int x, int y, int w, int h, int ref, const int* mv) {
    const Frame* r = ref_pic(ref);
    const int W = mb_w_ * 16, H = mb_h_ * 16;
    const int ax = mbx_ * 16 + x, ay = mby_ * 16 + y;
    uint8_t* dy = cur_->plane[0].data() + ay * W + ax;
    luma_mc(r->plane[0].data(), W, H, ax * 4 + mv[0], ay * 4 + mv[1], w, h,
            dy, W);
    const int cw = W / 2, ch = H / 2;
    for (int c = 1; c < 3; ++c) {
      uint8_t* dc = cur_->plane[c].data() + (ay / 2) * cw + ax / 2;
      chroma_mc(r->plane[c].data(), cw, ch, (ax / 2) * 8 + mv[0],
                (ay / 2) * 8 + mv[1], w / 2, h / 2, dc, cw);
    }
    if (!pp_->weighted_pred) return;
    const SliceHeader& sh = *sh_;
    weight(dy, W, w, h, sh.luma_log2, sh.lw[ref], sh.lo[ref]);
    for (int c = 0; c < 2; ++c) {
      uint8_t* dc = cur_->plane[1 + c].data() + (ay / 2) * cw + ax / 2;
      weight(dc, cw, w / 2, h / 2, sh.chroma_log2, sh.cw[ref][c],
             sh.co[ref][c]);
    }
  }

  static void weight(uint8_t* d, int s, int w, int h, int log2, int wt,
                     int off) {
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        uint8_t& p = d[y * s + x];
        p = log2 >= 1 ? clip1(((p * wt + (1 << (log2 - 1))) >> log2) + off)
                      : clip1(p * wt + off);
      }
    }
  }

  // 8.4.2.2.1: quarter-sample luma at (qx, qy) (quarter units, absolute)
  static void luma_mc(const uint8_t* ref, int W, int H, int qx, int qy, int w,
                      int h, uint8_t* dst, int ds) {
    const int xi = qx >> 2, yi = qy >> 2, fx = qx & 3, fy = qy & 3;
    // the (w + 5) x (h + 5) window from (xi - 2, yi - 2), edges clamped
    uint8_t win[21 * 21];
    const int ww = w + 5, wh = h + 5;
    const bool inside = xi - 2 >= 0 && yi - 2 >= 0 && xi + w + 3 <= W &&
                        yi + h + 3 <= H;
    for (int r = 0; r < wh; ++r) {
      const int sy = inside ? yi - 2 + r : clip3(0, H - 1, yi - 2 + r);
      const uint8_t* row = ref + sy * W;
      if (inside) {
        std::memcpy(win + r * ww, row + xi - 2, ww);
      } else {
        for (int c = 0; c < ww; ++c) {
          win[r * ww + c] = row[clip3(0, W - 1, xi - 2 + c)];
        }
      }
    }
    auto G = [&](int r, int c) -> int { return win[(r + 2) * ww + c + 2]; };
    if (!fx && !fy) {
      for (int r = 0; r < h; ++r) {
        std::memcpy(dst + r * ds, win + (r + 2) * ww + 2, w);
      }
      return;
    }
    auto tap = [](int a, int b, int c, int d, int e, int f) {
      return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
    };
    const int id = fx * 4 + fy;
    // j (the centre) is needed at (1|3, 2), (2, 1|2|3); the horizontal
    // sums b1 where fx is not 0 or j is needed, the vertical h1 where fy
    // is not 0 and fx is not 2
    const bool need_j = id == 6 || id == 9 || id == 10 || id == 11 || id == 14;
    const bool need_h = fx != 0;
    const bool need_v = fy != 0 && fx != 2;
    int hb[21][16];                   // b1 at rows -2..h+2, columns 0..w-1
    int vb[16][17];                   // h1 at rows 0..h-1, columns 0..w
    if (need_h || need_j) {
      const int r0 = need_j ? -2 : 0, r1 = need_j ? h + 2 : h;
      for (int r = r0; r <= r1; ++r) {
        const uint8_t* g = win + (r + 2) * ww;
        for (int c = 0; c < w; ++c) {
          hb[r + 2][c] = tap(g[c], g[c + 1], g[c + 2], g[c + 3], g[c + 4],
                             g[c + 5]);
        }
      }
    }
    if (need_v) {
      for (int r = 0; r < h; ++r) {
        const uint8_t* g = win + r * ww + 2;
        for (int c = 0; c <= w; ++c) {
          vb[r][c] = tap(g[c], g[ww + c], g[2 * ww + c], g[3 * ww + c],
                         g[4 * ww + c], g[5 * ww + c]);
        }
      }
    }
    auto avg = [](int a, int b) { return (a + b + 1) >> 1; };
    auto hp = [](int v) { return static_cast<int>(clip1((v + 16) >> 5)); };
    for (int r = 0; r < h; ++r) {
      uint8_t* d = dst + r * ds;
      for (int c = 0; c < w; ++c) {
        int j = 0;
        if (need_j) {
          j = clip1((tap(hb[r][c], hb[r + 1][c], hb[r + 2][c], hb[r + 3][c],
                         hb[r + 4][c], hb[r + 5][c]) + 512) >> 10);
        }
        int v;
        switch (id) {
          case 1: v = avg(G(r, c), hp(vb[r][c])); break;
          case 2: v = hp(vb[r][c]); break;
          case 3: v = avg(G(r + 1, c), hp(vb[r][c])); break;
          case 4: v = avg(G(r, c), hp(hb[r + 2][c])); break;
          case 5: v = avg(hp(hb[r + 2][c]), hp(vb[r][c])); break;
          case 6: v = avg(hp(vb[r][c]), j); break;
          case 7: v = avg(hp(vb[r][c]), hp(hb[r + 3][c])); break;
          case 8: v = hp(hb[r + 2][c]); break;
          case 9: v = avg(hp(hb[r + 2][c]), j); break;
          case 10: v = j; break;
          case 11: v = avg(j, hp(hb[r + 3][c])); break;
          case 12: v = avg(G(r, c + 1), hp(hb[r + 2][c])); break;
          case 13: v = avg(hp(hb[r + 2][c]), hp(vb[r][c + 1])); break;
          case 14: v = avg(j, hp(vb[r][c + 1])); break;
          default: v = avg(hp(vb[r][c + 1]), hp(hb[r + 3][c])); break;
        }
        d[c] = static_cast<uint8_t>(v);
      }
    }
  }

  // 8.4.2.2.2: eighth-sample chroma at (ex, ey) (eighth units, absolute)
  static void chroma_mc(const uint8_t* ref, int W, int H, int ex, int ey,
                        int w, int h, uint8_t* dst, int ds) {
    const int xi = ex >> 3, yi = ey >> 3, fx = ex & 7, fy = ey & 7;
    const int wa = (8 - fx) * (8 - fy), wb = fx * (8 - fy);
    const int wc = (8 - fx) * fy, wd = fx * fy;
    if (xi >= 0 && yi >= 0 && xi + w < W && yi + h < H) {
      for (int r = 0; r < h; ++r) {
        const uint8_t* a = ref + (yi + r) * W + xi;
        const uint8_t* c = a + W;
        uint8_t* d = dst + r * ds;
        for (int x = 0; x < w; ++x) {
          d[x] = static_cast<uint8_t>(
              (wa * a[x] + wb * a[x + 1] + wc * c[x] + wd * c[x + 1] + 32) >>
              6);
        }
      }
      return;
    }
    for (int r = 0; r < h; ++r) {
      const int y0 = clip3(0, H - 1, yi + r), y1 = clip3(0, H - 1, yi + r + 1);
      for (int c = 0; c < w; ++c) {
        const int x0 = clip3(0, W - 1, xi + c);
        const int x1 = clip3(0, W - 1, xi + c + 1);
        const int A = ref[y0 * W + x0], B = ref[y0 * W + x1];
        const int C = ref[y1 * W + x0], D = ref[y1 * W + x1];
        dst[r * ds + c] = static_cast<uint8_t>(
            ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B + (8 - fx) * fy * C +
             fx * fy * D + 32) >> 6);
      }
    }
  }

  // ---------------------------------------------------------- deblocking

  int bs(int pa, int pi, int qa, int qi, bool mb_edge) const {
    const MbInfo& p = mbs_[pa];
    const MbInfo& q = mbs_[qa];
    if (p.intra || q.intra) return mb_edge ? 4 : 3;
    if (p.nzdeb[pi] || q.nzdeb[qi]) return 2;
    const int p8 = ((pi >> 3) << 1) | ((pi & 3) >> 1);
    const int q8 = ((qi >> 3) << 1) | ((qi & 3) >> 1);
    if (p.refpic[p8] != q.refpic[q8]) return 1;
    if (std::abs(p.mv[pi][0] - q.mv[qi][0]) >= 4 ||
        std::abs(p.mv[pi][1] - q.mv[qi][1]) >= 4) {
      return 1;
    }
    return 0;
  }

  static void filter_edge(uint8_t* pix, int xs, int ls, int n, const int* bsv,
                          int bs_shift, int qpav, const SliceParams& sp,
                          bool chroma) {
    const int ia = clip3(0, 51, qpav + sp.alpha);
    const int ib = clip3(0, 51, qpav + sp.beta);
    const int alpha = kAlpha[ia], beta = kBeta[ib];
    for (int i = 0; i < n; ++i) {
      const int b = bsv[i >> bs_shift];
      if (!b) continue;
      uint8_t* s = pix + i * ls;
      const int p0 = s[-xs], p1 = s[-2 * xs], q0 = s[0], q1 = s[xs];
      if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta &&
            std::abs(q1 - q0) < beta)) {
        continue;
      }
      if (chroma) {
        if (b < 4) {
          const int tc = kTc0[ia][b - 1] + 1;
          const int d =
              clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
          s[-xs] = clip1(p0 + d);
          s[0] = clip1(q0 - d);
        } else {
          s[-xs] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
          s[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
        }
        continue;
      }
      const int p2 = s[-3 * xs], q2 = s[2 * xs];
      const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
      if (b < 4) {
        const int tc0 = kTc0[ia][b - 1];
        const int tc = tc0 + (ap < beta) + (aq < beta);
        const int d = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
        s[-xs] = clip1(p0 + d);
        s[0] = clip1(q0 - d);
        if (ap < beta) {
          s[-2 * xs] = static_cast<uint8_t>(
              p1 + clip3(-tc0, tc0,
                         (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
        }
        if (aq < beta) {
          s[xs] = static_cast<uint8_t>(
              q1 + clip3(-tc0, tc0,
                         (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
        }
      } else {
        const int p3 = s[-4 * xs], q3 = s[3 * xs];
        const bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
        if (ap < beta && strong) {
          s[-xs] = static_cast<uint8_t>(
              (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
          s[-2 * xs] = static_cast<uint8_t>((p2 + p1 + p0 + q0 + 2) >> 2);
          s[-3 * xs] = static_cast<uint8_t>(
              (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        } else {
          s[-xs] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
        }
        if (aq < beta && strong) {
          s[0] = static_cast<uint8_t>(
              (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
          s[xs] = static_cast<uint8_t>((p0 + q0 + q1 + q2 + 2) >> 2);
          s[2 * xs] = static_cast<uint8_t>(
              (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
        } else {
          s[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
        }
      }
    }
  }

  int cqp(int qp, int c) const {
    return kChromaQp[clip3(0, 51, qp + pp_->chroma_qp_offset[c])];
  }

  // 8.7, macroblock by macroblock. One departure, FFmpeg's: where both
  // chroma QP offsets are equal it takes h264_filter_mb_fast_internal,
  // which gives every luma edge of a 4x4 block boundary 8 apart (the MB's
  // left and top edges, its inner edges at 8) bS 2 in an inter MB with the
  // 8x8 transform whose 8x8 blocks 0, 1 and 2 are coded, without looking
  // at its coefficients: a CAVLC block coded with no coefficient counts.
  void deblock() {
    const int W = mb_w_ * 16, CW = mb_w_ * 8;
    const bool fast = pp_->chroma_qp_offset[0] == pp_->chroma_qp_offset[1];
    for (int a = 0; a < mb_w_ * mb_h_; ++a) {
      const MbInfo& q = mbs_[a];
      const SliceParams& sp = slices_[q.slice];
      if (sp.disable_deblock == 1) continue;
      const bool all2 = fast && !q.intra && q.t8x8 && (q.cbp & 7) == 7;
      const int mx = a % mb_w_, my = a / mb_w_;
      uint8_t* y = cur_->plane[0].data() + my * 16 * W + mx * 16;
      uint8_t* u = cur_->plane[1].data() + my * 8 * CW + mx * 8;
      uint8_t* v = cur_->plane[2].data() + my * 8 * CW + mx * 8;
      for (int dir = 0; dir < 2; ++dir) {       // vertical edges, horizontal
        int nbm = -1;
        if (dir == 0 && mx > 0) nbm = a - 1;
        if (dir == 1 && my > 0) nbm = a - mb_w_;
        if (nbm >= 0 && sp.disable_deblock == 2 &&
            mbs_[nbm].slice != q.slice) {
          nbm = -1;
        }
        for (int e = 0; e < 4; ++e) {
          if (e == 0 && nbm < 0) continue;
          if (e && q.t8x8 && (e & 1)) continue;
          const int pm = e == 0 ? nbm : a;
          int bsv[4];
          bool any = false;
          for (int k = 0; k < 4; ++k) {
            const int qi = dir == 0 ? k * 4 + e : e * 4 + k;
            const int pi = e == 0 ? (dir == 0 ? k * 4 + 3 : 12 + k)
                                  : (dir == 0 ? qi - 1 : qi - 4);
            bsv[k] = bs(pm, pi, a, qi, e == 0);
            if (all2 && !mbs_[pm].intra) bsv[k] = 2;
            any |= bsv[k] != 0;
          }
          if (!any) continue;
          const MbInfo& p = mbs_[pm];
          const int xs = dir == 0 ? 1 : W, ls = dir == 0 ? W : 1;
          uint8_t* edge = dir == 0 ? y + 4 * e : y + 4 * e * W;
          filter_edge(edge, xs, ls, 16, bsv, 2, (p.qp_deb + q.qp_deb + 1) >> 1,
                      sp, false);
          if (e & 1) continue;
          const int cxs = dir == 0 ? 1 : CW, cls = dir == 0 ? CW : 1;
          for (int c = 0; c < 2; ++c) {
            uint8_t* base = c == 0 ? u : v;
            uint8_t* ce = dir == 0 ? base + 2 * e : base + 2 * e * CW;
            const int qa = (cqp(p.qp_deb, c) + cqp(q.qp_deb, c) + 1) >> 1;
            filter_edge(ce, cxs, cls, 8, bsv, 1, qa, sp, true);
          }
        }
      }
    }
  }

  // ---------------------------------------------------------- state

  std::unique_ptr<Sps> sps_[32];
  int sps_tool_[32] = {};
  std::unique_ptr<Pps> pps_[256];
  int pps_tool_[256] = {};
  const Sps* sp_ = nullptr;
  const Pps* pp_ = nullptr;
  int nal_len_ = 0;
  int tool_ = kDecoded;
  // pictures
  std::vector<std::unique_ptr<Frame>> dpb_;
  Frame* cur_ = nullptr;
  Frame* out_ = nullptr;
  int next_id_ = 0;
  int mb_w_ = 0, mb_h_ = 0;
  int width_ = 0, height_ = 0, crop_x_ = 0, crop_y_ = 0;
  bool full_range_ = false;
  int matrix_ = 2;
  bool in_picture_ = false, started_ = false;
  SliceHeader pic_;
  int pic_poc_ = 0;
  std::vector<MbInfo> mbs_;
  std::vector<SliceParams> slices_;
  int decoded_mbs_ = 0;
  // POC / frame_num state (8.2.1)
  int prev_poc_msb_ = 0, prev_poc_lsb_ = 0, poc_msb_ = 0;
  int prev_frame_num_offset_ = 0, frame_num_offset_ = 0;
  int prev_frame_num_ = 0, prev_ref_frame_num_ = 0;
  int last_poc_ = 0;
  bool after_reset_ = false;
  int max_long_idx_ = -1;
  // the slice
  const SliceHeader* sh_ = nullptr;
  Cabac* cabac_ = nullptr;
  Frame* refs_[34] = {};
  int num_refs_ = 0;
  int qp_ = 26, last_dqp_ = 0, i16_mode_ = 0;
  int ls4_[6][6][16], ls8_[2][6][64];
  // the macroblock
  int mba_ = 0, mbx_ = 0, mby_ = 0;
  int nb_a_ = -1, nb_b_ = -1, nb_c_ = -1, nb_d_ = -1;
  bool ia_ = false, ib_ = false, ic_ = false, id_ = false;
  uint32_t decoded_mask_ = 0;
};

}  // namespace eth264
