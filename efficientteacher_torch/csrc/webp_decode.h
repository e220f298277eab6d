// WebP bitstreams for the host loader core: VP8L (lossless) and VP8 (lossy
// key frames, RFC 6386), each decoded as libwebp decodes it for
// cv2.imread (WebPDecodeBGRInto / WebPDecodeBGRAInto, and the first frame
// of WebPAnimDecoder), so that the RGB is bit-equal to cv2.imread's. The
// RIFF container, the demuxer's rules and the EXIF orientation are parsed
// in Python (data/webp_io.py); this header sees one bitstream:
//
//   decode_vp8l   header, the four transforms (predictor with its 14
//                 modes, cross-colour, subtract-green, colour indexing with
//                 pixel bundling), the colour cache, meta prefix codes,
//                 canonical codes (simple and code-length-coded), LZ77 with
//                 the 120-entry distance map
//   decode_vp8    the boolean decoder, frame header, segments, 1-8 token
//                 partitions, coefficient probability updates, the intra
//                 modes (16x16, 4x4, chroma), dequantisation, WHT / IDCT
//                 (libwebp's choice of transform per block, its SSE2 form
//                 of the full one),
//                 the simple and the normal loop filter, and libwebp's
//                 "fancy" chroma upsampling into RGB (upsampling.c,
//                 yuv.h: 14-bit MultHi, VP8Clip8)
//   decode_alpha  an ALPH chunk: raw or VP8L-coded. cv2 decodes it (it
//                 fails a file whose alpha fails) and drops it; the values
//                 are never used here, so its filter is not undone (that
//                 step cannot fail)
//
// The bit readers are libwebp's (vp8l: 64-bit window, end of stream when
// more bits are read than the stream holds, or 64 for a stream of fewer
// than 8 bytes; vp8: the boolean decoder's eof after the last byte), so a
// damaged stream fails where libwebp's does, and every read is bounded.
// Every routine writes into buffers the caller owns and keeps no state.

#pragma once

#include <algorithm>
#include <array>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace etwebp {

enum Status { kOk = 0, kCorrupt = -2 };

// RFC 6386 13.5: the default coefficient probabilities.
constexpr uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};
// RFC 6386 13.4: the probabilities of a coefficient probability update.
constexpr uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};
// RFC 6386 11.5: the 4x4 intra mode probabilities, [top][left], in the
// order of enum BMode.
constexpr uint8_t kBModesProba[10][10][9] = {
  {
    {231, 120, 48, 89, 115, 113, 120, 152, 112},
    {152, 179, 64, 126, 170, 118, 46, 70, 95},
    {175, 69, 143, 80, 85, 82, 72, 155, 103},
    {56, 58, 10, 171, 218, 189, 17, 13, 152},
    {114, 26, 17, 163, 44, 195, 21, 10, 173},
    {121, 24, 80, 195, 26, 62, 44, 64, 85},
    {144, 71, 10, 38, 171, 213, 144, 34, 26},
    {170, 46, 55, 19, 136, 160, 33, 206, 71},
    {63, 20, 8, 114, 114, 208, 12, 9, 226},
    {81, 40, 11, 96, 182, 84, 29, 16, 36},
  },
  {
    {134, 183, 89, 137, 98, 101, 106, 165, 148},
    {72, 187, 100, 130, 157, 111, 32, 75, 80},
    {66, 102, 167, 99, 74, 62, 40, 234, 128},
    {41, 53, 9, 178, 241, 141, 26, 8, 107},
    {74, 43, 26, 146, 73, 166, 49, 23, 157},
    {65, 38, 105, 160, 51, 52, 31, 115, 128},
    {104, 79, 12, 27, 217, 255, 87, 17, 7},
    {87, 68, 71, 44, 114, 51, 15, 186, 23},
    {47, 41, 14, 110, 182, 183, 21, 17, 194},
    {66, 45, 25, 102, 197, 189, 23, 18, 22},
  },
  {
    {88, 88, 147, 150, 42, 46, 45, 196, 205},
    {43, 97, 183, 117, 85, 38, 35, 179, 61},
    {39, 53, 200, 87, 26, 21, 43, 232, 171},
    {56, 34, 51, 104, 114, 102, 29, 93, 77},
    {39, 28, 85, 171, 58, 165, 90, 98, 64},
    {34, 22, 116, 206, 23, 34, 43, 166, 73},
    {107, 54, 32, 26, 51, 1, 81, 43, 31},
    {68, 25, 106, 22, 64, 171, 36, 225, 114},
    {34, 19, 21, 102, 132, 188, 16, 76, 124},
    {62, 18, 78, 95, 85, 57, 50, 48, 51},
  },
  {
    {193, 101, 35, 159, 215, 111, 89, 46, 111},
    {60, 148, 31, 172, 219, 228, 21, 18, 111},
    {112, 113, 77, 85, 179, 255, 38, 120, 114},
    {40, 42, 1, 196, 245, 209, 10, 25, 109},
    {88, 43, 29, 140, 166, 213, 37, 43, 154},
    {61, 63, 30, 155, 67, 45, 68, 1, 209},
    {100, 80, 8, 43, 154, 1, 51, 26, 71},
    {142, 78, 78, 16, 255, 128, 34, 197, 171},
    {41, 40, 5, 102, 211, 183, 4, 1, 221},
    {51, 50, 17, 168, 209, 192, 23, 25, 82},
  },
  {
    {138, 31, 36, 171, 27, 166, 38, 44, 229},
    {67, 87, 58, 169, 82, 115, 26, 59, 179},
    {63, 59, 90, 180, 59, 166, 93, 73, 154},
    {40, 40, 21, 116, 143, 209, 34, 39, 175},
    {47, 15, 16, 183, 34, 223, 49, 45, 183},
    {46, 17, 33, 183, 6, 98, 15, 32, 183},
    {57, 46, 22, 24, 128, 1, 54, 17, 37},
    {65, 32, 73, 115, 28, 128, 23, 128, 205},
    {40, 3, 9, 115, 51, 192, 18, 6, 223},
    {87, 37, 9, 115, 59, 77, 64, 21, 47},
  },
  {
    {104, 55, 44, 218, 9, 54, 53, 130, 226},
    {64, 90, 70, 205, 40, 41, 23, 26, 57},
    {54, 57, 112, 184, 5, 41, 38, 166, 213},
    {30, 34, 26, 133, 152, 116, 10, 32, 134},
    {39, 19, 53, 221, 26, 114, 32, 73, 255},
    {31, 9, 65, 234, 2, 15, 1, 118, 73},
    {75, 32, 12, 51, 192, 255, 160, 43, 51},
    {88, 31, 35, 67, 102, 85, 55, 186, 85},
    {56, 21, 23, 111, 59, 205, 45, 37, 192},
    {55, 38, 70, 124, 73, 102, 1, 34, 98},
  },
  {
    {125, 98, 42, 88, 104, 85, 117, 175, 82},
    {95, 84, 53, 89, 128, 100, 113, 101, 45},
    {75, 79, 123, 47, 51, 128, 81, 171, 1},
    {57, 17, 5, 71, 102, 57, 53, 41, 49},
    {38, 33, 13, 121, 57, 73, 26, 1, 85},
    {41, 10, 67, 138, 77, 110, 90, 47, 114},
    {115, 21, 2, 10, 102, 255, 166, 23, 6},
    {101, 29, 16, 10, 85, 128, 101, 196, 26},
    {57, 18, 10, 102, 102, 213, 34, 20, 43},
    {117, 20, 15, 36, 163, 128, 68, 1, 26},
  },
  {
    {102, 61, 71, 37, 34, 53, 31, 243, 192},
    {69, 60, 71, 38, 73, 119, 28, 222, 37},
    {68, 45, 128, 34, 1, 47, 11, 245, 171},
    {62, 17, 19, 70, 146, 85, 55, 62, 70},
    {37, 43, 37, 154, 100, 163, 85, 160, 1},
    {63, 9, 92, 136, 28, 64, 32, 201, 85},
    {75, 15, 9, 9, 64, 255, 184, 119, 16},
    {86, 6, 28, 5, 64, 255, 25, 248, 1},
    {56, 8, 17, 132, 137, 255, 55, 116, 128},
    {58, 15, 20, 82, 135, 57, 26, 121, 40},
  },
  {
    {164, 50, 31, 137, 154, 133, 25, 35, 218},
    {51, 103, 44, 131, 131, 123, 31, 6, 158},
    {86, 40, 64, 135, 148, 224, 45, 183, 128},
    {22, 26, 17, 131, 240, 154, 14, 1, 209},
    {45, 16, 21, 91, 64, 222, 7, 1, 197},
    {56, 21, 39, 155, 60, 138, 23, 102, 213},
    {83, 12, 13, 54, 192, 255, 68, 47, 28},
    {85, 26, 85, 85, 128, 128, 32, 146, 171},
    {18, 11, 7, 63, 144, 171, 4, 4, 246},
    {35, 27, 10, 146, 174, 171, 12, 26, 128},
  },
  {
    {190, 80, 35, 99, 180, 80, 126, 54, 45},
    {85, 126, 47, 87, 176, 51, 41, 20, 32},
    {101, 75, 128, 139, 118, 146, 116, 128, 85},
    {56, 41, 15, 176, 236, 85, 37, 9, 62},
    {71, 30, 17, 119, 118, 255, 17, 18, 138},
    {101, 38, 60, 138, 55, 70, 43, 26, 142},
    {146, 36, 19, 30, 171, 255, 97, 27, 20},
    {138, 45, 61, 62, 219, 1, 81, 188, 64},
    {32, 41, 20, 117, 151, 142, 20, 21, 163},
    {112, 19, 12, 61, 195, 128, 48, 4, 24},
  },
};
// RFC 6386 14.1: the dequantisation tables.
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// The VP8L distance map: (dy << 4) | (8 - dx) of the 120 short codes.
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// ---------------------------------------------------------------- VP8L

// libwebp's VP8LBitReader: bits LSB first through a 64-bit window.
class LBitReader {
 public:
  LBitReader(const uint8_t* p, size_t n) : buf_(p), len_(n) {
    const size_t k = std::min<size_t>(n, 8);
    for (size_t i = 0; i < k; ++i) val_ |= static_cast<uint64_t>(p[i]) << (8 * i);
    pos_ = k;
  }
  uint32_t prefetch() const {
    return static_cast<uint32_t>(val_ >> (bit_pos_ & 63));
  }
  bool end() const { return eos_ || (pos_ == len_ && bit_pos_ > 64); }
  void shift_bytes() {
    while (bit_pos_ >= 8 && pos_ < len_) {
      val_ >>= 8;
      val_ |= static_cast<uint64_t>(buf_[pos_]) << 56;
      ++pos_;
      bit_pos_ -= 8;
    }
    if (end()) set_eos();
  }
  uint32_t read(int n) {
    if (!eos_ && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos_ += n;
      shift_bytes();
      return v;
    }
    set_eos();
    return 0;
  }
  void fill() {
    if (bit_pos_ >= 32) shift_bytes();
  }
  void skip(int n) { bit_pos_ += n; }  // VP8LSetBitPos: no end check
  bool eos() const { return eos_; }
  void latch_end() { eos_ = end(); }

 private:
  void set_eos() {
    eos_ = true;
    bit_pos_ = 0;
  }
  const uint8_t* buf_;
  size_t len_, pos_ = 0;
  uint64_t val_ = 0;
  int bit_pos_ = 0;
  bool eos_ = false;
};

struct HCode {
  uint8_t bits;    // code length, or root + 2nd-level bits in a root entry
  uint16_t value;  // symbol, or the offset of a 2nd-level table
};

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;     // HUFFMAN_TABLE_BITS
constexpr int kLengthsBits = 7;  // LENGTHS_TABLE_BITS

inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: the two-level table of a canonical code,
// appended to `v`; returns the root's offset, or -1 for lengths that make
// no code (all zero, over-subscribed, or incomplete with more than one
// symbol). One symbol makes a code of 0 bits.
inline int build_table(std::vector<HCode>* v, int root_bits,
                       const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return -1;
    ++count[lengths[s]];
  }
  if (count[0] == n) return -1;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return -1;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
  }
  const int base = static_cast<int>(v->size());
  int total = 1 << root_bits;
  v->resize(base + total);
  if (offset[kMaxCodeLength] == 1) {
    replicate(v->data() + base, 1, total, HCode{0, sorted[0]});
    return base;
  }
  int step, len, symbol = 0;
  uint32_t low = 0xffffffffu, mask = total - 1, key = 0;
  int num_nodes = 1, num_open = 1;
  int table = base, table_bits = root_bits, table_size = 1 << table_bits;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return -1;
    for (; count[len] > 0; --count[len]) {
      replicate(v->data() + table + key, step, table_size,
                HCode{static_cast<uint8_t>(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength;
       ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return -1;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total += table_size;
        v->resize(base + total);
        low = key & mask;
        (*v)[base + low].bits = static_cast<uint8_t>(table_bits + root_bits);
        (*v)[base + low].value = static_cast<uint16_t>(table - base - low);
      }
      replicate(v->data() + table + (key >> root_bits), step, table_size,
                HCode{static_cast<uint8_t>(len - root_bits),
                      sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return -1;
  return base;
}

inline int read_symbol(const HCode* table, LBitReader* br) {
  uint32_t val = br->prefetch();
  table += val & ((1u << kRootBits) - 1);
  const int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br->skip(kRootBits);
    val = br->prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br->skip(table->bits);
  return table->value;
}

enum { kGreen = 0, kRed = 1, kBlue = 2, kAlpha = 3, kDist = 4 };
constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
constexpr int kAlphabet[5] = {kNumLiteral + kNumLength, kNumLiteral,
                              kNumLiteral, kNumLiteral, kNumDistance};
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

// One level's entropy code (libwebp's VP8LMetadata).
struct Codes {
  int cache_bits = 0;
  int huff_bits = 0;  // meta prefix codes' tile bits; 0: one group
  int huff_xsize = 0;
  std::vector<uint32_t> huff_image;  // group per tile
  std::vector<HCode> tables;
  std::vector<std::array<int, 5>> groups;  // root offsets of the 5 codes
  const HCode* tree(int group, int k) const {
    return tables.data() + groups[group][k];
  }
  int group_at(int x, int y) const {
    return huff_bits == 0 ? 0
                          : static_cast<int>(
                                huff_image[static_cast<size_t>(huff_xsize) *
                                               (y >> huff_bits) +
                                           (x >> huff_bits)]);
  }
};

enum TransformType { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2,
                     kColorIndexing = 3 };

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;  // tile data, or the expanded palette
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1,
                                          uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((c0 >> s) & 0xff) +
                  static_cast<int>((c1 >> s) & 0xff) -
                  static_cast<int>((c2 >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(v)) << s;
  }
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1,
                                          uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((ave >> s) & 0xff);
    const int b = static_cast<int>((c2 >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    d += sub3(static_cast<int>((a >> s) & 0xff),
              static_cast<int>((b >> s) & 0xff),
              static_cast<int>((c >> s) & 0xff));
  }
  return d <= 0 ? a : b;
}

// The predictor of mode m (0-15; 14 and 15 act as 0) for the pixel at p in
// an image `width` wide, from the pixels already put back.
inline uint32_t predict(int m, const uint32_t* p, int width) {
  const uint32_t L = p[-1];
  const uint32_t* T = p - width;
  switch (m) {
    case 1: return L;
    case 2: return T[0];
    case 3: return T[1];
    case 4: return T[-1];
    case 5: return average2(average2(L, T[1]), T[0]);
    case 6: return average2(L, T[-1]);
    case 7: return average2(L, T[0]);
    case 8: return average2(T[-1], T[0]);
    case 9: return average2(T[0], T[1]);
    case 10: return average2(average2(L, T[-1]), average2(T[0], T[1]));
    case 11: return select(T[0], L, T[-1]);
    case 12: return clamped_add_subtract_full(L, T[0], T[-1]);
    case 13: return clamped_add_subtract_half(L, T[0], T[-1]);
    default: return 0xff000000u;
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return (static_cast<int>(pred) * color) >> 5;
}

// The inverse of transform t on `img` (its xsize x ysize pixels, rows
// packed), in place but for colour indexing, which writes `out`.
inline void inverse_transform(const Transform& t, std::vector<uint32_t>* img,
                              int in_xsize) {
  const int w = t.xsize, h = t.ysize;
  uint32_t* px = img->data();
  switch (t.type) {
    case kPredictor: {
      px[0] = add_pixels(px[0], 0xff000000u);
      for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
      const int tiles = subsample(w, t.bits);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = px + static_cast<size_t>(y) * w;
        const uint32_t* modes = t.data.data() +
                                static_cast<size_t>(y >> t.bits) * tiles;
        row[0] = add_pixels(row[0], row[-w]);
        for (int x = 1; x < w; ++x) {
          const int m = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(m, row + x, w));
        }
      }
      break;
    }
    case kCrossColor: {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px + static_cast<size_t>(y) * w;
        const uint32_t* codes = t.data.data() +
                                static_cast<size_t>(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = static_cast<int8_t>(code & 0xff);
          const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
          const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int red = (argb >> 16) & 0xff;
          int blue = argb & 0xff;
          red = (red + color_delta(g2r, green)) & 0xff;
          blue += color_delta(g2b, green);
          blue = (blue + color_delta(r2b, static_cast<int8_t>(red))) & 0xff;
          row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
                   static_cast<uint32_t>(blue);
        }
      }
      break;
    }
    case kSubtractGreen: {
      const size_t n = static_cast<size_t>(w) * h;
      for (size_t i = 0; i < n; ++i) {
        const uint32_t g = (px[i] >> 8) & 0xff;
        const uint32_t rb = ((px[i] & 0x00ff00ffu) + ((g << 16) | g)) &
                            0x00ff00ffu;
        px[i] = (px[i] & 0xff00ff00u) | rb;
      }
      break;
    }
    case kColorIndexing: {
      std::vector<uint32_t> out(static_cast<size_t>(w) * h);
      const int bpp = 8 >> t.bits;
      const uint32_t bit_mask = (1u << bpp) - 1;
      const int count_mask = (1 << t.bits) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = px + static_cast<size_t>(y) * in_xsize;
        uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & bit_mask];
          packed >>= bpp;
        }
      }
      img->swap(out);
      break;
    }
  }
}

inline int copy_distance(int symbol, LBitReader* br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + static_cast<int>(br->read(extra)) + 1;
}

inline int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int c = kCodeToPlane[code - 1];
  const int dist = (c >> 4) * xsize + 8 - (c & 0xf);
  return dist >= 1 ? dist : 1;
}

class Vp8lDecoder {
 public:
  Vp8lDecoder(const uint8_t* data, size_t n) : br_(data, n) {}

  // ReadImageInfo: the 5-byte header of a VP8L bitstream.
  bool read_info(int* w, int* h) {
    if (br_.read(8) != 0x2f) return false;
    *w = static_cast<int>(br_.read(14)) + 1;
    *h = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha_is_used: a hint only
    if (br_.read(3) != 0) return false;
    return !br_.eos();
  }

  // The level-0 image of (w, h): transforms, colour cache, codes.
  bool read_level0(int w, int h) {
    xsize_ = w;
    int ysize = h;
    while (br_.read(1)) {
      if (!read_transform(&xsize_, &ysize)) return false;
    }
    return read_codes_header(xsize_, ysize, true, &codes_);
  }

  // The level-0 pixels into argb (w * h, the final image), transforms
  // undone; false for a damaged stream (libwebp's DecodeImageData: any read
  // past the end fails).
  bool decode_argb(int w, int h, std::vector<uint32_t>* argb) {
    argb->assign(static_cast<size_t>(xsize_) * h, 0);
    if (!decode_pixels(argb->data(), xsize_, h, codes_)) return false;
    int in_xsize = xsize_;
    for (int k = static_cast<int>(transforms_.size()) - 1; k >= 0; --k) {
      inverse_transform(transforms_[k], argb, in_xsize);
      in_xsize = transforms_[k].xsize;
    }
    return in_xsize == w && argb->size() == static_cast<size_t>(w) * h;
  }

  // An ALPH chunk's stream: libwebp takes the 8-bit route (which accepts a
  // last symbol that reads past the end) when the one transform is colour
  // indexing and every code but green's has one symbol.
  bool decode_alpha(int w, int h) {
    if (!read_level0(w, h)) return false;
    bool eight_bit = transforms_.size() == 1 &&
                     transforms_[0].type == kColorIndexing &&
                     codes_.cache_bits == 0;
    for (size_t g = 0; eight_bit && g < codes_.groups.size(); ++g) {
      for (int k : {kRed, kBlue, kAlpha}) {
        if (codes_.tree(static_cast<int>(g), k)->bits > 0) eight_bit = false;
      }
    }
    if (!eight_bit) {
      std::vector<uint32_t> argb;
      return decode_argb(w, h, &argb);
    }
    return decode_indices(xsize_, h);
  }

 private:
  bool read_transform(int* xsize, int* ysize) {
    const int type = static_cast<int>(br_.read(2));
    if (seen_ & (1u << type)) return false;  // each type once
    seen_ |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = *xsize;
    t.ysize = *ysize;
    if (type == kPredictor || type == kCrossColor) {
      t.bits = static_cast<int>(br_.read(3)) + 2;
      if (!decode_sub_image(subsample(t.xsize, t.bits),
                            subsample(t.ysize, t.bits), &t.data)) {
        return false;
      }
    } else if (type == kColorIndexing) {
      const int n = static_cast<int>(br_.read(8)) + 1;
      t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal;
      if (!decode_sub_image(n, 1, &pal)) return false;
      // ExpandColorMap: deltas summed byte-wise; entries past n are 0
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < n; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
    }
    transforms_.push_back(std::move(t));
    return true;
  }

  bool decode_sub_image(int xsize, int ysize, std::vector<uint32_t>* out) {
    Codes codes;
    if (!read_codes_header(xsize, ysize, false, &codes)) return false;
    out->assign(static_cast<size_t>(xsize) * ysize, 0);
    return decode_pixels(out->data(), xsize, ysize, codes) && !br_.eos();
  }

  // DecodeImageStream's colour cache and ReadHuffmanCodes.
  bool read_codes_header(int xsize, int ysize, bool level0, Codes* c) {
    if (br_.read(1)) {
      c->cache_bits = static_cast<int>(br_.read(4));
      if (c->cache_bits < 1 || c->cache_bits > 11) return false;
    }
    int max_groups = 1;
    if (level0 && br_.read(1)) {
      const int bits = 2 + static_cast<int>(br_.read(3));
      const int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
      if (!decode_sub_image(hx, hy, &c->huff_image)) return false;
      c->huff_bits = bits;
      c->huff_xsize = hx;
      for (uint32_t& p : c->huff_image) {
        p = (p >> 8) & 0xffff;
        max_groups = std::max(max_groups, static_cast<int>(p) + 1);
      }
    }
    if (br_.eos()) return false;
    // every group's five codes are read and checked; the ones no tile
    // uses are not kept (libwebp's mapping)
    std::vector<int> mapping(max_groups, -1);
    int used = 0;
    if (c->huff_bits == 0) {
      mapping[0] = used++;
    } else {
      for (uint32_t& p : c->huff_image) {
        if (mapping[p] < 0) mapping[p] = used++;
        p = static_cast<uint32_t>(mapping[p]);
      }
    }
    c->groups.assign(used, {0, 0, 0, 0, 0});
    const int cache_size = c->cache_bits ? 1 << c->cache_bits : 0;
    std::vector<int> lengths(kAlphabet[0] + cache_size);
    std::vector<HCode> scratch;
    for (int g = 0; g < max_groups; ++g) {
      for (int k = 0; k < 5; ++k) {
        const int n = kAlphabet[k] + (k == 0 ? cache_size : 0);
        std::vector<HCode>* into = mapping[g] < 0 ? &scratch : &c->tables;
        if (into == &scratch) scratch.clear();
        const int root = read_code(n, lengths.data(), into);
        if (root < 0) return false;
        if (mapping[g] >= 0) c->groups[mapping[g]][k] = root;
      }
    }
    return true;
  }

  // ReadHuffmanCode: one code of `n` symbols into `tables`.
  int read_code(int n, int* lengths, std::vector<HCode>* tables) {
    std::fill(lengths, lengths + n, 0);
    if (br_.read(1)) {  // simple code: 1 or 2 symbols, 1 or 8 bits each
      const int num = static_cast<int>(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      int symbol = static_cast<int>(br_.read(first_bits));
      if (symbol < n) lengths[symbol] = 1;
      if (num == 2) {
        symbol = static_cast<int>(br_.read(8));
        if (symbol < n) lengths[symbol] = 1;
      }
    } else {
      int cl_lengths[19] = {0};
      const int num = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < num; ++i) {
        cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br_.read(3));
      }
      if (!read_code_lengths(cl_lengths, n, lengths)) return -1;
    }
    if (br_.eos()) return -1;
    return build_table(tables, kRootBits, lengths, n);
  }

  bool read_code_lengths(const int* cl_lengths, int n, int* lengths) {
    std::vector<HCode> table;
    if (build_table(&table, kLengthsBits, cl_lengths, 19) < 0) return false;
    int max_symbol = n;
    if (br_.read(1)) {
      const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
      max_symbol = 2 + static_cast<int>(br_.read(nbits));
      if (max_symbol > n) return false;
    }
    int symbol = 0, prev = 8;
    while (symbol < n) {
      if (max_symbol-- == 0) break;
      br_.fill();
      const HCode& p = table[br_.prefetch() & ((1u << kLengthsBits) - 1)];
      br_.skip(p.bits);
      const int code = p.value;
      if (code < 16) {
        lengths[symbol++] = code;
        if (code != 0) prev = code;
      } else {
        static constexpr int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = code - 16;
        int repeat = static_cast<int>(br_.read(kExtra[slot])) + kOffset[slot];
        if (symbol + repeat > n) return false;
        const int len = code == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = len;
      }
    }
    return true;
  }

  // DecodeImageData: the entropy-coded ARGB pixels of an image `width`
  // wide (transforms not undone).
  bool decode_pixels(uint32_t* data, int width, int height, const Codes& c) {
    const int cache_size = c.cache_bits ? 1 << c.cache_bits : 0;
    std::vector<uint32_t> cache(cache_size, 0);
    const int shift = 32 - c.cache_bits;
    const int len_limit = kNumLiteral + kNumLength;
    const int cache_limit = len_limit + cache_size;
    const int64_t last = static_cast<int64_t>(width) * height;
    const int mask = c.huff_bits == 0 ? ~0 : (1 << c.huff_bits) - 1;
    int64_t src = 0, cached = 0;
    int col = 0, row = 0, g = 0;
    auto insert_upto = [&](int64_t end) {
      for (; cached < end; ++cached) {
        cache[(0x1e35a7bdu * data[cached]) >> shift] = data[cached];
      }
    };
    while (src < last) {
      if ((col & mask) == 0) g = c.group_at(col, row);
      br_.fill();
      const int code = read_symbol(c.tree(g, kGreen), &br_);
      if (br_.end()) break;
      if (code < kNumLiteral || (code >= len_limit && code < cache_limit)) {
        if (code < kNumLiteral) {
          const int red = read_symbol(c.tree(g, kRed), &br_);
          br_.fill();
          const int blue = read_symbol(c.tree(g, kBlue), &br_);
          const int alpha = read_symbol(c.tree(g, kAlpha), &br_);
          if (br_.end()) break;
          data[src] = (static_cast<uint32_t>(alpha) << 24) |
                      (static_cast<uint32_t>(red) << 16) |
                      (static_cast<uint32_t>(code) << 8) |
                      static_cast<uint32_t>(blue);
        } else {
          insert_upto(src);
          data[src] = cache[code - len_limit];
        }
        ++src;
        if (++col >= width) {
          col = 0;
          ++row;
          if (cache_size) insert_upto(src);
        }
      } else if (code < len_limit) {
        const int length = copy_distance(code - kNumLiteral, &br_);
        const int dist_symbol = read_symbol(c.tree(g, kDist), &br_);
        br_.fill();
        const int dist = plane_to_distance(width,
                                           copy_distance(dist_symbol, &br_));
        if (br_.end()) break;
        if (src < dist || last - src < length) return false;
        for (int i = 0; i < length; ++i) data[src + i] = data[src + i - dist];
        src += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (col & mask) g = c.group_at(col, row);
        if (cache_size) insert_upto(src);
      } else {
        return false;
      }
    }
    br_.latch_end();
    return !br_.eos();
  }

  // DecodeAlphaData: colour indices, one byte per pixel; a stream that
  // ends inside its last symbol still decodes.
  bool decode_indices(int width, int height) {
    const Codes& c = codes_;
    std::vector<uint8_t> data(static_cast<size_t>(width) * height);
    const int64_t end = static_cast<int64_t>(width) * height;
    const int len_limit = kNumLiteral + kNumLength;
    const int mask = c.huff_bits == 0 ? ~0 : (1 << c.huff_bits) - 1;
    int64_t pos = 0;
    int col = 0, row = 0, g = 0;
    while (!br_.eos() && pos < end) {
      if ((col & mask) == 0) g = c.group_at(col, row);
      br_.fill();
      const int code = read_symbol(c.tree(g, kGreen), &br_);
      if (code < kNumLiteral) {
        data[pos++] = static_cast<uint8_t>(code);
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < len_limit) {
        const int length = copy_distance(code - kNumLiteral, &br_);
        const int dist_symbol = read_symbol(c.tree(g, kDist), &br_);
        br_.fill();
        const int dist = plane_to_distance(width,
                                           copy_distance(dist_symbol, &br_));
        if (!(pos >= dist && end - pos >= length)) return false;
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (pos < end && (col & mask)) g = c.group_at(col, row);
      } else {
        return false;
      }
      br_.latch_end();
    }
    br_.latch_end();
    return !(br_.eos() && pos < end);
  }

  LBitReader br_;
  std::vector<Transform> transforms_;
  unsigned seen_ = 0;
  int xsize_ = 0;
  Codes codes_;
};

// A VP8L bitstream (n bytes: the chunk's payload and whatever follows it,
// as libwebp reads it) of size (w, h) -> rgb (h, w, 3).
inline int decode_vp8l(const uint8_t* data, size_t n, int w, int h,
                       uint8_t* rgb) {
  Vp8lDecoder dec(data, n);
  int iw, ih;
  if (!dec.read_info(&iw, &ih) || iw != w || ih != h) return kCorrupt;
  if (!dec.read_level0(w, h)) return kCorrupt;
  std::vector<uint32_t> argb;
  if (!dec.decode_argb(w, h, &argb)) return kCorrupt;
  const size_t npix = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < npix; ++i) {
    rgb[3 * i + 0] = static_cast<uint8_t>(argb[i] >> 16);
    rgb[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
    rgb[3 * i + 2] = static_cast<uint8_t>(argb[i]);
  }
  return kOk;
}

// An ALPH chunk's payload (n bytes) for an image of (w, h): whether
// libwebp's ALPHInit and ALPHDecode accept it.
inline bool decode_alpha(const uint8_t* data, size_t n, int w, int h) {
  if (n <= 1) return false;
  const int method = data[0] & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) return false;
  if (method == 0) return n - 1 >= static_cast<size_t>(w) * h;
  Vp8lDecoder dec(data + 1, n - 1);
  return dec.decode_alpha(w, h);
}

// ---------------------------------------------------------------- VP8

// libwebp's VP8BitReader (RFC 6386 7.3), a byte at a time: `bits` is the
// number of bits loaded beyond the 8 of the current window; past the last
// byte it reads zeros once and sets `eof`.
class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    range_ = 255 - 1;
    value_ = 0;
    bits_ = -8;
    eof = false;
    load();
  }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int b = value > split;
    if (b) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    int shift = 0;
    while ((range << shift) < 128) ++shift;  // 7 ^ BitsLog2Floor(range)
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  uint32_t value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = static_cast<int>(value(n));
    return bit(0x80) ? -v : v;
  }
  bool eof = false;

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof) {
      value_ <<= 8;
      bits_ += 8;
      eof = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint32_t range_ = 254;
  uint64_t value_ = 0;
  int bits_ = -8;
};

// libwebp's mode numbers (dec/common_dec.h)
enum BMode { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED,
             B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED, DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1,  4,  8, 5, 2,  3,  6,
                                 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                             153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int kWorkSize = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// ------------------------------------------------ transforms (dsp/dec.c)
//
// libwebp picks a transform per block from its non-zero coefficients
// (DoTransform): the full one, in its SSE2 form (16-bit lanes that wrap;
// equal to the C form while the values fit 16 bits, which a conforming
// stream's do), or for fewer coefficients the C forms TransformAC3 and
// TransformDC. The choice is kept, so that out-of-range coefficients (a
// damaged stream) give what cv2 gives too.

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int16_t w16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int16_t mulhi(int16_t a, int k) { return static_cast<int16_t>((a * k) >> 16); }

// Transform_SSE2: k1 = 20091, k2 = 35468 - 65536.
inline void transform_full(const int16_t* in, uint8_t* dst) {
  int16_t tmp[4][4];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i],
                  in3 = in[12 + i];
    const int16_t a = w16(in0 + in2), b = w16(in0 - in2);
    const int16_t c = w16(w16(in1 - in3) +
                          w16(mulhi(in1, -30068) - mulhi(in3, 20091)));
    const int16_t d = w16(w16(in1 + in3) +
                          w16(mulhi(in1, 20091) + mulhi(in3, -30068)));
    tmp[0][i] = w16(a + d);
    tmp[1][i] = w16(b + c);
    tmp[2][i] = w16(b - c);
    tmp[3][i] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {  // horizontal pass, one output row
    const int16_t t0 = tmp[r][0], t1 = tmp[r][1], t2 = tmp[r][2],
                  t3 = tmp[r][3];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3) +
                          w16(mulhi(t1, -30068) - mulhi(t3, 20091)));
    const int16_t d = w16(w16(t1 + t3) +
                          w16(mulhi(t1, 20091) + mulhi(t3, -30068)));
    const int16_t o[4] = {static_cast<int16_t>(w16(a + d) >> 3),
                          static_cast<int16_t>(w16(b + c) >> 3),
                          static_cast<int16_t>(w16(b - c) >> 3),
                          static_cast<int16_t>(w16(a - d) >> 3)};
    for (int x = 0; x < 4; ++x) {
      dst[r * BPS + x] = clip8(w16(dst[r * BPS + x] + o[x]));
    }
  }
}

// TransformAC3_C: only in[0], in[1] and in[4] are non-zero.
inline void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    uint8_t* row = dst + y * BPS;
    row[0] = clip8(row[0] + ((dcs[y] + d1) >> 3));
    row[1] = clip8(row[1] + ((dcs[y] + c1) >> 3));
    row[2] = clip8(row[2] + ((dcs[y] - c1) >> 3));
    row[3] = clip8(row[3] + ((dcs[y] - d1) >> 3));
  }
}

// TransformDC_C: only in[0] is non-zero.
inline void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      dst[y * BPS + x] = clip8(dst[y * BPS + x] + (dc >> 3));
    }
  }
}

// DoTransform: the top two bits of `bits` say which transform.
inline void do_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_full(in, dst); break;
    case 2: transform_ac3(in, dst); break;
    case 1: transform_dc(in, dst); break;
    default: break;
  }
}

// DoUVTransform: the four blocks of one chroma plane.
inline void do_uv_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa) {
      transform_full(in + n * 16, d);
    } else if (in[n * 16]) {
      transform_dc(in + n * 16, d);
    }
  }
}

inline void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ------------------------------------------------ intra prediction

inline uint8_t avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) {
  return static_cast<uint8_t>((a + b + 1) >> 1);
}

inline void fill_block(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

inline void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

// 16x16 luma and 8x8 chroma: DC (and its edge variants), TM, V, H.
inline void predict_block(int mode, uint8_t* dst, int size) {
  const int log = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case DC_PRED:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill_block(dst, (dc + size) >> (log + 1), size);
      break;
    case DC_NOTOP:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill_block(dst, (dc + size / 2) >> log, size);
      break;
    case DC_NOLEFT:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill_block(dst, (dc + size / 2) >> log, size);
      break;
    case DC_NOTOPLEFT:
      fill_block(dst, 0x80, size);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
inline void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE_PRED: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                            avg3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
      break;
    }
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = static_cast<uint8_t>(L);
      break;
  }
}
#undef DST

// ------------------------------------------------ loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// The simple filter across one edge of 16 pixels: `step` across it,
// `along` between its pixels.
inline void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along) {
    if (needs_filter(p, step, t2)) do_filter2(p, step);
  }
}

// The normal filter across an edge of `size` pixels: the macroblock
// edge's 6-tap filter (`mb`) or the inner edges' 4-tap one.
inline void normal_edge(uint8_t* p, int step, int along, int size,
                        int thresh, int ithresh, int hev_thresh, bool mb) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_thresh)) {
      do_filter2(p, step);
    } else if (mb) {
      do_filter6(p, step);
    } else {
      do_filter4(p, step);
    }
  }
}

// ------------------------------------------------ YUV -> RGB (yuv.h)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
  return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = static_cast<uint8_t>(
      yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = static_cast<uint8_t>(yuv_clip8(
      mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = static_cast<uint8_t>(
      yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// libwebp's UpsampleRgbLinePair (upsampling.c): the rows top_y and (when
// not null) bottom_y from the chroma rows top (above) and cur (below),
// `len` pixels -> RGB.
inline void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                          const uint8_t* top_u, const uint8_t* top_v,
                          const uint8_t* cur_u, const uint8_t* cur_v,
                          uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
             top_dst);
  if (bottom_y) {
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2,
               (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8;
    const int avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3;
    const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * 3);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
               top_dst + 2 * x * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1,
                 (d03_v + l_v) >> 1, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1,
                 bottom_dst + 2 * x * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2,
               (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
                 (3 * l_v + tl_v + 2) >> 2, bottom_dst + (len - 1) * 3);
    }
  }
}

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

class Vp8Decoder {
 public:
  // The key frame in data (n bytes) of size (w, h) -> rgb (h, w, 3).
  int decode(const uint8_t* data, size_t n, int w, int h, uint8_t* rgb) {
    if (!parse_headers(data, n, w, h)) return kCorrupt;
    if (!parse_frame()) return kCorrupt;
    filter_frame();
    emit_rgb(rgb);
    return kOk;
  }

 private:
  struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
    uint32_t non_zero_y, non_zero_uv;
  };
  struct Quant {
    int y1[2], y2[2], uv[2];
  };

  bool parse_headers(const uint8_t* buf, size_t size, int w, int h) {
    if (size < 10) return false;
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t part0 = bits >> 5;
    if (!key_frame || profile > 3 || !show) return false;
    buf += 3;
    size -= 3;
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return false;
    width_ = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height_ = ((buf[6] << 8) | buf[5]) & 0x3fff;
    if (width_ != w || height_ != h || !w || !h) return false;
    buf += 7;
    size -= 7;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    if (part0 > size) return false;
    br_.init(buf, part0);
    buf += part0;
    size -= part0;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type: libwebp always clamps
    // segment header
    use_segment_ = br_.value(1);
    if (use_segment_) {
      update_map_ = br_.value(1);
      if (br_.value(1)) {
        absolute_delta_ = br_.value(1);
        for (int s = 0; s < 4; ++s) {
          quantizer_[s] = br_.value(1) ? br_.signed_value(7) : 0;
        }
        for (int s = 0; s < 4; ++s) {
          filter_strength_[s] = br_.value(1) ? br_.signed_value(6) : 0;
        }
      }
      if (update_map_) {
        for (int s = 0; s < 3; ++s) {
          segment_proba_[s] = br_.value(1) ? br_.value(8) : 255;
        }
      }
    }
    if (br_.eof) return false;
    // filter header
    simple_ = br_.value(1);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      for (int i = 0; i < 4; ++i) {
        if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value(6);
      }
      for (int i = 0; i < 4; ++i) {
        if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value(6);
      }
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof) return false;
    // partitions: the last takes every byte left
    num_parts_ = 1 << br_.value(2);
    const size_t last = num_parts_ - 1;
    if (size < 3 * last) return false;
    const uint8_t* sz = buf;
    const uint8_t* part = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(part, psize);
      part += psize;
      left -= psize;
      sz += 3;
    }
    parts_[last].init(part, left);
    if (part >= buf + size) return false;
    parse_quant();
    br_.value(1);  // refresh_entropy_probs: ignored
    parse_proba();
    return true;
  }

  void parse_quant() {
    const int base_q0 = br_.value(7);
    const int dqy1_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.value(1) ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b) {
        for (int c = 0; c < 3; ++c) {
          for (int p = 0; p < 11; ++p) {
            proba_[t][b][c][p] = static_cast<uint8_t>(
                br_.bit(kCoeffsUpdateProba[t][b][c][p]) ? br_.value(8)
                                                         : kCoeffsProba0[t][b][c][p]);
          }
        }
      }
    }
    use_skip_proba_ = br_.value(1);
    if (use_skip_proba_) skip_p_ = br_.value(8);
  }

  void parse_intra_mode(int mb_x, MBData* block) {
    uint8_t* top = intra_t_.data() + 4 * mb_x;
    uint8_t* left = intra_l_;
    block->segment = 0;
    if (update_map_) {
      block->segment = !br_.bit(segment_proba_[0])
                           ? br_.bit(segment_proba_[1])
                           : br_.bit(segment_proba_[2]) + 2;
    }
    block->skip = use_skip_proba_ ? br_.bit(skip_p_) : 0;
    block->is_i4x4 = !br_.bit(145);
    if (!block->is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                     : (br_.bit(163) ? V_PRED : DC_PRED);
      block->imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block->imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          ymode = !br_.bit(prob[0])   ? B_DC_PRED
                  : !br_.bit(prob[1]) ? B_TM_PRED
                  : !br_.bit(prob[2]) ? B_VE_PRED
                  : !br_.bit(prob[3])
                      ? (!br_.bit(prob[4]) ? B_HE_PRED
                         : !br_.bit(prob[5]) ? B_RD_PRED : B_VR_PRED)
                      : (!br_.bit(prob[6]) ? B_LD_PRED
                         : !br_.bit(prob[7]) ? B_VL_PRED
                         : !br_.bit(prob[8]) ? B_HD_PRED : B_HU_PRED);
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    block->uvmode = !br_.bit(142)   ? DC_PRED
                    : !br_.bit(114) ? V_PRED
                    : br_.bit(183)  ? TM_PRED : H_PRED;
  }

  int large_value(BoolReader* br, const uint8_t* p) {
    int v;
    if (!br->bit(p[3])) {
      v = !br->bit(p[4]) ? 2 : 3 + br->bit(p[5]);
    } else if (!br->bit(p[6])) {
      if (!br->bit(p[7])) {
        v = 5 + br->bit(159);
      } else {
        v = 7 + 2 * br->bit(165);
        v += br->bit(145);
      }
    } else {
      const int bit1 = br->bit(p[8]);
      const int bit0 = br->bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) {
        v += v + br->bit(*tab);
      }
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: the tokens of one block of type t from position n; returns
  // the position after the last non-zero one (16 after a run of zeros).
  int get_coeffs(BoolReader* br, int t, int ctx, const int* dq, int n,
                 int16_t* out) {
    const uint8_t* p = proba_[t][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br->bit(p[0])) return n;
      while (!br->bit(p[1])) {
        p = proba_[t][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int nb = kBands[n + 1];
      if (!br->bit(p[2])) {
        v = 1;
        p = proba_[t][nb][1];
      } else {
        v = large_value(br, p);
        p = proba_[t][nb][2];
      }
      const int s = br->bit(0x80) ? -v : v;
      out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals: returns whether the block has no non-zero coefficient.
  bool parse_residuals(int mb_x, MBData* block, BoolReader* br) {
    const Quant& q = dqm_[block->segment];
    int16_t* dst = block->coeffs;
    uint8_t& mb_nz = nz_[mb_x];
    uint8_t& mb_nz_dc = nz_dc_[mb_x];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    std::memset(dst, 0, sizeof(block->coeffs));
    if (!block->is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc_;
      const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
      mb_nz_dc = left_nz_dc_ = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = mb_nz & 0x0f, lnz = left_nz_ & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = mb_nz >> (4 + ch);
      lnz = left_nz_ >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb_nz = static_cast<uint8_t>(out_t_nz);
    left_nz_ = static_cast<uint8_t>(out_l_nz);
    block->non_zero_y = non_zero_y;
    block->non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  void precompute_filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base_level = level_;
      if (use_segment_) {
        base_level = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = static_cast<uint8_t>(ilevel);
          info.limit = static_cast<uint8_t>(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = static_cast<uint8_t>(i4x4);
      }
    }
  }

  bool parse_frame() {
    ystride_ = mb_w_ * 16;
    uvstride_ = mb_w_ * 8;
    y_.assign(static_cast<size_t>(ystride_) * mb_h_ * 16, 0);
    u_.assign(static_cast<size_t>(uvstride_) * mb_h_ * 8, 0);
    v_.assign(static_cast<size_t>(uvstride_) * mb_h_ * 8, 0);
    intra_t_.assign(4 * mb_w_, B_DC_PRED);
    nz_.assign(mb_w_, 0);
    nz_dc_.assign(mb_w_, 0);
    top_y_.assign(16 * mb_w_, 0);
    top_u_.assign(8 * mb_w_, 0);
    top_v_.assign(8 * mb_w_, 0);
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo());
    precompute_filter_strengths();
    std::vector<MBData> row(mb_w_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      BoolReader* token_br = &parts_[mb_y & (num_parts_ - 1)];
      std::memset(intra_l_, B_DC_PRED, sizeof(intra_l_));
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        parse_intra_mode(mb_x, &row[mb_x]);
      }
      if (br_.eof) return false;
      left_nz_ = 0;
      left_nz_dc_ = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MBData* block = &row[mb_x];
        bool skip = use_skip_proba_ ? block->skip : false;
        if (!skip) {
          skip = parse_residuals(mb_x, block, token_br);
        } else {
          left_nz_ = nz_[mb_x] = 0;
          if (!block->is_i4x4) left_nz_dc_ = nz_dc_[mb_x] = 0;
          block->non_zero_y = block->non_zero_uv = 0;
          std::memset(block->coeffs, 0, sizeof(block->coeffs));
        }
        if (filter_type_ > 0) {
          FilterInfo f = fstrengths_[block->segment][block->is_i4x4];
          f.inner |= !skip;
          finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x] = f;
        }
        if (token_br->eof) return false;
      }
      reconstruct_row(mb_y, row.data());
    }
    return true;
  }

  // ReconstructRow: predictions from unfiltered neighbours in libwebp's
  // work buffer (left column 129, top row 127, top-left as libwebp sets
  // it), residuals added, then copied into the planes.
  void reconstruct_row(int mb_y, const MBData* blocks) {
    uint8_t* const y_dst = work_ + Y_OFF;
    uint8_t* const u_dst = work_ + U_OFF;
    uint8_t* const v_dst = work_ + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData& block = blocks[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) {
          std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        }
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* top_y = top_y_.data() + 16 * mb_x;
      uint8_t* top_u = top_u_.data() + 8 * mb_x;
      uint8_t* top_v = top_v_.data() + 8 * mb_x;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_y, 16);
        std::memcpy(u_dst - BPS, top_u, 8);
        std::memcpy(v_dst - BPS, top_v, 8);
      }
      const int16_t* coeffs = block.coeffs;
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) {
            std::memset(top_right, top_y[15], 4);
          } else {
            std::memcpy(top_right, top_y + 16, 4);
          }
        }
        for (int r = 1; r <= 3; ++r) {
          std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        }
        uint32_t bits = block.non_zero_y;
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        predict_block(check_mode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
        uint32_t bits = block.non_zero_y;
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          do_transform(bits, coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
      }
      const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
      predict_block(uvmode, u_dst, 8);
      predict_block(uvmode, v_dst, 8);
      do_uv_transform(block.non_zero_uv, coeffs + 256, u_dst);
      do_uv_transform(block.non_zero_uv >> 8, coeffs + 320, v_dst);
      if (mb_y < mb_h_ - 1) {
        std::memcpy(top_y, y_dst + 15 * BPS, 16);
        std::memcpy(top_u, u_dst + 7 * BPS, 8);
        std::memcpy(top_v, v_dst + 7 * BPS, 8);
      }
      uint8_t* yo = y_.data() + static_cast<size_t>(mb_y) * 16 * ystride_ + mb_x * 16;
      uint8_t* uo = u_.data() + static_cast<size_t>(mb_y) * 8 * uvstride_ + mb_x * 8;
      uint8_t* vo = v_.data() + static_cast<size_t>(mb_y) * 8 * uvstride_ + mb_x * 8;
      for (int j = 0; j < 16; ++j) std::memcpy(yo + j * ystride_, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(uo + j * uvstride_, u_dst + j * BPS, 8);
        std::memcpy(vo + j * uvstride_, v_dst + j * BPS, 8);
      }
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != B_DC_PRED) return mode;
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }

  // DoFilter over every macroblock in raster order, on the whole frame
  // (libwebp filters a row after reconstructing it from unfiltered
  // samples, which is the same).
  void filter_frame() {
    if (filter_type_ == 0) return;
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* y = y_.data() + static_cast<size_t>(mb_y) * 16 * ystride_ + mb_x * 16;
        const int ys = ystride_;
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
          }
          if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, limit);
          }
          continue;
        }
        const int us = uvstride_;
        uint8_t* u = u_.data() + static_cast<size_t>(mb_y) * 8 * us + mb_x * 8;
        uint8_t* v = v_.data() + static_cast<size_t>(mb_y) * 8 * us + mb_x * 8;
        const int il = f.ilevel, ht = f.hev_thresh;
        if (mb_x > 0) {
          normal_edge(y, 1, ys, 16, limit + 4, il, ht, true);
          normal_edge(u, 1, us, 8, limit + 4, il, ht, true);
          normal_edge(v, 1, us, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) {
            normal_edge(y + k, 1, ys, 16, limit, il, ht, false);
          }
          normal_edge(u + 4, 1, us, 8, limit, il, ht, false);
          normal_edge(v + 4, 1, us, 8, limit, il, ht, false);
        }
        if (mb_y > 0) {
          normal_edge(y, ys, 1, 16, limit + 4, il, ht, true);
          normal_edge(u, us, 1, 8, limit + 4, il, ht, true);
          normal_edge(v, us, 1, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) {
            normal_edge(y + k * ys, ys, 1, 16, limit, il, ht, false);
          }
          normal_edge(u + 4 * us, us, 1, 8, limit, il, ht, false);
          normal_edge(v + 4 * us, us, 1, 8, limit, il, ht, false);
        }
      }
    }
  }

  // EmitFancyRGB over the whole picture: row 0 alone, then pairs of rows
  // between chroma rows, and the last row alone when the height is even.
  void emit_rgb(uint8_t* rgb) {
    const int w = width_, h = height_;
    const size_t stride = static_cast<size_t>(w) * 3;
    auto yrow = [&](int y) { return y_.data() + static_cast<size_t>(y) * ystride_; };
    auto urow = [&](int y) { return u_.data() + static_cast<size_t>(y) * uvstride_; };
    auto vrow = [&](int y) { return v_.data() + static_cast<size_t>(y) * uvstride_; };
    upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgb,
                  nullptr, w);
    int y = 0;
    for (; y + 2 < h; y += 2) {
      const int k = y / 2;
      upsample_pair(yrow(y + 1), yrow(y + 2), urow(k), vrow(k), urow(k + 1),
                    vrow(k + 1), rgb + (y + 1) * stride, rgb + (y + 2) * stride,
                    w);
    }
    if (!(h & 1)) {
      const int k = (h - 1) / 2;
      upsample_pair(yrow(h - 1), nullptr, urow(k), vrow(k), urow(k), vrow(k),
                    rgb + (h - 1) * stride, nullptr, w);
    }
  }

  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_ = 1;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  int segment_proba_[3] = {255, 255, 255};
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  int filter_type_ = 0;
  Quant dqm_[4];
  uint8_t proba_[4][8][3][11];
  int use_skip_proba_ = 0, skip_p_ = 0;
  FilterInfo fstrengths_[4][2];
  std::vector<uint8_t> intra_t_, nz_, nz_dc_, top_y_, top_u_, top_v_;
  uint8_t intra_l_[4];
  uint8_t left_nz_ = 0, left_nz_dc_ = 0;
  std::vector<FilterInfo> finfo_;
  std::vector<uint8_t> y_, u_, v_;
  int ystride_ = 0, uvstride_ = 0;
  uint8_t work_[kWorkSize] = {0};
};

// A VP8 key frame (n bytes: the chunk's payload and whatever follows it)
// of size (w, h) -> rgb (h, w, 3); with an ALPH payload (`alpha`, may be
// null) that alpha must decode too.
inline int decode_vp8(const uint8_t* data, size_t n, int w, int h,
                      const uint8_t* alpha, size_t alpha_n, bool has_alpha,
                      uint8_t* rgb) {
  Vp8Decoder dec;
  if (dec.decode(data, n, w, h, rgb) != kOk) return kCorrupt;
  if (has_alpha && !decode_alpha(alpha, alpha_n, w, h)) return kCorrupt;
  return kOk;
}

}  // namespace etwebp
