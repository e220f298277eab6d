// Label text as cv2 5.0.0's putText draws it: the port's counterpart of
// cv2.putText(img, label, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1), the
// call of JAX's detect.py and Detections.render. Included by
// loader_core.cpp, which exports `put_text`; utils/draw.py calls it.
//
// cv2 5.0 draws no Hershey strokes. Its putText maps a Hershey face onto a
// built-in TrueType font (`hersheyToTruetype`) and renders it with a
// modified stb_truetype. Each rule below was probed against cv2.putText on
// seeded canvases (tests/test_torch_text.py holds them) and, where the
// pixels left a choice, read off cv2's x86-64 code:
//   - face, size, weight: FONT_HERSHEY_SIMPLEX at scale 0.5, thickness 1
//     draws exactly what putText(FontFace("sans"), size 14, weight 400)
//     draws; "sans" is Rubik, a variable font (wght 300-900, default 300),
//     committed under assets/fonts. LINE_AA and LINE_8 draw the same.
//   - scale: size / hhea.ascender in float (14 / 935 px per unit); the
//     baseline is org.y and the first pen position org.x, both exact.
//   - weight: wght 400 normalises to F2.14 2731, which avar maps to 3072.
//     gvar is applied in integers: a tuple's scalar in 16.16 (axis by
//     axis, scalar * coord / peak truncated), each point delta scaled to
//     24.8 by (delta * scalar) >> 8 and summed, and the point moved by
//     sum >> 8 (floor). Points a sparse tuple leaves untouched get an
//     integer IUP of the raw deltas, truncated, with one quirk of cv2's: in
//     a contour whose first point is untouched, the points after the last
//     touched one take its delta instead of wrapping to the first. The
//     components of a composite that a tuple leaves untouched do not move.
//     HVAR is not read.
//   - outlines: stb's vertices (short coordinates, the implied on-curve
//     point of two off-curve points at (a + b) >> 1), components added at
//     their varied offsets.
//   - rasterising: stb_truetype 1.26's v2 scan-converter in float32 (edges
//     quick- then insertion-sorted by y0, signed area accumulated in
//     the order of the active list, |sum| * 255 + 0.5 truncated), curves
//     flattened to 0.35 px. Each glyph is rasterised alone into a bitmap
//     whose box is the floor/ceil of its varied points' extent, with a
//     margin m = max(ceil(w / 10), ceil(h / 10)) + 10 on every side: its
//     edges lie at x * scale + m, and its scanlines at the box's integer
//     origin. The margin and origin change float rounding, so they are
//     cv2's.
//   - advance: the hmtx advance plus the floored gvar deltas of the
//     advance phantom point less those of the origin phantom point, scaled
//     in float, rounded to 26.6 (half to even), then floored to whole
//     pixels; no kerning, no GPOS. '\n' moves the pen to org.x one line
//     (round((ascender - descender) * scale) px) down once the pen has
//     moved; a character Rubik does not map is drawn as '?'. (cv2 draws
//     CJK from a second built-in font, WenQuanYi Micro Hei, which the port
//     does not carry: ROADMAP F8.) Text whose org.x is at or past the
//     canvas's right edge is not drawn at all, even a glyph that reaches
//     back left of its pen.
//   - blending: each glyph in turn, its coverage a in 0-255, every channel
//     (b * (255 - a) + c * a + 127) / 255, clipped to the canvas.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace ettext {

// ---- font tables ----------------------------------------------------------

struct Font {
  const uint8_t* d = nullptr;
  size_t n = 0;
  uint32_t cmap = 0, loca = 0, glyf = 0, hmtx = 0, hhea = 0, head = 0,
           gvar = 0;
  uint32_t cmap_sub = 0;  // the Unicode subtable
  int loca_long = 0, num_hmetrics = 0, num_glyphs = 0;
  int ascent = 0, descent = 0;
};

inline uint32_t u8at(const Font& f, size_t o) { return o < f.n ? f.d[o] : 0; }
inline uint32_t u16at(const Font& f, size_t o) {
  return o + 2 <= f.n ? (uint32_t(f.d[o]) << 8) | f.d[o + 1] : 0;
}
inline int s16at(const Font& f, size_t o) {
  return static_cast<int16_t>(static_cast<uint16_t>(u16at(f, o)));
}
inline uint32_t u32at(const Font& f, size_t o) {
  return (u16at(f, o) << 16) | u16at(f, o + 2);
}

inline uint32_t find_table(const Font& f, const char* tag) {
  const uint32_t num = u16at(f, 4);
  for (uint32_t i = 0; i < num; ++i) {
    const size_t rec = 12 + 16 * size_t(i);
    if (rec + 16 <= f.n && std::memcmp(f.d + rec, tag, 4) == 0) {
      return u32at(f, rec + 8);
    }
  }
  return 0;
}

inline bool open_font(Font& f, const uint8_t* data, size_t n) {
  f = Font();
  f.d = data;
  f.n = n;
  f.cmap = find_table(f, "cmap");
  f.loca = find_table(f, "loca");
  f.glyf = find_table(f, "glyf");
  f.hmtx = find_table(f, "hmtx");
  f.hhea = find_table(f, "hhea");
  f.head = find_table(f, "head");
  f.gvar = find_table(f, "gvar");
  const uint32_t maxp = find_table(f, "maxp");
  if (!f.cmap || !f.loca || !f.glyf || !f.hmtx || !f.hhea || !f.head ||
      !maxp) {
    return false;
  }
  f.num_glyphs = static_cast<int>(u16at(f, maxp + 4));
  f.loca_long = s16at(f, f.head + 50);
  f.ascent = s16at(f, f.hhea + 4);
  f.descent = s16at(f, f.hhea + 6);
  f.num_hmetrics = static_cast<int>(u16at(f, f.hhea + 34));
  // the Unicode subtable stb picks: Microsoft (3) UCS-2 (1) or UCS-4 (10),
  // or Unicode (0)
  const uint32_t num = u16at(f, f.cmap + 2);
  for (uint32_t i = 0; i < num; ++i) {
    const size_t rec = f.cmap + 4 + 8 * size_t(i);
    const uint32_t plat = u16at(f, rec), enc = u16at(f, rec + 2);
    const uint32_t off = f.cmap + u32at(f, rec + 4);
    if ((plat == 3 && (enc == 1 || enc == 10)) || plat == 0) f.cmap_sub = off;
  }
  return f.cmap_sub != 0 && f.ascent > 0;
}

// stbtt_FindGlyphIndex for the subtables of cv2's fonts: format 4
// (Rubik's) and 12 (WenQuanYi's last Unicode one, which stb picks)
inline int glyph_index(const Font& f, uint32_t cp) {
  const size_t t = f.cmap_sub;
  if (u16at(f, t) == 12) {
    const uint32_t ngroups = u32at(f, t + 12);
    uint32_t lo = 0, hi = ngroups;
    while (lo < hi) {  // stb's binary search over the sorted groups
      const uint32_t mid = lo + ((hi - lo) >> 1);
      const size_t g = t + 16 + 12 * size_t(mid);
      const uint32_t start = u32at(f, g), end = u32at(f, g + 4);
      if (cp < start) {
        hi = mid;
      } else if (cp > end) {
        lo = mid + 1;
      } else {
        return static_cast<int>(u32at(f, g + 8) + cp - start);
      }
    }
    return 0;
  }
  if (u16at(f, t) != 4 || cp > 0xffff) return 0;
  const uint32_t segx2 = u16at(f, t + 6);
  const size_t ends = t + 14, starts = ends + segx2 + 2;
  const size_t deltas = starts + segx2, ranges = deltas + segx2;
  for (uint32_t s = 0; s < segx2; s += 2) {
    if (cp > u16at(f, ends + s)) continue;
    const uint32_t start = u16at(f, starts + s);
    if (cp < start) return 0;
    const uint32_t ro = u16at(f, ranges + s);
    if (ro == 0) return static_cast<int>((cp + u16at(f, deltas + s)) & 0xffff);
    const uint32_t g = u16at(f, ranges + s + ro + 2 * (cp - start));
    return g ? static_cast<int>((g + u16at(f, deltas + s)) & 0xffff) : 0;
  }
  return 0;
}

inline bool glyph_range(const Font& f, int g, uint32_t* off, uint32_t* len) {
  if (g < 0 || g >= f.num_glyphs) return false;
  uint32_t a, b;
  if (f.loca_long) {
    a = u32at(f, f.loca + 4 * size_t(g));
    b = u32at(f, f.loca + 4 * size_t(g) + 4);
  } else {
    a = 2 * u16at(f, f.loca + 2 * size_t(g));
    b = 2 * u16at(f, f.loca + 2 * size_t(g) + 2);
  }
  if (b <= a) return false;
  *off = f.glyf + a;
  *len = b - a;
  return true;
}

inline int advance_width(const Font& f, int g) {
  const int i = std::min(g, f.num_hmetrics - 1);
  return static_cast<int>(u16at(f, f.hmtx + 4 * size_t(i)));
}

inline int trunc_div(int64_t a, int64_t b) { return static_cast<int>(a / b); }

// FONT_HERSHEY_SIMPLEX at scale 0.5 and thickness 1: 14 px, and the wght
// axis at 400, normalised over Rubik's 300-900 to F2.14 2731, which its
// avar maps to 3072
constexpr int kSizePx = 14;
constexpr int kWght400 = 3072;

// ---- gvar -------------------------------------------------------------------

// One tuple's scalar in 16.16 at coordinate `coord` of a one-axis (wght)
// font, as cv2 forms it (0: the tuple does not apply).
inline int tuple_scalar(int coord, int peak, bool inter, int start,
                        int end) {
  int64_t s = 0x10000;
  if (peak == 0 || peak == coord) return static_cast<int>(s);
  if (coord == 0) return 0;
  if (inter) {
    if (coord < start || coord > end) return 0;
    if (coord < peak) return trunc_div(s * (coord - start), peak - start);
    return trunc_div(s * (end - coord), end - peak);
  }
  if (coord > 0 ? coord > peak : coord < peak) return 0;
  if (coord > 0 && peak < 0) return 0;
  return trunc_div(s * coord, peak);
}

struct Cursor {
  const Font* f;
  size_t p, end;
  uint32_t u8() { return p < end ? u8at(*f, p++) : (p++, 0); }
  int s8() { return static_cast<int8_t>(static_cast<uint8_t>(u8())); }
  uint32_t u16() {
    const uint32_t v = p + 2 <= end ? u16at(*f, p) : 0;
    p += 2;
    return v;
  }
  int s16() { return static_cast<int16_t>(static_cast<uint16_t>(u16())); }
};

// Packed point numbers; all = every point.
inline void read_points(Cursor& c, std::vector<int>* pts, bool* all) {
  uint32_t count = c.u8();
  if (count & 0x80) count = ((count & 0x7f) << 8) | c.u8();
  pts->clear();
  *all = count == 0;
  int last = 0;
  while (pts->size() < count && c.p < c.end) {
    const uint32_t ctrl = c.u8();
    const uint32_t run = (ctrl & 0x7f) + 1;
    for (uint32_t i = 0; i < run && pts->size() < count; ++i) {
      last += (ctrl & 0x80) ? static_cast<int>(c.u16()) : static_cast<int>(c.u8());
      pts->push_back(last);
    }
  }
}

inline void read_deltas(Cursor& c, size_t count, std::vector<int>* out) {
  out->clear();
  while (out->size() < count && c.p < c.end) {
    const uint32_t ctrl = c.u8();
    const uint32_t run = (ctrl & 0x3f) + 1;
    for (uint32_t i = 0; i < run && out->size() < count; ++i) {
      out->push_back((ctrl & 0x80) ? 0 : (ctrl & 0x40) ? c.s16() : c.s8());
    }
  }
  out->resize(count, 0);
}

constexpr int kUntouched = -32768;

// cv2's integer IUP of one tuple's raw deltas dx, dy (kUntouched where the
// tuple gives none) over the contours `ends` of the points xs, ys.
inline void infer_deltas(const std::vector<int>& ends, const int* xs,
                         const int* ys, int* dx, int* dy) {
  auto interp = [](int c, int p1, int p2, int d1, int d2) {
    if (p1 == p2) return d1 == d2 ? d1 : 0;
    if (p1 < p2) {
      if (c <= p1) return d1;
      if (c >= p2) return d2;
      return trunc_div(int64_t(c - p1) * (d2 - d1) + int64_t(d1) * (p2 - p1),
                       p2 - p1);
    }
    if (c <= p2) return d2;
    if (c >= p1) return d1;
    return trunc_div(int64_t(c - p2) * (d1 - d2) + int64_t(p1 - p2) * d2,
                     p1 - p2);
  };
  int start = 0;
  for (int end : ends) {
    if (end < start) continue;
    int first = -1, last = -1;
    for (int i = start; i <= end; ++i) {
      if (dx[i] != kUntouched) {
        if (first < 0) first = i;
        last = i;
      }
    }
    if (first < 0) {
      for (int i = start; i <= end; ++i) dx[i] = dy[i] = 0;
      start = end + 1;
      continue;
    }
    // past the last touched point cv2 wraps to the contour's first point,
    // or, when that point is untouched, to the last touched point itself
    const int wrap = dx[start] != kUntouched ? start : last;
    std::vector<char> touched(end - start + 1);
    for (int i = start; i <= end; ++i) touched[i - start] = dx[i] != kUntouched;
    int prev = last;
    for (int i = start; i <= end; ++i) {
      if (touched[i - start]) {
        prev = i;
        continue;
      }
      int next = -1;
      for (int j = i + 1; j <= end; ++j) {
        if (touched[j - start]) {
          next = j;
          break;
        }
      }
      if (next < 0) next = wrap;
      const int ix = interp(xs[i], xs[prev], xs[next], dx[prev], dx[next]);
      const int iy = interp(ys[i], ys[prev], ys[next], dy[prev], dy[next]);
      dx[i] = ix;
      dy[i] = iy;
    }
    start = end + 1;
  }
}

// The summed 24.8 deltas (ax, ay) of glyph g's npts points and its four
// phantom points at coordinate `coord`. `composite`: untouched points stay
// (no IUP); else xs, ys, ends feed the IUP.
inline void glyph_deltas(const Font& f, int g, int coord, int npts,
                         bool composite, const int* xs, const int* ys,
                         const std::vector<int>& ends, std::vector<int>* ax,
                         std::vector<int>* ay) {
  const int total = npts + 4;
  ax->assign(total, 0);
  ay->assign(total, 0);
  if (!f.gvar || coord == 0 || g >= f.num_glyphs) return;
  const uint32_t axis_count = u16at(f, f.gvar + 4);
  if (axis_count != 1) return;
  const uint32_t shared = f.gvar + u32at(f, f.gvar + 8);
  const uint32_t flags = u16at(f, f.gvar + 14);
  const uint32_t array = f.gvar + u32at(f, f.gvar + 16);
  uint32_t a, b;
  if (flags & 1) {
    a = u32at(f, f.gvar + 20 + 4 * size_t(g));
    b = u32at(f, f.gvar + 24 + 4 * size_t(g));
  } else {
    a = 2 * u16at(f, f.gvar + 20 + 2 * size_t(g));
    b = 2 * u16at(f, f.gvar + 22 + 2 * size_t(g));
  }
  if (b <= a) return;
  const size_t base = array + a, limit = array + b;
  Cursor hdr{&f, base, limit};
  const uint32_t count_word = hdr.u16();
  const uint32_t data_off = hdr.u16();
  Cursor data{&f, base + data_off, limit};
  std::vector<int> shared_pts, pts, dxs, dys;
  bool shared_all = false, all = false;
  if (count_word & 0x8000) read_points(data, &shared_pts, &shared_all);
  std::vector<int> rx(total), ry(total);
  for (uint32_t t = 0; t < (count_word & 0x0fff); ++t) {
    const uint32_t size = hdr.u16();
    const uint32_t index = hdr.u16();
    int peak, start = 0, end = 0;
    if (index & 0x8000) {
      peak = hdr.s16();
    } else {
      peak = s16at(f, shared + 2 * size_t(index & 0x0fff));
    }
    const bool inter = (index & 0x4000) != 0;
    if (inter) {
      start = hdr.s16();
      end = hdr.s16();
    }
    Cursor body{&f, data.p, std::min(limit, data.p + size)};
    data.p += size;
    const int s = tuple_scalar(coord, peak, inter, start, end);
    if (s == 0) continue;
    if (index & 0x2000) {
      read_points(body, &pts, &all);
    } else {
      pts = shared_pts;
      all = shared_all;
    }
    const size_t n = all ? size_t(total) : pts.size();
    read_deltas(body, n, &dxs);
    read_deltas(body, n, &dys);
    const int fill = composite ? 0 : kUntouched;
    std::fill(rx.begin(), rx.begin() + npts, fill);
    std::fill(ry.begin(), ry.begin() + npts, fill);
    std::fill(rx.begin() + npts, rx.end(), 0);
    std::fill(ry.begin() + npts, ry.end(), 0);
    for (size_t i = 0; i < n; ++i) {
      const int p = all ? static_cast<int>(i) : pts[i];
      if (p < 0 || p >= total) continue;
      rx[p] = dxs[i];
      ry[p] = dys[i];
    }
    if (!all && !composite) {
      infer_deltas(ends, xs, ys, rx.data(), ry.data());
    }
    for (int i = 0; i < total; ++i) {
      (*ax)[i] += static_cast<int>((int64_t(rx[i]) * s) >> 8);
      (*ay)[i] += static_cast<int>((int64_t(ry[i]) * s) >> 8);
    }
  }
}

// ---- outlines ---------------------------------------------------------------

enum { kMove = 1, kLine = 2, kCurve = 3 };

struct Vertex {
  int16_t x, y, cx, cy;
  uint8_t type;
};

struct Shape {
  std::vector<Vertex> v;
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;  // extent of the points
  bool has_points = false;
  int advance = 0;  // design units, varied
};

inline void extend(Shape* s, int x, int y) {
  if (!s->has_points) {
    s->x0 = s->x1 = x;
    s->y0 = s->y1 = y;
    s->has_points = true;
    return;
  }
  s->x0 = std::min(s->x0, x);
  s->x1 = std::max(s->x1, x);
  s->y0 = std::min(s->y0, y);
  s->y1 = std::max(s->y1, y);
}

inline Vertex vtx(uint8_t type, int x, int y, int cx, int cy) {
  return Vertex{static_cast<int16_t>(x), static_cast<int16_t>(y),
                static_cast<int16_t>(cx), static_cast<int16_t>(cy), type};
}

// stbtt__GetGlyphShapeTT's contour walk over points with on-curve flags.
inline void contours_to_vertices(const std::vector<int>& xs,
                                 const std::vector<int>& ys,
                                 const std::vector<uint8_t>& on,
                                 const std::vector<int>& ends,
                                 std::vector<Vertex>* out) {
  const int n = static_cast<int>(xs.size());
  int sx = 0, sy = 0, cx = 0, cy = 0, scx = 0, scy = 0;
  bool was_off = false, start_off = false;
  int next_move = 0, j = 0;
  auto close = [&] {
    if (start_off) {
      if (was_off) {
        out->push_back(vtx(kCurve, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy));
      }
      out->push_back(vtx(kCurve, sx, sy, scx, scy));
    } else {
      out->push_back(was_off ? vtx(kCurve, sx, sy, cx, cy)
                             : vtx(kLine, sx, sy, 0, 0));
    }
  };
  for (int i = 0; i < n; ++i) {
    const int x = xs[i], y = ys[i];
    if (next_move == i) {
      if (i != 0) close();
      start_off = !on[i];
      if (start_off) {
        scx = x;
        scy = y;
        if (i + 1 < n && !on[i + 1]) {
          sx = (x + xs[i + 1]) >> 1;
          sy = (y + ys[i + 1]) >> 1;
        } else if (i + 1 < n) {
          sx = xs[i + 1];
          sy = ys[i + 1];
          ++i;
        }
      } else {
        sx = x;
        sy = y;
      }
      out->push_back(vtx(kMove, sx, sy, 0, 0));
      was_off = false;
      next_move = 1 + (j < static_cast<int>(ends.size()) ? ends[j] : n);
      ++j;
    } else if (!on[i]) {
      if (was_off) {
        out->push_back(vtx(kCurve, (cx + x) >> 1, (cy + y) >> 1, cx, cy));
      }
      cx = x;
      cy = y;
      was_off = true;
    } else {
      out->push_back(was_off ? vtx(kCurve, x, y, cx, cy)
                             : vtx(kLine, x, y, 0, 0));
      was_off = false;
    }
  }
  if (n > 0) close();
}

// Glyph g at coordinate `coord`: its vertices, point extent and advance.
inline bool glyph_shape(const Font& f, int g, int coord, Shape* s,
                        int depth = 0) {
  s->v.clear();
  s->has_points = false;
  s->advance = advance_width(f, g);
  uint32_t off, len;
  std::vector<int> ax, ay, no_ends;
  if (!glyph_range(f, g, &off, &len)) {  // no outline (a space)
    glyph_deltas(f, g, coord, 0, false, nullptr, nullptr, no_ends, &ax, &ay);
    s->advance += (ax[1] >> 8) - (ax[0] >> 8);
    return true;
  }
  Cursor c{&f, off, off + len};
  const int contours = c.s16();
  c.p += 8;  // the header's bbox: cv2 takes the varied points' extent
  if (contours >= 0) {
    std::vector<int> ends(contours);
    for (int i = 0; i < contours; ++i) ends[i] = static_cast<int>(c.u16());
    const int n = contours ? ends.back() + 1 : 0;
    c.p += c.u16();  // instructions
    std::vector<uint8_t> flags;
    flags.reserve(n);
    while (static_cast<int>(flags.size()) < n && c.p < c.end) {
      const uint8_t fl = static_cast<uint8_t>(c.u8());
      flags.push_back(fl);
      if (fl & 8) {
        for (uint32_t r = c.u8(); r > 0 && static_cast<int>(flags.size()) < n; --r) {
          flags.push_back(fl);
        }
      }
    }
    flags.resize(n, 0);
    std::vector<int> xs(n), ys(n);
    int v = 0;
    for (int i = 0; i < n; ++i) {
      const uint8_t fl = flags[i];
      if (fl & 2) {
        const int d = static_cast<int>(c.u8());
        v += (fl & 16) ? d : -d;
      } else if (!(fl & 16)) {
        v += c.s16();
      }
      xs[i] = v;
    }
    v = 0;
    for (int i = 0; i < n; ++i) {
      const uint8_t fl = flags[i];
      if (fl & 4) {
        const int d = static_cast<int>(c.u8());
        v += (fl & 32) ? d : -d;
      } else if (!(fl & 32)) {
        v += c.s16();
      }
      ys[i] = v;
    }
    glyph_deltas(f, g, coord, n, false, xs.data(), ys.data(), ends, &ax, &ay);
    std::vector<int> px(n), py(n);
    std::vector<uint8_t> on(n);
    for (int i = 0; i < n; ++i) {
      px[i] = xs[i] + (ax[i] >> 8);
      py[i] = ys[i] + (ay[i] >> 8);
      on[i] = flags[i] & 1;
      extend(s, px[i], py[i]);
    }
    s->advance += (ax[n + 1] >> 8) - (ax[n] >> 8);
    contours_to_vertices(px, py, on, ends, &s->v);
    return true;
  }
  if (depth > 8) return false;
  // composite: components at their (varied) offsets, through
  // stbtt_GetGlyphShape's matrix in float: a scaled component (WenQuanYi's
  // X_AND_Y_SCALE, F2.14) has its points x' = m * (a x + c y + e) with m
  // the scale's magnitude, as stb computes it, truncated to short
  struct Comp {
    int glyph, dx, dy;
    float a, b, c, d;
  };
  std::vector<Comp> comps;
  uint32_t more = 1;
  while (more && c.p < c.end) {
    const uint32_t flags = c.u16();
    Comp k{static_cast<int>(c.u16()), 0, 0, 1.0f, 0.0f, 0.0f, 1.0f};
    if (flags & 1) {
      k.dx = c.s16();
      k.dy = c.s16();
    } else {
      k.dx = c.s8();
      k.dy = c.s8();
    }
    if (!(flags & 2)) return false;  // point matching: stb asserts
    if (flags & 8) {
      k.a = k.d = static_cast<float>(c.s16()) / 16384.0f;
    } else if (flags & 0x40) {
      k.a = static_cast<float>(c.s16()) / 16384.0f;
      k.d = static_cast<float>(c.s16()) / 16384.0f;
    } else if (flags & 0x80) {
      k.a = static_cast<float>(c.s16()) / 16384.0f;
      k.b = static_cast<float>(c.s16()) / 16384.0f;
      k.c = static_cast<float>(c.s16()) / 16384.0f;
      k.d = static_cast<float>(c.s16()) / 16384.0f;
    }
    comps.push_back(k);
    more = flags & 0x20;
  }
  const int n = static_cast<int>(comps.size());
  glyph_deltas(f, g, coord, n, true, nullptr, nullptr, no_ends, &ax, &ay);
  s->advance += (ax[n + 1] >> 8) - (ax[n] >> 8);
  Shape part;
  for (int k = 0; k < n; ++k) {
    if (!glyph_shape(f, comps[k].glyph, coord, &part, depth + 1)) return false;
    const Comp& m = comps[k];
    const float e = static_cast<float>(m.dx + (ax[k] >> 8));
    const float ff = static_cast<float>(m.dy + (ay[k] >> 8));
    const float sm = std::sqrt(m.a * m.a + m.b * m.b);
    const float sn = std::sqrt(m.c * m.c + m.d * m.d);
    auto tx = [&](int x, int y) {
      return static_cast<int16_t>(sm * (m.a * static_cast<float>(x) +
                                        m.c * static_cast<float>(y) + e));
    };
    auto ty = [&](int x, int y) {
      return static_cast<int16_t>(sn * (m.b * static_cast<float>(x) +
                                        m.d * static_cast<float>(y) + ff));
    };
    for (Vertex q : part.v) {  // every point is a vertex or a control
      const int x = q.x, y = q.y;
      q.x = tx(x, y);
      q.y = ty(x, y);
      if (q.type == kCurve) {
        const int cx = q.cx, cy = q.cy;
        q.cx = tx(cx, cy);
        q.cy = ty(cx, cy);
        extend(s, q.cx, q.cy);
      }
      extend(s, q.x, q.y);
      s->v.push_back(q);
    }
  }
  return true;
}

// ---- stb_truetype 1.26's rasteriser ------------------------------------------

struct Pt {
  float x, y;
};
struct Edge {
  float x0, y0, x1, y1;
  int invert;
};
struct Active {
  int next;
  float fx, fdx, fdy, direction, sy, ey;
};

inline void tesselate(std::vector<Pt>* pts, float x0, float y0, float x1,
                      float y1, float x2, float y2, float flat2, int n) {
  const float mx = (x0 + 2 * x1 + x2) / 4, my = (y0 + 2 * y1 + y2) / 4;
  const float dx = (x0 + x2) / 2 - mx, dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flat2) {
    tesselate(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flat2,
              n + 1);
    tesselate(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flat2,
              n + 1);
  } else {
    pts->push_back({x2, y2});
  }
}

inline bool edge_less(const Edge& a, const Edge& b) { return a.y0 < b.y0; }

inline void sort_edges_quick(Edge* p, int n) {
  while (n > 12) {
    const int m = n >> 1;
    const bool c01 = edge_less(p[0], p[m]), c12 = edge_less(p[m], p[n - 1]);
    if (c01 != c12) {
      const bool c = edge_less(p[0], p[n - 1]);
      std::swap(p[(c == c12) ? 0 : n - 1], p[m]);
    }
    std::swap(p[0], p[m]);
    int i = 1, j = n - 1;
    for (;;) {
      while (edge_less(p[i], p[0])) ++i;
      while (edge_less(p[0], p[j])) --j;
      if (i >= j) break;
      std::swap(p[i], p[j]);
      ++i;
      --j;
    }
    if (j < n - i) {
      sort_edges_quick(p, j);
      p += i;
      n -= i;
    } else {
      sort_edges_quick(p + i, n - i);
      n = j;
    }
  }
}

inline void sort_edges(Edge* p, int n) {
  sort_edges_quick(p, n);
  for (int i = 1; i < n; ++i) {
    const Edge t = p[i];
    int j = i;
    while (j > 0 && edge_less(t, p[j - 1])) {
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

inline void clipped_edge(float* scanline, int x, const Active& e, float x0,
                         float y0, float x1, float y1) {
  if (y0 == y1) return;
  if (y0 > e.ey) return;
  if (y1 < e.sy) return;
  if (y0 < e.sy) {
    x0 += (x1 - x0) * (e.sy - y0) / (y1 - y0);
    y0 = e.sy;
  }
  if (y1 > e.ey) {
    x1 += (x1 - x0) * (e.ey - y1) / (y1 - y0);
    y1 = e.ey;
  }
  if (x0 <= x && x1 <= x) {
    scanline[x] += e.direction * (y1 - y0);
  } else if (x0 >= x + 1 && x1 >= x + 1) {
  } else {
    scanline[x] += e.direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
  }
}

inline float trapezoid(float h, float tx0, float tx1, float bx0, float bx1) {
  return ((tx1 - tx0) + (bx1 - bx0)) / 2.0f * h;
}

inline void fill_active(float* scanline, float* fill, int len,
                        const std::vector<Active>& pool, int head,
                        float y_top) {
  const float y_bottom = y_top + 1;
  for (int k = head; k >= 0; k = pool[k].next) {
    const Active& e = pool[k];
    if (e.fdx == 0) {
      const float x0 = e.fx;
      if (x0 < len) {
        if (x0 >= 0) {
          clipped_edge(scanline, static_cast<int>(x0), e, x0, y_top, x0,
                       y_bottom);
          clipped_edge(fill - 1, static_cast<int>(x0) + 1, e, x0, y_top, x0,
                       y_bottom);
        } else {
          clipped_edge(fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
      continue;
    }
    float x0 = e.fx, dx = e.fdx, xb = x0 + dx, x_top, x_bottom, sy0, sy1;
    float dy = e.fdy;
    if (e.sy > y_top) {
      x_top = x0 + dx * (e.sy - y_top);
      sy0 = e.sy;
    } else {
      x_top = x0;
      sy0 = y_top;
    }
    if (e.ey < y_bottom) {
      x_bottom = x0 + dx * (e.ey - y_top);
      sy1 = e.ey;
    } else {
      x_bottom = xb;
      sy1 = y_bottom;
    }
    if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
      if (static_cast<int>(x_top) == static_cast<int>(x_bottom)) {
        const int x = static_cast<int>(x_top);
        const float height = (sy1 - sy0) * e.direction;
        scanline[x] += trapezoid(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
        fill[x] += height;
      } else {
        if (x_top > x_bottom) {
          sy0 = y_bottom - (sy0 - y_top);
          sy1 = y_bottom - (sy1 - y_top);
          std::swap(sy0, sy1);
          std::swap(x_bottom, x_top);
          dx = -dx;
          dy = -dy;
          std::swap(x0, xb);
        }
        const int x1 = static_cast<int>(x_top), x2 = static_cast<int>(x_bottom);
        float y_crossing = y_top + dy * (x1 + 1 - x0);
        float y_final = y_top + dy * (x2 - x0);
        if (y_crossing > y_bottom) y_crossing = y_bottom;
        const float sign = e.direction;
        float area = sign * (y_crossing - sy0);
        scanline[x1] += area * (x1 + 1 - x_top) / 2;
        if (y_final > y_bottom) {
          const int denom = x2 - (x1 + 1);
          y_final = y_bottom;
          if (denom != 0) dy = (y_final - y_crossing) / denom;
        }
        const float step = sign * dy * 1;
        for (int x = x1 + 1; x < x2; ++x) {
          scanline[x] += area + step / 2;
          area += step;
        }
        scanline[x2] += area + sign * trapezoid(sy1 - y_final, (float)x2,
                                                x2 + 1.0f, x_bottom, x2 + 1.0f);
        fill[x2] += sign * (sy1 - sy0);
      }
      continue;
    }
    // the edge leaves the bitmap's columns: stb's brute-force clipping
    for (int x = 0; x < len; ++x) {
      const float y0 = y_top, fx1 = static_cast<float>(x),
                  fx2 = static_cast<float>(x + 1), x3 = xb, y3 = y_bottom;
      const float y1 = (x - x0) / dx + y_top, y2 = (x + 1 - x0) / dx + y_top;
      if (x0 < fx1 && x3 > fx2) {
        clipped_edge(scanline, x, e, x0, y0, fx1, y1);
        clipped_edge(scanline, x, e, fx1, y1, fx2, y2);
        clipped_edge(scanline, x, e, fx2, y2, x3, y3);
      } else if (x3 < fx1 && x0 > fx2) {
        clipped_edge(scanline, x, e, x0, y0, fx2, y2);
        clipped_edge(scanline, x, e, fx2, y2, fx1, y1);
        clipped_edge(scanline, x, e, fx1, y1, x3, y3);
      } else if (x0 < fx1 && x3 > fx1) {
        clipped_edge(scanline, x, e, x0, y0, fx1, y1);
        clipped_edge(scanline, x, e, fx1, y1, x3, y3);
      } else if (x3 < fx1 && x0 > fx1) {
        clipped_edge(scanline, x, e, x0, y0, fx1, y1);
        clipped_edge(scanline, x, e, fx1, y1, x3, y3);
      } else if (x0 < fx2 && x3 > fx2) {
        clipped_edge(scanline, x, e, x0, y0, fx2, y2);
        clipped_edge(scanline, x, e, fx2, y2, x3, y3);
      } else if (x3 < fx2 && x0 > fx2) {
        clipped_edge(scanline, x, e, x0, y0, fx2, y2);
        clipped_edge(scanline, x, e, fx2, y2, x3, y3);
      } else {
        clipped_edge(scanline, x, e, x0, y0, x3, y3);
      }
    }
  }
}

// stbtt_Rasterize(0.35 px, invert) of `v` into out (w x h, packed), edges at
// p * scale + shift, bitmap origin (off_x, off_y).
inline void rasterize(const std::vector<Vertex>& v, float scale,
                      float shift_x, float shift_y, int off_x, int off_y,
                      int w, int h, uint8_t* out) {
  const float flat = 0.35f / scale;
  const float flat2 = flat * flat;
  std::vector<Pt> pts;
  std::vector<int> lens;
  int start = 0;
  float x = 0, y = 0;
  for (size_t i = 0; i < v.size(); ++i) {
    switch (v[i].type) {
      case kMove:
        if (!pts.empty() || !lens.empty()) {
          lens.push_back(static_cast<int>(pts.size()) - start);
        }
        start = static_cast<int>(pts.size());
        x = v[i].x;
        y = v[i].y;
        pts.push_back({x, y});
        break;
      case kLine:
        x = v[i].x;
        y = v[i].y;
        pts.push_back({x, y});
        break;
      default:
        tesselate(&pts, x, y, v[i].cx, v[i].cy, v[i].x, v[i].y, flat2, 0);
        x = v[i].x;
        y = v[i].y;
        break;
    }
  }
  if (v.empty()) return;
  lens.push_back(static_cast<int>(pts.size()) - start);
  std::vector<Edge> e(pts.size() + 1);
  int ne = 0, m = 0;
  const float y_scale_inv = -scale;
  for (int len : lens) {
    const Pt* p = pts.data() + m;
    m += len;
    for (int k = 0, j = len - 1; k < len; j = k++) {
      if (p[j].y == p[k].y) continue;
      int a = k, b = j;
      e[ne].invert = 0;
      if (p[j].y > p[k].y) {
        e[ne].invert = 1;
        a = j;
        b = k;
      }
      e[ne].x0 = p[a].x * scale + shift_x;
      e[ne].y0 = p[a].y * y_scale_inv + shift_y;
      e[ne].x1 = p[b].x * scale + shift_x;
      e[ne].y1 = p[b].y * y_scale_inv + shift_y;
      ++ne;
    }
  }
  sort_edges(e.data(), ne);
  std::vector<Active> pool;
  int head = -1;
  std::vector<float> buf(2 * size_t(w) + 1);
  float* scanline = buf.data();
  float* scanline2 = scanline + w;
  e[ne].y0 = static_cast<float>(off_y + h) + 1;
  const Edge* ep = e.data();
  for (int j = 0, yy = off_y; j < h; ++j, ++yy) {
    const float scan_y_top = yy + 0.0f, scan_y_bottom = yy + 1.0f;
    std::fill(scanline, scanline + w, 0.f);
    std::fill(scanline2, scanline2 + w + 1, 0.f);
    for (int *link = &head; *link >= 0;) {  // drop edges that ended
      if (pool[*link].ey <= scan_y_top) {
        *link = pool[*link].next;
      } else {
        link = &pool[*link].next;
      }
    }
    while (ep->y0 <= scan_y_bottom) {
      if (ep->y0 != ep->y1) {
        Active z;
        const float dxdy = (ep->x1 - ep->x0) / (ep->y1 - ep->y0);
        z.fdx = dxdy;
        z.fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
        z.fx = ep->x0 + dxdy * (scan_y_top - ep->y0);
        z.fx -= off_x;
        z.direction = ep->invert ? 1.0f : -1.0f;
        z.sy = ep->y0;
        z.ey = ep->y1;
        if (j == 0 && off_y != 0 && z.ey < scan_y_top) z.ey = scan_y_top;
        z.next = head;
        pool.push_back(z);
        head = static_cast<int>(pool.size()) - 1;
      }
      ++ep;
    }
    if (head >= 0) fill_active(scanline, scanline2 + 1, w, pool, head, scan_y_top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += scanline2[i];
      float k = scanline[i] + sum;
      k = std::fabs(k) * 255 + 0.5f;
      const int mm = static_cast<int>(k);
      out[size_t(j) * w + i] = static_cast<uint8_t>(mm > 255 ? 255 : mm);
    }
    for (int k = head; k >= 0; k = pool[k].next) pool[k].fx += pool[k].fdx;
  }
}

// ---- putText ----------------------------------------------------------------

inline int floor_i(float v) {
  const int t = static_cast<int>(v);
  return static_cast<float>(t) > v ? t - 1 : t;
}
inline int ceil_i(float v) {
  const int t = static_cast<int>(v);
  return static_cast<float>(t) < v ? t + 1 : t;
}

// Draw the code points cps[0..n) at org (baseline's left end) into img
// (h, w, 3), rows `stride` bytes apart, in `color` (one value per channel,
// in the canvas's order). A code point `f` does not map is drawn from
// `fallback` (may be null) where that maps it, else as f's '?'.
inline void put_text(const Font& f, const Font* fallback, uint8_t* img,
                     int h, int w, int stride, const uint32_t* cps, int n,
                     int org_x, int org_y, const int* color) {
  if (org_x >= w) return;  // cv2 draws nothing from the right edge on
  const int coord = kWght400;
  const int line = static_cast<int>(std::nearbyint(
      static_cast<float>(f.ascent - f.descent) *
      (static_cast<float>(kSizePx) / f.ascent)));
  const int question = glyph_index(f, '?');
  int pen = org_x, base = org_y;
  Shape s;
  std::vector<uint8_t> bmp;
  for (int i = 0; i < n; ++i) {
    if (cps[i] == '\n') {
      if (pen != org_x || base != org_y) {
        pen = org_x;
        base += line;
      }
      continue;
    }
    const Font* font = &f;
    int g = glyph_index(f, cps[i]);
    if (g == 0 && fallback) {
      const int fg = glyph_index(*fallback, cps[i]);
      if (fg) {
        font = fallback;
        g = fg;
      }
    }
    if (g == 0) g = question;
    const float scale = static_cast<float>(kSizePx) / font->ascent;
    if (!glyph_shape(*font, g, coord, &s)) continue;
    const float adv = static_cast<float>(s.advance) * scale;
    const int adv64 = static_cast<int>(std::nearbyint(adv * 64.0f));
    if (s.has_points && !s.v.empty()) {
      const int ix0 = floor_i(static_cast<float>(s.x0) * scale + 0.0f);
      const int iy0 = floor_i(static_cast<float>(-s.y1) * scale + 0.0f);
      const int ix1 = ceil_i(static_cast<float>(s.x1) * scale + 0.0f);
      const int iy1 = ceil_i(static_cast<float>(-s.y0) * scale + 0.0f);
      const int gw = ix1 - ix0, gh = iy1 - iy0;
      const int mg = std::max((gh + 9) / 10, (gw + 9) / 10) + 10;
      const int bw = gw + 2 * mg, bh = gh + 2 * mg;
      if (gw > 0 && gh > 0) {
        bmp.assign(size_t(bw) * bh, 0);
        rasterize(s.v, scale, static_cast<float>(mg) + 0.0f,
                  0.0f + static_cast<float>(mg), ix0, iy0, bw, bh,
                  bmp.data());
        const int top = base + iy0 - mg, left = pen + ix0 - mg;
        for (int r = std::max(0, -top); r < bh && top + r < h; ++r) {
          uint8_t* row = img + size_t(top + r) * stride;
          for (int q = std::max(0, -left); q < bw && left + q < w; ++q) {
            const int a = bmp[size_t(r) * bw + q];
            if (!a) continue;
            uint8_t* px = row + size_t(left + q) * 3;
            for (int k = 0; k < 3; ++k) {
              px[k] = static_cast<uint8_t>(
                  (px[k] * (255 - a) + color[k] * a + 127) / 255);
            }
          }
        }
      }
    }
    pen += adv64 >> 6;
  }
}

}  // namespace ettext
