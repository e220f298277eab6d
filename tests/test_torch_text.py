"""The port's label text (`utils/draw.text`, `draw.box_label`) against
cv2.putText(img, label, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1) and
cv2.rectangle, the calls of JAX's detect.py and Detections.render.

Tolerance: bit-equal canvases, on seeded backgrounds, for every printable
ASCII character, the COCO names with f"{conf:.2f}" in their detect.py
colours, every character of Rubik's cmap, a seeded sample of 1,000 of the
characters cv2 draws from its second built-in font (WenQuanYi Micro Hei:
CJK, Greek, Hangul, ...) alone and in runs, strings that mix both fonts
with new lines and characters neither maps, origins that cut the text at
all four edges, and the fixed cases of `tests/text_cases.py` (whose
recorded digests are cv2's).

    python tests/test_torch_text.py --sweep

draws every character WenQuanYi maps and Rubik does not, alone, with cv2
and the port, and prints how many differ."""

import gzip
import struct
import sys

import cv2
import numpy as np
import pytest

import text_cases
from efficientteacher_torch.utils import draw

ASCII = text_cases.ASCII


def _cv2(img, label, org, color):
    return cv2.putText(img, label, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                       color, 1)


def _rubik_cmap() -> list:
    """The code points of Rubik's (3, 1) format-4 cmap."""
    font = draw.FONT.read_bytes()
    tables = {font[12 + 16 * k:16 + 16 * k]: struct.unpack(
        ">I", font[20 + 16 * k:24 + 16 * k])[0]
        for k in range(struct.unpack(">H", font[4:6])[0])}
    cmap = tables[b"cmap"]
    for k in range(struct.unpack(">H", font[cmap + 2:cmap + 4])[0]):
        plat, enc, off = struct.unpack(">HHI", font[cmap + 4 + 8 * k:
                                                    cmap + 12 + 8 * k])
        if (plat, enc) == (3, 1):
            t = cmap + off
    segx2 = struct.unpack(">H", font[t + 6:t + 8])[0]
    ends = struct.unpack(f">{segx2 // 2}H", font[t + 14:t + 14 + segx2])
    starts = struct.unpack(f">{segx2 // 2}H",
                           font[t + 16 + segx2:t + 16 + 2 * segx2])
    deltas = struct.unpack(f">{segx2 // 2}h",
                           font[t + 16 + 2 * segx2:t + 16 + 3 * segx2])
    ranges_at = t + 16 + 3 * segx2
    out = []
    for s, (lo, hi, d) in enumerate(zip(starts, ends, deltas)):
        ro = struct.unpack(">H", font[ranges_at + 2 * s:ranges_at + 2 * s
                                      + 2])[0]
        for cp in range(lo, min(hi, 0xfffe) + 1):
            if ro:
                p = ranges_at + 2 * s + ro + 2 * (cp - lo)
                g = struct.unpack(">H", font[p:p + 2])[0]
                g = (g + d) & 0xffff if g else 0
            else:
                g = (cp + d) & 0xffff
            if g:
                out.append(cp)
    return out


def _wenquanyi_only() -> list:
    """The code points of WenQuanYi's format-12 cmap (the subtable cv2's
    stb_truetype reads) that Rubik does not map."""
    font = gzip.decompress(draw.FALLBACK.read_bytes())
    tables = {font[12 + 16 * k:16 + 16 * k]: struct.unpack(
        ">I", font[20 + 16 * k:24 + 16 * k])[0]
        for k in range(struct.unpack(">H", font[4:6])[0])}
    cmap = tables[b"cmap"]
    for k in range(struct.unpack(">H", font[cmap + 2:cmap + 4])[0]):
        plat, enc, off = struct.unpack(">HHI", font[cmap + 4 + 8 * k:
                                                    cmap + 12 + 8 * k])
        if (plat, enc) == (3, 10):
            t = cmap + off
    groups = struct.unpack(">I", font[t + 12:t + 16])[0]
    rubik = set(_rubik_cmap())
    out = []
    for g in range(groups):
        lo, hi, first = struct.unpack(">3I", font[t + 16 + 12 * g:
                                                  t + 28 + 12 * g])
        out += [cp for cp in range(lo, hi + 1)
                if first + cp - lo and cp not in rubik]
    return out


def test_cases_are_cv2s_digests_and_the_port_draws_them():
    assert text_cases.cv2_digests(cv2) == text_cases.DIGESTS
    assert text_cases.check_port(draw) == []


@pytest.mark.parametrize("seed", range(4))
def test_labels_bit_equal_to_cv2(seed):
    """Printable ASCII and COCO labels on seeded canvases of random sizes,
    at origins from past the left and top edges to past the right and
    bottom ones; text and box_label both."""
    rng = np.random.default_rng(seed)
    names = text_cases.coco_names()
    for k in range(150):
        h, w = (int(v) for v in rng.integers(1, 90, 2) * (1, 3))
        want = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = want.copy()
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(0, 80))
            color = draw.color_of(c)
            if k % 3 == 0:
                label = "".join(ASCII[int(i)] for i in
                                rng.integers(0, 95, int(rng.integers(1, 30))))
            else:
                label = f"{names[c]} {rng.random():.2f}"
            x, y = int(rng.integers(-40, w + 3)), int(rng.integers(-6, h + 14))
            if k % 2:
                xyxy = (x, y, x + int(rng.integers(0, 60)),
                        y + int(rng.integers(0, 40)))
                cv2.rectangle(want, xyxy[:2], xyxy[2:], color, 2)
                _cv2(want, label, (x, y - 4), color)
                draw.box_label(got, xyxy, label, color)
            else:
                _cv2(want, label, (x, y), color)
                draw.text(got, label, (x, y), color)
        np.testing.assert_array_equal(got, want)


def test_every_cmap_character_alone_and_in_runs():
    """Each of Rubik's 885 characters alone, then all of them in runs of
    17 (advances, overlaps and the varied outlines of composites)."""
    cps = _rubik_cmap()
    assert len(cps) == 885 and all(ord(c) in cps for c in ASCII)
    bg = np.full((64, 96, 3), 30, np.uint8)
    for cp in cps:
        want = _cv2(bg.copy(), chr(cp), (30, 40), (250, 200, 100))
        got = bg.copy()
        draw.text(got, chr(cp), (30, 40), (250, 200, 100))
        np.testing.assert_array_equal(got, want, err_msg=hex(cp))
    canvas = np.random.default_rng(0).integers(0, 256, (40, 420, 3),
                                               dtype=np.uint8)
    for i in range(0, len(cps), 17):
        run = "".join(chr(cp) for cp in cps[i:i + 17])
        want = _cv2(canvas.copy(), run, (-3, 26), (10, 240, 60))
        got = canvas.copy()
        draw.text(got, run, (-3, 26), (10, 240, 60))
        np.testing.assert_array_equal(got, want, err_msg=run)


@pytest.mark.parametrize("label, org", [
    ("person\n0.87", (5, 20)),            # a new line, one line down
    ("\nleading newline", (5, 20)),       # ignored before the pen moves
    ("a\n\nb", (5, 10)),
    ("emoji \U0001F600 tab\t\x01", (5, 20)),  # unmapped: drawn as '?'
    ("j from the right edge", (96, 20)),  # org.x >= width: nothing drawn
    ("j one in", (95, 20)),
])
def test_newlines_unmapped_and_right_edge_as_cv2(label, org):
    want = np.random.default_rng(1).integers(0, 256, (60, 96, 3),
                                             dtype=np.uint8)
    got = want.copy()
    _cv2(want, label, org, (0, 0, 255))
    draw.text(got, label, org, (0, 0, 255))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("char", ["人", "Ω", "γ"])
def test_wenquanyi_characters_are_drawn_as_question_marks(char):
    """Once F8's remainder (these were drawn as '?'); now cv2's drawing:
    the character comes from WenQuanYi Micro Hei, between two of Rubik's,
    and differs from the '?' that cv2 draws only for what no font maps."""
    bg = np.zeros((40, 60, 3), np.uint8)
    got = bg.copy()
    draw.text(got, f"a{char}b", (5, 25), (255, 255, 255))
    np.testing.assert_array_equal(
        got, _cv2(bg.copy(), f"a{char}b", (5, 25), (255, 255, 255)))
    assert not np.array_equal(
        got, _cv2(bg.copy(), "a?b", (5, 25), (255, 255, 255)))


def test_wenquanyi_sample_alone_and_in_runs():
    """1,000 seeded characters of WenQuanYi's that Rubik lacks, each alone,
    then in runs of 12 (its advances and the boxes of its outlines)."""
    cps = _wenquanyi_only()
    assert len(cps) > 20000
    rng = np.random.default_rng(19)
    sample = [cps[int(i)] for i in rng.choice(len(cps), 1000, replace=False)]
    bg = np.full((48, 64, 3), 30, np.uint8)
    for cp in sample:
        want = _cv2(bg.copy(), chr(cp), (20, 30), (250, 200, 100))
        got = bg.copy()
        draw.text(got, chr(cp), (20, 30), (250, 200, 100))
        np.testing.assert_array_equal(got, want, err_msg=hex(cp))
    canvas = rng.integers(0, 256, (40, 220, 3), dtype=np.uint8)
    for i in range(0, len(sample), 12):
        run = "".join(chr(cp) for cp in sample[i:i + 12])
        want = _cv2(canvas.copy(), run, (-5, 27), (10, 240, 60))
        got = canvas.copy()
        draw.text(got, run, (-5, 27), (10, 240, 60))
        np.testing.assert_array_equal(got, want, err_msg=run)


@pytest.mark.parametrize("seed", range(2))
def test_strings_mixing_both_fonts(seed):
    """Labels that mix Rubik's characters with WenQuanYi's, new lines and
    characters neither font maps (drawn as Rubik's '?'), at origins that
    cut them at every edge; box labels too."""
    rng = np.random.default_rng(100 + seed)
    cjk = _wenquanyi_only()
    pools = [ASCII, "".join(chr(c) for c in _rubik_cmap()[95:300]),
             "".join(chr(cjk[int(i)]) for i in rng.integers(0, len(cjk),
                                                            400)),
             "\n\U0010fffd\U0001f600\u0378"]
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(10, 80, 2) * (1, 4))
        want = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = want.copy()
        n = int(rng.integers(1, 16))
        label = "".join(pools[int(p)][int(rng.integers(0, len(pools[int(p)])))]
                        for p in rng.choice(4, n, p=[0.4, 0.15, 0.4, 0.05]))
        x, y = int(rng.integers(-40, w)), int(rng.integers(-8, h + 14))
        color = draw.color_of(int(rng.integers(0, 80)))
        if rng.random() < 0.5:
            xyxy = (x, y, x + int(rng.integers(0, 60)),
                    y + int(rng.integers(0, 40)))
            cv2.rectangle(want, xyxy[:2], xyxy[2:], color, 2)
            _cv2(want, label, (x, y - 4), color)
            draw.box_label(got, xyxy, label, color)
        else:
            _cv2(want, label, (x, y), color)
            draw.text(got, label, (x, y), color)
        np.testing.assert_array_equal(got, want, err_msg=repr(label))


def test_strided_canvas_view():
    """A view into a larger array (a crop, a channel-reversed canvas) is
    drawn into in place, as cv2 draws into a Mat header over it."""
    base = np.random.default_rng(2).integers(0, 256, (50, 120, 3),
                                             dtype=np.uint8)
    want = base.copy()
    sub = np.ascontiguousarray(want[10:40, 20:100])
    _cv2(sub, "bus 0.42", (3, 20), (12, 34, 56))
    want[10:40, 20:100] = sub
    got = base.copy()
    draw.text(got[10:40, 20:100], "bus 0.42", (3, 20), (12, 34, 56))
    np.testing.assert_array_equal(got, want)


def sweep() -> None:
    """Every character WenQuanYi maps and Rubik does not, alone, drawn by
    cv2 and by the port: prints the count and those that differ."""
    cps = _wenquanyi_only()
    bg = np.full((48, 64, 3), 30, np.uint8)
    bad = []
    for cp in cps:
        want = _cv2(bg.copy(), chr(cp), (20, 30), (250, 200, 100))
        got = bg.copy()
        draw.text(got, chr(cp), (20, 30), (250, 200, 100))
        if not np.array_equal(got, want):
            bad.append(hex(cp))
    print(f"{len(cps)} characters of WenQuanYi Micro Hei that Rubik does "
          f"not map; {len(bad)} differ from cv2.putText: {bad[:20]}")


if __name__ == "__main__" and "--sweep" in sys.argv:
    sweep()
