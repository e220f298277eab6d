"""Damaged and rare JPEGs and damaged TIFF strips read as cv2.imread reads
them (`efficientteacher_torch/csrc/jpeg_decode.h`, `csrc/raster_decode.h`,
`data/tiff_io.py`; ROADMAP F11, F12, Q1.9c).

Tolerance: exact. Every file is decoded by the port and by cv2.imread at
IMREAD_COLOR and IMREAD_REDUCED_COLOR_2/4/8 (cv2 5.0.0: libjpeg-turbo
3.1.2, libtiff 4.7.1); a file cv2 returns None for raises OSError in the
port, and both packages' datasets drop it.

- Truncated files (an interrupted download): cv2's own baseline, grey,
  4:2:0, progressive and restart-interval files and the writers'
  arithmetic and lossless ones, cut at seeded points.
- Progressive files ended by EOI after some scans: block-smoothed.
- Arithmetic coding (SOF9, SOF10) with and without restarts and DAC
  conditioning; 8-bit lossless (SOF3), predictors 1-7, Pt 0 and 1.
- The kinds libjpeg refuses (12-bit, hierarchical, arithmetic lossless,
  lossless grey or YCbCr): OSError.
- TIFF strips whose LZW, Deflate or PackBits data fail part way.

The files come from `tests/jpeg_writers.py` (no encoder on the test
machines writes arithmetic, lossless, 12-bit or hierarchical JPEG) and
from cv2.imencode. `FIXTURES` hold a few of them with cv2's digests for
the card's machine (`check_fixtures`, called by chip_smoke.py);
`PYTHONPATH=. python tests/test_torch_jpeg_damaged.py` prints them anew
(needs cv2). This module imports no JAX and imports cv2 only inside the
tests that compare against it.
"""

import base64
import hashlib
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np
import pytest

import jpeg_writers as jw
from jpeg_writers import ycc
from efficientteacher_torch.data import datasets as port_ds
from efficientteacher_torch.data import image_io, loaders
from efficientteacher_torch.utils import native_loader as nl
from test_torch_image_formats import _packbits, tiff_file


def rgb_digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def smooth(rng, h, w, c=3):
    """A blurred random image (numpy only, for the card's machine too)."""
    x = rng.integers(0, 256, (h + 4, w + 4, c)).astype(np.float64)
    for axis in (0, 1):
        x = (np.roll(x, 1, axis) + 2 * x + np.roll(x, -1, axis)) / 4
    return x[2:-2, 2:-2].round().clip(0, 255).astype(np.uint8)


def _cv2():
    return pytest.importorskip("cv2")


def cv2_read(path, denom=1):
    cv2 = _cv2()
    flag = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
            4: cv2.IMREAD_REDUCED_COLOR_4,
            8: cv2.IMREAD_REDUCED_COLOR_8}[denom]
    if denom > 1:
        flag |= cv2.IMREAD_IGNORE_ORIENTATION
    img = cv2.imread(str(path), flag)
    return None if img is None else img[:, :, ::-1]


def port_read(path, denom=1):
    try:
        if image_io.suffix(str(path)) in image_io.JPEG_SUFFIXES:
            return nl.jpeg_decode(str(path), denom, orient=denom == 1)
        return image_io.imread(str(path))
    except OSError:
        return None


def assert_reads_as_cv2(path, denoms=(1, 2, 4, 8), what=""):
    """The port's read equals cv2.imread's at each scale, or both fail;
    returns whether cv2 read it."""
    for denom in denoms:
        want, got = cv2_read(path, denom), port_read(path, denom)
        assert (want is None) == (got is None), (what, denom, want is None)
        if want is not None:
            assert got.shape == want.shape, (what, denom)
            assert np.array_equal(got, want), (
                what, denom, int((got != want).any(2).sum()))
    return want is not None


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return path


# -- F12: files cut short ----------------------------------------------------

def _cv2_kinds():
    cv2 = _cv2()
    s, prog = cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_PROGRESSIVE
    rst = cv2.IMWRITE_JPEG_RST_INTERVAL
    return {  # name: (imencode params, grey)
        "baseline_444": ([s, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], False),
        "baseline_420": ([s, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420], False),
        "grey": ([], True),
        "progressive_420": ([prog, 1, s, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
                            False),
        "progressive_grey": ([prog, 1], True),
        "restart_420": ([rst, 2, s, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
                        False),
        "progressive_restart_422": (
            [prog, 1, rst, 3, s, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
            False),
    }


CV2_KINDS = ["baseline_444", "baseline_420", "grey", "progressive_420",
             "progressive_grey", "restart_420", "progressive_restart_422"]


def cv2_file(kind, rgb, quality=85):
    cv2 = _cv2()
    params, grey = _cv2_kinds()[kind]
    img = rgb[..., 0] if grey else rgb[..., ::-1]
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality]
                        + params)[1].tobytes()


@pytest.mark.parametrize("kind", CV2_KINDS)
def test_truncated_is_cv2_imread(kind, tmp_path):
    """cv2's own files cut at seeded points (inside a scan's data, a scan
    header, between scans): the MCU where the data end decodes on zero
    bits, the rest of the segment keeps zero (or its earlier scans')
    coefficients, progressive files are block-smoothed; the datasets build
    on them (image_size reads the headers)."""
    rng = np.random.default_rng(len(kind))
    for h, w in [(61, 83), (37, 29)]:
        data = cv2_file(kind, smooth(rng, h, w))
        for i, frac in enumerate(np.r_[rng.uniform(0.05, 0.99, 5), 0.999]):
            path = _write(tmp_path, f"{h}_{i}.jpg", jw.cut(data, frac))
            if assert_reads_as_cv2(path, what=f"{h}x{w} cut {frac:.3f}"):
                assert image_io.image_size(str(path)) == (w, h)


WRITER_KINDS = {
    "arith": dict(factors=[(2, 2), (1, 1), (1, 1)], arith=True),
    "arith_restart": dict(factors=[(2, 1), (1, 1), (1, 1)], arith=True,
                          restart=3),
    "arith_progressive": dict(factors=[(2, 2), (1, 1), (1, 1)],
                              script="progressive", arith=True),
    "arith_progressive_restart": dict(factors=[(1, 1)] * 3,
                                      script="progressive", arith=True,
                                      restart=2),
    "progressive_writer": dict(factors=[(2, 2), (1, 1), (1, 1)],
                               script="progressive", restart=5),
}


def writer_file(kind, rgb):
    if kind.startswith("lossless"):
        restart = 2 if kind.endswith("restart") else 0
        return jw.encode_lossless([rgb[..., c] for c in range(3)], 4, 1,
                                  restart_rows=restart)
    spec = dict(WRITER_KINDS[kind])
    return jw.encode(ycc(rgb), spec.pop("factors"), **spec)


@pytest.mark.parametrize("kind", sorted(WRITER_KINDS)
                         + ["lossless", "lossless_restart"])
def test_truncated_rare_kinds_are_cv2_imread(kind, tmp_path):
    """Arithmetic files cut short read zero data to the end of the scan
    (jdarith.c); lossless ones reset their predictor to the initial value
    on the rows after the cut (jdlhuff.c); progressive ones are smoothed."""
    rng = np.random.default_rng(len(kind) + 50)
    data = writer_file(kind, smooth(rng, 45, 61))
    assert assert_reads_as_cv2(_write(tmp_path, "whole.jpg", data))
    for i, frac in enumerate(rng.uniform(0.05, 0.99, 6)):
        assert_reads_as_cv2(_write(tmp_path, f"{i}.jpg", jw.cut(data, frac)),
                            what=f"cut {frac:.3f}")


# -- block smoothing of progressive files -------------------------------------

SCRIPTS = {  # (components, Ss, Se, Ah, Al) scans
    "dc_only": [((0, 1, 2), 0, 0, 0, 0)],
    "dc_point_transform": [((0, 1, 2), 0, 0, 0, 2)],
    "spectral_low": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 5, 0, 0),
                     ((1,), 1, 9, 0, 0), ((2,), 1, 2, 0, 0)],
    "approximation": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 63, 0, 2),
                      ((0,), 1, 63, 2, 1), ((1,), 1, 63, 0, 1),
                      ((2,), 1, 63, 0, 0), ((0, 1, 2), 0, 0, 1, 0)],
}


@pytest.mark.parametrize("kind", ["progressive_420", "progressive_grey",
                                  "progressive_restart_422"])
def test_partial_progressive_is_smoothed(kind, tmp_path):
    """cv2's progressive files ended by EOI after each of their scans:
    the coefficients the scans leave unrefined are estimated from the
    5x5 DC neighbourhood (jdcoefct.c decompress_smooth_data)."""
    rng = np.random.default_rng(len(kind) + 7)
    for h, w in [(40, 56), (27, 31), (9, 17)]:
        data = cv2_file(kind, smooth(rng, h, w))
        for k in range(1, len(jw.scan_offsets(data))):
            assert_reads_as_cv2(
                _write(tmp_path, f"{h}_{k}.jpg", jw.first_scans(data, k)),
                what=f"{h}x{w} first {k} scans")


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("arith", [False, True])
def test_progressive_scripts_are_smoothed(script, arith, tmp_path):
    """The writer's scan scripts that never refine some coefficients
    (DC alone, DC with a point transform, spectral selection, successive
    approximation), Huffman and arithmetic, whole and cut short."""
    rng = np.random.default_rng(len(script) + arith)
    for h, w, factors in [(33, 47, [(2, 2), (1, 1), (1, 1)]),
                          (24, 16, [(1, 1)] * 3)]:
        data = jw.encode(ycc(smooth(rng, h, w)), factors, SCRIPTS[script],
                         arith=arith)
        assert assert_reads_as_cv2(_write(tmp_path, f"{h}.jpg", data))
        assert_reads_as_cv2(_write(tmp_path, f"{h}c.jpg", jw.cut(data, 0.6)))


# -- arithmetic coding -----------------------------------------------------

ARITH = {
    "sequential_420": dict(factors=[(2, 2), (1, 1), (1, 1)]),
    "sequential_444_restart": dict(factors=[(1, 1)] * 3, restart=1),
    "sequential_411": dict(factors=[(4, 1), (1, 1), (1, 1)], restart=2),
    "sequential_dac": dict(factors=[(2, 2), (1, 1), (1, 1)],
                           dac=([1, 3], [5, 9], [2, 20])),
    "progressive_420": dict(factors=[(2, 2), (1, 1), (1, 1)],
                            script="progressive"),
    "progressive_restart_dac": dict(factors=[(2, 1), (1, 1), (1, 1)],
                                    script="progressive", restart=3,
                                    dac=([0, 2], [3, 2], [12, 1])),
    "rgb": dict(factors=[(1, 1)] * 3, adobe=0),
    "grey_progressive": dict(factors=[(1, 1)], script="progressive"),
}


@pytest.mark.parametrize("variant", sorted(ARITH))
def test_arithmetic_is_cv2_imread(variant, tmp_path):
    """SOF9 and SOF10 files of the writer's QM coder: decoded as cv2
    decodes them at every scale; cv2 decodes each as the same coefficients
    Huffman-coded (the writer's stream is a valid one)."""
    spec = dict(ARITH[variant])
    factors = spec.pop("factors")
    rng = np.random.default_rng(len(variant))
    for h, w in [(45, 61), (16, 8), (5, 3)]:
        rgb = smooth(rng, h, w)
        planes = ([rgb[..., c] for c in range(3)] if variant == "rgb" else
                  ycc(rgb)[:len(factors)])
        path = _write(tmp_path, f"{h}.jpg", jw.encode(
            planes, factors, arith=True, jfif=variant != "rgb", **spec))
        assert assert_reads_as_cv2(path)
        huffman = _write(tmp_path, f"{h}h.jpg", jw.encode(
            planes, factors, jfif=variant != "rgb", adobe=spec.get("adobe")))
        np.testing.assert_array_equal(cv2_read(path), cv2_read(huffman))


# -- 8-bit lossless ----------------------------------------------------------

@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_is_cv2_imread(psv, tmp_path):
    """SOF3 RGB files of predictors 1-7 with point transforms 0 and 1: the
    samples exactly (<< Pt), RGB unconverted, the full image at the
    reduced scales (libjpeg does not scale a lossless file)."""
    rng = np.random.default_rng(psv)
    for pt in (0, 1):
        for h, w in [(31, 45), (1, 7), (6, 1)]:
            rgb = smooth(rng, h, w)
            path = _write(tmp_path, f"{pt}_{h}.jpg", jw.encode_lossless(
                [rgb[..., c] for c in range(3)], psv, pt))
            assert assert_reads_as_cv2(path)
            np.testing.assert_array_equal(port_read(path, 4),
                                          rgb >> pt << pt)
            assert image_io.image_size(str(path)) == (w, h)


LOSSLESS = {
    "restart": dict(psv=7, restart_rows=3),
    "non_interleaved": dict(psv=5, interleave=False),
    "subsampled": dict(psv=1, factors=[(2, 2), (1, 1), (1, 1)]),
    "rgb_ids": dict(psv=4, ids=[82, 71, 66]),
    "adobe_0": dict(psv=6, adobe=0),
    "cmyk": dict(psv=2, adobe=0, planes=4),
    "six_bit": dict(psv=3, precision=6),
    "four_bit_pt": dict(psv=1, precision=4, pt=2),
    "two_bit": dict(psv=7, precision=2),
}


@pytest.mark.parametrize("layout", sorted(LOSSLESS))
def test_lossless_layouts_are_cv2_imread(layout, tmp_path):
    spec = dict(LOSSLESS[layout])
    planes_n = spec.pop("planes", 3)
    prec = spec.get("precision", 8)
    rng = np.random.default_rng(len(layout))
    rgb = smooth(rng, 26, 35, 4)
    planes = [rgb[..., c] >> (8 - prec) for c in range(planes_n)]
    path = _write(tmp_path, "a.jpg", jw.encode_lossless(planes, **spec))
    assert assert_reads_as_cv2(path)


# -- what libjpeg refuses: OSError, dropped by both packages ------------------

def refused_file(kind, rng):
    rgb = smooth(rng, 24, 40)
    if kind == "precision_12":
        return jw.encode([p.astype(np.int64) * 16 for p in ycc(rgb)],
                         [(2, 2), (1, 1), (1, 1)], precision=12)
    if kind == "precision_12_progressive":
        return jw.encode([p.astype(np.int64) * 16 for p in ycc(rgb)[:1]],
                         [(1, 1)], "progressive", precision=12)
    if kind == "hierarchical":
        return jw.encode_hierarchical(ycc(rgb)[0])
    if kind in ("sof13", "jpg_marker"):  # a baseline file's SOF0 changed
        marker = {"sof13": 0xCD, "jpg_marker": 0xC8}[kind]
        return jw.encode(ycc(rgb), [(1, 1)] * 3).replace(
            b"\xff\xc0", bytes([0xFF, marker]), 1)
    planes = [rgb[..., c] for c in range(3)]
    if kind == "arith_lossless":  # SOF11: libjpeg-turbo has no such decoder
        return jw.encode_lossless(planes).replace(b"\xff\xc3", b"\xff\xcb", 1)
    if kind == "lossless_grey":
        return jw.encode_lossless(planes[:1])
    if kind == "lossless_adobe_1":
        return jw.encode_lossless(planes, adobe=1)
    if kind == "lossless_jfif":
        return jw.encode_lossless(planes, jfif=True)
    if kind == "lossless_12_bit":
        return jw.encode_lossless([p.astype(np.int64) << 4 for p in planes],
                                  precision=12)
    raise KeyError(kind)


REFUSED = {"precision_12": "precision", "precision_12_progressive":
           "precision", "hierarchical": "hierarchical", "sof13":
           "hierarchical", "jpg_marker": "JPG marker", "arith_lossless":
           "SOF11", "lossless_grey": "lossless colour", "lossless_adobe_1":
           "lossless colour", "lossless_jfif": "lossless colour",
           "lossless_12_bit": "precision"}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_kinds_leave_both_datasets(kind, tmp_path):
    """cv2.imread returns None: the port raises OSError naming the kind
    from the headers, and both packages' verify_image_label, datasets and
    LoadImages drop the file (ROADMAP F10's route)."""
    jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
    path = _write(tmp_path, "bad.jpg", refused_file(kind, np.random.default_rng(
        len(kind))))
    assert cv2_read(path) is None
    for denom in (1, 2, 4, 8):
        assert cv2_read(path, denom) is None
        with pytest.raises(OSError, match=REFUSED[kind]):
            nl.jpeg_decode(str(path), denom)
    with pytest.raises(OSError, match=REFUSED[kind]):
        image_io.image_size(str(path))
    assert port_ds.verify_image_label(str(path), None, 8) is None
    assert jax_ds.verify_image_label(str(path), None, 8) is None
    good = tmp_path / "good.jpg"
    nl.jpeg_write(str(good), np.full((24, 40, 3), 90, np.uint8), 90)
    assert [p for p, *_ in loaders.LoadImages(str(tmp_path), 32)] == [
        str(good)]


# -- the prescale route ------------------------------------------------------

@pytest.mark.parametrize("kind", ["truncated", "partial", "arith",
                                  "lossless"])
def test_new_kinds_through_the_letterbox(kind, tmp_path):
    """The fused decode + letterbox with the IDCT prescale (Dataset.
    native_loader) equals cv2's reduced read + cv2.resize; a lossless file
    is decoded at full size before the resize, as libjpeg gives it."""
    cv2 = _cv2()
    rng = np.random.default_rng(len(kind))
    rgb = smooth(rng, 213, 321)
    data = {"truncated": lambda: jw.cut(cv2_file("baseline_420", rgb), 0.4),
            "partial": lambda: jw.first_scans(cv2_file("progressive_420",
                                                       rgb), 2),
            "arith": lambda: writer_file("arith_progressive", rgb),
            "lossless": lambda: writer_file("lossless", rgb)}[kind]()
    path = _write(tmp_path, "a.jpg", data)
    for new_w, new_h, denom in [(150, 99, 2), (80, 53, 4), (40, 26, 8)]:
        got = np.empty((new_h, new_w, 3), np.uint8)
        nl.jpeg_letterbox(str(path), got, 0, 0, new_w, new_h, pad_value=-1,
                          expect_wh=(321, 213), prescale=True)
        src = cv2_read(path, 1 if kind == "lossless" else denom)
        want = cv2.resize(np.ascontiguousarray(src), (new_w, new_h),
                          interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want, err_msg=str(denom))


# -- header damage ----------------------------------------------------------------

def _header_end(data: bytes) -> int:
    """The end of the first SOS header."""
    i = data.find(b"\xff\xda")
    return i + 2 + int.from_bytes(data[i + 2:i + 4], "big")


def header_damaged(rng, sources):
    """One of `sources` with its headers damaged: 1-3 bytes overwritten,
    1-7 bytes of garbage inserted, or cut, anywhere from the third byte
    (the end of cv2's signature) to the end of the first SOS header."""
    src = sources[int(rng.integers(0, len(sources)))]
    end = _header_end(src)
    b = bytearray(src)
    mode = int(rng.integers(0, 3))
    if mode == 0:
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(2, end))] = int(rng.integers(0, 256))
    elif mode == 1:
        at = int(rng.integers(2, end))
        b[at:at] = rng.integers(0, 256, int(rng.integers(1, 8)),
                                np.uint8).tobytes()
    else:
        b = b[:int(rng.integers(2, end + 1))]
    return bytes(b)


@pytest.mark.parametrize("seed", range(3))
def test_header_damage_is_cv2s(seed, tmp_path):
    """Seeded damage to the headers of cv2's baseline, progressive,
    restart-interval and 4:4:4 files: the port reads each as cv2.imread
    does, or fails where it fails. The cases that once differed: a broken
    third signature byte (cv2 finds no decoder), a quantisation table the
    segment cuts short (libjpeg-turbo reads it whole and fails on the
    length), a component twice in a scan, and a progressive file that
    lost a Huffman table (only the sequential decoder falls back on the
    standard ones)."""
    cv2 = _cv2()
    rng = np.random.default_rng(seed)
    sources = []
    for h, w in ((21, 35), (48, 64)):
        img = smooth(rng, h, w)[..., ::-1]
        for params in ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                       [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
                       [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]):
            sources.append(cv2.imencode(".jpg", img, params)[1].tobytes())
    for i in range(300):
        path = _write(tmp_path, f"{i}.jpg", header_damaged(rng, sources))
        assert_reads_as_cv2(path, (1, 2) if i % 4 else (1, 2, 4, 8), what=i)


# -- F11: TIFF strips whose data fail part way ----------------------------------

TIFF_CODECS = {"lzw": (5, 1), "lzw_predictor": (5, 2), "deflate": (8, 1),
               "deflate_predictor": (8, 2), "packbits": (32773, 1)}


def damaged_tiff(codec, rng, mode):
    """A 3-strip RGB TIFF whose strip k's data are cut short, have bytes
    flipped, or end in garbage."""
    compression, predictor = TIFF_CODECS[codec]
    h, w = 24, 16
    img = smooth(rng, h, w)
    raw = []
    for y in range(0, h, 8):
        v = img[y:y + 8].reshape(8, -1).astype(np.int64)
        if predictor == 2:
            v[:, 3:] = (v[:, 3:] - v[:, :-3]) & 255
        raw.append(v.astype(np.uint8).tobytes())
    encode = {5: nl.lzw_encode, 8: zlib.compress, 32773: _packbits}
    chunks = [encode[compression](r) for r in raw]
    k = int(rng.integers(0, 3))
    b = bytearray(chunks[k])
    if mode == 0:
        b = b[:int(rng.integers(1, len(b)))]
    elif mode == 1:
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
    else:
        b[int(rng.integers(0, len(b))):] = rng.integers(
            0, 256, 20, np.uint8).tobytes()
    chunks[k] = bytes(b)
    tags = [(317, 3, [2])] if predictor == 2 else []
    return tiff_file((h, w, 3), chunks, compression=compression,
                     rows_per_strip=8, tags=tags)


@pytest.mark.parametrize("codec", sorted(TIFF_CODECS))
def test_tiff_strip_failures_are_cv2s(codec, tmp_path):
    """TIFFReadRGBAStrip runs with stop_on_error 0: a strip is put as far
    as it decoded and zero after, with no predictor; the strips around it
    are whole."""
    rng = np.random.default_rng(len(codec))
    for i in range(24):
        path = _write(tmp_path, f"{i}.tif", damaged_tiff(codec, rng, i % 3))
        assert assert_reads_as_cv2(path, (1,), what=i)


def test_short_uncompressed_strip_is_zeros(tmp_path):
    """An uncompressed last strip with fewer bytes than its rows decodes
    nothing (tif_dumpmode.c): its rows are black, the image is kept."""
    rng = np.random.default_rng(1)
    img = smooth(rng, 24, 16)
    chunks = [img[y:y + 8].tobytes() for y in range(0, 24, 8)]
    chunks[2] = chunks[2][:100]
    path = _write(tmp_path, "a.tif", tiff_file(img.shape, chunks,
                                               rows_per_strip=8))
    assert assert_reads_as_cv2(path, (1,))
    got = image_io.imread(str(path))
    assert not got[16:].any() and np.array_equal(got[:16], img[:16])


def _with_counts(data: bytes, counts) -> bytes:
    """A little-endian one-IFD TIFF with its StripByteCounts replaced by
    `counts` (as many as it had), or, with `counts` None, retagged as a
    private tag libtiff ignores (the IFD keeps its size)."""
    import struct

    data = bytearray(data)
    ifd = struct.unpack("<I", data[4:8])[0]
    for e in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        o = ifd + 2 + 12 * e
        tag, _, n = struct.unpack("<HHI", data[o:o + 8])
        if tag != 279:
            continue
        if counts is None:
            data[o:o + 2] = struct.pack("<H", 65000)
        elif n == 1:
            data[o + 8:o + 12] = struct.pack("<I", counts[0])
        else:
            at = struct.unpack("<I", data[o + 8:o + 12])[0]
            data[at:at + 4 * n] = struct.pack(f"<{n}I", *counts)
    return bytes(data)


@pytest.mark.parametrize("rule", ["strips_0_1_differ", "one_strip_bad",
                                  "missing"])
def test_strip_byte_counts_as_libtiff_estimates(rule, tmp_path):
    """TIFFReadDirectory's EstimateStripByteCounts (F11's remainder):
    uncompressed contiguous strips whose counts 0 and 1 differ (three or
    more strips) are all rows * (h // strips) bytes long; a single strip
    whose count is 0, runs past the file or is short of its rows takes its
    rows' bytes (a compressed one of count 0: the file less its header and
    IFD); a missing StripByteCounts is estimated for one strip (one a
    plane) and refuses the file otherwise."""
    rng = np.random.default_rng(len(rule))
    from test_torch_image_formats import tiff_bytes

    for i in range(40):
        h, w = int(rng.integers(3, 40)), int(rng.integers(1, 30))
        spp = (1, 3)[i % 2]
        img = rng.integers(0, 256, (h, w, spp), dtype=np.uint8)
        comp = 1 if rule == "strips_0_1_differ" else (1, 5, 32773, 8)[i % 4]
        rows = h if rule == "one_strip_bad" else int(rng.integers(1, h))
        planar = 2 if rule == "missing" and i % 3 == 0 and spp == 3 else 1
        data = tiff_bytes(img, compression=comp, rows_per_strip=rows,
                          planar=planar, photometric=1 if spp == 1 else 2)
        tail = b"\0" * int(rng.integers(0, 2)) * 300
        n = -(-h // rows) * (spp if planar == 2 else 1)
        sizes = [rows * w * spp] * n
        if rule == "strips_0_1_differ" and n > 1:
            k = int(rng.integers(0, 2))
            sizes[k] = max(1, sizes[k] + int(rng.integers(-20, 40)))
        elif rule == "one_strip_bad":
            sizes = [(0, 10 ** 6, max(1, sizes[0] - 9))[i % 3]]
        path = _write(tmp_path, f"{i}.tif",
                      _with_counts(data, None if rule == "missing" else
                                   sizes) + tail)
        if cv2_read(path) is None:
            with pytest.raises(OSError):
                image_io.image_size(str(path))
        else:
            assert assert_reads_as_cv2(path, (1,), what=(rule, i))


def test_jpeg_in_tiff_of_the_new_kinds(tmp_path):
    """A JPEG-in-TIFF stream of a kind the core now reads (arithmetic,
    progressive, ended early, lossless RGB) reads as cv2 reads the file,
    whole or after JPEGTables; a 12-bit stream fails as the file does."""
    from test_torch_tiff_kinds import split_tables

    rng = np.random.default_rng(3)
    rgb = smooth(rng, 32, 48)
    sub = [(2, 2), (1, 1), (1, 1)]
    streams = {
        "arith": (jw.encode(ycc(rgb), sub, arith=True, jfif=False), 6),
        "arith_progressive": (jw.encode(ycc(rgb), sub, "progressive",
                                        arith=True, jfif=False), 6),
        "partial": (jw.first_scans(jw.encode(ycc(rgb), sub, "progressive",
                                             jfif=False), 3), 6),
        "cut": (jw.cut(jw.encode(ycc(rgb), sub, jfif=False), 0.6), 6),
        "lossless_rgb": (jw.encode_lossless([rgb[..., c] for c in range(3)]),
                         2),
        "precision_12": (jw.encode([p.astype(np.int64) * 16
                                    for p in ycc(rgb)], sub, precision=12,
                                   jfif=False), 6)}
    for name, (stream, photometric) in streams.items():
        for tables in (False, True):
            tags = [(530, 3, [2, 2])] if photometric == 6 else []
            if tables:
                shared, stream = split_tables(stream)
                tags.append((347, 7, list(shared)))
            path = _write(tmp_path, f"{name}{tables}.tif", tiff_file(
                rgb.shape, [stream], photometric=photometric, compression=7,
                tags=tags))
            assert assert_reads_as_cv2(path, (1,), what=name) == (
                name != "precision_12")


# -- a split against the JAX package -------------------------------------------

def write_mixed(root: Path) -> Path:
    """A split of the new kinds (chip_smoke.py's: `jpeg_writers.
    SPLIT_KINDS`, and a cut file of cv2's) and of kinds cv2 reads nothing
    of, each with a label file; returns its list file."""
    rng = np.random.default_rng(17)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    kinds = [(k, lambda r, k=k: jw.kind_file(k, r)) for k in jw.SPLIT_KINDS]
    kinds += [("cv2_truncated", lambda r: jw.cut(
        cv2_file("progressive_420", r), 0.4)),
        ("none_precision_12", lambda r: refused_file("precision_12", rng)),
        ("none_hierarchical", lambda r: refused_file("hierarchical", rng))]
    paths = []
    for i, (kind, make) in enumerate(kinds):
        path = root / "images" / f"{i:02d}_{kind}.jpg"
        path.write_bytes(make(smooth(rng, 40 + 3 * i, 64 - 2 * i)))
        n = int(rng.integers(1, 4))
        rows = np.column_stack([rng.integers(0, 8, n),
                                rng.uniform(0.3, 0.7, (n, 2)),
                                rng.uniform(0.1, 0.3, (n, 2))])
        (root / "labels" / f"{path.stem}.txt").write_text(
            "".join(f"{int(r[0])} {r[1]:.4f} {r[2]:.4f} {r[3]:.4f} "
                    f"{r[4]:.4f}\n" for r in rows))
        paths.append(path)
    lst = root / "list.txt"
    lst.write_text("".join(f"{p}\n" for p in paths))
    return lst


def test_mixed_split_equals_jax(tmp_path):
    """verify_image_label, LoadImagesAndLabels (items and load_image, both
    routes) and LoadImages of both packages on the split: the same files
    kept (what cv2 reads nothing of dropped), shapes, labels, letterboxed
    and decoded images, bit for bit."""
    jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
    jax_loaders = pytest.importorskip("efficientteacher_tpu.data.loaders")
    lst = write_mixed(tmp_path / "mixed")
    for f in lst.read_text().split():
        label = f.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt"
        got = port_ds.verify_image_label(f, label, 8)
        want = jax_ds.verify_image_label(f, label, 8)
        assert (got is None) == (want is None) == ("none_" in f), f
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            assert tuple(got[1]) == tuple(want[1]), f
    port = port_ds.LoadImagesAndLabels(str(lst), img_size=64, nc=8)
    ref = jax_ds.LoadImagesAndLabels(str(lst), img_size=64, nc=8)
    assert port.img_files == ref.img_files and len(port) == 7
    np.testing.assert_array_equal(port.shapes, ref.shapes)
    for i in range(len(port)):
        got, want = port[i], ref[i]
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        img, hw0, hw = port.load_image(i)
        img_j, hw0_j, hw_j = ref.load_image(i)
        np.testing.assert_array_equal(img, img_j[:, :, ::-1])
        assert (tuple(hw0), tuple(hw)) == (tuple(hw0_j), tuple(hw_j))
    folder = str(tmp_path / "mixed" / "images")
    got = list(loaders.LoadImages(folder, 64))
    want = list(jax_loaders.LoadImages(folder, 64))
    assert [g[0] for g in got] == [w[0] for w in want] == port.img_files
    for (p, rgb, img0, rp), (jp, jrgb, jimg0, jrp) in zip(got, want):
        assert rp == jrp
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(img0, jimg0)


# -- fixtures: cv2's digests for the card's machine ------------------------------

FIXTURE_KINDS = ("truncated_baseline", "truncated_restart",
                 "truncated_progressive", "partial_progressive",
                 "arith_sequential", "arith_progressive_restart",
                 "truncated_arith", "lossless_psv5_pt1", "lossless_restart",
                 "tiff_lzw_cut", "tiff_deflate_flipped",
                 "tiff_packbits_cut")


def fixture_bytes(name: str) -> bytes:
    """The file of fixture `name` (numpy and the port's writers only)."""
    rng = np.random.default_rng([len(name), 7])
    rgb = smooth(rng, 21, 35)
    sub = [(2, 2), (1, 1), (1, 1)]
    if name == "truncated_baseline":
        return jw.cut(jw.encode(ycc(rgb), sub), 0.55, in_data=True)
    if name == "truncated_restart":
        return jw.cut(jw.encode(ycc(rgb), [(2, 1), (1, 1), (1, 1)],
                                restart=1), 0.5, in_data=True)
    if name == "truncated_progressive":  # in the data of scan 6 of 10
        data = jw.encode(ycc(rgb), sub, "progressive")
        sos = jw.scan_offsets(data)
        return data[:(sos[5] + sos[6]) // 2]
    if name == "partial_progressive":
        return jw.first_scans(jw.encode(ycc(rgb), sub, "progressive"), 4)
    if name == "arith_sequential":
        return jw.encode(ycc(rgb), sub, arith=True, dac=([1, 0], [4, 2],
                                                         [3, 7]))
    if name == "arith_progressive_restart":
        return jw.encode(ycc(rgb), [(1, 1)] * 3, "progressive", arith=True,
                         restart=2)
    if name == "truncated_arith":
        return jw.cut(jw.encode(ycc(rgb), sub, "progressive", arith=True),
                      0.6, in_data=True)
    if name == "lossless_psv5_pt1":
        return jw.encode_lossless([rgb[..., c] for c in range(3)], 5, 1)
    if name == "lossless_restart":
        return jw.encode_lossless([rgb[..., c] for c in range(3)], 7,
                                  restart_rows=4)
    codec, mode = {"tiff_lzw_cut": ("lzw_predictor", 0),
                   "tiff_deflate_flipped": ("deflate", 1),
                   "tiff_packbits_cut": ("packbits", 0)}[name]
    return damaged_tiff(codec, rng, mode)


def _suffix(name):
    return ".tif" if name.startswith("tiff") else ".jpg"


def _scales(name):
    return (1,) if name.startswith("tiff") else (1, 2, 4, 8)


def write_fixtures(root) -> dict:
    """FIXTURES as files under `root`: {name: path}."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (b64, _) in FIXTURES.items():
        path = root / f"{name}{_suffix(name)}"
        path.write_bytes(base64.b64decode(b64))
        paths[name] = str(path)
    return paths


def check_fixtures(root) -> list:
    """Decode every fixture at each of its scales with the port; returns
    the mismatches against cv2's digests as (name, denom, shape, digest)."""
    bad = []
    for name, path in write_fixtures(root).items():
        for denom, (shape, digest) in FIXTURES[name][1].items():
            got = port_read(path, denom)
            if got is None or got.shape != shape or \
                    rgb_digest(got) != digest:
                bad.append((name, denom, None if got is None else got.shape,
                            None if got is None else rgb_digest(got)))
    return bad


def test_fixtures_are_the_listed_kinds():
    assert tuple(FIXTURES) == FIXTURE_KINDS


@pytest.mark.parametrize("name", FIXTURE_KINDS)
def test_fixtures_decode_to_cv2s_digests(name, tmp_path):
    path = write_fixtures(tmp_path)[name]
    assert Path(path).read_bytes() == fixture_bytes(name)
    for denom, (shape, digest) in FIXTURES[name][1].items():
        got = port_read(path, denom)
        assert (got.shape, rgb_digest(got)) == (shape, digest), denom
        want = cv2_read(path, denom)
        assert (want.shape, rgb_digest(want)) == (shape, digest), denom


def _print_fixtures():
    """The FIXTURES dict, with cv2's digests (needs cv2)."""
    import textwrap

    with tempfile.TemporaryDirectory() as tmp:
        print("FIXTURES = {")
        for name in FIXTURE_KINDS:
            path = Path(tmp) / f"f{_suffix(name)}"
            path.write_bytes(fixture_bytes(name))
            lines = textwrap.wrap(base64.b64encode(path.read_bytes())
                                  .decode(), 66)
            print(f'    "{name}": (\n'
                  + "".join(f'        "{line}"\n' for line in lines[:-1])
                  + f'        "{lines[-1]}",\n        {{')
            for denom in _scales(name):
                want = np.ascontiguousarray(cv2_read(path, denom))
                d = rgb_digest(want)
                print(f"            {denom}: ({want.shape}, \"{d[:32]}\"\n"
                      f"                {' ' * len(str(want.shape))}"
                      f"\"{d[32:]}\"),")
            print("        }),")
        print("}")


# name: (base64 file, {denom: ((h, w, 3), sha256 of cv2.imread's RGB bytes)})
FIXTURES = {
    "truncated_baseline": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0N"
        "GDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMv/AABEIABUAIwMBIgACEQEDEQH/xAAZAAACAwEAAAAAAAAAAAAAAAACBAAB"
        "AwX/xAAXAQADAQAAAAAAAAAAAAAAAAAAAgQD/8QAMBAAAgEDAgIHBwUAAAAAAAAAAQ"
        "IDAAQREiEFMRMUIjRBUWEjMkRScnOSU3GBkaH/xAAnEQACAAQEBgMBAAAAAAAAAAAB"
        "AgADETEEIUFREnGBkaHwEyJh4f/aAAwDAQACEQMRAD8AUWNry7WFEKAdojO2abNvHN"
        "LpvBhk7KyQtvjFZ5ktZ2vIS0oHaZym2PlpgJaT3UBtpF9qC8oc40n08qOIUFCaaHpv"
        "11jaYxUk8Nxne/oO0LWomidGgjlXGY9Uh2ZT61d1GlsY3CB0AOGD5JPpVzGS5jYFFW"
        "2U9HjXgkjxFS4WRIujjWONYjqUMdzmgOpmChHts63MIjZEoKaZHvXuN7x0LfM0CSAl"
        "Qw5O2/8ANa9E3zL+VcqOBigOh2zvkNj/ACj6",
        {
            1: ((21, 35, 3), "a69c873d6e106ca5aed13eb3a80ae266"
                           "00c4a3587cf96d3f0950e35af6b9cfdf"),
            2: ((11, 18, 3), "f8b64490be53646eda411364aedce52f"
                           "38f30d961a7cf4886211d230c759a524"),
            4: ((6, 9, 3), "0abe410d69bc74f9455f0636b2aaf4d7"
                         "32958417aff086a0d2eaefc528a7ad3a"),
            8: ((3, 5, 3), "0055931caa0c31fc12fdae2406fd23af"
                         "fa693921d236082d8254a92248cb5970"),
        }),
    "truncated_restart": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0N"
        "GDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMv/AABEIABUAIwMBIQACEQEDEQH/3QAEAAH/xAAYAAEBAQEBAAAAAAAAAAAA"
        "AAACAwABBP/EABkBAQADAQEAAAAAAAAAAAAAAAIBAwQABf/EACwQAAIBAwIEBQMFAA"
        "AAAAAAAAECAwAEERIhEzFBYQUUIiMyUlNUcZGhotH/xAAqEQACAQMBBQgDAAAAAAAA"
        "AAABAhEAAyExBBJBobETFCIyUXGB4WGR8P/aAAwDAQACEQMRAD8AlMLtvDrhGALRgF"
        "oYxj0f7ULKSKbMZMzxoupYcHUO9QAgtPGvPSZ+TFdcVBLJxzyjqK//0Dc29mYYBa+Y"
        "lT5e5zHatwFspxK9vIivGRpO64/SnvO4KsM59s/XOoVuyHajyiJn4iOtf//Ry8MIA4"
        "4bY3XUNq77H1fyKz3C5clWxQa5ckwtf//S3h0sECTq8riMrgE/Ijoc9qk8SZiuYZHJ"
        "jIjOWALr3pHfVzbcZ9fz6ewo3UCJPCMev9kkV//Tkbp51QU=",
        {
            1: ((21, 35, 3), "10b627cdbf58acc9b838a5dec6d4f73e"
                           "0ee0f48be7ec22cf4a0993be115fe766"),
            2: ((11, 18, 3), "40e91ae6fb225586cdde652f3186cb21"
                           "940f80d303fbef9e0d665925b519b7cf"),
            4: ((6, 9, 3), "6260afbc4c919af0a6b0a824dfef10d5"
                         "910f8dd579a60f556ed5b5f145f6e43b"),
            8: ((3, 5, 3), "6d179cff972cb15f50fa336072a82056"
                         "90961b2ace43dc1c447b62618cfe9e74"),
        }),
    "truncated_progressive": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0N"
        "GDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMv/CABEIABUAIwMBIgACEQEDEQH/xAAYAAEBAQEBAAAAAAAAAAAAAAADAQIA"
        "BP/EABgBAQADAQAAAAAAAAAAAAAAAAIAAQQD/9oADAMBAAIRAxEAAAGCltp3nQnMSK"
        "99cmMbD0qzEz6f/8QAHRAAAQQDAQEAAAAAAAAAAAAAAQACERIDITIiMf/aAAgBAQAB"
        "BQLQbCpZvIORwNRGN0IlASyjivmN3gxtvVl//8QAHBEAAgICAwAAAAAAAAAAAAAAAA"
        "ECERIhBFFh/9oACAEDEQE/AU8lbFEUdFU6Xpx3lp9EYqj/xAAZEQACAwEAAAAAAAAA"
        "AAAAAAAAAQIRITH/2gAIAQIRAT8B18KEs4R0cUi2f//EACAQAAIBAwQDAAAAAAAAAA"
        "AAAAABERASISIxMnECQWH/2gAIAQEABj8CtnczqOXSNTMNQSRueUXImM/TiqKPaOxK"
        "n//EABwQAAMBAQADAQAAAAAAAAAAAAABESExQVFhcf/aAAgBAQABPyFpuHs6XVULtR"
        "2xm+g4Lu8GhPpwdQ==",
        {
            1: ((21, 35, 3), "db9024304c23c4f3719d6c9396f1e05b"
                           "76d04596bd67bc838404d5fa37856db7"),
            2: ((11, 18, 3), "387afe0c6eadbd282889524b01f8e5fb"
                           "2b37288cba638a7efe941c8da3456957"),
            4: ((6, 9, 3), "a4a014047402d70a5bccbc983f56c029"
                         "0d21220f7e684c18ef5e29e42d0a4325"),
            8: ((3, 5, 3), "765ac86302814ef0fa364cb20ad6b198"
                         "9c9ddc4a3a6e443572acd45b291174e8"),
        }),
    "partial_progressive": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0N"
        "GDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMv/CABEIABUAIwMBIgACEQEDEQH/xAAYAAADAQEAAAAAAAAAAAAAAAABAgMA"
        "BP/EABgBAAMBAQAAAAAAAAAAAAAAAAECAwAE/9oADAMBAAIRAxEAAAHZRmNAFaAolE"
        "6C8ozUUmXATdQ//8QAGhAAAwEBAQEAAAAAAAAAAAAAAQIRABIDMv/aAAgBAQABBQKM"
        "cUK5VYs6gpDhzX+i1PYzBKF43obgKrYtT//EAB4RAAIBAwUAAAAAAAAAAAAAAAABAh"
        "EhMRJBUYHR/9oACAEDEQE/AdPJK7vkpXYhebQ89+jP/8QAGBEBAQEBAQAAAAAAAAAA"
        "AAAAAQASEUL/2gAIAQIRAT8B9EiOrd11aSyX/9k=",
        {
            1: ((21, 35, 3), "a81b5d6cb34d5a059f013c14de76a4db"
                           "5c0080e633fedd8faebc75bd44847920"),
            2: ((11, 18, 3), "7eac1df217d64a0e1e45e5405f768e8e"
                           "d2df7016deaec46c939a555e4725a646"),
            4: ((6, 9, 3), "f88a7d11647bc06a8a0998f04344e598"
                         "455f4d840beee9970e7b1758b6b1d3a5"),
            8: ((3, 5, 3), "34bb812ca03b255a2858defb2371030a"
                         "f9a1443534b13b663af3363211226a54"),
        }),
    "arith_sequential": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0N"
        "GDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMv/JABEIABUAIwMBIgACEQEDEQH/zAAKAEEBIBADEQf/2gAMAwEAAhEDEQA/"
        "ANBYBRlBYAyKvi2u9jB01YBj68mgjfaBtNQ6LhPBYV6WSbs+Lv8AAGnKw+zWnf8A1b"
        "fthiUePqLepZEb3DKrF668l406SW/f78oucqXOunQIJXLLTMgMbQZ2C/249cmYw1Vn"
        "bq/Zh4xaCydtrbI+bzdfb9Y4KuserCCGzINwjXG3BXveKGOci3bkSngf+rUG1Rly8Y"
        "cky2flhX+QQy18J+r+wNXbJsfAjmNJPm4ppNdjb+VqfYCIrICGkodBl+LnRzcBQGjk"
        "zLheAu7bRF3fTRuXKxr/AM+Je5CaZqCLRV7o5TumpmWybpoq5U8lU6PgLV4ZGsV1Qu"
        "PxF1CG9JMYW9M17LcxWzDBdPjo4pkjxCHpbh9zSW0xIxf1W65AryChwYVq5WgIdScJ"
        "j1Ur7ygseMwW2UgkHPFmeH1j3xNJolZ/W5w2gOO7MLs8pkZzLNYn+p02LpJoRnsO1a"
        "CBW9XHO+xlNhx/ohK46TisRqL0TR7/2Q==",
        {
            1: ((21, 35, 3), "25026abbd10fbd1b2f6004457fc3d253"
                           "4660e8e4c5d57bf210867af24509b8df"),
            2: ((11, 18, 3), "99dbbf556e0130f0570f1fcdb3863122"
                           "999f9d0fd693854c9751c011ae3673f2"),
            4: ((6, 9, 3), "07090fdae2194668dfe43e27fde7f8bc"
                         "8490c412e7b6213b0f253c82e3fcd3cc"),
            8: ((3, 5, 3), "32b13e8ad15fa681693849aa8767ed98"
                         "781a454f38964beea816eb614c6b2e0f"),
        }),
    "arith_progressive_restart": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0N"
        "GDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMv/KABEIABUAIwMBEQACEQEDEQH/zAAKABABEBAFEQX/3QAEAAL/2gAMAwEA"
        "AhEDEQAAAcLz8QT/0MTo0ID/0fuX7VkvgP/SPtr/0xYzhmYo/9ToLsXOoP/V+/mgZI"
        "D/1rTn/9oACAEBAAEFAiBBPI2A/9ChJChiQP/RIDlMJ8D/0glBgP/TiGcS/9QJlj3f"
        "0P/VGDVD4P/Wog5A/9oACAEDEQE/AY6mM55Wza6g/9AeWuT1BAlInP/RDLSQ/9J9P0"
        "e1VlAZ/9Mi/AlifcD/1ErYVtfA/9WOebwfVTiA/9YpAYn/2gAIAQIRAT8BHgjXmtnz"
        "LTgo/9A902AX8NI+plP/0XgjmQEt/9KQ24/1iRb/0xKhBRrEWyT/1BNPIGaXav/VHY"
        "gwcXbd6SD/1h5auP/aAAgBAQAGPwInX3pA/9BkWmlo/9F7bv1nSmD/0kzyr8M2/9Mi"
        "fN1nGv/UYrdM/9VNXP/WZMD/2gAIAQEAAT8h/KmfR1hUKm1NaP/Q3Ikae0wC5pZg/9"
        "EJR2RakZyA/9IY2o3tpNJs/9PpkFoeU6Fm/9QsQhXZ/wCd/9W6MYtB+KYXXP/WqRrj"
        "5P/aAAwDAQACEQMRAAAQsv/Q/P/RzP/SYP/T2P/U8P/VyP/WYP/aAAgBAxEBPxB997"
        "IXtwrWhUX/0CUP6kR0PMNSP4D/0VTI0hC/uP/SSqpiGxbwyVRA/9Mzh6C+ByHwuFyi"
        "/9QE4cY4SrH/1cQ6w883/iz/1sW1/9oACAECEQE/EFuocynfVR5jkP/Qr37RBdFRfK"
        "6A/9F5xE5YOr3A/9KEJCjCMwfFNID/09t9JSWxTA//1CSKyaprBEb/1fTIvcG7lBda"
        "wP/W6P/aAAgBAQABPxBehvFNy9Z3fXU9NF7Q/9D/APD58wbFW7lHChKYr//Rw49l1S"
        "U619kLgGD/0hjc+Qb5i7FMmDP/08/hf8ZtnozsXPBA/9TaYHUKgDsBrPtJQL7/1Z5M"
        "w6c9Zwz3jIUQgP/WIwjm15T/2Q==",
        {
            1: ((21, 35, 3), "a3960bb89015f3b218ce779c1c1ba2cb"
                           "42210eb71260716119ed6eadca4e9cc2"),
            2: ((11, 18, 3), "dbf3df289c86a22e5ddf3cb981999050"
                           "9f6bc49aaa8427dcfd7e700612b05376"),
            4: ((6, 9, 3), "75213fd7d5c12dc61a88ee0596c67c7a"
                         "512fb493ead7a15222fd6551ee45f7f6"),
            8: ((3, 5, 3), "1323826a4ad3dd6b91609ca9a292b1e5"
                         "55efc9bff1eb912ca09d524d10aa6d61"),
        }),
    "truncated_arith": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wCEAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDIBCQkJDAsMGA0N"
        "GDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMv/KABEIABUAIwMBIgACEQEDEQH/zAAKABABEBAFEQX/2gAMAwEAAhEDEQAA"
        "Aa06XYG0ymLJC/TN0W17rQ56meZwlZ9A/9oACAEBAAEFAjxU8G+pD6uMmoIY48MxWD"
        "kfpo98ucjbQblo/9oACAEDEQE/ARDrJh0FNwQnLdw3lP/aAAgBAhEBPwEjEw9oEBPD"
        "OJNW/9oACAEBAAY/ApObnEQr661lw40Tq5Zpirv83ZQWf0KoJlqA/9oACAEBAAE/Id"
        "Q917L1QrEMrhAF7j3xYrXvZOlRdqQYpwzEKnRTGY2661MkpaHZDsvvqFQirJc2HQkg"
        "fgUHHqtQnUD/2gAMAwEAAhEDEQAAEDa1VATA/9oACAEDEQE/EBd1VQ+WGzkVZJ/r4w"
        "==",
        {
            1: ((21, 35, 3), "ab95a288f09069f2ab6d913bc2169a50"
                           "e7b7b0ef559dc7592c1b5480981042a7"),
            2: ((11, 18, 3), "2d4fa9aba9f5f0351069e2e7fbb6d540"
                           "a3b34688b0d67c3c0c2e4b203fa31209"),
            4: ((6, 9, 3), "456fcd6bf83538d5dc9ddadcd6da8e66"
                         "e2a13d279526d6864d37783e8667065b"),
            8: ((3, 5, 3), "a4468e13668668aa91512726370290d5"
                         "da4b2b0bd29181683270e02919a9e5d1"),
        }),
    "lossless_psv5_pt1": (
        "/9j/wwARCAAVACMDAREAAhEAAxEA/8QAGgAAAwEBAQEAAAAAAAAAAAAAAgMEAQUABv"
        "/aAAwDAQACAAMABQABhmHrsXN1QmpsCvFq59nAVHy851QX03dpvXbUyabnI5csLQm6"
        "NDYa+pP6nsqiWmLj1qX0ntUPuWUvuvgtsh4hGPrforGWeg5fNyMbaOhg6XYukZmlKc"
        "k5ca3Z3A2MaZWGRJYeZUzV0MieSUsJAXzxWsQDaJ5emY3ktM7ucPYaBPRi/ZFvPjq0"
        "+n27R6VskxV8pWxs5j8FKcaFtCcBck1qvGZproV0d2rmVTRZyqIZejTUvsLS6SqOvy"
        "KNxLcJFFmi7JZ2ZllVCrQg8hK2UzZahrC8wgYfQlaUr+S2aaHmuORD6Nd06nlvuYCQ"
        "ZnQ6VDaM9HBvO8he70kdQ7nxddBOrdtkwrUiJs3KoMfPf6EG82tannuW9HZmBzo8Bq"
        "mVyU+B43zIogqB70cmWnc7HSs89XI3lzp2jei6k/IndM51RDZMQPySpPj6Dz6KSRzl"
        "xjDOYgJefOBlvm5cQ07QqIoh8i2ygUMRzA8wj6e5SV9U82pRgVHb73T5cYp5fOpBZX"
        "LOsHa9mMS9UqlogPH2P6DaFzAtPvE0GSsPxF15ldBKdcznk/lLDX49zwTrARpsGiwO"
        "kz1WbzEly5eheJdW3kTW8/lSsRyqTzcsAcZRPXbULmc+bJoqWbW6kiYFu+s9gYA6yj"
        "xXFGyj3OSXJ3YqappAuRL3eiZ07BEBWnED6ONT0pp7+nx5ukrn0dNaven55Jd6DoTp"
        "QVM9ltrbrRJY8+Q5AdXQLjWqRy5q1ueVOWsTY6EqYlBOMy8LU+oyOk5sQimPOdy4Rq"
        "tIKetm30AnwoodhClU/rGeWqfkzDrfXeYLrtoqrh042r6Ogc0/Pnnx40G1Q2QxY+BP"
        "YedFmR0ZO9ti15z5pJpEWFkPHFt4Z1sczLp+havpYgebFGgRp65srkXyPKldPTKz09"
        "7NKrFUeM6bZnBIEKD8tp0zzUz8+Hdnf2r7u1X4gmQNCNrGjQMJhi6bzUmPbgQaVz39"
        "ejsWtzlQQSI9Uyyqoj8MUM0C46OnlHQxEfmQsspN5+XEuKeltFvQrapD+ZEGbN0KyY"
        "8FhN4DQ6+fo4+ierc7nZVLzFKjWp7/AFV1VQ5Wud1DFFTzahmbP0ZQNSoJiOc7RlmL"
        "3NqtOqh5JNajOmx9RebyRFOiR+8rksjjty2joLU/kDJrk9ah6aiFFmwbU9dFoIPmRb"
        "5x9B+6ULxgOGxQdOwotXzeZRqyF3NnYebdRqutu3uJOhBz65kudR4vUMwaClNmsvSv"
        "3MRIvRrzZeRf51W7lh897Odmr8DGoyHdiYfTPXO3lPsjyoZ/dFD+jnolxynNW9DWHM"
        "3pSx6M3OOw8or9kdbEdECarV+eDdSyNaAaNec7rvZGNEUrEM1Vo1lIc+xROJDWXXja"
        "5i0vh3ZvUMGjoYluxQMVq2Wc+pKjQ9fnrJo+Ua1nTgPGVGrAW1M19U8DwW+zn1WXbz"
        "7F8+de+8wtth95dMNTFNlyFgC0umttG6BZKtqMM6pCagE0AimuVFFIp6THzyP5+qG5"
        "jcXu8srk+2wZKDNV3lVrU2ClrnIGhKSFk78TZPTlNseTy8/kBs4nb4evU1408yernM"
        "9T0effVzpVBCmu8D6dCJbFAii2N2+llXPD66ezt+qecEN3MXc4wvnbRxR905W2ZP58"
        "7LGx2bLVPUrAi2KZZqCp9IW2FiupIih2xWu5qymAH6dbKNqOIl+SNp0Sg7lxReWih3"
        "QMm2jJU/nz1asrVVO5POm6in9ADteLKp0USqJyZ652rTQta7mnb7yTRPTRg9AJppkc"
        "2J9jup0+p6E50Kf0IXmcqulzkb6dJuxVnkNq2e6rnLPZR6GA5CEecRkxtA00ypZ5an"
        "sBk7KJpnNmb1aaG0ZOlMETpfG+2TzpomV+ymiaN7IKbGKW1XPasqJ7F3qVQqhNNPR1"
        "F8XMlSK3OU4t6dLsP0qslUqiYugqxbly3QEMq42ofbd0m9UjkWmAefQllg2P8gfI5z"
        "jEaHyUSr2ZiElO+31DbVSDmw1119FdOImnmbkvqv/Z",
        {
            1: ((21, 35, 3), "12db54d5a61012d82b5719f8312009e0"
                           "a00b5dec7a972858f84bbe6fe2ae483b"),
            2: ((21, 35, 3), "12db54d5a61012d82b5719f8312009e0"
                           "a00b5dec7a972858f84bbe6fe2ae483b"),
            4: ((21, 35, 3), "12db54d5a61012d82b5719f8312009e0"
                           "a00b5dec7a972858f84bbe6fe2ae483b"),
            8: ((21, 35, 3), "12db54d5a61012d82b5719f8312009e0"
                           "a00b5dec7a972858f84bbe6fe2ae483b"),
        }),
    "lossless_restart": (
        "/9j/wwARCAAVACMDAREAAhEAAxEA/8QAGwAAAwEBAQEBAAAAAAAAAAAAAwQFBgIBAA"
        "f/3QAEAIz/2gAMAwEAAgADAAcAAEDD0ofrv1WYe3EKqJju0whXk4OJnFk6dq/rqgLu"
        "gzKvp8/itMpOa90ufuM5jiYTHy9hK55p6HDmq88JaJqefj1bp+a0IXUV9ogWtVBJWc"
        "o5LS9S6+Xri4nIx66PYA0A/URMBRTz6QYqDCUaSGZGeAxZFU88rR+7Kw3nCJuPSG31"
        "e7JJtGsNzm81nKrpeLNZB7xZMNSGDRzuu1WZoB+9lRLo04r6uQiRIkTk/KDGcbDFpw"
        "ysx/UO+V1qRUSH55orNsSyTEPM0myku40VaYObLnm+I8t72nDdZmFosh4qvjLSbltt"
        "5rs8ZJpZH46yGgWI175MWKnCEvLy3Sk6rohkT4M1Riaeqkyq38A7dlmTa7RZ7reLCV"
        "SzqrCHdRcb05LwAhNModUcrN8ySy04ar0/PtJRJbfsLgMrLyHs4vVUY8KzQMc3VGfO"
        "bGKFQv5u7Reb/9BqC7K6bt6LL29HOQnUJ8Rty4xPoBSz3tpSQg5m8sw6bjbWktA22s"
        "s7Hn8xxvyvQAqZXRNwtVPT598k1HZqv0jHdV8rasEeg6Nteg1VbbY7Ih9jx2YzhdSe"
        "Z+gTqrPlOWSdGqqnf6ojGVUCzHEB7rNtpiMu0n0QxGNF3ULMdhy5nwImje+1ls+wfU"
        "vUDdVKgaJF7nHFT2qDl7jxY5111WQpPsPhPR5JS7baeuMZ3Xmi+k7lJWOXO+9LMiPz"
        "IqvXsCw7Fuc0Knlb10fxwuJNKqfZ+vC4uwXme++dT0aoQaXMYqXz6tbvovTzB2rNI5"
        "ariXJxiR9LLMTmm0/XPU0eGlXlZaGlXk1F0+5ZrqAW+U4HP0QrNCy9qXnqhHfqAFCx"
        "l1eCd0ytt+rcOSOtJ0V2nKgCicod3w8m5gF4NRLq3GO6xZlEpgS+pOc5mKndpKPV/w"
        "D/0ddOzxWpWP2qccjr82vYq0hrsysQhGkro6XY2qVXQx4RPTQmvosyO+d+jbZTQjl9"
        "m6/V06v2lgYwMKbPasm9CrMmRaTILlWpG0lXME7Hjc8PO55ui3b1+lkL381Y1MFvvK"
        "9dhDVvK6lyTZmSll0F1xNoVKfHP02MjF9T6qzG1JlKM7oVqIFpst6VToc1gNepLqpJ"
        "wlC5mfPTRh/LoTjtpOVuk0SxFfJ2jcpUK9yOvMQJ016sZSI8z4alQYe9YR4AqOjRHb"
        "uVFa1OWKwIGkUqUOqKNI03usFemRL59bzxxKdTm8tIN8xgzJPMLmqnXI1W6uUFbVTL"
        "oNqpdW6DFecy1lUyEroEopO9oec9SxvxSUjAboiQsUYxnOYDnQ9KZ7Qv/c+0k12VmM"
        "+jWguuMaBVl7OzpkccOta9sfV+s5crStFa91bjVTp00h2hGPw9N91UKtRTaBTn+6T/"
        "0q0LYezpyruenWIvRQc9aVd+wxI8bwopXkoelJqKjdi4qlcFme5kcMNhSnfj6nQoeE"
        "jZjNpmh6nX29CreYzPni33h7LTA0hR4rgVKU8sahclXnr6CmmxiC/DifHGWXehuVxu"
        "IVec9rHk6GgJNfnryuDQ76EgspJJShQ47IJaKZ2FsfY2vLzYA65nBe/J+WWPvmaEuB"
        "XlQbwjfKPTs++XOz1EIUKqxzVpXUFnIE2K5psk5o88vbO/0V6L0KdV5Mdi98/Wo0GK"
        "fgOpEVKQitzxfNO0J8/7Ti03FLNMwyWEZDHx+fGnVYrIYsmhLi6OOqONwnJBbVz3XS"
        "ucbtze+vVYs71CJDN5HrCVYbsT6FmZ8u6jKvgh6KoCrfr+P/SHZgB9W03z6B7nQ8vS"
        "O/M1Y+kPlzpuofVInzHnoM4mOSMdxVm2h6l1IR5juMn6o6dAVcEiNTHGY0VGN//Tmv"
        "aFCjA0quf3y1SkzVzTfmVW+jFussvPT1F5R1mkurWapJ020rc+lj/JuU1SP1L55WXV"
        "UdbRcVGhJ4SqJF3UKq+NTJUZM+Pxb8uq6LTZz73lLN6C3MDpNRharlG0ZDUpZhpLhO"
        "nQS7MDF8Vc6A5omb9yS3kGm0gUM4WdnLzkfKKh+uOvOp71GdPfJn/mUmuBV3kdJQVv"
        "ppdGQBVdb5pUTmNpvObqnjq3NbhLoE76sO5wOlHzGUjhz4nXFgOSJ5e0lqIERzSITv"
        "Z3jWbUcycwUgzTT7NFWR2LNiZRS6Og76lpeJrZEYZPkpvIglF7oPeK4LoPNGNc/EFf"
        "yaCjxGJ5zCntwO/c5DzPXEFioyOhwXvHUA5k7HM6gedcOvrHZbXagkxW2VKbdVZeom"
        "CLz9LrdMH5GLuYr6rmFnInVUTbKCdRMFVmyFp4CKsuMrKXSbPItP8A/9SpHR+WXG5J"
        "yWnUkN1L87VVoNbMKKZwqB5/twVPW1aLoU5IUEvi1J61zWIi1cpXNk4j6L3pNiCmKO"
        "dNxQttti7R5bQmPEHR0z8l9yTAoScZzKloOUlbtH//2Q==",
        {
            1: ((21, 35, 3), "39235a2a1c05fcd8656da8945e43f8b9"
                           "a00e44a0700039e0af9b7fc1390a1735"),
            2: ((21, 35, 3), "39235a2a1c05fcd8656da8945e43f8b9"
                           "a00e44a0700039e0af9b7fc1390a1735"),
            4: ((21, 35, 3), "39235a2a1c05fcd8656da8945e43f8b9"
                           "a00e44a0700039e0af9b7fc1390a1735"),
            8: ((21, 35, 3), "39235a2a1c05fcd8656da8945e43f8b9"
                           "a00e44a0700039e0af9b7fc1390a1735"),
        }),
    "tiff_lzw_cut": (
        "SUkqAMkEAACAIY+nl+BN+vx6Ol+NkHvd6jENBcJgMMvRuAFxvV6PsUgUHB0IPt+Pxx"
        "O9zuJovd+O8CgYHAEBllBokLB56BN4uoAtYQRoZhUHv8KBNtOAJulwAUKgwEg4Qgpy"
        "i9wOMBN99LkEBtug4Egl+O43GpLhMTN95AV5vN3jcRPMIi18NkDPhwuoIPJ6iIOvgN"
        "BMGvlxC5kvyoBhhCoLskLPkBulzoUyKh7hdnu8Lu4CA4djZ6hMSvBnOp3ON2gUEgET"
        "Q2bAOVhRsBcNN4SPYMhBkg12uxxOVBIReOF/ssFgp3iUFiMOAQOAcKyd8Nt7OgGg4K"
        "A1+BZ0PZ2vACN0Bht7iAJAkOut9O9sAByIpTMt7PRvgZ1uIDPAAgQEhMACd7uABmuB"
        "hzH0FICA0f4AgAf5sHAAxvHed4PBIf4Og+CB+nYa4MHMSpUmABx8gQch1msbp0m6BA"
        "CAE6p8nYdpwgyep+BGBgMnafYDg0dR2gOcx7mMDAJH8G4JBODB3P8eJPkITh9geEJr"
        "H4dR4n4Z4OgkfAGHkBZ2mwdgRn8e4NgqBZxAGfQIgIAB6ncC5nLcCwWgAEQVnKdp3H"
        "KgIIAmzmhW8FQu7HY6gsAm8Kxo/3a9Ao2Gq8hQB32IQ2D3o9HYAH063WBhG7nMOhCB"
        "QkGg+5H49Wmj0OiXK/3q83Q6QQCACJxu/XeBH04G48w4/gMCAWEX+6HmDXm5ACFg+B"
        "3WSQi3wkDwM438EHkekmggI5XE9X29nKExAEQ3CwY9QA+W4GHu6nW8we93oDg+8n4F"
        "gUHn4AJK3HA/3y2wCIg4ZkOcgw432CHZIQeCgOIBqCAiHgK9msAgE1HiDgUBAECws5"
        "pU+BG+QY9HK+1+8gG9n0DxiakGZxK+QkF2oEAEBHUBxYGXmBRe6XS6HUBXA/hKCwoF"
        "nYAXe8wS4BKCXS9HmA3E7weGHMAwwhESVgqBQOFHKF34BXm/QiDHE+w2cQDHWfABn0"
        "fB/AuBQFnOAgEHSf50gsf5qgCex/AiewBg+uRwlMQQuHeeB4H2Ax/HADQJHwAwOgEA"
        "p/HqBx0uOBiQhCAh0nkfoHnYe4CAuBxzAMeoGAGdUcgYeZ1kmNo8AAb5vnsBoAmyFI"
        "PHuCIKhEywApCdoBg2A4BBEBhynKbwJHEewKgsHR0AmBQDH6bYGAEAJ7gqgICAHQtn"
        "IMvV2AANht6BcJPN/v0LAB7gN4vNogEJPsKBkNAJ1O8LOd4gUCChwAISAkDgMQw13h"
        "U9HolgQCAB5BgTBR2A0BPJ4P8DPd/Ox6tB7Apxh0XBkWhMKgt7gBnvIANtrhUTvYWj"
        "gXgB5hUxo4fv5/Ad/A8JiBuBEPvR7gUPOh9vd9NpzipqhQgAsZWl+u0IMByvxtNt/C"
        "B9BceDIAhQPlM0E0DAoPBQUP4KPt9CN7vkRhp6AJ+A9pt0gNF+CcEg94Bx+u4FuR5g"
        "p050Mgh5594goKHcqmB8CATPwSgEAPhtAkAO0UBEKToOuRtiF1WeaO4APwAgsAAYNA"
        "x5PcOv14AMIPd5gM6mRDP8WgZ/A4CgJpNt5gZxAEMBgJt0Mgkd4GASDoEneCR8m+fQ"
        "En+fwBgsDZxAMAp6AedwNAMAYAjGORPgsEZ8ggCJ4gQbBpnsAQsAAAEEAAEAAAAQAA"
        "AAAQEEAAEAAAAYAAAAAgEDAAMAAABTBQAAAwEDAAEAAAAFAAAABgEDAAEAAAACAAAA"
        "EQEEAAMAAABZBQAAFQEDAAEAAAADAAAAFgEEAAEAAAAIAAAAFwEEAAMAAABlBQAAHA"
        "EDAAEAAAABAAAAPQEDAAEAAAACAAAAAAAAAAgACAAIAAgAAADAAQAAdwMAALgBAAC3"
        "AQAAUgEAAA==",
        {
            1: ((24, 16, 3), "f81c5e3114ab20f36668e167a4f286e8"
                           "121e863d3e01938321b5e18ebc6a9e30"),
        }),
    "tiff_deflate_flipped": (
        "SUkqAGQEAAB4nAXB3U6CUAAA4Gfrptq6a7o0L/Ini0TUgwSiRHCAAyICKgoIZpK/We"
        "qac6uttbYerO9rteY+ZHd0+qNc2VO2bxlMrwhMAvgSNzCGyIryvHmDdVlCFhqYU7f0"
        "vRNo6yC3g+m3HNTTDpVRNIaWHFYIjWXU/6Jbg1MkxMx6UcGY8kxfDA+C+hMjowviDt"
        "yeCfUUH2qg91bTDnrwpS903kxa91Rg2O2+Jq4Hs2AlkvPSaVg94gpXmZJJiWNdcd3H"
        "py18+RNGIbGkmEUgheuS2ifdybsxtTlfzjbxFLoAcpGHKsSadoYY29n5L3hZVbc02k"
        "ADOfm4BMLXb81yEJdtoxPbi7W9CmEyACftFN4VC8MpM3GhB6bKdVjBi7Ey8g+fgSCP"
        "4omITj7buF/HoUSozUef7CJcVkCmQ2XbrNdk+128BMWWuRjNB+quwE8wycE46xgTL2"
        "taxzWcUZXR79MJJXfeeFBUwdsQSiQb/7JWxuZ4nAXBXVOiUAAA0P/UvvrUvjQ19dCO"
        "mY5GmCniBRIRgS6fV6+icCEMh4zSzHFXp5qasZ3dt35a5wz8cS+KiW0avKrlHJjhL0"
        "7aNYLkJS/MOeg2PYmVVK4mi1ERLfIjLR3TnnPu5k+jbFUS5eNmsQE4nw/THN6WnH/2"
        "dA5Jj6L1c0ltPDOj7psJ7svccJdK9i9sWioo14y2aIkfTpusMNre+ZuRcWuU+lAagz"
        "dPIZ91cVNCbhH3QMvAoPlIlOG2IkQ1KMRESgelwMhEo4wVAEFfsjyeXtErpC3ihETE"
        "/mjdfHUns0cFtttiNuDpYWUfyTuB+8OxcoLdrxppGcDS4jz/DQdrrK+N2aa3+e3fD2"
        "Wv15kUA5l60GFijTKrwCmEDvVylO13zOvwD4YPHYSspTVZ427CNoxjUWGV2FJX7Dg8"
        "nAl7T8rP/+QgPS2Iar4SyabfQrhh3mqJB2LprJnn9GrXXyX6u+Zav+aVy7Ugv7rCN2"
        "RhvQF4nAXBXW+aUAAA0N/WpWlmNXZLjTqcbCJSEcdlgMiHQ6Uo9VZALgUsEZ0bazaz"
        "RB/mssU0bfqyp+037ZzAAFx8/PJ7nlqwULN0M7H6esDxPON12nE0jqbJleAPAUDjcj"
        "QhoB/38B/40ddXDUWDeMq17knSp5pMxbHaKDQBRLplL9ymYrOY7pAW9LVcyj9TCaMI"
        "bjNIPNlUXqDnNMhDAOCo00j6XDqx7ZrA1lnmI3RFpJQgeU7lr1jwszr/nZsHwgwL1V"
        "KM9w1JxZYkvah60ukoUx8VovmsaNtV9aJJFIYttH396wm7XZkqnWL0Lmt/eWe816Q3"
        "LKcTJXjCBFnXF6rugvRE5kOtS0RG4ZtV7JkcPrAxdy2vt2g25mMCX4qMMub1qeY5Tb"
        "kXyneyvMOlmw4NrGG2u8LF0HAd7yFJ/82DFYJdlArmZ2uEZkbUkBrIXGnoQCkbgeoN"
        "p1mYVpzLQfh28Mhf/738tG/v49Ifs3xQ6KQ1mJz9B/hgvWcKAAABBAABAAAAEAAAAA"
        "EBBAABAAAAGAAAAAIBAwADAAAA4gQAAAMBAwABAAAACAAAAAYBAwABAAAAAgAAABEB"
        "BAADAAAA6AQAABUBAwABAAAAAwAAABYBBAABAAAACAAAABcBBAADAAAA9AQAABwBAw"
        "ABAAAAAQAAAAAAAAAIAAgACAAIAAAAdgEAAOoCAABuAQAAdAEAAHoBAAA=",
        {
            1: ((24, 16, 3), "462dfa61ec8fb9d1ac88d5a87adbbbaf"
                           "e21d025bd6ec9b29d1821fbf81743f7c"),
        }),
    "tiff_packbits_cut": (
        "SUkqAIYEAAB/fnZ0lXJ8qFyQpVeDoW1/iGiEWVpYXG1Rd4B/cGl+bF99fmKbhWCueG"
        "yag3h/nISQfpFsmYZ2rWqWqG+Dq293onNsiHk4i3JAfY10W5h5bIV+l22GnlKEgk55"
        "b2ZihHldap1sfY2Ah4Z/ippepoFgonxogoBBdXZMXZqIVJyNfXImgKRSjLo5k7RWep"
        "KJUYCERmGecGd/eoCaZpzBPragN5t/RmZ4SWV9/2t9kKVmh59yaISCTZ+dOaifYpWL"
        "nIiBiIBOp2NskW6ZrWqjvkmkpy+LfytydEKOinmMhKBmeYVVgH5Yc5lbUIhbXpdmms"
        "Jlo7ZQq3R6mn+gooKOo26BiV6Cd0yQfzegkFGFgHVcZWRFc19FeG9JVF9cVYN8g8Fq"
        "obRuoKR8d6KD/306b5Z2cH6SkXWAnYJNj4o2f4xXb3J4WWhmYG1QeV1NiWJsiG6Uc2"
        "6hgJyLgXmKWotgSphaeHyBnHSIh3r/eBmVTnipUnWPjn6JkZKVcKSGa5VyanVeYGVS"
        "dH+NjF99h1VNoFRijVaebl2YeHBohoBao2Bop1R7jYKVl5ilqIuem36ChHVoamdLcW"
        "aLgHpfg19OhWaLX3qnV3qIfHhqjXlYkm9fgHF8bJKIdpiHgYCBenF1gHZiho1BkIxw"
        "mGxEjnJKa3uBRoGUV4eFaHx1ZmhidXBfbo11VKyCXUiZi3RyjmFsdlh4VHaSSZCKaJ"
        "1ATJlcYnF8gGB5gnRte1lcZUVHTmlcZHiMllytsGqUsZRuontwgFiFW3aKU5xxdI5e"
        "cpxclJh//5wVlXudjXB5c25lV1poXG9rgq55m8KUkv+lf4GLgHaHbXyJi312kYBveo"
        "SOiG6drn2WyaCFtq2Fn5aUk32BeXNsc4CBmoqUrHuKmmxzfFh2eU+Shm+LhqeHW4ei"
        "cVeErFh8wYuSspyZsn2droGQn5pbo5Q8rotRnHJqfUpnfz5ihk5weXVvkauqdIelh0"
        "h3qESLtYahtp2Et3F4HKZzi5SeX6CPLJp1Pn+jq2eUoUhrklKOm4ySm6pekX1UjV54"
        "e2pxgWVcdV9wS1yAQ1d7VmZ5gnOKnHCmg3yKlVaHhF1nZmxqYodkZqRYbYdfhl5rhl"
        "h+gmJ+dXKDVXeRTICMWIyKfI2flYbAa4F1Y4BoVIFcOoNKQoxEaq5gdKZ/eXh9f298"
        "hIBwm4JfmAqIdIenlIOrnICMp/94BbxWZmxblv9Pf4dTLotORpFMgatxdrSYYZGGYX"
        "5nbZBZk5dLn5FcmpiBl5CLfniOeXKadFZpfJFdeZRlRJJsUHF4gW+SbJeZWqF8WoZl"
        "XYNfd5lag5JShXBXfmtnYYh5dYeOkWZ7tIF1ooRpWntqYlmFklGVgXqGdYyBcXqGZH"
        "GAcXd7fmxcgE5TanZnclWchl+NlYN2ishxfqRzU3KAP4x6WK53cZp8dodheW9ee0x0"
        "g05pj3ZIb5VHXoqBf2Wxhlqffm9/ka18kJyIZpWkQaCRNpyOSX2ZY2hzWk1kUSdvfS"
        "lgnmNUfpBpZ4aPd2qwc121cmWSCgAAAQQAAQAAABAAAAABAQQAAQAAABgAAAACAQMA"
        "AwAAAAQFAAADAQMAAQAAAAWAAAAGAQMAAQAAAAIAAAARAQQAAwAAAAoFAAAVAQMAAQ"
        "AAAAMAAAAWAQQAAQAAAAgAAAAXAQQAAwAAABYFAAAcAQMAAQAAAAEAAAAAAAAACAAI"
        "AAgACAAAAI0BAAABAwAAhQEAAHQBAACFAQAA",
        {
            1: ((24, 16, 3), "0565dbb738e44d562b124fc7f5c3eb5b"
                           "5da1f06de6739275438ed330863b33d0"),
        }),
}


if __name__ == "__main__":
    sys.exit(_print_fixtures())
