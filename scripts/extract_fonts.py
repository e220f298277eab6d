"""Extract the fonts that cv2 5.0's putText draws with, and their notices.

cv2 5.0 renders its Hershey faces with built-in TrueType fonts, stored in
its binary (`cv2.abi3.so`) as gzip members named by their FNAME field:
Rubik, and WenQuanYi Micro Hei, from which it draws what Rubik does not
map (CJK, Greek, ...). The port draws label text from these files
(`efficientteacher_torch/utils/draw.py`), and reads only the committed
copies: the machine that runs the port need not have cv2.

    python scripts/extract_fonts.py [--so PATH] [--out DIR]

writes into DIR (default `efficientteacher_torch/assets/fonts`) Rubik.ttf,
inflated, with OFL.txt, and WenQuanYiMicroHei.ttf.gz, the gzip member
exactly as cv2 stores it (2.1 MB; the port inflates it when it loads it),
with WenQuanYi-NOTICE.txt. Each notice quotes the font's copyright and
licence strings (name IDs 0, 13 and 14). A member is found by its name,
not by an offset.
"""

from __future__ import annotations

import argparse
import struct
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUBIK = b"Rubik.ttf"
WQY = b"WenQuanYiMicroHei.ttf"


def gzip_member(blob: bytes, name: bytes, raw: bool = False) -> bytes:
    """The gzip member of `blob` whose FNAME is `name`: inflated, or with
    `raw` its bytes as stored (a gzip file of its own)."""
    i = blob.find(b"\x1f\x8b\x08")
    while i >= 0:
        flags = blob[i + 3]
        p = i + 10
        if flags & 4:  # FEXTRA
            p += 2 + struct.unpack("<H", blob[p:p + 2])[0]
        if flags & 8 and blob[p:p + len(name) + 1] == name + b"\0":
            d = zlib.decompressobj(31)
            font = d.decompress(blob[i:])
            if raw:
                return blob[i:len(blob) - len(d.unused_data)]
            return font
        i = blob.find(b"\x1f\x8b\x08", i + 3)
    raise SystemExit(f"no gzip member named {name.decode()}")


def name_strings(font: bytes, ids=(0, 13, 14)) -> dict:
    """Windows (3, 1) English strings of the font's `name` table."""
    count = struct.unpack(">H", font[4:6])[0]
    table = None
    for k in range(count):
        tag, _, off, _ = struct.unpack(">4sIII", font[12 + 16 * k:28 + 16 * k])
        if tag == b"name":
            table = off
    if table is None:
        raise SystemExit("the font has no name table")
    n, strings = struct.unpack(">HH", font[table + 2:table + 6])
    out = {}
    for k in range(n):
        plat, enc, lang, nid, length, off = struct.unpack(
            ">6H", font[table + 6 + 12 * k:table + 18 + 12 * k])
        if (plat, enc, lang) == (3, 1, 0x409) and nid in ids:
            s = table + strings + off
            out[nid] = font[s:s + length].decode("utf-16-be")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--so", type=Path, default=None,
                    help="cv2's binary (default: the installed cv2's)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "efficientteacher_torch/assets/fonts")
    args = ap.parse_args()
    so = args.so
    if so is None:
        import cv2
        so = next(Path(cv2.__file__).parent.glob("cv2*.so"))
    blob = so.read_bytes()
    args.out.mkdir(parents=True, exist_ok=True)
    rubik = gzip_member(blob, RUBIK)
    (args.out / RUBIK.decode()).write_bytes(rubik)
    notice(args.out / "OFL.txt", rubik,
           "Rubik.ttf: the Rubik variable font (wght 300-900) that OpenCV "
           "5.0\nbuilds into cv2 as the face of putText's FONT_HERSHEY_* "
           "fonts,\nextracted unchanged by scripts/extract_fonts.py.")
    print(f"{args.out / RUBIK.decode()}: {len(rubik)} bytes")
    member = gzip_member(blob, WQY, raw=True)
    wqy = zlib.decompressobj(31).decompress(member)
    (args.out / (WQY.decode() + ".gz")).write_bytes(member)
    notice(args.out / "WenQuanYi-NOTICE.txt", wqy,
           "WenQuanYiMicroHei.ttf.gz: WenQuanYi Micro Hei, the font OpenCV "
           "5.0\nbuilds into cv2 for the characters putText's Rubik does not "
           "map,\nthe gzip member of cv2's binary unchanged (the font "
           "inflated is\n" f"{len(wqy):,} bytes), extracted by "
           "scripts/extract_fonts.py.")
    print(f"{args.out / WQY.decode()}.gz: {len(member)} bytes "
          f"({len(wqy)} inflated)")


def notice(path: Path, font: bytes, head: str) -> None:
    names = name_strings(font)
    path.write_text(
        head + "\n\nFrom the font's name table:\n"
        f"  Copyright (name ID 0): {names[0]}\n"
        f"  License (name ID 13): {names[13]}\n"
        f"  License URL (name ID 14): {names[14]}\n")

if __name__ == "__main__":
    main()
