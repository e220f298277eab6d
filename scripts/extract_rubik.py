"""Extract the Rubik font that cv2 5.0's putText draws with, and its notice.

cv2 5.0 renders its Hershey faces with built-in TrueType fonts, stored in
its binary (`cv2.abi3.so`) as gzip members named by their FNAME field. The
port draws label text from this file (`efficientteacher_torch/utils/
draw.py`), and reads only the committed copy: the machine that runs the
port need not have cv2.

    python scripts/extract_rubik.py [--so PATH] [--out DIR]

writes DIR/Rubik.ttf (default `efficientteacher_torch/assets/fonts`) and
DIR/OFL.txt, which quotes the font's copyright and licence strings (name
IDs 0, 13 and 14). The member is found by its name, not by an offset.
"""

from __future__ import annotations

import argparse
import struct
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = b"Rubik.ttf"


def gzip_member(blob: bytes, name: bytes) -> bytes:
    """The inflated gzip member of `blob` whose FNAME is `name`."""
    i = blob.find(b"\x1f\x8b\x08")
    while i >= 0:
        flags = blob[i + 3]
        p = i + 10
        if flags & 4:  # FEXTRA
            p += 2 + struct.unpack("<H", blob[p:p + 2])[0]
        if flags & 8 and blob[p:p + len(name) + 1] == name + b"\0":
            return zlib.decompressobj(31).decompress(blob[i:])
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
    font = gzip_member(so.read_bytes(), NAME)
    names = name_strings(font)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / NAME.decode()).write_bytes(font)
    (args.out / "OFL.txt").write_text(
        "Rubik.ttf: the Rubik variable font (wght 300-900) that OpenCV 5.0\n"
        "builds into cv2 as the face of putText's FONT_HERSHEY_* fonts,\n"
        "extracted unchanged by scripts/extract_rubik.py.\n\n"
        "From the font's name table:\n"
        f"  Copyright (name ID 0): {names[0]}\n"
        f"  License (name ID 13): {names[13]}\n"
        f"  License URL (name ID 14): {names[14]}\n")
    print(f"{args.out / NAME.decode()}: {len(font)} bytes")


if __name__ == "__main__":
    main()
