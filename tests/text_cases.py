"""Fixed label-drawing cases with the sha256 of cv2 5.0.0's canvases
(recorded on an x86-64 host with cv2 5.0.0, the oracle the JAX package's
detect.py draws with), so a machine without that cv2 can hold the port's
`utils/draw.py` against it: `chip_smoke.py`'s `[serve]` phase on the
card's machine, `tests/test_torch_text.py` here (which also checks the
digests against cv2 itself).

Each case is a canvas (`pixel_op_cases.image`, integer arithmetic, the
same under any numpy) and a list of draws, each either a detection as
JAX's detect.py draws it, `("box", xyxy, label, colour)`:
`cv2.rectangle(im, p1, p2, colour, 2)` then `cv2.putText(im, label, (x1,
y1 - 4), FONT_HERSHEY_SIMPLEX, 0.5, colour, 1)`, or a bare label
`("text", org, label, colour)`. The canvas is in cv2's order on both sides
(the port draws channel by channel, as cv2 does). Imports neither cv2 nor
jax."""

import hashlib
from pathlib import Path

import numpy as np

from pixel_op_cases import image

REPO = Path(__file__).resolve().parents[1]
ASCII = "".join(chr(c) for c in range(32, 127))


def coco_names() -> list:
    from efficientteacher_torch.configs import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs/sup/public/yolov5l_coco.yaml"))
    return list(cfg.Dataset.names)


def colour_of(c: int):
    """JAX detect.py's class colour (utils/draw.color_of)."""
    return (37 * c % 255, 17 * c % 255, 29 * c % 255)


def cases():
    """[(name, canvas (h, w, 3) uint8, draws)]."""
    names = coco_names()
    coco = []
    for k, name in enumerate(names):  # 80 boxes on a 10 x 8 lattice
        x, y = 6 + (k % 8) * 79, 22 + (k // 8) * 46
        conf = ((k * 37) % 100) / 100
        coco.append(("box", (x, y, x + 60 + k % 9, y + 30 + k % 5),
                     f"{name} {conf:.2f}", colour_of(k)))
    w, h = 240, 120
    edges = [  # labels cut by each edge (labels sit at y1 - 4)
        ("box", (10, 0, 80, 40), "person 0.91", colour_of(0)),
        ("box", (100, 3, 200, 60), "traffic light 0.33", colour_of(9)),
        ("box", (-30, 50, 40, 90), "bicycle 0.57", colour_of(1)),
        ("box", (190, 70, 260, 110), "toothbrush 0.25", colour_of(79)),
        ("text", (5, h + 3), "dog 0.66 gjpqy", colour_of(16)),
        ("text", (60, 4), "Egypt 0.50", colour_of(40)),
        ("text", (-7, 112), "zebra 1.00", colour_of(22)),
        ("text", (w - 3, 100), "j", colour_of(5)),
    ]
    return [
        ("ascii_printable", image(60, 800, 21),
         [("text", (3, 22), ASCII, (255, 255, 255)),
          ("text", (-20, 50), ASCII[::-1], (20, 140, 230))]),
        ("coco_labels", image(480, 640, 22), coco),
        ("clipped_edges", image(h, w, 23), edges),
        ("latin_cyrillic_hebrew", image(40, 420, 24),
         [("text", (2, 28), "Café Ünïcödé Łódź Привет שלום ½ € “ok” №5",
           (0, 255, 128))]),
        # drawn from cv2's second font, WenQuanYi Micro Hei, beside Rubik
        ("cjk_greek_hangul", image(100, 360, 25),
         [("box", (8, 24, 120, 90), "行人 0.91", colour_of(0)),
          ("box", (150, 30, 300, 96), "自行车 0.57", colour_of(1)),
          ("text", (4, 96), "猫 0.87 狗 0.66 αβγ Ω 한국어 ☃\n"
           "熊猫", (255, 255, 255))]),
    ]


def draw_port(draw, canvas, draws):
    out = canvas.copy()
    for kind, at, label, colour in draws:
        if kind == "box":
            draw.box_label(out, at, label, colour)
        else:
            draw.text(out, label, at, colour)
    return out


def draw_cv2(cv2, canvas, draws):
    out = canvas.copy()
    for kind, at, label, colour in draws:
        if kind == "box":
            cv2.rectangle(out, at[:2], at[2:], colour, 2)
            at = (at[0], at[1] - 4)
        cv2.putText(out, label, at, cv2.FONT_HERSHEY_SIMPLEX, 0.5, colour, 1)
    return out


def digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def check_port(draw) -> list:
    """The cases whose port canvas differs from DIGESTS: (name, digest)."""
    bad = []
    for name, canvas, draws in cases():
        got = digest(draw_port(draw, canvas, draws))
        if got != DIGESTS[name]:
            bad.append((name, got))
    return bad


def cv2_digests(cv2) -> dict:
    """The digests of cv2's canvases on this machine."""
    return {name: digest(draw_cv2(cv2, canvas, draws))
            for name, canvas, draws in cases()}


DIGESTS = {
    "ascii_printable":
        "e1b4fb92b03416ff92e3e40c738e6208a3386779cddf04dfc26d910057e01acb",
    "coco_labels":
        "d349904e37bcf63963d4a292077777e4a2dee68a7be416af2ab7f1b070c6c63a",
    "clipped_edges":
        "2dff40b7f7075738ee39023d298361f553e83d701f180b38f91697dee67e6762",
    "latin_cyrillic_hebrew":
        "745943ca5d15da3ec2f6100a60eb3bc51e90a7670512485fd2fc002a03f20a53",
    "cjk_greek_hangul":
        "a2e10faff1ca270cfd2a7bc21ea3293eee24b97977b27b7c7740123efdc48a77",
}
