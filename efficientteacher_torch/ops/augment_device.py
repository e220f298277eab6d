"""Train augmentation on the card, batched (counterpart of
`efficientteacher_tpu/ops/augment_device.py`): mosaic-4, random
perspective, HSV, flips and mixup for the labelled batch
(`device_augment_batch`), and the SSOD weak / strong pair with its
transform record M_s for the unlabelled batch (`device_ssod_views`,
`cutout_device`).

The host only decodes and letterboxes; everything here runs as batched
tensor ops on the images' device, with no loop over samples. Each entry
point is two parts:
  - a draw of its random parameters (`draw_augment`, `draw_ssod`) from an
    explicit `torch.Generator` on the device, which the trainers seed from
    the step counter (`step_seed`: the counterpart of
    `fold_in(PRNGKey(c), ni)`);
  - a deterministic transform of the batch given those parameters
    (`augment_batch`, `ssod_views`), so the same parameters give the same
    batch on the card and on the CPU, and the tests feed it the JAX
    package's own draws.
The draws are the quantities the JAX functions draw (mosaic centres and
gates, the eight uniforms of the affine, flip and HSV uniforms, cutout
rectangles), in the JAX functions' ranges.

Semantics per sample follow the JAX functions (and through them the host
pipeline): partner tiles are drawn within the batch by three shifted
permutations; the affine is T @ S @ R @ P @ C; flips are folded into it.
The JAX version resamples by weight-matrix products (the TPU's fast path);
here the same bilinear weights are applied as two-tap gathers per axis
(rows, then columns), which is the same sum without its zero terms. The
SSOD weak view is the 2s mosaic canvas downscaled by `jax.image.resize`'s
antialiased bilinear, written out as its fixed 4-tap filter [1, 3, 3, 1] /
8 (renormalised at the borders). Outputs are clipped to [0, 255] and
truncated to uint8, as JAX does.

Deviation kept from JAX: AutoAugment (ssod_hyp.autoaugment) is not applied
to the strong view (the JAX device path skips it too).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

FILL = 114.0
CUT_SCALES = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 \
    + [0.03125] * 16


def step_seed(stream: int, ni: int, part: int = 0, rank: int = 0) -> int:
    """The seed of the draws of step `ni` in `stream` (the trainers use 0
    for the supervised loop, 1 for burn-in, 2 for the SSOD loop, whose
    labelled and unlabelled draws are `part` 0 and 1). A DDP rank past 0
    draws its own (its share of the batch holds other images)."""
    key = f"{stream}/{ni}/{part}" + (f"/{rank}" if rank else "")
    h = hashlib.blake2b(key.encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def _f(hyp, k, default=0.0):
    return float(hyp.get(k, default))


def _axis_aligned(hyp: Dict) -> bool:
    """True when the random affine never rotates, shears or tilts."""
    return (_f(hyp, "degrees") == 0.0 and _f(hyp, "shear") == 0.0
            and _f(hyp, "perspective") == 0.0)


# -- draws ------------------------------------------------------------------

def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _draw_shifts(g, b, device):
    if b == 1:
        return torch.zeros(3, dtype=torch.long, device=device)
    return 1 + torch.randint(0, b - 1, (3,), generator=g, device=device)


def _draw_affine(g, b, hyp, device):
    """(B, 8): perspective x, y, degrees, scale, shear x, shear y,
    translate x, y, in build_affine_device's ranges."""
    p, d = _f(hyp, "perspective"), _f(hyp, "degrees")
    sc, sh = _f(hyp, "scale", 0.5), _f(hyp, "shear")
    t = _f(hyp, "translate", 0.1)
    lo = torch.tensor([-p, -p, -d, 1 - sc, -sh, -sh, 0.5 - t, 0.5 - t],
                      device=device)
    hi = torch.tensor([p, p, d, 1 + sc, sh, sh, 0.5 + t, 0.5 + t],
                      device=device)
    return _uniform(g, (b, 8), lo, hi, device)


def _draw_common(g, b, s, hyp, device, p_mosaic):
    return {
        "shifts": _draw_shifts(g, b, device),
        "xc": _uniform(g, (b,), 0.5 * s, 1.5 * s, device),
        "yc": _uniform(g, (b,), 0.5 * s, 1.5 * s, device),
        "do_mos": torch.rand(b, generator=g, device=device) < p_mosaic,
        "affine": _draw_affine(g, b, hyp, device),
        "do_lr": torch.rand(b, generator=g, device=device)
        < _f(hyp, "fliplr"),
        "do_ud": torch.rand(b, generator=g, device=device)
        < _f(hyp, "flipud"),
        "hsv": _uniform(g, (b, 3), -1.0, 1.0, device),
    }


def draw_augment(g: torch.Generator, b: int, s: int, hyp: Dict,
                 device) -> Dict[str, torch.Tensor]:
    """The random parameters of `augment_batch` for a batch of b images of
    s x s. Mixup's Beta(32, 32) ratio is X / (X + Y) with X, Y sums of 32
    exponentials (Gamma(32) draws from the generator's uniforms)."""
    out = _draw_common(g, b, s, hyp, device, _f(hyp, "mosaic", 1.0))
    if _f(hyp, "mixup") > 0:
        e = -torch.log1p(-torch.rand((2, b, 32), generator=g, device=device))
        x, y = e.sum(-1)
        out["mix_r"] = x / (x + y)
        out["do_mix"] = torch.rand(b, generator=g, device=device) \
            < _f(hyp, "mixup")
    return out


def draw_cutout(g, b: int, s: int, device) -> Dict[str, torch.Tensor]:
    """31 rectangles per image (cutout_device's scale ladder): heights and
    widths, centres, grey-ish colours."""
    n = len(CUT_SCALES)
    sc = torch.tensor(CUT_SCALES, device=device)
    mh = (torch.rand((b, n), generator=g, device=device) * (sc * s - 1)
          + 1).to(torch.int32)
    mw = (torch.rand((b, n), generator=g, device=device) * (sc * s - 1)
          + 1).to(torch.int32)
    return {
        "mh": mh, "mw": mw,
        "cx": torch.randint(0, s + 1, (b, n), generator=g, device=device),
        "cy": torch.randint(0, s + 1, (b, n), generator=g, device=device),
        "colors": torch.randint(64, 192, (b, n, 3), generator=g,
                                device=device).float(),
    }


def draw_ssod(g: torch.Generator, b: int, s: int, hyp: Dict,
              device) -> Dict[str, torch.Tensor]:
    """The random parameters of `ssod_views`."""
    out = _draw_common(g, b, s, hyp, device, _f(hyp, "mosaic", 1.0))
    if _f(hyp, "cutout") > 0:
        out["do_cut"] = torch.rand(b, generator=g, device=device) \
            < _f(hyp, "cutout")
        out["cut"] = draw_cutout(g, b, s, device)
    return out


# -- geometry -----------------------------------------------------------------

def build_affine_device(affine: torch.Tensor, width, height,
                        border=(0, 0)):
    """M (B, 3, 3) and scale s (B,) from the affine draws (B, 8):
    T @ S @ R @ P @ C, as build_affine_device composes it (reference
    augmentations.py:278-303). Composed in float64 and rounded to float32,
    so the card and the CPU give the same M: the HSV hue gain wraps at
    red, so a warp moved by float32 rounding (1e-5 in M) can shift a
    pixel there by several levels."""
    out_dtype = affine.dtype
    affine = affine.double()
    b = affine.shape[0]
    dev = affine.device
    eye = torch.eye(3, device=dev, dtype=torch.float64).expand(b, 3, 3)
    C = eye.clone()
    C[:, 0, 2] = -width / 2
    C[:, 1, 2] = -height / 2
    P = eye.clone()
    P[:, 2, 0] = affine[:, 0]
    P[:, 2, 1] = affine[:, 1]
    a = affine[:, 2] * math.pi / 180.0
    s = affine[:, 3]
    alpha, beta = s * torch.cos(a), s * torch.sin(a)
    R = eye.clone()
    R[:, 0, 0], R[:, 0, 1] = alpha, beta
    R[:, 1, 0], R[:, 1, 1] = -beta, alpha
    S = eye.clone()
    S[:, 0, 1] = torch.tan(affine[:, 4] * math.pi / 180.0)
    S[:, 1, 0] = torch.tan(affine[:, 5] * math.pi / 180.0)
    out_w = width + border[1] * 2
    out_h = height + border[0] * 2
    T = eye.clone()
    T[:, 0, 2] = affine[:, 6] * out_w
    T[:, 1, 2] = affine[:, 7] * out_h
    return (T @ S @ R @ P @ C).to(out_dtype), s.to(out_dtype)


def _fold_flips(M, do_lr, do_ud, s: int, pixel: bool):
    """F @ M: flips composed into the affine. Pixels flip around s - 1,
    box corners around s (as the host pipeline flips them)."""
    off = (s - 1.0) if pixel else float(s)
    b = M.shape[0]
    F = torch.eye(3, device=M.device, dtype=torch.float64).expand(b, 3, 3) \
        .clone()
    F[:, 0, 0] = torch.where(do_lr, -1.0, 1.0)
    F[:, 0, 2] = torch.where(do_lr, off, 0.0)
    F[:, 1, 1] = torch.where(do_ud, -1.0, 1.0)
    F[:, 1, 2] = torch.where(do_ud, off, 0.0)
    return (F @ M.double()).to(M.dtype)  # float64: see build_affine_device


def _taps(n_in: int, n_out: int, scale, trans):
    """Two-tap bilinear sampling of out(X) = in((X - trans) / scale) per
    image (scale, trans (B,)): indices (B, n_out) x 2, clamped, and
    weights, zero for taps outside the input (the JAX resample matrix's
    rows, clip(1 - |x - i|, 0, 1))."""
    x = (torch.arange(n_out, device=scale.device, dtype=torch.float32)
         - trans[:, None]) / scale[:, None]
    i0 = torch.floor(x)
    i1 = i0 + 1
    w0 = torch.clamp(1.0 - torch.abs(x - i0), 0.0, 1.0)
    w1 = torch.clamp(1.0 - torch.abs(x - i1), 0.0, 1.0)
    w0 = torch.where((i0 >= 0) & (i0 < n_in), w0, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 < n_in), w1, 0.0)
    return (i0.clamp(0, n_in - 1).long(), i1.clamp(0, n_in - 1).long(),
            w0, w1)


def _st_warp(imgs, sy, sx, ty, tx, out_h: int, out_w: int, src=None,
             fill: float = FILL):
    """Separable scale + translate warp, out(Y, X) = img((Y - ty) / sy,
    (X - tx) / sx) per image, fill outside (the JAX `_st_warp`). imgs
    (N, h, w, 3); `src` (B,) picks the image of each output (default: the
    i-th). Returns (B, out_h, out_w, 3) float32."""
    b = sy.shape[0]
    h, w = imgs.shape[1], imgs.shape[2]
    src = torch.arange(b, device=sy.device) if src is None else src
    y0, y1, wy0, wy1 = _taps(h, out_h, sy, ty)
    x0, x1, wx0, wx1 = _taps(w, out_w, sx, tx)
    bi = src[:, None]
    rows = (wy0[..., None, None] * (imgs[bi, y0].float() - fill)
            + wy1[..., None, None] * (imgs[bi, y1].float() - fill))
    # the column taps gathered as rows of the transposed tensor: an index
    # per (image, column), not per pixel
    cols = rows.transpose(1, 2)
    ar = torch.arange(b, device=sy.device)[:, None]
    out = (wx0[..., None, None] * cols[ar, x0]
           + wx1[..., None, None] * cols[ar, x1])
    return (out + fill).transpose(1, 2)


def warp_scale_translate_device(imgs, M, out_h: int, out_w: int,
                                fill: float = FILL):
    """`_st_warp` for axis-aligned affines M (B, 3, 3)."""
    return _st_warp(imgs, M[:, 1, 1], M[:, 0, 0], M[:, 1, 2], M[:, 0, 2],
                    out_h, out_w, fill=fill)


def _inverse3(M):
    """Inverses of 3x3 matrices (B, 3, 3) by the adjugate in float64,
    rounded to float32: the same on every device (a float32 LU inverse
    differs between the CPU's and the card's solvers by up to 1e-3 of an
    entry on these translation-heavy matrices, a pixel at 640)."""
    m = M.double()
    a, b, c = m[:, 0].unbind(-1)
    d, e, f = m[:, 1].unbind(-1)
    g, h, i = m[:, 2].unbind(-1)
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], 1)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return (adj / det[:, None, None]).to(M.dtype)


def warp_image_device(imgs, M, out_h: int, out_w: int, fill: float = FILL):
    """Inverse-map bilinear warp of any affine or perspective M (B, 3, 3):
    out(x, y) = img(M^-1 (x, y, 1)), taps outside the image read `fill`.
    imgs (B, H, W, 3) uint8 or float; returns float32."""
    b, h, w = imgs.shape[:3]
    dev = imgs.device
    Minv = _inverse3(M)
    ys = torch.arange(out_h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(out_w, device=dev, dtype=torch.float32)[None, :]
    m = Minv[:, :, :, None, None]
    src = m[:, :, 0] * xs + m[:, :, 1] * ys + m[:, :, 2]   # (B, 3, H, W)
    sx = src[:, 0] / src[:, 2]
    sy = src[:, 1] / src[:, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    bi = torch.arange(b, device=dev)[:, None, None]

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = imgs[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)].float()
        return torch.where(inside[..., None], v, fill)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def mosaic_warp_fused_device(images, idx, corners_yx, tile_on, M, s: int,
                             fill: float = FILL):
    """Mosaic composition fused with an axis-aligned warp: each tile is
    warped straight into output space and composited with its coverage
    rectangle, where a later tile wins (the JAX function, batched). images
    (B, s, s, 3) uint8; idx (B, 4) the tile of each corner (top-left,
    top-right, bottom-left, bottom-right); corners_yx (B, 4, 2) tile
    top-left in mosaic coordinates; tile_on (B, 4) = [True, m, m, m]
    (m: the mosaic gate; off, tile 0 alone is placed); M (B, 3, 3).

    The tiles' rectangles are a 2 x 2 grid, so the winner at (Y, X) is
    the tile of the row band covering Y and the column band covering X.
    One row pass per column band then gathers each output row from its
    band's tile (two passes, not four), and one column pass over both
    bands' results makes the image: the same taps and sums as four tile
    warps, without their full-size intermediates. A tap outside its tile
    reads fill (the JAX version's seam)."""
    sx, sy = M[:, 0, 0], M[:, 1, 1]
    tx, ty = M[:, 0, 2], M[:, 1, 2]
    b = idx.shape[0]
    dev = images.device
    pos = torch.arange(s, device=dev, dtype=torch.float32)[None, :]
    multi = tile_on[:, 1:2]

    def span(lo, hi):
        return torch.minimum(lo, hi), torch.maximum(lo, hi)

    def inside(lo, hi):
        lo, hi = span(lo, hi)
        return (pos >= lo[:, None]) & (pos < hi[:, None])

    def bands(scale, trans, first, second, n):
        """Per output coordinate along one axis: which band (0, 1) covers
        it, whether one does, and its two taps and weights in that
        band's tile."""
        win = inside(trans, trans + scale * 2 * s)
        cov = [inside(scale * c + trans, scale * (c + s) + trans) & win
               for c in (first, second)]
        band = (multi & cov[1]).long()          # the later band wins
        ok = torch.where(multi, cov[0] | cov[1], cov[0])
        taps = [_taps(s, n, scale, trans + scale * c) for c in (first, second)]
        i0, i1, w0, w1 = (torch.where(band.bool(), t1, t0)
                          for t0, t1 in zip(*taps))
        return band, ok, i0, i1, w0, w1

    # row bands: tiles 0/1 (corner of tile 0), tiles 2/3 (tile 2); column
    # bands: tiles 0/2 (tile 0), tiles 1/3 (tile 1)
    ry, oky, y0, y1, wy0, wy1 = bands(sy, ty, corners_yx[:, 0, 0],
                                      corners_yx[:, 2, 0], s)
    rx, okx, x0, x1, wx0, wx1 = bands(sx, tx, corners_yx[:, 0, 1],
                                      corners_yx[:, 1, 1], s)
    rows = []
    for c in (0, 1):  # the tile of each output row in column band c
        src = torch.gather(idx, 1, 2 * ry + c)
        rows.append(wy0[..., None, None] * (images[src, y0].float() - fill)
                    + wy1[..., None, None] * (images[src, y1].float() - fill))
    cols = torch.cat(rows, 2).transpose(1, 2)            # (B, 2s, s, 3)
    ar = torch.arange(b, device=dev)[:, None]
    out = (wx0[..., None, None] * cols[ar, x0 + rx * s]
           + wx1[..., None, None] * cols[ar, x1 + rx * s])
    out = (out + fill).transpose(1, 2)
    ok = oky[:, :, None] & okx[:, None, :]
    return torch.where(ok[..., None], out, fill)


def warp_boxes_device(boxes, M, out_w: int, out_h: int):
    """(B, N, 4) xyxy -> the enclosing boxes of the warped corners,
    clipped (reference augmentations.py:318-337)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx = torch.stack([x1, x2, x1, x2], -1)     # (B, N, 4)
    cy = torch.stack([y1, y1, y2, y2], -1)
    m = M[:, None, None]                       # (B, 1, 1, 3, 3)
    wx = cx * m[..., 0, 0] + cy * m[..., 0, 1] + m[..., 0, 2]
    wy = cx * m[..., 1, 0] + cy * m[..., 1, 1] + m[..., 1, 2]
    wz = cx * m[..., 2, 0] + cy * m[..., 2, 1] + m[..., 2, 2]
    x, y = wx / wz, wy / wz
    return torch.stack([x.amin(-1).clamp(0, out_w), y.amin(-1).clamp(0, out_h),
                        x.amax(-1).clamp(0, out_w),
                        y.amax(-1).clamp(0, out_h)], -1)


def box_candidates_device(before, after, s, wh_thr=2.0, ar_thr=20.0,
                          area_thr=0.1, eps=1e-16):
    """Survival mask after a warp (reference augmentations.py:417);
    before/after (B, N, 4), s (B,) the affine's scale."""
    s = s[:, None]
    w1 = (before[..., 2] - before[..., 0]) * s
    h1 = (before[..., 3] - before[..., 1]) * s
    w2 = after[..., 2] - after[..., 0]
    h2 = after[..., 3] - after[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def _tile_boxes(labels, cx0, cy0, s: int):
    """[cls, xyxy px] of normalized labels (B, M, 5) placed with their
    tile's top-left at (cx0, cy0) (B,)."""
    cx = labels[..., 1] * s + cx0[:, None]
    cy = labels[..., 2] * s + cy0[:, None]
    bw = labels[..., 3] * s
    bh = labels[..., 4] * s
    return torch.stack([labels[..., 0], cx - bw / 2, cy - bh / 2,
                        cx + bw / 2, cy + bh / 2], -1)


def mosaic4_device(images, idx, labels, mask, xc, yc, s: int):
    """4 s-square tiles per image -> its (2s, 2s) mosaic canvas around the
    centre (xc, yc) (reference utils/datasets.py load_mosaic; the tiles are
    letterboxed, so the crop is a corner placement). Tiles sit at the
    rounded centre, boxes at the drawn one, as in JAX. images (B, s, s, 3)
    uint8, idx (B, 4), labels (B, M, 5) [cls, xywhn], mask (B, M).
    Returns canvas (B, 2s, 2s, 3) uint8, boxes (B, 4M, 5) [cls, xyxy px]
    clipped to the canvas, valid (B, 4M)."""
    b = idx.shape[0]  # the tiles come from `images` by idx
    dev = images.device
    xci = torch.round(xc).long()
    yci = torch.round(yc).long()
    c = torch.arange(2 * s, device=dev)[None, :]

    def axis(ci):
        """Per canvas coordinate: the tile half (0: before the centre),
        the coordinate inside the tile, and whether a tile covers it."""
        second = c >= ci[:, None]
        local = torch.where(second, c - ci[:, None], c - ci[:, None] + s)
        return second.long(), local, (local >= 0) & (local < s)

    ry, ly, oky = axis(yci)
    rx, lx, okx = axis(xci)
    # rows first: for each column half, the row of the tile it lies in,
    # side by side; then the columns, as rows of the transposed tensor
    ly = ly.clamp(0, s - 1)
    rows = torch.cat([images[torch.gather(idx, 1, 2 * ry + c), ly]
                      for c in (0, 1)], 2)                   # (B, 2s, 2s, 3)
    col = rx * s + lx.clamp(0, s - 1)
    ar = torch.arange(b, device=dev)[:, None]
    canvas = rows.transpose(1, 2)[ar, col].transpose(1, 2)
    ok = oky[:, :, None] & okx[:, None, :]
    canvas = torch.where(ok[..., None], canvas,
                         torch.full_like(canvas, int(FILL)))
    offs = [(-s, -s), (-s, 0), (0, -s), (0, 0)]
    boxes, valid = [], []
    for k, (oy, ox) in enumerate(offs):
        boxes.append(_tile_boxes(labels[idx[:, k]], xc + ox, yc + oy, s))
        valid.append(mask[idx[:, k]])
    boxes = torch.cat(boxes, 1)
    boxes = torch.cat([boxes[..., :1], boxes[..., 1:].clamp(0, 2 * s)], -1)
    return canvas, boxes, torch.cat(valid, 1)


# -- colour -------------------------------------------------------------------

def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn + 1e-12
    h = torch.where(
        mx == r, torch.remainder((g - b) / d, 6.0),
        torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)) / 6.0
    sat = d / (mx + 1e-12)
    return torch.remainder(h, 1.0), sat, mx


def _hsv_to_rgb(h, s, v):
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select([v, q, p, p, t, v]),
                        select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], -1)


def hsv_jitter_device(imgs, u, hgain, sgain, vgain):
    """HSV gains r = u * gains + 1 per image (u (B, 3) in [-1, 1)); imgs
    float RGB 0..255 (B, H, W, 3). The float-space form of the reference's
    uint8 LUT (augmentations.py:48-60)."""
    gains = torch.tensor([hgain, sgain, vgain], device=imgs.device)
    r = (u * gains + 1.0)[:, None, None, :]
    h, s, v = _rgb_to_hsv(imgs / 255.0)
    h = torch.remainder(h * r[..., 0], 1.0)
    s = torch.clamp(s * r[..., 1], 0.0, 1.0)
    v = torch.clamp(v * r[..., 2], 0.0, 1.0)
    return _hsv_to_rgb(h, s, v) * 255.0


def cutout_device(imgs, cut: Dict[str, torch.Tensor], s: int):
    """Random occlusion rectangles (reference augmentations.py:382-407): the
    31 rectangles of `cut` (draw_cutout) filled with their colours, later
    ones over earlier ones; labels are untouched. The last rectangle that
    covers a pixel is found from per-row and per-column bit masks of the
    31 rectangles (their AND's highest set bit)."""
    mh, mw = cut["mh"].long(), cut["mw"].long()
    x1 = torch.clamp(cut["cx"] - mw // 2, min=0)
    y1 = torch.clamp(cut["cy"] - mh // 2, min=0)
    x2 = torch.clamp(x1 + mw, max=s)
    y2 = torch.clamp(y1 + mh, max=s)
    n = mh.shape[1]
    pos = torch.arange(s, device=imgs.device)[None, :, None]
    bits = (1 << torch.arange(n, device=imgs.device, dtype=torch.long))
    rows = (((pos >= y1[:, None]) & (pos < y2[:, None])) * bits).sum(-1)
    cols = (((pos >= x1[:, None]) & (pos < x2[:, None])) * bits).sum(-1)
    hit = rows[:, :, None] & cols[:, None, :]              # (B, s, s)
    _, exp = torch.frexp(hit.double())
    last = (exp - 1).clamp(min=0).long()                   # highest bit
    b = imgs.shape[0]
    fill = cut["colors"][torch.arange(b, device=imgs.device)[:, None, None],
                         last]
    return torch.where((hit > 0)[..., None], fill, imgs)


def _compact(out, keep, mo: int):
    """Valid rows first (stable), cut to mo, invalid rows zeroed."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    out = torch.gather(out, 1, order[..., None].expand_as(out))[:, :mo]
    keep = torch.gather(keep, 1, order)[:, :mo]
    return torch.where(keep[..., None], out, 0.0), keep


def _quad_index(shifts, b: int, device):
    """(B, 4): each image and its three in-batch partners."""
    ar = torch.arange(b, device=device)
    return torch.stack([ar] + [(ar + shifts[j]) % b for j in range(3)], 1)


def _to_labels(cls, new, s: int):
    x1, y1, x2, y2 = new.unbind(-1)
    return torch.stack([cls, (x1 + x2) / 2 / s, (y1 + y2) / 2 / s,
                        (x2 - x1) / s, (y2 - y1) / s], -1)


def _u8(x):
    return torch.clamp(x, 0, 255).to(torch.uint8)


# -- the batched entry points ------------------------------------------------

def augment_batch(images, labels, mask, hyp: Dict, draws: Dict,
                  max_out: int = 0):
    """Batched train augmentation given its draws (`draw_augment`).

    images (B, s, s, 3) uint8 letterboxed; labels (B, M, 5) [cls, xywhn]
    float32; mask (B, M) bool. Returns (images uint8 (B, s, s, 3), labels
    (B, Mo, 5) normalised, mask (B, Mo)) with Mo = max_out or 4M."""
    b, s = images.shape[0], images.shape[1]
    m = labels.shape[1]
    mo = max_out or 4 * m
    dev = images.device
    use_mosaic = _f(hyp, "mosaic", 1.0) > 0
    fast = _axis_aligned(hyp)
    idx = _quad_index(draws["shifts"], b, dev)
    do_mos = draws["do_mos"]
    if use_mosaic:
        xc, yc = draws["xc"], draws["yc"]
        half = float(s // 2)
        corners, tile_on, boxes, valid = [], [], [], []
        for k, (oy, ox) in enumerate([(-s, -s), (-s, 0), (0, -s), (0, 0)]):
            cy_k, cx_k = yc + oy, xc + ox
            if k == 0:  # solo fallback: the primary tile centred on 2s
                cy_k = torch.where(do_mos, cy_k, half)
                cx_k = torch.where(do_mos, cx_k, half)
                on_k = torch.ones_like(do_mos)
            else:
                on_k = do_mos
            corners.append(torch.stack([cy_k, cx_k], -1))
            tile_on.append(on_k)
            boxes.append(_tile_boxes(labels[idx[:, k]], cx_k, cy_k, s))
            valid.append(mask[idx[:, k]] & on_k[:, None])
        corners = torch.stack(corners, 1)
        tile_on = torch.stack(tile_on, 1)
        boxes = torch.cat(boxes, 1)
        boxes = torch.cat([boxes[..., :1], boxes[..., 1:].clamp(0, 2 * s)],
                          -1)
        valid = torch.cat(valid, 1)
        border = (-s // 2, -s // 2)
        src = 2 * s
    else:
        zero = torch.zeros(b, device=dev)
        boxes = _tile_boxes(labels, zero, zero, s)
        valid = mask
        border = (0, 0)
        src = s
    M, sc = build_affine_device(draws["affine"], src, src, border)
    M_img = _fold_flips(M, draws["do_lr"], draws["do_ud"], s, pixel=True)
    M_box = _fold_flips(M, draws["do_lr"], draws["do_ud"], s, pixel=False)
    if use_mosaic and fast:
        img = mosaic_warp_fused_device(images, idx, corners, tile_on, M_img,
                                       s)
    elif use_mosaic:
        canvas, _, _ = mosaic4_device(images, idx, labels, mask,
                                      draws["xc"], draws["yc"], s)
        solo = torch.full((b, 2 * s, 2 * s, 3), int(FILL), dtype=torch.uint8,
                          device=dev)
        solo[:, s // 2:s // 2 + s, s // 2:s // 2 + s] = images
        canvas = torch.where(do_mos[:, None, None, None], canvas, solo)
        img = warp_image_device(canvas, M_img, s, s)
    elif fast:
        img = warp_scale_translate_device(images, M_img, s, s)
    else:
        img = warp_image_device(images, M_img, s, s)
    new = warp_boxes_device(boxes[..., 1:], M_box, s, s)
    keep = valid & box_candidates_device(boxes[..., 1:], new, sc)
    out, keep = _compact(_to_labels(boxes[..., 0], new, s), keep, mo)

    # mixup (host order: post-warp, pre-HSV): a Beta(32, 32) blend with the
    # batch-rolled partner, labels concatenated
    if _f(hyp, "mixup") > 0 and use_mosaic and b > 1:
        r = draws["mix_r"][:, None, None, None]
        do_mix = draws["do_mix"]
        partner = torch.roll(img, 1, 0)
        img = torch.where(do_mix[:, None, None, None],
                          img * r + partner * (1.0 - r), img)
        p_out = torch.roll(out, 1, 0)
        p_keep = torch.roll(keep, 1, 0) & do_mix[:, None]
        out, keep = _compact(torch.cat([out, p_out], 1),
                             torch.cat([keep, p_keep], 1), mo)
    img = hsv_jitter_device(img, draws["hsv"], _f(hyp, "hsv_h"),
                            _f(hyp, "hsv_s"), _f(hyp, "hsv_v"))
    return _u8(img), out, keep


def device_augment_batch(g: torch.Generator, images, labels, mask,
                         hyp: Dict, max_out: int = 0):
    """`augment_batch` with its draws from `g` (on the images' device)."""
    draws = draw_augment(g, images.shape[0], images.shape[1], hyp,
                         images.device)
    return augment_batch(images, labels, mask, hyp, draws, max_out)


def _halve(canvas):
    """(B, 2s, 2s, 3) -> (B, s, s, 3) float32: jax.image.resize's bilinear
    with antialias at scale 1/2, a 4-tap triangle [1, 3, 3, 1] / 8 over
    inputs 2X-1 .. 2X+2, renormalised where taps fall outside (first and
    last outputs: [3, 3, 1] / 7, [1, 3, 3] / 7). Rows, then columns."""
    s = canvas.shape[1] // 2
    w = torch.tensor([0.25, 0.75, 0.75, 0.25], device=canvas.device)
    wt = (w / w.sum()).expand(s, 4).clone()
    edge = torch.tensor([0.0, 0.75, 0.75, 0.25], device=canvas.device)
    wt[0] = edge / edge.sum()
    wt[-1] = edge.flip(0) / edge.sum()

    def axis(x, dim):
        xp = torch.nn.functional.pad(x.movedim(dim, -1), (1, 1))
        out = xp[..., 0:2 * s:2] * wt[:, 0]
        for t in range(1, 4):
            out = out + xp[..., t:t + 2 * s:2] * wt[:, t]
        return out.movedim(-1, dim)

    return axis(axis(canvas.float(), 1), 2)


def ssod_views(images, labels, mask, hyp: Dict, draws: Dict,
               max_out: int = 0):
    """SSOD weak / strong pair given its draws (`draw_ssod`), as
    LoadImagesAndFakeLabels.__getitem__ builds it on the host:

      weak   = in-batch mosaic-4 of the letterboxed tiles, the 2s canvas
               halved to s (the solo tile where the mosaic gate is off)
      strong = the recorded affine warp of the weak view + HSV + cutout +
               flips
      M_s    = [batch index, M (9), s, flip-ud, flip-lr]

    images (B, s, s, 3) uint8; labels (B, M, 5) [cls, xywhn] (zeros for an
    unlabelled pool); mask (B, M). Returns (strong uint8, labels (B, Mo, 5)
    xywhn on the strong view, mask, weak uint8, M_s (B, 13))."""
    b, s = images.shape[0], images.shape[1]
    m = labels.shape[1]
    mo = max_out or 4 * m
    dev = images.device
    idx = _quad_index(draws["shifts"], b, dev)
    zero = torch.zeros(b, device=dev)
    if _f(hyp, "mosaic", 1.0) > 0:
        canvas, boxes2s, valid = mosaic4_device(
            images, idx, labels, mask, draws["xc"], draws["yc"], s)
        do_mos = draws["do_mos"]
        weak = torch.where(do_mos[:, None, None, None], _halve(canvas),
                           images.float())
        solo = torch.cat([_tile_boxes(labels, zero, zero, s),
                          torch.zeros((b, 3 * m, 5), device=dev)], 1)
        solo_valid = torch.cat(
            [mask, torch.zeros((b, 3 * m), dtype=torch.bool, device=dev)], 1)
        half = torch.cat([boxes2s[..., :1], boxes2s[..., 1:] * 0.5], -1)
        boxes = torch.where(do_mos[:, None, None], half, solo)
        valid = torch.where(do_mos[:, None], valid, solo_valid)
    else:
        weak = images.float()
        boxes = _tile_boxes(labels, zero, zero, s)
        valid = mask
    M, sc = build_affine_device(draws["affine"], s, s)
    M_img = _fold_flips(M, draws["do_lr"], draws["do_ud"], s, pixel=True)
    M_box = _fold_flips(M, draws["do_lr"], draws["do_ud"], s, pixel=False)
    if _axis_aligned(hyp):
        strong = warp_scale_translate_device(weak, M_img, s, s)
    else:
        strong = warp_image_device(weak, M_img, s, s)
    new = warp_boxes_device(boxes[..., 1:], M_box, s, s)
    keep = valid & box_candidates_device(boxes[..., 1:], new, sc)
    strong = hsv_jitter_device(strong, draws["hsv"], _f(hyp, "hsv_h"),
                               _f(hyp, "hsv_s"), _f(hyp, "hsv_v"))
    if _f(hyp, "cutout") > 0:
        strong = torch.where(draws["do_cut"][:, None, None, None],
                             cutout_device(strong, draws["cut"], s), strong)
    m_s = torch.cat([
        torch.arange(b, device=dev, dtype=torch.float32)[:, None],
        M.reshape(b, 9), sc[:, None],
        draws["do_ud"].float()[:, None], draws["do_lr"].float()[:, None]], 1)
    out, keep = _compact(_to_labels(boxes[..., 0], new, s), keep, mo)
    return _u8(strong), out, keep, _u8(weak), m_s


def device_ssod_views(g: torch.Generator, images, labels, mask, hyp: Dict,
                      max_out: int = 0):
    """`ssod_views` with its draws from `g` (on the images' device)."""
    draws = draw_ssod(g, images.shape[0], images.shape[1], hyp,
                      images.device)
    return ssod_views(images, labels, mask, hyp, draws, max_out)

