"""YOLOv5 anchor assignment as fixed-shape masked tensors (counterpart of
`efficientteacher_tpu/assigners/yolo_anchor.py`; reference
models/assigner/yolo_anchor_assigner.py:319-372 `build_targets`).

Every (target, neighbour cell, anchor) triple is a slot of a (B, M, 5, na)
lattice with a validity mask, in the JAX package's slot order:
  - anchor gate: max(wh/anchor, anchor/wh) < anchor_t (reference :341-343)
  - neighbour cells: the centre cell, plus left/top/right/bottom when the
    box centre lies within 0.5 of that cell's edge and > 1 from the image
    edge (reference :346-353)
  - regression target (gxy - cell, gwh), class, anchor wh

One difference, of layout: the port's raw maps are (B, na, ny, nx, no)
(the reference torch layout, `models/heads/yolov5.py`), so `flat_cell`
indexes them flattened as `(a * ny + gj) * nx + gi`; the JAX maps are
(B, ny, nx, na, no), indexed `(gj * nx + gi) * na + a`.

Labels arrive padded: (B, M, 5 + E) rows [cls, cx, cy, w, h, extra...]
normalized to [0, 1], with label_mask (B, M). Extra columns (the SSOD
loss's pseudo-label scores) ride along untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

NUM_NEIGHBORS = 5


class DenseAssignment(NamedTuple):
    """Per-scale dense assignment; K = M * 5 * na slots."""

    valid: torch.Tensor      # (B, K) bool: a real positive
    flat_cell: torch.Tensor  # (B, K) int64: (a * ny + gj) * nx + gi, in range
    txy: torch.Tensor        # (B, K, 2) target xy offset in its cell
    twh: torch.Tensor        # (B, K, 2) target wh in grid units
    tcls: torch.Tensor       # (B, K) int64
    anchor_wh: torch.Tensor  # (B, K, 2) anchor wh in grid units
    extra: torch.Tensor      # (B, K, E) passthrough target columns


def assign_scale(labels: torch.Tensor, label_mask: torch.Tensor,
                 grid_hw: Tuple[int, int], anchors_grid: torch.Tensor,
                 anchor_t: float, single_targets: bool = False
                 ) -> DenseAssignment:
    """Dense build_targets for one scale. anchors_grid: (na, 2) anchor wh
    in grid units of this scale."""
    ny, nx = grid_hw
    b, m = labels.shape[:2]
    na = anchors_grid.shape[0]
    e = labels.shape[-1] - 5
    dev = labels.device
    # no constant tensors are made here: on the card each would be a host
    # copy that waits for the stream

    cls = labels[..., 0]
    gxy = torch.stack([labels[..., 1] * nx, labels[..., 2] * ny], -1)
    gwh = torch.stack([labels[..., 3] * nx, labels[..., 4] * ny], -1)
    extra = labels[..., 5:]

    r = gwh[:, :, None, :] / anchors_grid[None, None]        # (B, M, na, 2)
    anchor_ok = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t

    gx, gy = gxy[..., 0], gxy[..., 1]
    ix, iy = nx - gx, ny - gy                                  # inverse
    cell_ok = torch.stack([
        torch.ones_like(gx, dtype=torch.bool),
        (gx % 1.0 < 0.5) & (gx > 1.0),                         # left
        (gy % 1.0 < 0.5) & (gy > 1.0),                         # top
        (ix % 1.0 < 0.5) & (ix > 1.0),                         # right
        (iy % 1.0 < 0.5) & (iy > 1.0),                         # bottom
    ], -1)                                                     # (B, M, 5)
    if single_targets:
        cell_ok[..., 1:] = False

    # floor(gxy - offset) for the offsets (0,0), (.5,0), (0,.5), (-.5,0),
    # (0,-.5) (reference table, yolo_anchor_assigner.py:328-332, g = 0.5)
    gi = torch.stack([gx, gx - 0.5, gx, gx + 0.5, gx], -1).floor()
    gj = torch.stack([gy, gy, gy - 0.5, gy, gy + 0.5], -1).floor()
    gi = gi.clamp(0, nx - 1)
    gj = gj.clamp(0, ny - 1)
    txy = gxy[:, :, None, :] - torch.stack([gi, gj], -1)      # (B, M, 5, 2)

    valid = (label_mask[:, :, None, None] & cell_ok[..., None]
             & anchor_ok[:, :, None, :])                       # (B, M, 5, na)
    a = torch.arange(na, device=dev)
    flat_cell = ((a * ny + gj.long()[..., None]) * nx
                 + gi.long()[..., None])

    k = m * NUM_NEIGHBORS * na
    shape = (b, m, NUM_NEIGHBORS, na)

    def bc(x, tail=()):
        return x.expand(shape + tail).reshape((b, k) + tail)

    return DenseAssignment(
        valid=valid.reshape(b, k),
        flat_cell=flat_cell.reshape(b, k),
        txy=bc(txy[:, :, :, None, :], (2,)),
        twh=bc(gwh[:, :, None, None, :], (2,)),
        tcls=bc(cls.long()[:, :, None, None]),
        anchor_wh=bc(anchors_grid, (2,)),
        extra=bc(extra[:, :, None, None, :], (e,)),
    )


def assign_all_scales(labels: torch.Tensor, label_mask: torch.Tensor,
                      grid_shapes: Sequence[Tuple[int, int]],
                      anchors_grid: torch.Tensor, anchor_t: float,
                      single_targets: bool = False
                      ) -> Tuple[DenseAssignment, ...]:
    """Dense assignment for every scale; anchors_grid (nl, na, 2) in grid
    units (anchors_px / stride). Pass it on the labels' device: an array
    or a tensor elsewhere is copied there on every call."""
    anchors_grid = torch.as_tensor(anchors_grid, dtype=torch.float32,
                                   device=labels.device)
    return tuple(
        assign_scale(labels, label_mask, hw, anchors_grid[i], anchor_t,
                     single_targets)
        for i, hw in enumerate(grid_shapes))
