"""Greedy NMS keep mask: the CUDA kernel (`csrc/nms.cu`) and its plain
PyTorch version.

Counterpart of the TPU kernel `efficientteacher_tpu/ops/nms_pallas.py`
(`greedy_nms_keep_pallas`) and of its pure oracle
`efficientteacher_tpu/ops/nms.py:43 greedy_nms_keep`.

`greedy_nms_keep_cuda` is the wrapper the NMS path calls. On a CUDA tensor
it launches the kernel (or raises); on a CPU tensor it runs the plain
version, `greedy_nms_keep`. `greedy_nms_keep_cuda.launches` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from ._build import check, library
from .boxes import box_iou


def greedy_nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_thres: float, tile: int = 256,
                    stop_at: int | None = None) -> torch.Tensor:
    """Exact greedy NMS keep masks, plain PyTorch, batched over images.

    boxes (B, K, 4) xyxy, score-sorted; valid (B, K) bool, False on padding
    rows. Returns (B, K) bool. K must be a multiple of `tile`.

    The tiled sweep of the JAX oracle, with its batch written out: each tile
    is suppressed by the kept rows of earlier tiles, then resolved inside by
    the fixpoint iteration. The sweep stops after the tile of the last
    valid row and, with `stop_at`, at the first tile boundary where that
    many rows are kept; later tiles keep their `valid` value (exact for the
    first `stop_at` kept rows, all a max_det-capped consumer reads). IoU
    uses eps 0, as the oracle does.
    """
    b, k, _ = boxes.shape
    if k % tile:
        raise ValueError(f"K={k} must be a multiple of tile={tile}")
    rows = torch.arange(k, device=boxes.device)
    last = torch.where(valid, rows, -1).amax(1)
    valid_tiles = (last + tile) // tile                 # 0 when none valid
    keep = valid.clone()
    cnt = torch.zeros(b, dtype=torch.long, device=boxes.device)
    tri = torch.ones(tile, tile, dtype=torch.bool,
                     device=boxes.device).triu(1)       # [i, j]: i < j
    for ti in range(int(valid_tiles.max()) if b else 0):
        active = ti < valid_tiles
        if stop_at is not None:
            active &= cnt < stop_at
        if not bool(active.any()):
            break
        cur = slice(ti * tile, (ti + 1) * tile)
        tile_boxes = boxes[:, cur]
        base = keep[:, cur].clone()
        for tj in range(ti):
            prev = slice(tj * tile, (tj + 1) * tile)
            iou = box_iou(boxes[:, prev], tile_boxes)
            base &= ~((iou > iou_thres) & keep[:, prev, None]).any(1)
        sup = (box_iou(tile_boxes, tile_boxes) > iou_thres) & tri
        act = base
        for _ in range(tile):
            new = base & ~(sup & act[:, :, None]).any(1)
            if torch.equal(new, act):
                break
            act = new
        act = torch.where(active[:, None], act, keep[:, cur])
        keep[:, cur] = act
        cnt += act.sum(1) * active
    return keep


def greedy_nms_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_thres: float, tile: int = 256,
                         stop_at: int | None = None) -> torch.Tensor:
    """`greedy_nms_keep` through the CUDA kernel for CUDA tensors (plain
    version for CPU tensors only). Same arguments and result."""
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return greedy_nms_keep(boxes, valid, iou_thres, tile, stop_at)
    b, k = valid.shape
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}: "
                         "need both on one CUDA device (or both on the CPU)")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 boxes and bool valid, got "
                        f"{boxes.dtype} and {valid.dtype}")
    if boxes.shape != (b, k, 4):
        raise ValueError(f"boxes {tuple(boxes.shape)} vs valid {(b, k)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    if not 1 <= tile <= 256 or k % tile:
        raise ValueError(f"need 1 <= tile <= 256 dividing K={k}, got {tile}")
    if not 0 <= b * 4 < 2 ** 31 or k >= 2 ** 31:  # 4 blocks per image
        raise ValueError(f"unsupported sizes B={b}, K={k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    lib = library().lib
    # the kept list holds at most min(K, stop_at - 1 + tile) boxes; what
    # shared memory cannot hold spills to a scratch region per image
    most = k if stop_at is None else min(k, max(stop_at, 0) - 1 + tile)
    spill_rows = max(0, most - lib.et_nms_list_cap())
    spill = (torch.empty((b, spill_rows, 4), dtype=torch.float32,
                         device=boxes.device) if spill_rows else None)
    with torch.cuda.device(boxes.device):
        code = lib.et_nms_keep(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, tile,
            float(iou_thres), -1 if stop_at is None else int(stop_at),
            spill.data_ptr() if spill is not None else None, spill_rows,
            torch.cuda.current_stream().cuda_stream)
    check(code, "et_nms_keep")
    greedy_nms_keep_cuda.launches += 1
    return keep


greedy_nms_keep_cuda.launches = 0
