"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a CUDA device (as on the CPU test host)
and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports no jax (the GPU machine has none)."""

import numpy as np
import pytest
import torch

from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                 greedy_nms_keep_cuda)
from efficientteacher_torch.ops.select_cuda import (
    check_exact_topk, exact_topk_elems, exact_topk_rows, threshold_compact,
    threshold_compact_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fields(rng, k, n_valid):
    """Overlapping xyxy boxes in score order; prefix and holed masks."""
    xy = rng.uniform(0, 300, (2, k, 2))
    wh = rng.uniform(10, 90, (2, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.zeros((2, k), bool)
    valid[:, :n_valid] = True
    valid[1, rng.choice(n_valid, n_valid // 3, replace=False)] = False
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.parametrize("k,n_valid", [(2048, 700), (30208, 3000)])
def test_nms_kernel_matches_plain(card, k, n_valid):
    boxes, valid = _fields(np.random.default_rng(k), k, n_valid)
    boxes, valid = boxes.to(card), valid.to(card)
    for tile in (128, 256):
        for stop_at in (None, 300):
            before = greedy_nms_keep_cuda.launches
            got = greedy_nms_keep_cuda(boxes, valid, 0.6, tile, stop_at)
            assert greedy_nms_keep_cuda.launches == before + 1
            ref = greedy_nms_keep(boxes, valid, 0.6, tile, stop_at)
            assert torch.equal(got, ref)


def test_nms_kernel_rejects_bad_input(card):
    boxes = torch.zeros(1, 256, 4, device=card)
    valid = torch.zeros(1, 256, dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        greedy_nms_keep_cuda(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        greedy_nms_keep_cuda(boxes, valid, 0.5, tile=512)
    with pytest.raises(ValueError):
        greedy_nms_keep_cuda(boxes, valid.cpu(), 0.5)


def test_compact_kernel_matches_plain(card):
    rng = np.random.default_rng(2)
    sc = np.full((3, 300001), -1.0, np.float32)
    for i, npos in enumerate((0, 7000, 250000)):
        pos = rng.choice(sc.shape[1], npos, replace=False)
        sc[i, pos] = rng.uniform(1e-4, 1.0, npos)
    scores = torch.from_numpy(sc).to(card)
    lo = torch.tensor([0.0, 0.3, 0.0], device=card)
    hi = torch.full((3,), float("inf"), device=card)
    for cap in (1, 4096, 62848):
        before = threshold_compact_cuda.launches
        ks, ki = threshold_compact_cuda(scores, lo, hi, cap)
        assert threshold_compact_cuda.launches == before + 1
        ps, pi = threshold_compact(scores, lo, hi, cap)
        assert torch.equal(ks, ps) and torch.equal(ki, pi)
    for engine in (exact_topk_rows, exact_topk_elems):
        ts, ti = engine(scores, 30000)
        check_exact_topk(scores, 30000, ts, ti)
