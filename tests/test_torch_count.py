"""PyTorch port, the element engine's counts: the plain `_count_ge` (the
multi-threshold count kernel's plain version) against the JAX package's
`select_pallas._count_ge`, the wrapper on CPU tensors, the candidate total
through the count, and the engines' tiers through the new count path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.ops.select_pallas import _count_ge as jax_count_ge
from efficientteacher_torch.ops import select_cuda
from efficientteacher_torch.ops.select_cuda import (
    _TINY, _count_ge, check_exact_topk, count_ge_cuda, exact_topk_elems,
    exact_topk_rows)


def _lattice(rng, b, n, live):
    """Masked lattice: -1 padding, `live` candidates per image in
    [1e-4, 1)."""
    sc = np.full((b, n), -1.0, np.float32)
    for i in range(b):
        pos = rng.choice(n, live, replace=False)
        sc[i, pos] = rng.uniform(1e-4, 1.0, live).astype(np.float32)
    return sc


def _taus(rng, scores, t):
    """Per-image thresholds: half drawn from the image's own scores (ties),
    the rest uniform, plus -1 (the padding value) where t allows."""
    b = scores.shape[0]
    taus = rng.uniform(0.0, 1.0, (b, t)).astype(np.float32)
    for i in range(b):
        live = scores[i][scores[i] > 0]
        for k in range(0, t, 2):
            if live.size:
                taus[i, k] = live[rng.integers(live.size)]
    if t > 2:
        taus[:, -1] = -1.0
    return np.sort(taus, 1)


@pytest.mark.parametrize("t", [1, 2, 5, 8])
@pytest.mark.parametrize("n,live", [(4096, 0), (30001, 3000), (65536, 65536)])
def test_count_ge_matches_jax(t, n, live):
    rng = np.random.default_rng(n + t)
    scores = _lattice(rng, 3, n, live)
    scores[0, :50] = 0.5                       # a tie class ...
    taus = _taus(rng, scores, t)
    taus[0, 0] = 0.5                           # ... on a threshold
    got = _count_ge(torch.from_numpy(scores), torch.from_numpy(taus))
    ref = np.asarray(jax_count_ge(jnp.asarray(scores), jnp.asarray(taus)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_count_ge_wrapper_on_cpu_runs_plain_version_without_launch():
    rng = np.random.default_rng(7)
    scores = torch.from_numpy(_lattice(rng, 2, 9000, 4000))
    taus = torch.from_numpy(_taus(rng, scores.numpy(), 8))
    before = count_ge_cuda.launches
    assert torch.equal(count_ge_cuda(scores, taus), _count_ge(scores, taus))
    assert count_ge_cuda.launches == before


def test_total_through_count_equals_positive_count():
    """The element engine counts candidates as s >= 2^-149: the same as
    s > 0, with zeros, negative zeros and subnormals in the lattice."""
    rng = np.random.default_rng(3)
    scores = _lattice(rng, 2, 5000, 1000)
    scores[0, :4] = [0.0, -0.0, np.float32(_TINY), np.float32(2 * _TINY)]
    scores[1, :2] = [-np.float32(_TINY), 1e-40]
    s = torch.from_numpy(scores)
    tiny = torch.full((2, 1), _TINY)
    assert float(tiny[0, 0]) > 0.0
    assert torch.equal(count_ge_cuda(s, tiny)[:, 0],
                       (s > 0.0).sum(1, dtype=torch.int32))


def _tiers(engine, scores, k):
    select_cuda.tier_counts.clear()
    ts, ti = engine(torch.from_numpy(scores), k)
    check_exact_topk(torch.from_numpy(scores), k, ts, ti)
    return dict(select_cuda.tier_counts)


def test_engine_tiers_through_the_count_path():
    """Which tier each call takes, with the exact top-k contract on each:
    bisection through the counts, tau 0, the row tiers, and the tie tier on
    a spectrum no threshold can split."""
    rng = np.random.default_rng(11)
    dense = _lattice(rng, 2, 262144, 150000)
    assert _tiers(exact_topk_elems, dense, 500) == {"elems:bisect": 1}
    assert _tiers(exact_topk_rows, dense, 500) == {
        "rows:to_elems": 1, "elems:bisect": 1}
    sparse = _lattice(rng, 2, 262144, 3000)
    assert _tiers(exact_topk_elems, sparse, 500) == {"elems:tau0": 1}
    few_rows = np.full((2, 65536), -1.0, np.float32)
    few_rows[:, 128:256] = 0.25
    assert _tiers(exact_topk_rows, few_rows, 1000) == {"rows:r1": 1}
    flat = np.full((1, 262144), -1.0, np.float32)
    flat[0, ::2] = 0.25                  # more equal scores than a buffer
    assert _tiers(exact_topk_elems, flat, 500) == {"elems:ties": 1}
    small = _lattice(rng, 1, 4096, 100)
    assert _tiers(exact_topk_elems, small, 512) == {"elems:topk": 1}


def _spectrum(name):
    """(1 or 2, 262144) lattices that the value grid cannot split."""
    rng = np.random.default_rng(13)
    sc = np.full((2, 262144), -1.0, np.float32)
    if name == "ties_below_some":   # 200 above a tie class of 100000
        sc[0, rng.choice(262144, 200, replace=False)] = rng.uniform(
            0.5, 1.0, 200)
        sc[0, 1::2][:100000][sc[0, 1::2][:100000] < 0] = 0.25
    elif name == "ties_at_max":     # the top score ties > cap times
        sc[0, 3::2] = 0.75
    elif name == "ties_beside_bisect":  # image 1 takes a plain tau
        sc[0, ::2] = 0.25
        sc[1] = _lattice(rng, 1, 262144, 150000)[0]
    elif name == "narrow_window":   # distinct scores 1 ulp apart, one huge
        run = np.arange(100000, dtype=np.int32) + np.float32(0.5).view(
            np.int32)
        sc[0, rng.permutation(262144)[:100000]] = run.view(np.float32)
        sc[0, 7] = 1e30
    return sc[:1] if name in ("ties_below_some", "ties_at_max",
                              "narrow_window") else sc


@pytest.mark.parametrize("name,tier", [
    ("ties_below_some", "elems:ties"), ("ties_at_max", "elems:ties"),
    ("ties_beside_bisect", "elems:ties"), ("narrow_window", "elems:bisect")])
def test_bit_bisection_and_tie_tier_equal_full_topk(name, tier):
    """Where the value grid finds no tau, the engine bisects the float bit
    patterns: it finds a window, or narrows to the k-th score and compacts
    the scores above it and its tie class apart. Either way the answer is
    the lowest-index-first top-k of the whole lattice, index for index."""
    from efficientteacher_torch.assigners.topk import topk_lower_index_first
    scores = _spectrum(name)
    k = 500
    assert _tiers(exact_topk_elems, scores, k) == {tier: 1}
    s = torch.from_numpy(scores)
    ts, ti = exact_topk_elems(s, k)
    rs, ri = topk_lower_index_first(s, k)
    assert torch.equal(ts, rs)
    assert torch.equal(ti, torch.where(rs > 0.0, ri.long(), 0))
