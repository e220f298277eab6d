"""PyTorch port, candidate selection: the threshold compaction (K2's plain
version and its wrapper) and the two exact top-k engines over it, against
jax.lax.top_k and, on two cases, against the JAX engines with their Pallas
kernel in interpret mode.

What is compared is the exactness contract of select_pallas.py's
docstring: the same score multiset (bit for bit) and the same membership of
every tie class strictly above the k-th score. The order among bit-equal
scores is not part of it: torch.topk fixes none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.ops.select_pallas import (
    exact_topk_elems as jax_topk_elems, exact_topk_rows as jax_topk_rows)
from efficientteacher_torch.ops.select_cuda import (
    check_exact_topk, exact_topk_elems, exact_topk_rows, threshold_compact,
    threshold_compact_cuda)

_N = 65536  # 512 rows of 128: the row engine compacts (r1 = 256 rows)
_ENGINES = {"rows": exact_topk_rows, "elems": exact_topk_elems}


def _masked(rng, b, n, npos_per_row):
    sc = np.full((b, n), -1.0, np.float32)
    for i, npos in enumerate(npos_per_row):
        pos = rng.choice(n, npos, replace=False)
        sc[i, pos] = rng.uniform(1e-4, 1.0, npos).astype(np.float32)
    return sc


def _clustered(rng, b, n, runs, run_len=80):
    """Hot-anchor-like clustering: runs of consecutive live lanes."""
    sc = np.full((b, n), -1.0, np.float32)
    for i in range(b):
        for s in rng.choice(n - run_len, runs, replace=False):
            sc[i, s:s + run_len] = rng.uniform(
                1e-4, 1.0, run_len).astype(np.float32)
    return sc


def _assert_contract_vs_jax(scores, k, ts, ti, ref_s, ref_i):
    """Scores bit-identical to JAX's; identical tie-class membership above
    the k-th score (as index sets); every returned candidate genuine."""
    ts, ti = ts.numpy(), ti.numpy()
    np.testing.assert_array_equal(ts, ref_s)
    for i in range(scores.shape[0]):
        kth = max(float(ref_s[i, -1]), 0.0)
        ours = set(ti[i][ts[i] > kth].tolist())
        theirs = set(ref_i[i][ref_s[i] > kth].tolist())
        assert ours == theirs
        real = ts[i] > 0
        np.testing.assert_array_equal(scores[i, ti[i][real]], ts[i][real])
        assert len(set(ti[i][real].tolist())) == int(real.sum())


def _check(engine, scores, k):
    ts, ti = engine(torch.from_numpy(scores), k)
    rs, ri = map(np.asarray, jax.lax.top_k(jnp.asarray(scores), k))
    _assert_contract_vs_jax(scores, k, ts, ti, rs, ri)
    check_exact_topk(torch.from_numpy(scores), k, ts, ti)


def _cases():
    rng = np.random.default_rng(0)
    ties = np.full((2, _N), -1.0, np.float32)
    ties[0, ::2] = 0.5                        # 32768 identical scores
    ties[1, 100:3100] = 0.25                  # 3000 identical scores ...
    ties[1, 5] = 0.9                          # ... and one clear winner
    mixed = _clustered(rng, 2, _N, runs=30)
    mixed[0, 1000:1900] = 0.123               # tie block inside a live region
    bisect_ties = _masked(rng, 1, 262144, [150000])
    bisect_ties[0, 10000:60000] = 0.5         # 50k-wide tie class
    degenerate = np.full((1, 262144), -1.0, np.float32)
    degenerate[0, ::2] = 0.25                 # more equal scores than a buffer
    boundary = []
    for rows in (255, 256, 257, 300):         # live rows around r1 = 256
        sc = np.full((1, _N), -1.0, np.float32)
        for rr in rng.choice(_N // 128, rows, replace=False):
            sc[0, rr * 128 + 3] = np.float32(rng.uniform(0.1, 1.0))
        boundary.append(sc)
    return {
        "sparse": (_clustered(rng, 3, _N, runs=12), 1000),
        "spread": (_masked(rng, 2, _N, [5000, 20000]), 1000),
        "dense": (_masked(rng, 1, 262144, [150000]), 500),
        "bisect_mixed": (_masked(rng, 2, 262144, [200000, 2000]), 500),
        "bisect_ties": (bisect_ties, 500),
        "degenerate": (degenerate, 500),
        "ties_at_k": (ties, 256),
        "mixed_ties": (mixed, 256),
        "row_boundaries": (np.concatenate(boundary), 1000),
        "empty": (np.full((2, _N), -1.0, np.float32), 128),
        "small_lattice": (_masked(rng, 2, 4096, [100, 1000]), 512),
        "unpadded_n": (_clustered(rng, 2, 65519, runs=10), 500),
    }


_CASES = _cases()


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("engine", sorted(_ENGINES))
def test_engine_matches_lax_top_k(engine, case):
    scores, k = _CASES[case]
    _check(_ENGINES[engine], scores, k)


@pytest.mark.parametrize("engine", sorted(_ENGINES))
def test_engine_matches_jax_engine_in_interpret_mode(engine):
    """Against the JAX engine itself (its Pallas compaction interpreted on
    the CPU), on a clustered and a tie-heavy lattice."""
    jax_engine = {"rows": jax_topk_rows, "elems": jax_topk_elems}[engine]
    rng = np.random.default_rng(21)
    sc = _clustered(rng, 2, _N, runs=12)
    sc[1, 4000:4900] = 0.123
    for k in (1000, 256):
        rs, ri = map(np.asarray,
                     jax_engine(jnp.asarray(sc), k, interpret=True))
        ts, ti = _ENGINES[engine](torch.from_numpy(sc), k)
        _assert_contract_vs_jax(sc, k, ts, ti, rs, ri)


def _compact_reference(scores, lo, hi, cap):
    out_s = np.full((scores.shape[0], cap), -1.0, np.float32)
    out_i = np.full((scores.shape[0], cap), -1, np.int32)
    for i, row in enumerate(scores):
        idx = np.nonzero((row >= lo[i]) & (row <= hi[i]))[0][:cap]
        out_s[i, :len(idx)] = row[idx]
        out_i[i, :len(idx)] = idx
    return out_s, out_i


@pytest.mark.parametrize("cap", [1, 700, 5000, 70000])
def test_threshold_compact_matches_numpy(cap):
    """Survivors in ascending index order, the cap dropping later indices
    first, -1 padding; per-image thresholds, ties at both ends kept."""
    rng = np.random.default_rng(cap)
    scores = _masked(rng, 3, 60001, [0, 3000, 60001])
    scores[1, 10:20] = 0.25
    lo = np.array([0.0, 0.25, 0.5], np.float32)
    hi = np.array([np.inf, 0.9, 0.5 + 2 ** -10], np.float32)
    got_s, got_i = threshold_compact(torch.from_numpy(scores),
                                     torch.from_numpy(lo),
                                     torch.from_numpy(hi), cap)
    ref_s, ref_i = _compact_reference(scores, lo, hi, cap)
    np.testing.assert_array_equal(got_s.numpy(), ref_s)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    assert got_i.dtype == torch.int32


def test_compact_wrapper_on_cpu_runs_plain_version_without_launch():
    scores = torch.from_numpy(_masked(np.random.default_rng(4), 2, 9000,
                                      [100, 5000]))
    lo, hi = torch.zeros(2), torch.full((2,), float("inf"))
    before = threshold_compact_cuda.launches
    a = threshold_compact_cuda(scores, lo, hi, 1000)
    b = threshold_compact(scores, lo, hi, 1000)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert threshold_compact_cuda.launches == before

