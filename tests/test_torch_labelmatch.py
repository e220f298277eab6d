"""LabelMatch in the PyTorch port (`efficientteacher_torch/ssod/labelmatch.py`)
against sklearn and the JAX package.

The port's two-component 1-D Gaussian mixture is held to sklearn's
`GaussianMixture(2, weights_init, means_init, precisions_init)` (the fit
JAX's `gmm_policy` runs) on seeded bimodal, skewed and degenerate score
sets: the fitted weights, means and precisions, `score_samples` within
1e-6, the iteration count, convergence and `predict` exactly. `gmm_policy`
and `LabelMatch.update_epoch_cls_thr` are held exactly to JAX's on the
same collected scores, over two refreshes (the class totals carry over),
with an empty class and a class with fewer than four scores."""

import numpy as np
import pytest

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.ssod import labelmatch as jax_lm
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.ssod import labelmatch as lm


def _score_sets():
    rng = np.random.default_rng(0)
    bimodal = np.concatenate([rng.normal(0.35, 0.05, 300),
                              rng.normal(0.8, 0.06, 120)])
    skewed = rng.beta(2.0, 6.0, 500)
    few = rng.uniform(0.3, 0.9, 6)
    return {
        "bimodal": np.clip(bimodal, 0.01, 0.999),
        "skewed": skewed,
        "few": few,
        "two_values": np.array([0.4] * 7 + [0.9] * 3),
        "constant": np.full(12, 0.55),
        "float32_scores": rng.uniform(0.3, 1.0, 200).astype(np.float32),
    }


SETS = _score_sets()


@pytest.mark.parametrize("name", list(SETS))
def test_gmm_is_sklearns(name):
    mixture = pytest.importorskip("sklearn.mixture")
    s = np.asarray(SETS[name], np.float64)
    x = s.reshape(-1, 1)
    want = mixture.GaussianMixture(
        2, weights_init=[0.5, 0.5], means_init=[[s.min()], [s.max()]],
        precisions_init=[[[1.0]], [[1.0]]]).fit(x)
    got = lm.GaussianMixture1D([0.5, 0.5], [s.min(), s.max()],
                               [1.0, 1.0]).fit(s)
    assert got.n_iter == want.n_iter_ and got.converged == want.converged_
    np.testing.assert_allclose(got.weights, want.weights_, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.means, want.means_[:, 0], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.prec_chol ** 2, want.precisions_[:, 0, 0],
                               rtol=1e-9)
    np.testing.assert_array_equal(got.predict(s), want.predict(x))
    np.testing.assert_allclose(got.score_samples(s), want.score_samples(x),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("policy", ["high", "low"])
@pytest.mark.parametrize("name", list(SETS))
def test_gmm_policy_is_jaxs(name, policy):
    pytest.importorskip("sklearn.mixture")  # JAX's gmm_policy fits sklearn's
    s = np.sort(np.asarray(SETS[name], np.float64))[::-1]
    for given in (0.0, 0.5):
        assert lm.gmm_policy(s, given, policy) == \
            jax_lm.gmm_policy(s, given, policy)
    assert lm.gmm_policy(s[:3], 0.25) == 0.25  # fewer than 4 scores


def _cfgs():
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.SSOD.ignore_thres_high = 0.6
        cfg.SSOD.ignore_thres_low = 0.1
        cfg.SSOD.resample_low_percent = 0.3
        out.append(cfg)
    return out


def _batches(rng, n, nc):
    """(conf, cls) batches as the trainer collects them: (B, max_pl),
    zero where the NMS row is padding; class nc - 1 never appears and class
    nc - 2 at most three times."""
    out = []
    for _ in range(n):
        conf = rng.uniform(0.05, 1.0, (4, 16)).astype(np.float32)
        conf[rng.uniform(size=conf.shape) < 0.3] = 0.0
        cls = rng.integers(0, nc - 2, conf.shape).astype(np.float32)
        out.append((conf, cls))
    conf, cls = out[0]
    cls[0, :3] = nc - 2
    conf[0, :3] = [0.9, 0.7, 0.8]
    return out


def test_update_epoch_cls_thr_is_jaxs():
    pytest.importorskip("sklearn.mixture")
    nc = 5
    ratio = np.full(nc, 1.0 / nc)
    jcfg, pcfg = _cfgs()
    want = jax_lm.LabelMatch(jcfg, 64, 3.5, ratio)
    got = lm.LabelMatch(pcfg, 64, 3.5, ratio)
    rng = np.random.default_rng(3)
    for epoch in range(2):
        for conf, cls in _batches(rng, 6, nc):
            want.collect(conf, cls)
            got.collect(conf, cls)
        if epoch == 0:  # a resumed LabelMatch mid-epoch: same state
            again = lm.LabelMatch(pcfg, 64, 3.5, ratio)
            again.load_state_dict(got.state_dict())
        want.update_epoch_cls_thr(epoch)
        got.update_epoch_cls_thr(epoch)
        if epoch == 0:
            again.update_epoch_cls_thr(epoch)
            np.testing.assert_array_equal(again.cls_thr_high,
                                          got.cls_thr_high)
            np.testing.assert_array_equal(again.cls_thr_low, got.cls_thr_low)
        np.testing.assert_array_equal(got.cls_thr_high, want.cls_thr_high)
        np.testing.assert_array_equal(got.cls_thr_low, want.cls_thr_low)
        np.testing.assert_array_equal(got.cls_num_total, want.cls_num_total)
        assert got.cls_thr_high.dtype == np.float32
        # the empty class keeps the ignore thresholds
        assert got.cls_thr_high[-1] == np.float32(0.6)
        assert got.cls_thr_low[-1] == np.float32(0.1)
    assert not np.allclose(got.cls_thr_high[:3], 0.6)
    assert all(not parts for parts in got.score_list_epoch)
