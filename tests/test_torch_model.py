"""PyTorch port, YOLOv5 model: forward and decode against the JAX package,
full-width state_dict structure, and the weight bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.models import Model as JaxModel
from efficientteacher_tpu.models.spec import ModelSpec as JaxModelSpec
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec_from_cfg
from efficientteacher_tpu.utils.torch_import import export_to_torch_state_dict
from efficientteacher_torch.models import Model, build_model, spec_from_cfg
from efficientteacher_torch.utils.eval_regimes import yolov5l_spec
from efficientteacher_torch.utils.jax_import import state_dict_from_jax

from torch_port_helpers import jax_and_port_models, yolov5_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def small():
    return jax_and_port_models(yolov5_cfg())


def test_forward_and_decode_match_jax(small):
    """fp32, width 0.25 / depth 0.33 / nc 8 / 64 px. Tolerances: fp32 convs
    sum in another order in XLA and in PyTorch, so raw maps may differ by
    1e-4 * max(1, max|ref|); decoded scores (sigmoids) by 1e-5; decoded
    xywh (pixels, up to stride 32 times a sigmoid) by 1e-3 px."""
    jm, variables, port = small
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    decoded_j, raw_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        decoded_t, raw_t = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(raw_t) == len(raw_j) == 3
    for rj, rt in zip(raw_j, raw_t):
        rj = np.asarray(rj).transpose(0, 3, 1, 2, 4)  # -> (B, na, ny, nx, no)
        assert rt.shape == rj.shape
        tol = 1e-4 * max(1.0, float(np.abs(rj).max()))
        np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=tol)
    decoded_j = np.asarray(decoded_j)
    assert decoded_t.shape == decoded_j.shape == (2, 3 * (64 + 16 + 4), 13)
    np.testing.assert_allclose(decoded_t[..., :4].numpy(), decoded_j[..., :4],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(decoded_t[..., 4:].numpy(), decoded_j[..., 4:],
                               rtol=0, atol=1e-5)


def test_train_mode_returns_raw_maps():
    port = build_model(spec_from_cfg(yolov5_cfg()), device="cpu",
                       generator=torch.Generator().manual_seed(0)).train()
    raw = port(torch.zeros(2, 3, 64, 64))
    assert [tuple(r.shape) for r in raw] == [
        (2, 3, 8, 8, 13), (2, 3, 4, 4, 13), (2, 3, 2, 2, 13)]


def test_yolov5l_state_dict_structure_matches_jax():
    """Full width (YOLOv5l, nc 80), without a forward: the port's state_dict
    has exactly the keys and shapes of the JAX export of
    jax.eval_shape(model.init), plus BatchNorm's num_batches_tracked."""
    model = JaxModel(spec=JaxModelSpec())
    shapes = jax.eval_shape(
        lambda key, x: model.init(key, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    exported = export_to_torch_state_dict(zeros["params"],
                                          zeros["batch_stats"])
    port = Model(yolov5l_spec()).state_dict()
    bn_counters = {k for k in port if k.endswith("num_batches_tracked")}
    assert set(port) - bn_counters == set(exported)
    assert {k.rsplit(".", 1)[0] for k in bn_counters} == {
        k.rsplit(".", 1)[0] for k in exported if k.endswith("running_mean")}
    for k, v in exported.items():
        assert tuple(port[k].shape) == v.shape, k
    assert sum(v.numel() for k, v in port.items()
               if k not in bn_counters and "running" not in k) > 46_000_000


def test_bridge_equals_jax_export(small):
    """state_dict_from_jax gives what efficientteacher_tpu's
    export_to_torch_state_dict gives, key for key and bit for bit, plus a
    zero num_batches_tracked per BatchNorm."""
    _, variables, _ = small
    ours = state_dict_from_jax(variables["params"], variables["batch_stats"])
    theirs = export_to_torch_state_dict(variables["params"],
                                        variables["batch_stats"])
    counters = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - counters == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert all(int(ours[k]) == 0 for k in counters)


@pytest.mark.parametrize("width,depth,nc", [(0.25, 0.33, 8), (1.0, 1.0, 80),
                                            (0.5, 0.33, 3)])
def test_spec_from_cfg_matches_jax(width, depth, nc):
    cfg = yolov5_cfg(width, depth, nc, 320)
    assert dataclasses.asdict(spec_from_cfg(cfg)) == dataclasses.asdict(
        jax_spec_from_cfg(cfg))


def test_yolov5l_spec_is_jax_default():
    assert dataclasses.asdict(yolov5l_spec()) == dataclasses.asdict(
        JaxModelSpec())


def test_seeded_init_is_reproducible_and_has_focal_prior_bias():
    spec = spec_from_cfg(yolov5_cfg())
    a = build_model(spec, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = build_model(spec, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    bias = a.head.m[0].bias.detach().view(3, 13)
    np.testing.assert_allclose(bias[:, 4].numpy(), np.log(8 / 80 ** 2),
                               rtol=1e-6)
    np.testing.assert_allclose(bias[:, 5:].numpy(), np.log(0.6 / 7.01),
                               rtol=1e-6)


def test_build_model_defaults_to_the_card():
    """Without a card, the default raises and device="cpu" builds; with
    one, the default builds on it."""
    spec = spec_from_cfg(yolov5_cfg())
    if torch.cuda.is_available():
        model = build_model(spec)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(spec)
    model = build_model(spec, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
