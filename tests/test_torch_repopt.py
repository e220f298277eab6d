"""RepOpt in the PyTorch port (`train/repopt.py`) against the JAX package's
`train/repopt.py`, mirroring
tests/test_repopt_multiteacher.py::test_extract_scales_and_masks: on the
same parameters (the JAX variables carried by the bridge), the scales, the
gradient masks and the re-initialised 3x3 kernels are JAX's, block for
block, for single blocks and for the YOLOv6-s RealVGG model with a
LinearAdd model's scales; the port's scales also come back from a port
checkpoint (`load_repscale_scales`).

Tolerances: scales and masks exact (the same float32 products); the
re-initialised kernels 1e-6 of their largest entry (the same numpy
draws, scaled in float32 by torch and by numpy)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg
from efficientteacher_tpu.models import Model as JaxModel
from efficientteacher_tpu.models.common import (
    LinearAddBlock as JaxLinearAdd, RealVGGBlock as JaxRealVGG)
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec
from efficientteacher_tpu.train import repopt as jax_repopt
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.models.common import LinearAddBlock, RealVGGBlock
from efficientteacher_torch.train import repopt
from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                     save_checkpoint)
from efficientteacher_torch.utils.jax_import import (_torch_path,
                                                     state_dict_from_jax)

from torch_port_helpers import one_torch_thread  # noqa: F401

PUBLIC = Path(__file__).resolve().parents[1] / "configs/sup/public"


def _port_name(jax_key):
    return ".".join(_torch_path(jax_key.split("/")))


def _init(module, x, seed):
    v = jax.jit(lambda k: module.init(k, x, train=False))(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, v)


def _scaled(params, rng):
    """LinearAdd scales drawn away from their init of 1."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.uniform(0.2, 2.0, v.shape).astype(np.float32)
                        if k.startswith("scale_") else walk(v))
                    for k, v in node.items()}
        return node
    return walk(params)


def _assert_scales(got, want):
    assert set(got) == {_port_name(k) for k in want}
    for k, sc in want.items():
        g = got[_port_name(k)]
        assert len(g) == len(sc)
        for a, b in zip(g, sc):
            np.testing.assert_array_equal(a.numpy(), b)


def _assert_masks(model, masks, jax_masks):
    """The port's mask list against JAX's mask tree (HWIO arrays at the
    masked kernels, 1.0 elsewhere), by parameter name; returns the number
    of masked kernels."""
    want = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif np.ndim(node) == 4:
            key = ".".join(_torch_path(path[:-1]) + ["weight"])
            want[key] = np.asarray(node).transpose(3, 2, 0, 1)
        else:
            assert node == 1.0, path

    walk(jax_masks, [])
    named = [n for n, _ in model.named_parameters()]
    assert len(masks) == len(named)
    got = {n: m for n, m in zip(named, masks) if m is not None}
    assert set(got) == set(want)
    for name, m in got.items():
        np.testing.assert_array_equal(m.numpy(), want[name], err_msg=name)
    return len(got)


@pytest.mark.parametrize("c1,s", [(8, 1), (4, 2)],
                         ids=["identity", "no_identity"])
def test_extract_scales_and_masks_match_jax(c1, s):
    rng = np.random.default_rng(0)
    x = jnp.zeros((1, 8, 8, c1))
    lv = _init(JaxLinearAdd(8, s=s), x, 0)
    lp = {"blk": _scaled(lv["params"], rng)}
    want = jax_repopt.extract_scales(lp)
    assert len(want["blk"]) == (3 if s == 1 and c1 == 8 else 2)
    la = torch.nn.Module()
    la.blk = LinearAddBlock(c1, 8, s=s)
    la.load_state_dict(state_dict_from_jax(lp, {"blk": lv["batch_stats"]}),
                       strict=True)
    scales = repopt.extract_scales(dict(la.named_parameters()))
    _assert_scales(scales, want)

    rv = _init(JaxRealVGG(8, s=s), x, 1)
    params = {"blk": rv["params"]}
    jmasks = jax_repopt.build_grad_masks(params, want)
    model = torch.nn.Module()
    model.blk = RealVGGBlock(c1, 8, s=s)
    model.load_state_dict(state_dict_from_jax(
        params, {"blk": rv["batch_stats"]}), strict=True)
    masks = repopt.build_grad_masks(model, scales)
    assert _assert_masks(model, masks, jmasks) == 1
    m = masks[0]
    assert (m[:, :, 1, 1] >= m[:, :, 0, 0]).all()
    grads = [torch.ones_like(p) for p in model.parameters()]
    got = repopt.apply_grad_masks(grads, masks)
    np.testing.assert_array_equal(got[0].numpy(), m.numpy())
    assert all(g.eq(1).all() for g in got[1:])    # the BN passes

    jk = jax_repopt.reinitialize_from_scales(params, want,
                                             np.random.default_rng(3))
    repopt.reinitialize_from_scales(model, scales, np.random.default_rng(3))
    k = state_dict_from_jax(jk, {})["blk.conv.weight"].numpy()
    np.testing.assert_allclose(model.blk.conv.weight.detach().numpy(), k,
                               rtol=0, atol=1e-6 * np.abs(k).max())


def _cfg(**model):
    cfg = get_cfg()
    cfg.merge_from_file(str(PUBLIC / "yolov6s_coco_repopt_finetune.yaml"))
    cfg.merge_from_list(["Model.width_multiple", 0.25,
                         "Model.depth_multiple", 0.33, "Dataset.nc", 8,
                         "Dataset.img_size", 64])
    for k, v in model.items():
        cfg.merge_from_list([f"Model.{k}", v])
    return cfg


def test_yolov6s_realvgg_model_matches_jax(tmp_path):
    """The whole RealVGG YOLOv6-s with a LinearAdd YOLOv6-s's scales, as
    the JAX trainer builds it (its trees after `jax.tree.map`, keys
    sorted): every RealVGG block has a mask, and the masks and the
    re-initialised kernels are JAX's; the scales read back from a port
    checkpoint equal the model's."""
    x = jnp.zeros((1, 64, 64, 3))
    lcfg = _cfg(RealVGGModel=False, LinearAddModel=True)
    lv = _init(JaxModel(spec=jax_spec(lcfg)), x, 0)
    lparams = jax.tree.map(np.asarray, _scaled(lv["params"],
                                               np.random.default_rng(1)))
    want = jax_repopt.extract_scales(lparams)
    la = build_model(spec_from_cfg(lcfg), device="cpu")
    la.load_state_dict(state_dict_from_jax(lparams, lv["batch_stats"]),
                       strict=True)
    v = module_variables(la)
    save_checkpoint(tmp_path / "repscale.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"], half=False)
    scales = repopt.load_repscale_scales(str(tmp_path / "repscale.ckpt"))
    _assert_scales(scales, want)

    cfg = _cfg()
    rv = _init(JaxModel(spec=jax_spec(cfg)), x, 2)
    params = jax.tree.map(np.asarray, rv["params"])
    model = build_model(spec_from_cfg(cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, rv["batch_stats"]),
                          strict=True)
    jmasks = jax_repopt.build_grad_masks(params, want)
    masks = repopt.build_grad_masks(model, scales)
    n_blocks = sum(isinstance(m, RealVGGBlock) for m in model.modules())
    assert _assert_masks(model, masks, jmasks) == n_blocks == len(want)

    jk = state_dict_from_jax(jax_repopt.reinitialize_from_scales(
        params, want), {})
    repopt.reinitialize_from_scales(model, scales)
    for name, t in model.state_dict().items():
        if name.endswith("conv.weight"):
            k = jk[name].numpy()
            np.testing.assert_allclose(t.numpy(), k, rtol=0,
                                       atol=1e-6 * np.abs(k).max(),
                                       err_msg=name)


def test_load_repscale_scales_refuses_a_model_without_scales(tmp_path):
    model = build_model(spec_from_cfg(_cfg()), device="cpu")
    v = module_variables(model)
    save_checkpoint(tmp_path / "plain.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"])
    with pytest.raises(ValueError, match="LinearAddModel"):
        repopt.load_repscale_scales(str(tmp_path / "plain.ckpt"))
