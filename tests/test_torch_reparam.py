"""RepVGG deploy fusion in the PyTorch port (`utils/reparam.py`), mirroring
tests/test_reparam.py: the fused single-conv block and the fused model
reproduce the trained multi-branch ones in eval mode, and the port's
fusion equals the JAX package's `fuse_repvgg_tree` through the weight
bridge.

Tolerances, each of the largest entry compared: conv + BN folding 1e-5;
the fused block against the unfused one 1e-5 (float32 summation order
differs); the fused YOLOv6 / YOLOv7 models' decoded outputs against the
unfused 1e-4 (rounding accumulates through ~30 fused layers; boxes are
pixels, up to ~10^3); the port's fused tensors against JAX's 1e-6."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from efficientteacher_tpu.configs import get_cfg
from efficientteacher_tpu.models import Model as JaxModel
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec
from efficientteacher_tpu.utils.reparam import fuse_repvgg_tree
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.models.common import RepVGGBlock
from efficientteacher_torch.utils.jax_import import state_dict_from_jax
from efficientteacher_torch.utils.reparam import (deploy_model, fuse_conv_bn,
                                                  fuse_repvgg_state_dict)

from torch_port_helpers import one_torch_thread  # noqa: F401

PUBLIC = Path(__file__).resolve().parents[1] / "configs/sup/public"


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=what)


def _randomize_bn(module, seed):
    """BN statistics and affine drawn away from their init, so the fusion
    is not trivial."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.weight, m.running_var):
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.randn(t.shape, generator=g) * 0.2)


def test_fuse_conv_bn_math():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 4, 3, 3, generator=g) * 0.1
    scale, var = torch.rand(8, generator=g) + 0.5, torch.rand(8, generator=g)
    bias, mean = torch.randn(8, generator=g) * 0.1, torch.randn(8, generator=g)
    x = torch.randn(1, 4, 8, 8, generator=g)
    want = F.batch_norm(F.conv2d(x, w, padding=1), mean, var, scale, bias,
                        False, 0.0, 1e-3)
    wf, bf = fuse_conv_bn(w, scale, bias, mean, var, 1e-3)
    _close(F.conv2d(x, wf, bf, padding=1), want, 1e-5)


@pytest.mark.parametrize("c2,s", [(8, 1), (12, 1), (8, 2)],
                         ids=["identity", "no_identity_c", "no_identity_s"])
def test_repvgg_block_fusion(c2, s):
    """Trained 3-branch block == fused single-conv block, elementwise."""
    block = RepVGGBlock(8, c2, s=s, act="relu")
    torch.nn.init.normal_(block.rbr_dense_conv.weight, 0, 0.2)
    torch.nn.init.normal_(block.rbr_1x1_conv.weight, 0, 0.2)
    _randomize_bn(block, 1)
    x = torch.randn(2, 8, 16, 16, generator=torch.Generator().manual_seed(2))
    want = block.eval()(x)
    sd = fuse_repvgg_state_dict({f"b.{k}": v for k, v in
                                 block.state_dict().items()})
    assert set(sd) == {"b.rbr_reparam.weight", "b.rbr_reparam.bias"}
    deploy = RepVGGBlock(8, c2, s=s, act="relu", deploy=True)
    deploy.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    _close(deploy.eval()(x).detach(), want.detach(), 1e-5)


def _cfg(yaml, width=0.25, depth=0.33):
    cfg = get_cfg()
    cfg.merge_from_file(str(PUBLIC / yaml))
    cfg.merge_from_list(["Model.width_multiple", width,
                         "Model.depth_multiple", depth, "Dataset.nc", 8,
                         "Dataset.img_size", 64])
    return cfg


@pytest.mark.parametrize("yaml", ["yolov6s_coco.yaml", "yolov7l_coco.yaml"])
def test_full_model_fusion(yaml):
    """Whole YOLOv6-s / YOLOv7-L (RepConv outputs) model: the deploy model
    reproduces the trained one's decoded and raw outputs in eval mode."""
    model = build_model(spec_from_cfg(_cfg(yaml)), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    _randomize_bn(model, 3)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want, want_raw = model.eval()(x)
        fused = deploy_model(model)
        got, got_raw = fused(x)
    assert fused.spec.deploy and not any(
        "rbr_dense" in k for k in fused.state_dict())
    n_fused = sum(k.endswith("rbr_reparam.weight") for k in fused.state_dict())
    assert n_fused == sum(isinstance(m, RepVGGBlock)
                          for m in model.modules()) > 0
    _close(got, want, 1e-4, "decoded")
    for a, b in zip(got_raw, want_raw):
        _close(a, b, 1e-4, "raw")


def test_fusion_equals_jax_fuse_repvgg_tree():
    """The port's fused state_dict equals JAX's fused tree, carried by the
    bridge (strict=True into the deploy model), on the JAX model's
    variables with randomised statistics."""
    cfg = _cfg("yolov6s_coco.yaml")
    spec = jax_spec(cfg)
    jm = JaxModel(spec=spec)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)),
                                  train=False))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    jp, jbs = fuse_repvgg_tree(params, stats)
    want = state_dict_from_jax(jp, jbs)
    got = fuse_repvgg_state_dict(state_dict_from_jax(params, stats))
    assert set(got) - {k for k in got if k.endswith("num_batches_tracked")} \
        == set(want) - {k for k in want if k.endswith("num_batches_tracked")}
    for k, t in want.items():
        _close(got[k].numpy(), t.numpy(), 1e-6, k)
    deploy = build_model(dataclasses.replace(spec_from_cfg(cfg), deploy=True),
                         device="cpu")
    deploy.load_state_dict(want, strict=True)
