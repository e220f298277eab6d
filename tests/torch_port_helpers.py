"""Shared set-up of the PyTorch port's parity tests: the same YOLOv5 config
and weights for the JAX package and the port, with the weights carried
across by the port's bridge (numpy trees in between)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from efficientteacher_tpu.configs import get_cfg
from efficientteacher_tpu.models import build_model as jax_build_model
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.utils.jax_import import state_dict_from_jax


def yolov5_cfg(width=0.25, depth=0.33, nc=8, img=64):
    cfg = get_cfg()
    cfg.Model.Backbone.name = "YoloV5"
    cfg.Model.Neck.name = "YoloV5"
    cfg.Model.Head.name = "YoloV5"
    cfg.Model.Neck.in_channels = [256, 512, 1024]
    cfg.Model.Neck.out_channels = [256, 512, 1024]
    cfg.Model.width_multiple = width
    cfg.Model.depth_multiple = depth
    cfg.Dataset.nc = nc
    cfg.Dataset.img_size = img
    return cfg


def jax_and_port_models(cfg, seed=0):
    """(JAX model, its variables as numpy trees, port model in eval mode
    holding the same weights, loaded with strict=True)."""
    jm = jax_build_model(cfg)
    img = cfg.Dataset.img_size
    # jitted: eager Flax init dispatches op by op, ~3x slower on the CPU
    variables = jax.jit(lambda key: jm.init(
        key, jnp.zeros((1, img, img, 3)), train=False))(
            jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_model(spec_from_cfg(cfg), device="cpu")
    port.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"]),
        strict=True)
    return jm, variables, port.eval()


def to_jax_variables(state_dict, variables):
    """The port's state_dict back into the JAX variables' tree (for weights
    changed on the port's side, e.g. by a regime)."""
    from efficientteacher_tpu.utils.torch_import import state_dict_to_flax

    sd = {k: v.numpy() for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    out = state_dict_to_flax(sd)
    assert jax.tree_util.tree_structure(out) == \
        jax.tree_util.tree_structure(variables)
    return out


def images_u8(rng, b, img):
    return rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8)


def port_tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x))
