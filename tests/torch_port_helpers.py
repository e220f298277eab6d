"""Shared set-up of the PyTorch port's parity tests: the same YOLOv5 config
and weights for the JAX package and the port, with the weights carried
across by the port's bridge (numpy trees in between)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg
from efficientteacher_tpu.models import build_model as jax_build_model
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.utils.jax_import import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module's tests, restored after. The
    small test models are bound by per-op overhead on the CPU, so one
    thread is as fast alone, and test workers running side by side, each
    with a thread per core, slow each other ~2x. A test module takes it
    with `from torch_port_helpers import one_torch_thread`."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_leaked_pt_stubs():
    """Removes, after each test, the stub packages ("models", "utils",
    ...) that the JAX package's `.pt` loader leaves in `sys.modules`: a
    stub answers every attribute, `__file__` too, and a later first import
    of `torch._dynamo` (which walks `sys.modules` through `inspect`) fails
    on it in the same worker. A test module takes it with `from
    torch_port_helpers import no_leaked_pt_stubs`."""
    before = set(sys.modules)
    yield
    for name in set(sys.modules) - before:
        if type(sys.modules[name]).__name__ == "_StubModule":
            del sys.modules[name]


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


# grid-unit anchors of test_yolov5_loss.py / test_ssod.py
ANCHORS_GRID = np.array(
    [[[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]],
     [[1.875, 3.8125], [3.875, 2.8125], [3.6875, 7.4375]],
     [[3.625, 2.8125], [4.875, 6.1875], [11.65625, 10.1875]]], np.float32)


def anchors_grid_of(cfg):
    """(nl, na, 2) anchors in grid units of the config's strides."""
    spec = spec_from_cfg(cfg)
    return (np.asarray(spec.anchors, np.float32).reshape(spec.nl, spec.na, 2)
            / np.asarray(spec.strides, np.float32)[:, None, None])


def make_labels(rng, b, m, n_per_img, nc=8, extra=0):
    """Padded normalized labels (b, m, 5 + extra) [cls, cx, cy, w, h, ...]
    with n_per_img[i] rows set, and their mask."""
    labels = np.zeros((b, m, 5 + extra), np.float32)
    mask = np.zeros((b, m), bool)
    for bi, n in enumerate(n_per_img):
        labels[bi, :n, 0] = rng.integers(0, nc, n)
        labels[bi, :n, 1:3] = rng.uniform(0.05, 0.95, (n, 2))
        labels[bi, :n, 3:5] = rng.uniform(0.02, 0.4, (n, 2))
        labels[bi, :n, 5:] = rng.uniform(0, 1, (n, extra))
        mask[bi, :n] = True
    return labels, mask


def assert_states(got, want, tol, grad_tol=None):
    """Every tensor of two port train states: parameters and BatchNorm
    statistics, momentum buffers, accumulated gradients, the EMA and the
    semi-EMA (where both have one), and the counters. Each tensor is held
    to `tol` times max(1, its largest entry in `want`); the gradient-made
    buffers (momentum, accumulators) to `grad_tol` times theirs, if
    given."""
    def close(a, b, what, scale=tol):
        b = b.detach().numpy()
        atol = scale * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=atol,
                                   err_msg=what)

    def modules(a, b, what):
        sb = b.state_dict()
        for k, v in a.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                close(v, sb[k], f"{what} {k}")

    modules(got.model, want.model, "model")
    names = [n for n, _ in got.model.named_parameters()]
    for what in ("momentum_buf", "acc_grads"):
        for n, a, b in zip(names, getattr(got, what), getattr(want, what)):
            close(a, b, f"{what} {n}", grad_tol or tol)
    for what in ("ema", "semi_ema"):
        a, b = getattr(got, what, None), getattr(want, what, None)
        if a is not None or b is not None:
            modules(a.module, b.module, what)
            assert a.updates == b.updates, what
    assert (got.acc_count, got.step, got.opt_step) == (
        want.acc_count, want.step, want.opt_step)


def jax_maps(maps):
    """The port's raw maps (B, na, ny, nx, no) in the JAX layout
    (B, ny, nx, na, no), as jax arrays."""
    return [jnp.asarray(m.detach().numpy().transpose(0, 2, 3, 1, 4))
            for m in maps]
