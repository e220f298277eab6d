"""The cases of tests/test_torch_zoo.py, test_torch_zoo_v7.py and
test_torch_zoo_v6.py, which split the families between them so that
pytest-xdist's `--dist loadfile` runs them on three workers; each file
takes its families' models from `family_fixture` and the tests below.
What they hold:

The zoo families' models in the PyTorch port (`C2f`, the YOLOv8
backbone and neck, the YOLOX and YOLOv8 heads, the TAL decode; the YOLOv7
ELAN backbone, SPPCSPC / ELAN_NECK neck and IDetect head; the YOLOv6
EfficientRep backbone, RepPAN neck and effidehead, with their RepVGG,
RealVGG and LinearAdd blocks, the transposed-conv upsample and the
implicit tokens; the ResNet-50 backbone; the registries) against the JAX
package: the JAX
variables carried across by `utils/jax_import.state_dict_from_jax` with
`strict=True`, the same numpy-seeded inputs through both.

Configs: `configs/sup/public/yolox_coco.yaml`, `yolov8m_coco.yaml`,
`yolov7l_coco.yaml`, `yolov7s_coco_simota.yaml` (the YOLOX head on the
YOLOv7 body), `yolov6s_coco.yaml` (RepVGG blocks) and
`yolov6s_coco_repopt_finetune.yaml` (RealVGG blocks), each shrunk to
width 0.25, depth 0.33, nc 8, 64 px (reg_max 16 as written).
Tolerances, each of the largest entry compared: eval-mode outputs 1e-5
(decoded boxes are pixels, up to ~10^3 for the v8 head's init bias of
1.0 on every bin); train-mode raw maps 1e-4 for YOLOX and YOLOv8 and 2e-3
for YOLOv7 and YOLOv6 (measured 3.0e-4 / 2.4e-4 / 8.1e-4 / 1.1e-3), as
flax's one-pass batch variance (E[x^2] - E[x]^2) loses digits the
two-pass one keeps (ROADMAP, Queue 3, "Justified"): on the deeper
YOLOv7 and the ReLU YOLOv6 nets JAX is 3e-4 to 1e-3 from a float64 run,
the port 5e-5 to 1.6e-4, so the port's float32 train maps are also held
to its own float64 run at 5e-4; the decodes on given raw maps 1e-6; the
blocks 1e-6 in eval, 1e-5 in train mode (the running statistics too)."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg
from efficientteacher_tpu.models import common as jax_common
from efficientteacher_tpu.models.heads import _MODEL_TYPE
from efficientteacher_tpu.models.heads.yolov6 import (
    decode_tal_scale as jax_decode_tal)
from efficientteacher_tpu.models.heads.yolox import (
    decode_yolox_scale as jax_decode_yolox)
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.models.backbones import build_backbone_cls
from efficientteacher_torch.models.common import (C2f, ImplicitA,
                                                  ImplicitM, LinearAddBlock,
                                                  RepVGGBlock, Transpose)
from efficientteacher_torch.models.heads import (build_head_cls,
                                                 head_model_type)
from efficientteacher_torch.models.heads.yolov6 import decode_tal_scale
from efficientteacher_torch.models.heads.yolox import decode_yolox_scale
from efficientteacher_torch.models.necks import build_neck_cls
from efficientteacher_torch.utils.jax_import import state_dict_from_jax

from torch_port_helpers import jax_and_port_models, jax_maps
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PUBLIC = REPO / "configs/sup/public"
YAMLS = {"yolox": PUBLIC / "yolox_coco.yaml",
         "yolov8": PUBLIC / "yolov8m_coco.yaml",
         "yolov7l": PUBLIC / "yolov7l_coco.yaml",
         "yolov7s_simota": PUBLIC / "yolov7s_coco_simota.yaml",
         "yolov6s": PUBLIC / "yolov6s_coco.yaml",
         "yolov6s_realvgg": PUBLIC / "yolov6s_coco_repopt_finetune.yaml"}
TRAIN_TOL = {"yolox": 1e-4, "yolov8": 1e-4, "yolov7l": 2e-3,
             "yolov7s_simota": 2e-3, "yolov6s": 2e-3,
             "yolov6s_realvgg": 2e-3}


def zoo_cfg(family, width=0.25, depth=0.33, nc=8, img=64):
    cfg = get_cfg()
    cfg.merge_from_file(str(YAMLS[family]))
    cfg.merge_from_list(["Model.width_multiple", width,
                         "Model.depth_multiple", depth, "Dataset.nc", nc,
                         "Dataset.img_size", img])
    return cfg


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=what)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shortcut", [True, False])
def test_c2f_matches_jax(shortcut):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 12, 12, 16)).astype(np.float32)
    block = jax_common.C2f(32, n=2, shortcut=shortcut)
    v = jax.jit(lambda k: block.init(k, jnp.zeros((1, 12, 12, 16))))(
        jax.random.PRNGKey(1))
    v = jax.tree_util.tree_map(np.asarray, v)
    port = C2f(16, 32, n=2, shortcut=shortcut)
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    want = block.apply(v, jnp.asarray(x))
    _close(port.eval()(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1),
           want, 1e-6, "eval")
    want, new = block.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    got = port.train()(_nchw(x))
    _close(got.detach().numpy().transpose(0, 2, 3, 1), want, 1e-5, "train")
    sd = state_dict_from_jax(v["params"], new["batch_stats"])
    for k, t in port.state_dict().items():
        if "running" in k:
            _close(t.numpy(), sd[k].numpy(), 1e-5, k)


def _block_parity(jblock, port, x, *, train=True, tweak=None):
    """A JAX block and its port counterpart on the same NHWC input, the
    JAX variables carried by the bridge (strict=True): eval output, and
    with `train` the train-mode output and running statistics. `tweak`
    rewrites the JAX variables first (numpy trees)."""
    v = jax.jit(lambda k: jblock.init(k, jnp.zeros((1,) + x.shape[1:])))(
        jax.random.PRNGKey(1))
    v = jax.tree_util.tree_map(np.asarray, v)
    if tweak is not None:
        v = tweak(v)
    port.load_state_dict(state_dict_from_jax(v["params"],
                                             v.get("batch_stats", {})),
                         strict=True)
    want = jblock.apply(v, jnp.asarray(x))
    got = port.eval()(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got, want, 1e-6, "eval")
    if not train:
        return
    want, new = jblock.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    got = port.train()(_nchw(x))
    _close(got.detach().numpy().transpose(0, 2, 3, 1), want, 1e-5, "train")
    sd = state_dict_from_jax(v["params"], new["batch_stats"])
    for k, t in port.state_dict().items():
        if "running" in k:
            _close(t.numpy(), sd[k].numpy(), 1e-5, k)


def test_transpose_in_ne_out_matches_jax():
    """flax's unflipped (kh, kw, in, out) kernel against ConvTranspose2d's
    flipped (in, out, kh, kw) one, 4 -> 6 channels."""
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 7, 4)).astype(
        np.float32)
    _block_parity(jax_common.Transpose(6), Transpose(4, 6), x, train=False)


@pytest.mark.parametrize("kind", ["A", "M"])
def test_implicit_tokens_match_jax(kind):
    x = np.random.default_rng(5).normal(0, 1, (2, 3, 4, 12)).astype(
        np.float32)
    jblock, port = ((jax_common.ImplicitA(12), ImplicitA(12)) if kind == "A"
                    else (jax_common.ImplicitM(12), ImplicitM(12)))
    _block_parity(jblock, port, x, train=False)
    assert tuple(port.implicit.shape) == (1, 12, 1, 1)


@pytest.mark.parametrize("c2,s", [(16, 1), (24, 1), (16, 2)],
                         ids=["identity", "no_identity_c", "no_identity_s"])
def test_repvgg_block_matches_jax(c2, s):
    x = np.random.default_rng(6).normal(0, 1, (2, 8, 8, 16)).astype(
        np.float32)
    port = RepVGGBlock(16, c2, s=s)
    assert (port.rbr_identity is not None) == (c2 == 16 and s == 1)
    _block_parity(jax_common.RepVGGBlock(c2, s=s), port, x)


@pytest.mark.parametrize("c2,s", [(16, 1), (24, 2)],
                         ids=["identity", "no_identity"])
def test_linear_add_block_matches_jax(c2, s):
    """The scales drawn away from their init of 1, so each branch's scale
    shows."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)

    def tweak(v):
        for k in ("scale_conv", "scale_1x1", "scale_identity"):
            if k in v["params"]:
                v["params"][k] = rng.uniform(0.2, 2.0, c2).astype(np.float32)
        return v

    port = LinearAddBlock(16, c2, s=s)
    _block_parity(jax_common.LinearAddBlock(c2, s=s), port, x, tweak=tweak)
    assert (port.scale_identity is not None) == (s == 1)


def family_fixture(families):
    """The module's `family` fixture: both packages' models of each
    family's YAML shrunk."""
    @pytest.fixture(scope="module", params=families, name="family")
    def family(request):
        cfg = zoo_cfg(request.param)
        jm, variables, port = jax_and_port_models(cfg)
        return request.param, cfg, jm, variables, port
    return family


def test_models_forward_match_jax(family):
    """Eval (decoded and raw) and train-mode raw maps, through the bridge
    with strict=True (`jax_and_port_models`)."""
    name, cfg, jm, variables, port = family
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 256, (2, 64, 64, 3)) / 255.0).astype(np.float32)
    jd, jraw = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        pd, praw = port.eval()(_nchw(x))
    n = 64 // 8 * 64 // 8 + 64 // 16 * 64 // 16 + 64 // 32 * 64 // 32
    n *= 3 if name == "yolov7l" else 1    # IDetect's 3 anchors per cell
    assert pd.shape == (2, n, 5 + 8) and jd.shape == pd.shape
    _close(pd.numpy(), jd, 1e-5, f"{name} decoded")
    for got, want in zip(jax_maps(praw), jraw):
        assert got.shape == want.shape
        _close(got, want, 1e-5, f"{name} raw")
    jraw, _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, decode=False, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    own64 = copy.deepcopy(port).double().train()(_nchw(x).double(),
                                                  decode=False)
    praw = port.train()(_nchw(x), decode=False)
    for got, want, ref in zip(jax_maps(praw), jraw, jax_maps(own64)):
        _close(got, want, TRAIN_TOL[name], f"{name} train raw")
        _close(got, ref, 5e-4, f"{name} train raw, own float64")
    if name in ("yolov8", "yolov6s", "yolov6s_realvgg"):
        assert (pd[..., 4] == 1).all()   # the TAL decode's objectness


def test_train_gradients_match_jax_in_float64(family):
    """The gradients through the whole network in train mode, both sides in
    float64, of a fixed random linear form of the raw maps (the losses are
    held apart, tests/test_torch_zoo_losses.py): 1e-6 of each tensor's
    largest entry. In float32 the ReLU and deeper nets' train-mode
    gradients are ill-conditioned (tests/torch_trainer_zoo_cases.py); in
    float64 they agree. JAX's max pools split a window's gradient among
    tied maxima and the port's give it to one; the ties here are YOLOv6's
    ReLU zeros, whose gradient ReLU'(0) = 0 stops in both."""
    name, cfg, jm32, variables, port = family
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (2, 64, 64, 3))
    with jax.enable_x64(True):
        jm = type(jm32)(spec=jm32.spec, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        shapes = [r.shape for r in jax.eval_shape(lambda v: jm.apply(
            v, jnp.asarray(x), train=True, decode=False,
            mutable=["batch_stats"])[0], v64)]
        ws = [rng.normal(0, 1, s) for s in shapes]

        def form(params):
            raw, _ = jm.apply({"params": params,
                               "batch_stats": v64["batch_stats"]},
                              jnp.asarray(x), train=True, decode=False,
                              mutable=["batch_stats"])
            return sum((r * w).sum() for r, w in zip(raw, ws))

        jgrads = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(form))(v64["params"]))
    own = copy.deepcopy(port).double().train()
    raw = own(torch.from_numpy(x).permute(0, 3, 1, 2), decode=False)
    total = sum((r * torch.from_numpy(w.transpose(0, 3, 1, 2, 4))).sum()
                for r, w in zip(raw, ws))
    got = torch.autograd.grad(total, list(own.parameters()))
    want = state_dict_from_jax(jgrads, {})
    for (n, _), g in zip(own.named_parameters(), got):
        w = want[n].double().numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=n)


def test_seeded_init_biases_are_jax_init(family):
    """The port's own seeded init puts the heads' prediction biases where
    JAX's init does: YOLOX's prior -log((1-p)/p) on class and objectness
    (0 on the box), YOLOv8's 1.0 on the bins and log(5/nc/(640/s)^2) on the
    classes, IDetect's the YOLOv5 Detect's focal prior, YOLOv6's 0 (flax's
    default); its implicit tokens are drawn as JAX draws them, N(0, 0.02)
    and N(1, 0.02) (means within 4 standard errors, standard deviations
    within 30%, in both packages), and the transposed convs' biases are
    0."""
    name, cfg, _, variables, _ = family
    # a generator of its own: the tokens' draw does not depend on what
    # earlier tests left in the global one
    own = build_model(spec_from_cfg(cfg), device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    bridged = state_dict_from_jax(variables["params"],
                                  variables["batch_stats"])
    heads = [k for k in own if k.startswith("head.") and k.endswith("bias")
             and ".bn." not in k]
    assert len(heads) == {"yolov8": 6, "yolov6s": 6, "yolov6s_realvgg": 6,
                          "yolov7l": 3}.get(name, 9)
    for k in heads:
        np.testing.assert_allclose(own[k].numpy(), bridged[k].numpy(),
                                   rtol=1e-7, err_msg=k)
    assert set(own) == set(bridged)
    tokens = [k for k in own if k.endswith(".implicit")]
    assert len(tokens) == (6 if name == "yolov7l" else 0)
    for k in tokens:
        mean = 0.0 if ".ia." in k else 1.0
        for sd in (own, bridged):
            t = sd[k].double().flatten()
            assert abs(float(t.mean()) - mean) < 4 * 0.02 / len(t) ** 0.5, k
            assert 0.7 < float(t.std()) / 0.02 < 1.3, k
    for k in own:
        if "upsample_transpose.bias" in k:
            assert own[k].eq(0).all() and bridged[k].eq(0).all(), k
    if name == "yolov8":
        s = spec_from_cfg(cfg)
        assert own["head.cv2_0.2.bias"].eq(1.0).all()
        np.testing.assert_allclose(
            own["head.cv3_2.2.bias"].numpy(),
            np.log(5.0 / s.nc / (640.0 / 32) ** 2), rtol=1e-6)


@pytest.mark.parametrize("use_dfl", [True, False])
def test_decode_tal_scale_matches_jax(use_dfl):
    rng = np.random.default_rng(2)
    raw = rng.normal(0, 2, (2, 1, 5, 7, 4 * 17 + 6)).astype(np.float32)
    want = jax_decode_tal(jnp.asarray(raw.transpose(0, 2, 3, 1, 4)), 16.0,
                          16, use_dfl, 6)
    got = decode_tal_scale(torch.from_numpy(raw), 16.0, 16, use_dfl, 6)
    _close(got.numpy(), want, 1e-6)


def test_decode_yolox_scale_matches_jax():
    rng = np.random.default_rng(3)
    raw = rng.normal(0, 1, (2, 1, 5, 7, 13)).astype(np.float32)
    want = jax_decode_yolox(jnp.asarray(raw.transpose(0, 2, 3, 1, 4)), 8.0)
    got = decode_yolox_scale(torch.from_numpy(raw), 8.0)
    _close(got.numpy(), want, 1e-6)


def test_registries_and_model_type():
    assert {n: head_model_type(n) for n in _MODEL_TYPE} == _MODEL_TYPE
    assert head_model_type("YoloV5") == "yolov5"
    for family_ in ("yolox", "yolov8"):
        model = build_model(spec_from_cfg(zoo_cfg(family_)), device="cpu")
        assert head_model_type(model.spec.head) == (
            "yolox" if family_ == "yolox" else "tal")
    for build, name in ((build_head_cls, "YoloV6"), (build_head_cls, "YoloV7"),
                        (build_backbone_cls, "YoloV7"),
                        (build_backbone_cls, "YoloV6"),
                        (build_neck_cls, "YoloV7"),
                        (build_neck_cls, "YoloV6")):
        assert build(name).__name__ == f"{name}" + {
            build_head_cls: "Detect", build_backbone_cls: "BackBone",
            build_neck_cls: "Neck"}[build]
    assert build_backbone_cls("ResNet50") is build_backbone_cls("resnet50")
    with pytest.raises(NotImplementedError, match="in no registry"):
        build_backbone_cls("ResNet")     # not a name in either registry
    for family_ in ("yolov7l", "yolov6s"):
        model = build_model(spec_from_cfg(zoo_cfg(family_)), device="cpu")
        assert head_model_type(model.spec.head) == (
            "yolov5" if family_ == "yolov7l" else "tal")


def test_resnet50_model_matches_jax():
    """The ResNet-50 backbone under the YOLOv5 neck and head, with
    tests/test_model_zoo.py::test_resnet_backbone_builds's config (width
    1.0, depth 0.34, nc 4, 64 px): eval decoded and raw maps 1e-5 of the
    largest entry, train-mode raw maps 2e-3 (measured 2.3e-4: flax's
    one-pass variance on a ReLU net, module docstring) and 5e-4 to the
    port's own float64 run, through the bridge with strict=True; the
    backbone returns 512 / 1024 / 2048 channels at strides 8 / 16 / 32."""
    cfg = get_cfg()
    cfg.Model.Backbone.name = "ResNet50"
    cfg.Model.Neck.name = "YoloV5"
    cfg.Model.Head.name = "YoloV5"
    cfg.Model.Neck.in_channels = [512, 1024, 2048]
    cfg.Model.Neck.out_channels = [256, 512, 1024]
    cfg.Model.width_multiple = 1.0
    cfg.Model.depth_multiple = 0.34
    cfg.Dataset.nc = 4
    cfg.Dataset.img_size = 64
    jm, variables, port = jax_and_port_models(cfg)
    x = np.random.default_rng(12).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    feats = port.backbone(_nchw(x))
    assert [tuple(f.shape[1:]) for f in feats] == [(512, 8, 8), (1024, 4, 4),
                                                   (2048, 2, 2)]
    jd, jraw = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        pd, praw = port.eval()(_nchw(x))
    _close(pd.numpy(), jd, 1e-5, "decoded")
    for got, want in zip(jax_maps(praw), jraw):
        _close(got, want, 1e-5, "raw")
    jraw, _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, decode=False, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    own64 = copy.deepcopy(port).double().train()(_nchw(x).double(),
                                                  decode=False)
    praw = port.train()(_nchw(x), decode=False)
    for got, want, ref in zip(jax_maps(praw), jraw, jax_maps(own64)):
        _close(got, want, 2e-3, "train raw")
        _close(got, ref, 5e-4, "train raw, own float64")
