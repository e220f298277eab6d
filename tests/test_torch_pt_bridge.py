"""The port's reference `.pt` bridge (`efficientteacher_torch/utils/
torch_import.py`) against the JAX package's (`efficientteacher_tpu/utils/
torch_import.py`; `tests/test_torch_import.py` is that module's own test).

No reference `.pt` is in the repo, so the tests pickle their own: a port
model saved as the reference saves (fp16 module trees, the classes
registered under `models.common` only while saving, so loading needs the
stubs), and JAX trees exported by `export_to_torch_state_dict`. Held:

  - the stubbed load prefers `ema`, takes `model` otherwise, and reads a
    bare state_dict; nothing of the stubs stays in `sys.modules`;
  - per family of the port's registries the bridge's tensors are bit-equal
    to `utils/jax_import.py`'s from the same tree, the ConvTranspose
    kernel apart (the JAX exporter lays it out as a conv's: ROADMAP F5);
    a YOLOv6 `Transpose` with in != out loads from torch's own layout and
    its forward is a plain ConvTranspose2d's;
  - `cli.val` on a `.pt` against the JAX package's `load_torch_weights` +
    `validator.run` on the same file and images (float32): P, R, mAP to
    1e-6, the COCO JSON detections the same rows, boxes to 1e-3 px,
    scores to 1e-5;
  - both shipped YAMLs that name a `.pt` warm-start from one (the head
    skipped on shape where the classes differ), `RepScale_weight` and an
    extra teacher read from one, and the two converters round-trip.
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.data.datasets import \
    create_dataloader as jax_create_dataloader
from efficientteacher_tpu.eval import validator as jax_validator
from efficientteacher_tpu.models import build_model as jax_build_model
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec
from efficientteacher_tpu.utils.torch_import import (
    export_to_torch_state_dict, load_torch_weights as jax_load_torch_weights)
from efficientteacher_torch.cli import val as cli_val
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.models.common import Transpose
from efficientteacher_torch.train.repopt import (build_grad_masks,
                                                 load_repscale_scales)
from efficientteacher_torch.train.ssod_trainer import SSODTrainer
from efficientteacher_torch.utils import torch_import as ti
from efficientteacher_torch.utils.checkpoint import (load_checkpoint,
                                                     module_variables,
                                                     save_checkpoint)
from efficientteacher_torch.utils.jax_import import state_dict_from_jax

from test_torch_datasets import write_dataset
from test_torch_trainer_resume import Replay, _sup_batches, _target_batches
from torch_zoo_cases import YAMLS, zoo_cfg
from torch_port_helpers import (jax_and_port_models, one_torch_thread,  # noqa
                                no_leaked_pt_stubs, yolov5_cfg)

REPO = Path(__file__).resolve().parents[1]
VOC_YAML = REPO / "configs/ssod/voc/yolov5l_voc_burn.yaml"
TRANSFER_YAML = REPO / "configs/ssod/custom/yolov5l_transfer_ssod.yaml"
SMALL = ["Model.width_multiple", 0.125, "Model.depth_multiple", 0.34,
         "Dataset.img_size", 64]


def _seeded(cfg, seed=0):
    """A seeded detector of `cfg` (without the SSOD discriminators: a
    reference `.pt` holds a supervised model)."""
    spec = dataclasses.replace(spec_from_cfg(cfg), train_domain=False)
    return build_model(spec, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _perturbed(model, seed):
    """A copy of `model` with every float tensor moved: a distinct EMA."""
    import copy

    out = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(out.parameters()) + list(out.buffers()):
            if t.is_floating_point():
                t.add_(torch.rand(t.shape, generator=g) * 0.01)
    return out


def _fp16(variables):
    return {g: {k: v.detach().half().float() for k, v in variables[g].items()}
            for g in ("params", "batch_stats")}


def _assert_loaded(got, want):
    for g in ("params", "batch_stats"):
        assert set(got[g]) == set(want[g]), g
        for k, v in want[g].items():
            assert torch.equal(got[g][k], v), k


def test_stubbed_pickle_prefers_ema_and_reads_state_dicts(tmp_path):
    model = _seeded(yolov5_cfg()).eval()
    ema = _perturbed(model, 1)
    pt = tmp_path / "ref.pt"
    ti.save_reference_pt(pt, model, ema, epoch=3)
    assert not [k for k in sys.modules if k.split(".")[0] == "models"]
    raw = pt.read_bytes()
    assert b"models.common" in raw and b"efficientteacher_torch" not in raw
    with pytest.raises(ModuleNotFoundError):
        torch.load(pt, weights_only=False)
    _assert_loaded(ti.load_torch_weights(pt),
                   _fp16(module_variables(ema)))
    _assert_loaded(ti.load_torch_weights(pt, prefer_ema=False),
                   _fp16(module_variables(model)))
    assert not [k for k in sys.modules if k.split(".")[0] == "models"]
    # a {"model": state_dict} file and a bare state_dict
    sd = {k: v.half() for k, v in model.state_dict().items()}
    torch.save({"model": sd, "ema": None}, tmp_path / "sd.pt")
    torch.save(sd, tmp_path / "bare.pt")
    for name in ("sd.pt", "bare.pt"):
        _assert_loaded(ti.load_torch_weights(tmp_path / name),
                       _fp16(module_variables(model)))
    # the loads into a fresh model, strict, report every tensor matched
    fresh = _seeded(yolov5_cfg(), seed=1)
    counts = ti.load_weights_into(fresh, pt, strict=True)
    assert counts == {"params": (177, 177), "batch_stats": (114, 114)}
    _assert_loaded(module_variables(fresh), _fp16(module_variables(ema)))


def _family_cfg(family):
    if family == "yolov5":
        return yolov5_cfg()
    if family == "resnet":
        cfg = jax_get_cfg()
        cfg.Model.Backbone.name = "ResNet50"
        cfg.Model.Neck.name = cfg.Model.Head.name = "YoloV5"
        cfg.Model.Neck.in_channels = [512, 1024, 2048]
        cfg.Model.Neck.out_channels = [256, 512, 1024]
        cfg.Model.width_multiple, cfg.Model.depth_multiple = 1.0, 0.34
        cfg.Dataset.nc, cfg.Dataset.img_size = 4, 64
        return cfg
    if family == "yolov6s_linearadd":  # the ScaleLayers' `.weight` names
        cfg = zoo_cfg("yolov6s")
        cfg.Model.LinearAddModel = True
        return cfg
    return zoo_cfg(family)


@pytest.mark.parametrize("family", ["yolov5", *YAMLS, "yolov6s_linearadd",
                                    "resnet"])
def test_jax_exported_pt_loads_as_jax_import_does(tmp_path, family):
    """JAX tree -> `export_to_torch_state_dict` -> .pt -> the bridge, bit
    for bit what `state_dict_from_jax` makes of the same tree; every
    tensor of the port's model found, the ConvTranspose kernels apart."""
    _, variables, port = jax_and_port_models(_family_cfg(family))
    sd = export_to_torch_state_dict(variables["params"],
                                    variables["batch_stats"])
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, "ema": None},
               tmp_path / "jax.pt")
    got = ti.load_torch_weights(tmp_path / "jax.pt")
    want = state_dict_from_jax(variables["params"], variables["batch_stats"])
    own = module_variables(port)
    transposed = {k for k in own["params"] if "upsample_transpose" in k}
    assert bool(transposed) == family.startswith("yolov6")
    for g in ("params", "batch_stats"):
        assert set(got[g]) == set(own[g]), g
        for k, v in got[g].items():
            if k in transposed:
                continue
            assert torch.equal(v, want[k]), k
    if family == "yolov6s_linearadd":
        assert any(k.endswith(".scale_conv.weight") for k in sd)
        assert any(k.endswith(".scale_conv") for k in got["params"])


def test_transpose_in_ne_out_loads_torch_layout(tmp_path):
    """A ConvTranspose2d weight crosses as the reference stores it, (in,
    out, kh, kw); the loaded block's forward is a plain ConvTranspose2d's."""
    ref = torch.nn.ConvTranspose2d(4, 6, 2, 2, bias=True)
    with torch.no_grad():
        ref.bias.uniform_(-1, 1)
    sd = {"neck.up.upsample_transpose.weight": ref.weight.detach().half(),
          "neck.up.upsample_transpose.bias": ref.bias.detach().half()}
    torch.save({"model": sd}, tmp_path / "t.pt")
    w = ti.load_torch_weights(tmp_path / "t.pt")["params"]
    block = Transpose(4, 6)
    block.upsample_transpose.weight.data.copy_(
        w["neck.up.upsample_transpose.weight"])
    block.upsample_transpose.bias.data.copy_(
        w["neck.up.upsample_transpose.bias"])
    assert tuple(block.upsample_transpose.weight.shape) == (4, 6, 2, 2)
    x = torch.randn(2, 4, 5, 7, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = torch.nn.functional.conv_transpose2d(
            x, ref.weight.half().float(), ref.bias.half().float(), stride=2)
        torch.testing.assert_close(block(x), plain, rtol=0, atol=0)


def _val_cfg(val, nc):
    return ["device", "cpu", "Dataset.val", val, "Dataset.nc", str(nc),
            "Dataset.names", str([f"c{i}" for i in range(nc)]),
            "Dataset.img_size", "128", "Model.width_multiple", "0.25",
            "Model.depth_multiple", "0.33"]


def test_cli_val_on_pt_equals_jax_load_torch_weights(tmp_path, capsys):
    """cli.val on a reference-style .pt of a detecting YOLOv5 (objectness
    and classes 0-1 raised) equals JAX's val of the same file."""
    yaml = REPO / "configs/sup/public/yolov5l_coco.yaml"
    sizes = [(96, 128, "png"), (128, 100, "png"), (120, 128, "png")] * 2
    val = write_dataset(tmp_path / "v", sizes, seed=3, nc=2, name="val")
    overrides = _val_cfg(val, 3)
    cfg = get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(overrides)
    model = _seeded(cfg, seed=4).eval()
    with torch.no_grad():
        for conv in model.head.m:
            b = conv.bias.view(model.head.na, model.head.no)
            b[:, 4] += 6.0
            b[:, 5:7] += 3.0
    pt = tmp_path / "det.pt"
    ti.save_reference_pt(pt, model, model)
    got = cli_val.main(["--cfg", str(yaml), "--weights", str(pt),
                        "--batch-size", "2", "--save-json",
                        str(tmp_path / "port.json"), *overrides])
    assert "mAP50=" in capsys.readouterr().out

    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(yaml))
    jcfg.merge_from_list([o for i, o in enumerate(overrides)
                          if i >= 2])  # JAX has no `device cpu` override
    jcfg.freeze()
    jmodel = jax_build_model(jax_spec(jcfg), ssod=False, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        jnp.asarray, jax_load_torch_weights(str(pt)))
    loader = jax_create_dataloader(jcfg, "val", augment=False, batch_size=2)
    want = jax_validator.run(jmodel, variables, loader, nc=3,
                             compute_dtype=jnp.float32,
                             save_json=str(tmp_path / "jax.json"))[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[2] > 0
    rows = [json.loads((tmp_path / f).read_text())
            for f in ("port.json", "jax.json")]
    assert len(rows[0]) == len(rows[1]) > 0
    key = lambda r: (r["image_id"], r["category_id"], -r["score"])  # noqa
    for a, b in zip(sorted(rows[0], key=key), sorted(rows[1], key=key)):
        assert (a["image_id"], a["category_id"]) == \
            (b["image_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-5
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-3)


class _Loaders(SSODTrainer):
    """The SSOD trainer on in-memory batches (its `.pt` warm start is what
    is held)."""

    def build_dataloader(self, cfg):
        ds = types.SimpleNamespace(mosaic=True, labels=[])
        self.train_loader = Replay(_sup_batches(1, 2, 64, 0), ds)
        self.target_loader = Replay(_target_batches(1, 2, 64, 2))
        self.val_loader = None
        self.dataset, self.nb = ds, 1


def _yaml_cfg(yaml, tmp_path, extra=()):
    cfg = get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(SMALL + ["project", str(tmp_path), "noautoanchor",
                                 True, "device", "cpu", *extra])
    return cfg


@pytest.mark.parametrize("yaml,pt_nc", [(VOC_YAML, 20), (TRANSFER_YAML, 365)],
                         ids=["voc_burn", "transfer_obj365"])
def test_shipped_yamls_warm_start_from_pt(tmp_path, yaml, pt_nc):
    """The YAML's `.pt` warm start: a reference model of the YAML's body
    with `pt_nc` classes; every tensor matched but the head's where the
    classes differ (obj365 -> 2 classes)."""
    cfg = _yaml_cfg(yaml, tmp_path)
    src_cfg = _yaml_cfg(yaml, tmp_path, ["Dataset.nc", pt_nc])
    src = _seeded(src_cfg, seed=7)
    pt = tmp_path / Path(str(cfg.weights)).name
    ti.save_reference_pt(pt, src, _perturbed(src, 2))
    cfg.merge_from_list(["weights", str(pt)])
    t = _Loaders(cfg, compute_dtype=torch.float32, device="cpu")
    (cp, tp), (cs, ts) = (t.warm_start_counts["params"],
                          t.warm_start_counts["batch_stats"])
    assert cs == ts and tp == cp + (6 if pt_nc != cfg.Dataset.nc else 0) \
        + len([k for k in module_variables(t.model)["params"]
               if k.startswith("det_")])  # the head's 3 convs, discriminators
    want = _fp16(module_variables(_perturbed(src, 2)))
    mine = module_variables(t.model)
    for g in ("params", "batch_stats"):
        for k, v in mine[g].items():
            if k in want[g] and want[g][k].shape == v.shape:
                assert torch.equal(v, want[g][k]), k


def test_repscale_weight_from_pt_gives_the_checkpoint_masks(tmp_path):
    cfg = get_cfg()
    cfg.merge_from_file(str(YAMLS["yolov6s"]))
    cfg.merge_from_list(["Model.LinearAddModel", True, *SMALL])
    src = _seeded(cfg, seed=3)
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for name, p in src.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("scale_"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
    v = module_variables(src)
    save_checkpoint(tmp_path / "scales.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"])
    ti.save_reference_pt(tmp_path / "scales.pt", src)
    a = load_repscale_scales(str(tmp_path / "scales.ckpt"))
    b = load_repscale_scales(str(tmp_path / "scales.pt"))
    assert set(a) == set(b) and a
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert torch.equal(x, y), k
    ft = get_cfg()
    ft.merge_from_file(str(YAMLS["yolov6s_realvgg"]))
    ft.merge_from_list(SMALL)
    model = _seeded(ft)
    for x, y in zip(build_grad_masks(model, a), build_grad_masks(model, b)):
        assert (x is None and y is None) or torch.equal(x, y)


def test_extra_teacher_from_pt(tmp_path):
    cfg = _yaml_cfg(VOC_YAML, tmp_path)
    teacher = _seeded(cfg, seed=9)
    ti.save_reference_pt(tmp_path / "teacher.pt", teacher)
    cfg.merge_from_list(["weights", "", "SSOD.extra_teachers",
                         [str(tmp_path / "teacher.pt")]])
    t = _Loaders(cfg, compute_dtype=torch.float32, device="cpu")
    (module, cmap), = t.extra_teachers
    assert cmap is None and not module.training
    _assert_loaded(module_variables(module),
                   _fp16(module_variables(teacher)))


def test_converters_round_trip(tmp_path):
    cfg = yolov5_cfg()
    model, ema = _seeded(cfg), _perturbed(_seeded(cfg), 3)
    ti.save_reference_pt(tmp_path / "a.pt", model, ema)
    counts = ti.convert_pt_to_checkpoint(tmp_path / "a.pt", cfg,
                                         tmp_path / "a.ckpt")
    assert counts == {"params": (177, 177), "batch_stats": (114, 114)}
    ckpt = load_checkpoint(tmp_path / "a.ckpt")
    assert "cfg" in ckpt["meta"]
    n = ti.export_checkpoint_to_pt(tmp_path / "a.ckpt", tmp_path / "b.pt")
    assert n == 177 + 114
    plain = torch.load(tmp_path / "b.pt", weights_only=True)
    assert set(plain) == {"model", "ema", "epoch"}
    _assert_loaded(ti.load_torch_weights(tmp_path / "b.pt"),
                   ti.load_torch_weights(tmp_path / "a.pt"))
    # the reference's names on the way out, the port's on the way in
    assert ti.port_name("neck.x.rbr_dense.0.weight") == \
        "neck.x.rbr_dense_conv.weight"
    assert ti.port_name("neck.x.rbr_1x1.bn.running_var") == \
        "neck.x.rbr_1x1_bn.running_var"
    assert ti.port_name("b.block.scale_conv.weight") == "b.block.scale_conv"
    for name in ("head.anchors", "head.anchor_grid", "head.stride",
                 "bn.num_batches_tracked", "head.proj",
                 "head.proj_conv.weight"):
        assert ti.port_name(name) is None
    for name in ("neck.x.rbr_dense_conv.weight", "b.scale_identity",
                 "backbone.stage2_1.cv1.conv.weight"):
        assert ti.port_name(ti.reference_name(name)) == name
