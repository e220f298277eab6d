"""The port's `models/autoshape.py` against the JAX package's: AutoShape on
paths and arrays, Detections (xyxy, xywh, crop, render, save, print),
Ensemble and attempt_load, on the same weights.

The model is the supervised YAML's YOLOv5 at width 0.125 (nc 80, 128 px)
with its objectness and first class biases raised, as in
tests/test_torch_loaders_detect.py. JAX's AutoShape and Ensemble compute
in bf16; here in float32 (`jnp.bfloat16` patched while they trace), as the
port does on the CPU. Tolerances: the detections keep the same rows in
the same order, boxes within 1e-3 px and confidences within 1e-5 (float32
convolution order); crops are bit-equal; rendered images, label text
included, are bit-equal; Ensemble's mean within 1e-5 of the largest
output.
"""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.models import autoshape as jax_autoshape
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.models import autoshape
from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                     save_checkpoint)

from test_torch_loaders_detect import _write_images
from torch_port_helpers import jax_and_port_models, to_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SUP_YAML = REPO / "configs/sup/public/yolov5l_coco.yaml"
IMG = 128
OVERRIDES = ["Model.width_multiple", "0.125", "Model.depth_multiple",
             "0.33", "Dataset.img_size", str(IMG)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("autoshape")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(SUP_YAML))
    jcfg.merge_from_list(OVERRIDES)
    jm, variables, port = jax_and_port_models(jcfg)
    with torch.no_grad():
        for conv in port.head.m:
            conv.bias.view(port.head.na, port.head.no)[:, 4] += 5.0
            conv.bias.view(port.head.na, port.head.no)[:, 5:9] += 5.0
    jv = to_jax_variables(port.state_dict(), variables)
    jv = jax.tree_util.tree_map(jnp.asarray, jv)
    paths = _write_images(root / "imgs", seed=2)
    return jm, jv, jcfg, port, paths, root


def _jax_call(fn, *args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "bfloat16", jnp.float32)    # float32, as the port
        return fn(*args)


def test_autoshape_detections_equal_jax(models, tmp_path, capsys):
    jm, jv, jcfg, port, paths, _ = models
    names = list(jcfg.Dataset.names)
    ours = autoshape.AutoShape(port, names, IMG, compute_dtype=torch.float32)
    theirs = _jax_call(jax_autoshape.AutoShape, jm, jv, jax_spec(jcfg),
                       names, IMG)
    arrays = [cv2.imread(p) for p in paths[:2]]
    for inputs in (paths, arrays, paths[0]):
        got = ours(inputs)
        want = _jax_call(theirs, inputs)
        assert len(got) == len(want) == (1 if isinstance(inputs, str)
                                         else len(inputs))
        assert sum(len(p) for p in got.xyxy) >= 10
        for g, w in zip(got.xyxy + got.xywh, want.xyxy + want.xywh):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g[:, 5], w[:, 5])
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3, rtol=0)
            np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5, rtol=0)
        for gi, wi in zip(got.imgs, want.imgs):
            np.testing.assert_array_equal(gi, wi)
    # crop / render / print on one set of rows (JAX's), so that the pixels
    # do not depend on the last float32 digit of a box
    got.preds = [p.copy() for p in want.preds]
    for gc, wc in zip(got.crop(), want.crop()):
        assert len(gc) == len(wc)
        for a, b in zip(gc, wc):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got.render(), want.render()):
        np.testing.assert_array_equal(g, w)
    got.print()
    printed = capsys.readouterr().out
    want.print()
    assert printed == capsys.readouterr().out and "image 0:" in printed
    got.save(tmp_path / "port")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "image0.jpg"]


def test_ensemble_and_attempt_load_equal_jax(models):
    jm, jv, jcfg, port, paths, root = models
    second = {k: v * 0.9 if k.endswith("conv.weight") else v
              for k, v in port.state_dict().items()}
    jv2 = jax.tree_util.tree_map(
        jnp.asarray, to_jax_variables({k: v.clone() for k, v in
                                       second.items()}, jv))
    files = []
    for i, sd in enumerate((port.state_dict(), second)):
        port.load_state_dict(sd)
        v = module_variables(port)
        files.append(root / f"m{i}.ckpt")
        save_checkpoint(files[-1], params=v["params"],
                        batch_stats=v["batch_stats"], half=False)
    cfg = get_cfg()
    cfg.merge_from_file(str(SUP_YAML))
    cfg.merge_from_list(OVERRIDES)
    ens = autoshape.attempt_load([str(f) for f in files], cfg, device="cpu")
    assert isinstance(ens, autoshape.Ensemble) and len(ens.models) == 2
    one = autoshape.attempt_load(str(files[0]), cfg, device="cpu")
    assert isinstance(one, torch.nn.Module) and not one.training
    x = np.random.default_rng(0).uniform(0, 1, (2, IMG, IMG, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = ens(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
        alone = one(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
    want = np.asarray(_jax_call(
        lambda: jax_autoshape.Ensemble(jm, [jv, jv2])(jnp.asarray(x))))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    decoded, _ = jm.apply(jv, jnp.asarray(x), train=False)
    np.testing.assert_allclose(alone, np.asarray(decoded), rtol=0,
                               atol=1e-5 * np.abs(want).max())
