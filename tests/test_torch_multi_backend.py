"""The port's DetectBackend (`eval/multi_backend.py`) against the JAX
package's, format by format, on the same weights: a YOLOv7-L
(`yolov7l_coco.yaml`, its RepConv blocks fused by the deploy exports) at
width 0.125, depth 0.33, 64 px, JAX's init carried across, in fp16
checkpoints of each package. (YOLOv7 and not YOLOv6: JAX's `.pt` import
lays YOLOv6's ConvTranspose out wrong, ROADMAP F5.)

JAX's checkpoint backends compute in bf16; here they run in float32
(`jnp.bfloat16` patched while they are built and called), as the port's
do on the CPU. Tolerances: `.ckpt`, `.deploy.ckpt` and `.pt` hold the two
packages' float32 forwards of the same weights: 1e-5 of the largest output
(measured 1.7e-8: convolution order); `.torchscript`, `.onnx` and the
TensorFlow formats run the same file through the same runtime in both
packages: bit-equal. The port writes the `.deploy.ckpt`, `.torchscript` and
`.onnx` (`cli.export`), JAX's export.py the TensorFlow ones. Without cv2
the port's `.onnx` backend raises ImportError naming it."""

import argparse
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.eval.multi_backend import \
    DetectBackend as JaxDetectBackend
from efficientteacher_tpu.utils.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from efficientteacher_torch.cli import export as cli_export
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.eval.multi_backend import DetectBackend
from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                     save_checkpoint)
from efficientteacher_torch.utils.torch_import import save_reference_pt

from torch_port_helpers import jax_and_port_models
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import no_leaked_pt_stubs  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "configs/sup/public/yolov7l_coco.yaml"
IMG = 64
OVERRIDES = ["Model.width_multiple", "0.125", "Model.depth_multiple", "0.33",
             "Dataset.img_size", str(IMG)]


def _jax_export_main():
    spec = importlib.util.spec_from_file_location("jax_export",
                                                  REPO / "export.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("backends")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(YAML))
    jcfg.merge_from_list(OVERRIDES)
    _, variables, port = jax_and_port_models(jcfg)
    jcfg.freeze()
    v = module_variables(port)
    save_checkpoint(root / "w.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"])
    save_reference_pt(root / "w.pt", port)
    (root / "jax").mkdir()
    jax_save_checkpoint(root / "jax" / "w.ckpt", params=variables["params"],
                        batch_stats=variables["batch_stats"])
    done = cli_export.main(["--cfg", str(YAML), "--weights",
                            str(root / "w.ckpt"), "--include", "deploy",
                            "torchscript", "onnx", "--img-size", str(IMG),
                            "--batch", "2",
                            *OVERRIDES, "device", "cpu"])
    export = _jax_export_main()
    base = dict(cfg=str(YAML), weights=str(root / "jax" / "w.ckpt"),
                opset=13, int8=False, data_dir=None, img_size=IMG, batch=2,
                out=None, opts=OVERRIDES)
    export(argparse.Namespace(include=["deploy", "saved_model", "pb",
                                       "tflite"], **base))
    cfg = get_cfg()
    cfg.merge_from_file(str(YAML))
    cfg.merge_from_list(OVERRIDES + ["device", "cpu"])
    cfg.freeze()
    jstem = root / "jax" / "w"
    files = {
        "ckpt": (root / "w.ckpt", root / "jax" / "w.ckpt"),
        "deploy": (done["deploy"]["path"], jstem.with_suffix(".deploy.ckpt")),
        "pt": (root / "w.pt", root / "w.pt"),
        "torchscript": (done["torchscript"]["path"],) * 2,
        "onnx": (done["onnx"]["path"],) * 2,
        "saved_model": (Path(str(jstem) + "_saved_model"),) * 2,
        "pb": (jstem.with_suffix(".pb"),) * 2,
        "tflite": (jstem.with_suffix(".tflite"),) * 2,
    }
    images = np.random.default_rng(3).integers(0, 256, (2, IMG, IMG, 3),
                                               np.uint8)
    return cfg, jcfg, files, images


@pytest.mark.parametrize("kind", ["ckpt", "deploy", "pt", "torchscript",
                                  "onnx", "saved_model", "pb", "tflite"])
def test_every_format_matches_jax(artifacts, kind):
    cfg, jcfg, files, images = artifacts
    ours, theirs = files[kind]
    backend = DetectBackend(str(ours), cfg)
    assert backend.kind == kind
    got = backend(images)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "bfloat16", jnp.float32)    # float32, as the port
        jax_backend = JaxDetectBackend(str(theirs), jcfg)
        want = jax_backend(images)
    assert got.shape == want.shape and got.dtype == np.float32
    if kind in ("ckpt", "deploy", "pt"):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)
    backend.warmup(images.shape)


def test_onnx_without_cv2_raises(artifacts, monkeypatch):
    cfg, _, files, _ = artifacts
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        DetectBackend(str(files["onnx"][0]), cfg)
