"""The port's deploy exports on the CPU (`cli.export`,
`export/onnx_graph.py`) against the JAX package's.

- ONNX: the port writes its fused deploy model straight to ONNX, with no
  `onnx` package; cv2.dnn (an independent ONNX runtime) runs the file and
  matches the port's own float32 forward for the five families of JAX's
  tests/test_onnx_export.py, on the same tiny configs (width 0.125, depth
  0.34, nc 7, 96 px) and JAX's init of the deploy graph (PRNGKey 0)
  carried across, at JAX's tolerances: atol 2e-4, YOLOv7 5e-4. The YOLOv5 graph is flat:
  no BatchNormalization node and no BN Sub chain (JAX's census).
- `--include torch`: the reference-named `.npz` equals JAX's `export.py
  --include torch` key for key and value for value on the same fp16
  checkpoint, but for the YOLOv6 ConvTranspose kernels, which JAX lays
  out as a conv's (ROADMAP F5): there the port's is torch's layout, the
  JAX file's the same values transposed (checked as such).
- `--include torchscript`: JAX's own DetectBackend loads the port's
  `.torchscript` and gives the port's float32 forward (bit-equal: the
  traced graph replays the same CPU ops).
- The TensorFlow formats raise NotImplementedError.
"""

import argparse
import dataclasses
import importlib.util
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.eval.multi_backend import \
    DetectBackend as JaxDetectBackend
from efficientteacher_tpu.models import build_model as jax_build_model
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec
from efficientteacher_tpu.utils.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from efficientteacher_torch.cli import export as cli_export
from efficientteacher_torch.export.onnx_graph import export_onnx
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                     save_checkpoint)
from efficientteacher_torch.utils.jax_import import state_dict_from_jax

from torch_port_helpers import jax_and_port_models
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
IMG = 96


def _tiny_cfg(backbone, neck, head, nc=7):
    """tests/test_onnx_export.py's _tiny_cfg."""
    cfg = jax_get_cfg()
    cfg.Model.Backbone.name = backbone
    cfg.Model.Neck.name = neck
    cfg.Model.Head.name = head
    cfg.Model.Neck.in_channels = [256, 512, 1024]
    cfg.Model.Neck.out_channels = [256, 512, 1024]
    cfg.Model.width_multiple = 0.125
    cfg.Model.depth_multiple = 0.34
    cfg.Dataset.nc = nc
    cfg.Dataset.img_size = IMG
    return cfg


FAMILIES = {
    "yolov5": (("YoloV5", "YoloV5", "YoloV5"), 2e-4),
    "yolox": (("YoloV5", "YoloV5", "YoloX"), 2e-4),
    "yolov6_deploy": (("YoloV6", "YoloV6", "YoloV6"), 2e-4),
    "yolov7": (("YoloV7", "YoloV7", "YoloV7"), 5e-4),
    "yolov8": (("YoloV8", "YoloV8", "YoloV8"), 2e-4),
}


def _deploy_model(cfg):
    """The port's deploy model holding the JAX deploy model's init
    (PRNGKey 0), as tests/test_onnx_export.py inits its deploy graph."""
    spec = dataclasses.replace(jax_spec(cfg), deploy=True)
    jm = jax_build_model(spec, ssod=False)
    variables = jax.jit(lambda key: jm.init(
        key, jnp.zeros((1, IMG, IMG, 3)), train=False))(
            jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = build_model(dataclasses.replace(spec_from_cfg(cfg), deploy=True),
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_onnx_runs_in_cv2_dnn_and_matches_the_port(family, tmp_path):
    names, atol = FAMILIES[family]
    model = _deploy_model(_tiny_cfg(*names))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 3, IMG, IMG)).astype(np.float32))
    with torch.no_grad():
        ref = model(x, decode=True)[0].numpy()
    path = tmp_path / "m.onnx"
    census = export_onnx(model, x, path)
    assert "BatchNormalization" not in census
    if family == "yolov6_deploy":
        assert census["ConvTranspose"] == 2
    net = cv2.dnn.readNetFromONNX(str(path))
    net.setInput(x.numpy())
    out = net.forward()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)
    if family == "yolov5":
        # JAX's census (test_bn_folding_produces_flat_conv_graph): every
        # conv's BN folded, the only Subs the decode's three `2 s - 0.5`
        data = path.read_bytes()
        assert data.count(b"\x22\x04Conv") == census["Conv"] >= 30
        assert census.get("Sub", 0) <= 3


def _jax_export_main():
    spec = importlib.util.spec_from_file_location("jax_export",
                                                  REPO / "export.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _weights(tmp_path, yaml, overrides):
    """One fp16 checkpoint of JAX init weights in each package's format,
    with the config YAML the CLIs read."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(overrides)
    _, variables, port = jax_and_port_models(cfg)
    v = module_variables(port)
    save_checkpoint(tmp_path / "w.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"])
    # JAX's own init, which the port's bridge carried across (a round trip
    # through JAX's .pt-style import would lay the ConvTranspose out wrong,
    # F5)
    jax_save_checkpoint(tmp_path / "jax" / "w.ckpt",
                        params=variables["params"],
                        batch_stats=variables["batch_stats"])
    return cfg, port


@pytest.mark.parametrize("yaml", ["yolov5l_coco.yaml", "yolov6s_coco.yaml"])
def test_state_dict_npz_equals_jax_export(yaml, tmp_path):
    yaml = REPO / "configs/sup/public" / yaml
    overrides = ["Model.width_multiple", "0.125", "Model.depth_multiple",
                 "0.33", "Dataset.img_size", str(IMG)]
    _weights(tmp_path, yaml, overrides)
    done = cli_export.main(["--cfg", str(yaml), "--weights",
                            str(tmp_path / "w.ckpt"), "--include", "torch",
                            "--img-size", str(IMG), *overrides, "device",
                            "cpu"])
    _jax_export_main()(argparse.Namespace(
        cfg=str(yaml), weights=str(tmp_path / "jax" / "w.ckpt"),
        include=["torch"], opset=13, int8=False, data_dir=None,
        img_size=IMG, batch=1, out=None, opts=overrides))
    got = dict(np.load(done["torch"]["path"]))
    want = dict(np.load(tmp_path / "jax" / "w.state_dict.npz"))
    assert sorted(got) == sorted(want)
    transposed = 0
    for k, v in got.items():
        if ".upsample_transpose." in k and k.endswith(".weight"):
            # F5: JAX writes the ConvTranspose kernel (kh, kw, in, out) as
            # a conv's (out, in, kh, kw); torch's layout is (in, out, kh,
            # kw) with the taps flipped
            np.testing.assert_array_equal(
                v, want[k].transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])
            transposed += 1
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert transposed == (2 if "yolov6" in yaml.name else 0)


def test_torchscript_loads_in_jax_detect_backend(tmp_path):
    yaml = REPO / "configs/sup/public/yolov5l_coco.yaml"
    overrides = ["Model.width_multiple", "0.125", "Model.depth_multiple",
                 "0.33", "Dataset.img_size", str(IMG)]
    cfg, port = _weights(tmp_path, yaml, overrides)
    done = cli_export.main(["--cfg", str(yaml), "--weights",
                            str(tmp_path / "w.ckpt"), "--include",
                            "torchscript", "--img-size", str(IMG),
                            *overrides, "device", "cpu"])
    images = np.random.default_rng(1).integers(0, 256, (2, IMG, IMG, 3),
                                                np.uint8)
    cfg.freeze()
    got = JaxDetectBackend(str(done["torchscript"]["path"]), cfg)(images)
    # the port's forward on the fp16-rounded weights the file holds
    sd = {k: v.half().float() for k, v in port.state_dict().items()}
    port.load_state_dict(sd)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        want = port(x, decode=True)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [["--include", "saved_model"],
                                   ["--include", "pb", "tflite"],
                                   ["--include", "onnx", "--int8"]])
def test_tensorflow_formats_raise(flags):
    with pytest.raises(NotImplementedError, match="jax2tf"):
        cli_export.main(["--cfg", "x.yaml", "--weights", "w.ckpt", *flags])

