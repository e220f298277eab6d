"""The PyTorch port imports neither jax, flax, yaml, cv2, PIL, sklearn nor
matplotlib (the GPU machine it runs on need not have them), nor the JAX
package.
Checked in a fresh interpreter, since this test process has them
loaded."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "efficientteacher_torch",
    "efficientteacher_torch.models",
    "efficientteacher_torch.models.common",
    "efficientteacher_torch.models.detector",
    "efficientteacher_torch.models.spec",
    "efficientteacher_torch.models.backbones.yolov5",
    "efficientteacher_torch.models.necks.yolov5",
    "efficientteacher_torch.models.heads.yolov5",
    "efficientteacher_torch.models.backbones.yolov8",
    "efficientteacher_torch.models.necks.yolov8",
    "efficientteacher_torch.models.backbones.resnet",
    "efficientteacher_torch.models.backbones.yolov6",
    "efficientteacher_torch.models.backbones.yolov7",
    "efficientteacher_torch.models.necks.yolov6",
    "efficientteacher_torch.models.necks.yolov7",
    "efficientteacher_torch.models.heads.yolov6",
    "efficientteacher_torch.models.heads.yolov7",
    "efficientteacher_torch.models.heads.yolov8",
    "efficientteacher_torch.models.heads.yolox",
    "efficientteacher_torch.assigners.simota",
    "efficientteacher_torch.assigners.tal",
    "efficientteacher_torch.assigners.topk",
    "efficientteacher_torch.losses.yolox_loss",
    "efficientteacher_torch.losses.tal_loss",
    "efficientteacher_torch.ops.boxes",
    "efficientteacher_torch.ops._build",
    "efficientteacher_torch.ops.nms",
    "efficientteacher_torch.ops.nms_cuda",
    "efficientteacher_torch.ops.select_cuda",
    "efficientteacher_torch.eval.validator",
    "efficientteacher_torch.utils.eval_regimes",
    "efficientteacher_torch.utils.jax_import",
    "efficientteacher_torch.utils.precision",
    "efficientteacher_torch.assigners.yolo_anchor",
    "efficientteacher_torch.losses.common",
    "efficientteacher_torch.losses.domain_loss",
    "efficientteacher_torch.losses.yolov5_loss",
    "efficientteacher_torch.losses.ssod_loss",
    "efficientteacher_torch.ssod.pseudo_label",
    "efficientteacher_torch.train.optim",
    "efficientteacher_torch.train.train_state",
    "efficientteacher_torch.train.supervised",
    "efficientteacher_torch.train.ssod_step",
    "efficientteacher_torch.train.from_jax",
    "efficientteacher_torch.train.repopt",
    "efficientteacher_torch.utils.reparam",
    "efficientteacher_torch.train.trainer",
    "efficientteacher_torch.train.ssod_trainer",
    "efficientteacher_torch.configs",
    "efficientteacher_torch.configs.cfg_node",
    "efficientteacher_torch.configs.defaults",
    "efficientteacher_torch.configs.yaml_lite",
    "efficientteacher_torch.cli",
    "efficientteacher_torch.cli.train",
    "efficientteacher_torch.cli.val",
    "efficientteacher_torch.data",
    "efficientteacher_torch.data.augment",
    "efficientteacher_torch.data.autoaugment",
    "efficientteacher_torch.data.datasets",
    "efficientteacher_torch.data.datasets_ssod",
    "efficientteacher_torch.data.image_io",
    "efficientteacher_torch.data.tiff_io",
    "efficientteacher_torch.data.webp_io",
    "efficientteacher_torch.data.parallel_loader",
    "efficientteacher_torch.ops.augment_device",
    "efficientteacher_torch.utils.native_loader",
    "efficientteacher_torch.eval.metrics",
    "efficientteacher_torch.eval.coco",
    "efficientteacher_torch.ssod.quality",
    "efficientteacher_torch.parallel.distributed",
    "efficientteacher_torch.utils.callbacks",
    "efficientteacher_torch.utils.checkpoint",
    "efficientteacher_torch.utils.general",
    "efficientteacher_torch.utils.shutdown",
    "efficientteacher_torch.losses.yolov5_ota_loss",
    "efficientteacher_torch.ssod.labelmatch",
    "efficientteacher_torch.data.autoanchor",
    "efficientteacher_torch.utils.torch_import",
    "efficientteacher_torch.eval.keypoint_metrics",
    "efficientteacher_torch.data.loaders",
    "efficientteacher_torch.utils.draw",
    "efficientteacher_torch.models.autoshape",
    "efficientteacher_torch.cli.detect",
    "efficientteacher_torch.cli.export",
    "efficientteacher_torch.export",
    "efficientteacher_torch.export.onnx_proto",
    "efficientteacher_torch.export.onnx_graph",
    "efficientteacher_torch.eval.multi_backend",
    "efficientteacher_torch.utils.profile",
    "efficientteacher_torch.utils.loggers",
    "efficientteacher_torch.utils.wandb_artifacts",
    "efficientteacher_torch.utils.plots",
    "chip_smoke",
    "ab_kernels",
]


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'yaml', 'cv2', 'PIL', 'sklearn',\n"
        "                              'matplotlib', 'tensorflow', 'wandb',\n"
        "                              'efficientteacher_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# the tests' writers and fixture checks chip_smoke.py imports on the card's
# machine
CHIP_HELPERS = ["test_torch_image_formats", "test_torch_webp",
                "test_torch_tiff_kinds"]


def test_chip_smoke_helpers_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
        f"for m in {CHIP_HELPERS!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'efficientteacher_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (as here) it exits non-zero and prints no result line;
    alone in a directory it cannot import the port and fails too."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_port_sources_import_no_sklearn_or_jax_even_lazily():
    """No import statement anywhere in the port's sources (function-level
    ones included, which the import check above cannot see) names sklearn,
    jax, flax or the JAX package: LabelMatch fits its own mixture."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(sklearn|jax|jaxlib|flax|"
                         r"efficientteacher_tpu)\b", re.M)
    bad = [str(p.relative_to(REPO))
           for p in sorted((REPO / "efficientteacher_torch").rglob("*.py"))
           + [REPO / "chip_smoke.py"]
           if pattern.search(p.read_text())]
    assert not bad, bad
