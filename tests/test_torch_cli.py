"""The port's CLIs on the CPU: `cli.train` reads the main SSOD YAML itself
(no PyYAML), takes string overrides, and trains one SSOD epoch from files
on disk with `Dataset.device_aug True` (YOLOv5l at width 0.25, 256 px, a
handful of images), writing results.csv, last.ckpt and best.ckpt; then
`cli.val` on best.ckpt, last.ckpt, or a copy whose teacher detects (its
objectness and class biases raised), gives exactly what `validator.run`
gives on the same weights and loader, and `cli.val --save-json --coco-gt`
writes the JSON `validator.run` writes; `cli.val --plots DIR` writes the
PR / F1 / P / R curves and prints the same results."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from efficientteacher_torch.cli import train as cli_train
from efficientteacher_torch.cli import val as cli_val
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.data.datasets import create_dataloader
from efficientteacher_torch.eval import coco, validator
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.utils.checkpoint import (load_checkpoint,
                                                     load_eval_variables,
                                                     load_module_variables,
                                                     module_variables,
                                                     save_checkpoint)
from test_torch_datasets import write_dataset
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
MAIN_YAML = REPO / "configs/ssod/coco-standard/yolov5l_coco_ssod_10_percent.yaml"
SIZES = [(192, 256, "jpg"), (256, 192, "png"), (170, 256, "jpg"),
         (150, 200, "png")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    train = write_dataset(root / "l", SIZES, seed=1, nc=80, name="train")
    target = write_dataset(root / "u", SIZES, seed=2, nc=80, name="target")
    # val labels of classes 0 and 1, the classes the shifted copy detects
    val = write_dataset(root / "v", SIZES * 2, seed=3, nc=2, name="val")
    overrides = [
        "device", "cpu", "project", str(root / "runs"), "name", "ssod",
        "epochs", "1", "hyp.burn_epochs", "0", "Dataset.device_aug", "True",
        "Dataset.train", train, "Dataset.target", target, "Dataset.val", val,
        "Dataset.img_size", "256", "Dataset.batch_size", "2",
        "Dataset.workers", "2", "Model.width_multiple", "0.25",
        "Model.depth_multiple", "0.33"]
    best = cli_train.main(["--cfg", str(MAIN_YAML), *overrides])
    # a copy of best.ckpt whose teacher detects classes 0 and 1: a
    # one-epoch teacher gives no detections at conf 0.001, and P/R/mAP
    # would be 0 on both sides
    weights = root / "runs" / "ssod" / "weights"
    model = _model(overrides, weights / "best.ckpt")
    with torch.no_grad():
        for conv in model.head.m:
            conv.bias.view(model.head.na, model.head.no)[:, 4] += 6.0
            conv.bias.view(model.head.na, model.head.no)[:, 5:7] += 3.0
    v = module_variables(model)
    save_checkpoint(weights / "shifted.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"], ema_params=v["params"],
                    ema_batch_stats=v["batch_stats"])
    return root, overrides, best


def _model(overrides, weights):
    cfg = get_cfg()
    cfg.merge_from_file(str(MAIN_YAML))
    cfg.merge_from_list(overrides)
    model = build_model(spec_from_cfg(cfg), device="cpu")
    load_module_variables(model, load_eval_variables(str(weights)))
    return model.eval()


def test_cli_train_runs_an_ssod_epoch_from_disk(run):
    root, _, best = run
    weights = root / "runs" / "ssod" / "weights"
    rows = (root / "runs" / "ssod" / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[0] == "0"
    last = load_checkpoint(weights / "last.ckpt")
    assert last["meta"]["epoch"] == 0 and "student_ema" in last
    assert (weights / "best.ckpt").is_file()
    assert best >= 0.0
    for entry in ("model", "ema"):
        for t in last[entry]["params"].values():
            assert torch.isfinite(t.float()).all()


def test_cli_train_writes_the_plots_and_tensorboard(run):
    """The trainer's loggers and plots, on rank 0 as in JAX: labels.png
    when the loaders are built, results.png at the end, TensorBoard event
    files under tb/."""
    root, _, _ = run
    out = root / "runs" / "ssod"
    assert (out / "labels.png").stat().st_size > 0
    assert (out / "results.png").stat().st_size > 0
    assert list((out / "tb").glob("events.out.tfevents.*"))


@pytest.mark.parametrize("ckpt", ["best.ckpt", "last.ckpt", "shifted.ckpt"])
def test_cli_val_equals_validator_run(run, capsys, ckpt):
    root, overrides, _ = run
    weights = root / "runs" / "ssod" / "weights" / ckpt
    got = cli_val.main(["--cfg", str(MAIN_YAML), "--weights", str(weights),
                        "--batch-size", "2", "--selection", "approx",
                        *overrides])
    assert "mAP50=" in capsys.readouterr().out
    cfg = get_cfg()
    cfg.merge_from_file(str(MAIN_YAML))
    cfg.merge_from_list(overrides)
    loader = create_dataloader(cfg, "val", augment=False, batch_size=2)
    want = validator.run(_model(overrides, weights), loader, nc=80,
                         compute_dtype=torch.float32)[0]
    assert got == want
    assert all(np.isfinite(got))
    if ckpt == "shifted.ckpt":
        assert got[1] > 0  # some detections match the labels


def test_cli_val_save_json_equals_validator_run(run, tmp_path, capsys):
    """cli.val --save-json --coco-gt writes the JSON validator.run writes
    on the same weights and loader (exact), and re-scores it."""
    root, overrides, _ = run
    weights = root / "runs" / "ssod" / "weights" / "shifted.ckpt"
    cfg = get_cfg()
    cfg.merge_from_file(str(MAIN_YAML))
    cfg.merge_from_list(overrides)
    loader = create_dataloader(cfg, "val", augment=False, batch_size=2)
    gt = coco.yolo_labels_to_coco_gt(loader.ds.img_files,
                                     str(tmp_path / "gt.json"), 80)
    got = cli_val.main(["--cfg", str(MAIN_YAML), "--weights", str(weights),
                        "--batch-size", "2", "--save-json",
                        str(tmp_path / "cli.json"), "--coco-gt", gt,
                        *overrides])
    assert "COCOeval: mAP@0.5" in capsys.readouterr().out
    want = validator.run(_model(overrides, weights), loader, nc=80,
                         compute_dtype=torch.float32,
                         save_json=str(tmp_path / "run.json"))[0]
    assert got == want
    rows = json.loads((tmp_path / "cli.json").read_text())
    assert rows == json.loads((tmp_path / "run.json").read_text())
    assert len(rows) > 0
    assert {r["image_id"] for r in rows} <= {
        Path(p).stem for p in loader.ds.img_files}
    pair = coco.evaluate_predictions_json(str(tmp_path / "cli.json"), gt)
    assert all(np.isfinite(pair)) and pair[0] > 0


# --val-kp and a reference .pt are ported (tests/test_torch_keypoints.py,
# tests/test_torch_pt_bridge.py), and so is --plots: nothing is refused
@pytest.mark.parametrize("flag", [["--plots", "plots"]])
def test_cli_val_refuses_what_is_not_ported(run, flag, tmp_path, capsys):
    """--plots DIR writes the PR / F1 / P / R curves of the detecting copy's
    run and prints the results the run without it prints."""
    root, overrides, _ = run
    shifted = root / "runs" / "ssod" / "weights" / "shifted.ckpt"
    argv = ["--cfg", str(MAIN_YAML), "--weights", str(shifted), *overrides]
    want = cli_val.main(argv)
    plots = tmp_path / flag[1]
    got = cli_val.main(argv[:4] + [flag[0], str(plots)] + argv[4:])
    assert got == want and got[2] > 0
    assert sorted(p.name for p in plots.iterdir()) == [
        "F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png"]
