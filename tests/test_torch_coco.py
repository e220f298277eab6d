"""The port's COCO interop (`efficientteacher_torch/eval/coco.py`) and
`validator.run(save_json=...)` against the JAX package's.

`eval/coco.py` equals JAX's on the five cases of tests/test_coco_interop.py
(exact). `validator.run` writes the JSON JAX's writes on the batches and
weights of tests/test_torch_validator.py (float32 on both sides): the same
rows in the same order, image ids and category ids exact, boxes within
1e-3 px and scores within 1e-5 after their rounding (the detections agree
to 1e-3 px and 1e-5 in confidence). COCOeval on the two JSONs against one
ground-truth file: the vendor-free re-scorer gives the same (mAP@0.5,
mAP@[.5:.95]) within 1e-9 where the two JSONs are equal, and within 1e-3
otherwise."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_coco_interop as jax_cases
from efficientteacher_tpu.eval import coco as jax_coco
from efficientteacher_tpu.eval import validator as jax_validator
from efficientteacher_torch.eval import coco
from efficientteacher_torch.eval import validator
from test_torch_validator import IMG, _batches, relu_models  # noqa: F401
from torch_port_helpers import one_torch_thread  # noqa: F401


def test_coco80_to_91_map():
    assert coco.coco80_to_coco91_class() == \
        jax_coco.coco80_to_coco91_class()
    assert len(set(coco.coco80_to_coco91_class())) == 80


def test_coco_image_id_stem():
    for path, fallback in [("/data/val2017/000000000139.jpg", 7),
                           ("/data/imgs/street_01.png", 7), (None, 7),
                           ("", 3)]:
        assert coco.coco_image_id(path, fallback) == \
            jax_coco.coco_image_id(path, fallback)
    assert coco.coco_image_id("/data/val2017/000000000139.jpg", 7) == 139


def test_detections_to_json_mapping():
    det = np.array([[10.0, 20.0, 110.0, 70.0, 0.9, 0.0],
                    [5.0, 5.0, 25.0, 45.0, 0.8, 79.0],
                    [0.12345, 1.98765, 3.5, 9.25, 0.123456789, 5.0]],
                   np.float32)
    for cmap in (coco.coco80_to_coco91_class(), list(range(1000))):
        assert coco.detections_to_json(det, 139, cmap) == \
            jax_coco.detections_to_json(det, 139, cmap)
    rows = coco.detections_to_json(det, 139, coco.coco80_to_coco91_class())
    assert rows[0]["bbox"] == [10.0, 20.0, 100.0, 50.0]
    assert rows[1]["category_id"] == 90


def _preds(tmp_path, preds):
    path = tmp_path / "preds.json"
    path.write_text(json.dumps(preds))
    return str(path)


def test_vendor_free_cocoeval(tmp_path):
    gt = jax_cases._gt_json(tmp_path)
    pred = _preds(tmp_path, [
        {"image_id": 139, "category_id": 1,
         "bbox": [100, 100, 50, 80], "score": 0.9},
        {"image_id": 285, "category_id": 1,
         "bbox": [300, 200, 60, 90], "score": 0.85},
        {"image_id": 139, "category_id": 90,
         "bbox": [500, 400, 20, 30], "score": 0.8},
        {"image_id": 285, "category_id": 90,
         "bbox": [50, 50, 20, 30], "score": 0.7}])
    got = coco.evaluate_predictions_json(pred, gt)
    assert got == jax_coco.evaluate_predictions_json(pred, gt)
    assert abs(got[0] - 0.75) < 0.02 and abs(got[1] - got[0]) < 0.02


def test_vendor_free_cocoeval_perfect(tmp_path):
    gt = jax_cases._gt_json(tmp_path)
    pred = _preds(tmp_path, [
        {"image_id": 139, "category_id": 1,
         "bbox": [100, 100, 50, 80], "score": 0.9},
        {"image_id": 285, "category_id": 1,
         "bbox": [300, 200, 60, 90], "score": 0.85},
        {"image_id": 285, "category_id": 90,
         "bbox": [50, 50, 20, 30], "score": 0.7}])
    got = coco.evaluate_predictions_json(pred, gt)
    assert got == jax_coco.evaluate_predictions_json(pred, gt)
    assert got[0] > 0.99 and got[1] > 0.99
    assert coco.run_cocoeval(pred, gt) == \
        jax_coco.run_cocoeval(pred, gt)


def _gt_from_batches(batches, path, category):
    """A COCO ground-truth file of the batches' labels in native pixels,
    image ids the running image index (what run() uses without paths)."""
    images, anns = [], []
    idx = 0
    for b in batches:
        for bi in range(len(b["images"])):
            pad = b["ratio_pad"][bi][1] if "ratio_pad" in b else (0.0, 0.0)
            hw = b["shapes"][bi] or (IMG, IMG)
            images.append({"id": idx, "height": hw[0], "width": hw[1]})
            for lab in b["labels"][bi][b["mask"][bi]]:
                w, h = lab[3] * IMG, lab[4] * IMG
                x0 = lab[1] * IMG - w / 2 - pad[0]
                y0 = lab[2] * IMG - h / 2 - pad[1]
                anns.append({"id": len(anns) + 1, "image_id": idx,
                             "category_id": category, "iscrowd": 0,
                             "bbox": [float(x0), float(y0), float(w),
                                      float(h)], "area": float(w * h)})
            idx += 1
    path.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": category, "name": "c"}]}))
    return str(path)


@pytest.mark.parametrize("is_coco", [True, False])
def test_validator_json_matches_jax(relu_models, tmp_path, capsys,  # noqa: F811
                                    is_coco):
    jm, variables, port = relu_models
    batches = _batches(jm, variables)
    gt = _gt_from_batches(batches, tmp_path / "gt.json", 1 if is_coco else 0)
    want_path, got_path = tmp_path / "jax.json", tmp_path / "port.json"
    want_out = jax_validator.run(
        jm, variables, batches, nc=1, compute_dtype=jnp.float32,
        save_json=str(want_path), coco_gt_json=gt, is_coco=is_coco)
    want_print = capsys.readouterr().out
    got_out = validator.run(
        port, batches, nc=1, compute_dtype=torch.float32,
        save_json=str(got_path), coco_gt_json=gt, is_coco=is_coco)
    got_print = capsys.readouterr().out
    assert "COCOeval: mAP@0.5" in got_print and "COCOeval" in want_print
    np.testing.assert_allclose(got_out[0][2:], want_out[0][2:], atol=1e-9)
    want = json.loads(want_path.read_text())
    got = json.loads(got_path.read_text())
    assert len(got) == len(want) > 20
    assert [(r["image_id"], r["category_id"]) for r in got] == \
        [(r["image_id"], r["category_id"]) for r in want]
    assert {r["category_id"] for r in got} == {1 if is_coco else 0}
    # one quantum of the rounding (3 and 5 decimals); the slack is the
    # binary error of the decimal difference (0.001 is not exact)
    np.testing.assert_allclose([r["bbox"] for r in got],
                               [r["bbox"] for r in want], rtol=0,
                               atol=1e-3 + 1e-9)
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=0,
                               atol=1e-5 + 1e-11)
    pair = coco.evaluate_predictions_json(str(got_path), gt)
    want_pair = jax_coco.evaluate_predictions_json(str(want_path), gt)
    np.testing.assert_allclose(pair, want_pair, rtol=0,
                               atol=1e-9 if got == want else 1e-3)
    assert pair[0] > 0.3
