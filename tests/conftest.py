"""Test environment: force an 8-device virtual CPU platform so sharding
tests run without TPU hardware (the JAX 'fake cluster').

Also maintains the quick/full split: tests matching SLOW_PATTERNS get the
`slow` marker (measured >=19 s on the 1-core CI host, round-2 durations).
`./run_tests.sh --quick` runs `-m "not slow"` (~5-7 min); plain
`./run_tests.sh` runs everything (~40 min)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

# whole-file prefixes or test-name substrings; matched against nodeid
SLOW_PATTERNS = (
    "test_e2e_ssod.py",
    "test_e2e_train.py",
    "test_e2e_loss_families.py",
    "test_zoo_configs_r2.py",
    "test_train_step.py::test_dp_sharded_train_step",
    "test_train_step.py::test_loss_decreases_single_device",
    "test_train_step.py::test_gradient_accumulation",
    "test_keypoints.py::test_keypoint_model_and_loss",
    "test_reference_parity.py::test_forward_parity_yolov8m",
    "test_reference_parity.py::test_multi_teacher_pseudo_label_parity",
    "test_backends_loaders.py",
    "test_model_zoo.py::test_zoo_config_builds_and_runs[yolov5x",
    "test_model_zoo.py::test_zoo_config_builds_and_runs[yolov6s",
    "test_model_zoo.py::test_resnet_backbone_builds",
    "test_model_zoo.py::test_zoo_config_builds_and_runs[yolov5m",
    "test_tal.py::test_tal_loss_finite_and_grads",
    "test_ota_loss.py::test_ota_loss_finite_and_grads",
    # sharded-val: keep the dp8 bit-equality pin in quick; the 2-D mesh
    # variant + the two full validator.run comparisons are compile-heavy
    "test_sharded_val.py::test_sharded_infer_matches_single_device[dp4xsp2",
    "test_sharded_val.py::test_sharded_validator_run_matches_single_device",
    "test_sharded_val.py::test_sharded_val_fallback_on_indivisible_batch",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: excluded by ./run_tests.sh --quick")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(p in item.nodeid for p in SLOW_PATTERNS):
            item.add_marker(pytest.mark.slow)
