"""The port's supervised Trainer against the JAX package's on the YOLOX
and YOLOv8 YAMLs and on YOLOv5-L with keypoints, the Trainer's refusals,
and cli.train / cli.val on the YOLOX and YOLOv8 YAMLs (the cases and their
tolerances: tests/torch_trainer_zoo_cases.py). The YOLOv7 YAMLs are in
test_torch_trainer_zoo_v7.py, the YOLOv6 ones in
test_torch_trainer_zoo_v6.py."""

from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_trainer_zoo_cases import (  # noqa: F401
    cli_run_fixture, kp_run,
    test_anchor_free_loss_with_an_anchor_head_raises_value_error,
    test_cli_train_and_val_on_the_yaml,
    test_keypoint_trainer_batches_schedule_and_counters_exact,
    test_keypoint_trainer_losses_and_results_within_tolerance,
    test_unported_families_raise_naming_the_roadmap,
    test_yolov7_ota_loss_still_raises,
    test_zoo_batches_schedule_and_counters_exact,
    test_zoo_losses_and_results_within_tolerance,
    test_zoo_state_after_each_step_within_tolerance, zoo_runs_fixture)

zoo_runs = zoo_runs_fixture(["yolox", "yolov8"])
cli_run = cli_run_fixture(["yolox", "yolov8"])
