"""The port's supervised Trainer against the JAX package's on the
YOLOv6-s and RepOpt finetune YAMLs, and cli.train / cli.val on YOLOv6-s's (the cases and their tolerances:
tests/torch_trainer_zoo_cases.py)."""

from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_trainer_zoo_cases import (  # noqa: F401
    cli_run_fixture, test_cli_train_and_val_on_the_yaml,
    test_zoo_batches_schedule_and_counters_exact,
    test_zoo_losses_and_results_within_tolerance,
    test_zoo_state_after_each_step_within_tolerance, zoo_runs_fixture)

zoo_runs = zoo_runs_fixture(["yolov6s", "yolov6s_repopt"])
cli_run = cli_run_fixture(["yolov6s"])
