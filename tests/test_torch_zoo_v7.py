"""The YOLOv7-L and YOLOv7-s-SimOTA YAMLs' models against the JAX package (the cases and
their tolerances: tests/torch_zoo_cases.py)."""

from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_zoo_cases import (  # noqa: F401
    family_fixture, test_models_forward_match_jax,
    test_seeded_init_biases_are_jax_init,
    test_train_gradients_match_jax_in_float64)

family = family_fixture(["yolov7l", "yolov7s_simota"])
