"""The zoo families' models against the JAX package (the cases and their
tolerances: tests/torch_zoo_cases.py): the blocks, the decodes, the
registries, the ResNet-50 model, and the YOLOX and YOLOv8 YAMLs. The
YOLOv7 YAMLs are in test_torch_zoo_v7.py, the YOLOv6 ones in
test_torch_zoo_v6.py."""

from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_zoo_cases import (  # noqa: F401
    family_fixture, test_c2f_matches_jax, test_decode_tal_scale_matches_jax,
    test_decode_yolox_scale_matches_jax, test_implicit_tokens_match_jax,
    test_linear_add_block_matches_jax, test_models_forward_match_jax,
    test_registries_and_model_type, test_repvgg_block_matches_jax,
    test_resnet50_model_matches_jax, test_seeded_init_biases_are_jax_init,
    test_train_gradients_match_jax_in_float64,
    test_transpose_in_ne_out_matches_jax)

family = family_fixture(["yolox", "yolov8"])
