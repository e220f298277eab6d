"""The port's config tree (`efficientteacher_torch/configs`) against the
JAX package's: the defaults key for key, every YAML under `configs/`
merged, dotted overrides (typed, and strings parsed as YAML), the port's
JSON dump (read back by `yaml.safe_load` and `json.loads`), and
`chip_smoke.py`'s config against the main SSOD YAML. Tolerance: none,
the trees are equal."""

import glob
import json
from pathlib import Path

import pytest
import yaml

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_torch.configs import get_cfg

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(glob.glob(str(REPO / "configs" / "**" / "*.yaml"),
                         recursive=True))
MAIN_YAML = REPO / "configs/ssod/coco-standard/yolov5l_coco_ssod_10_percent.yaml"


def test_defaults_equal_key_for_key():
    assert get_cfg().to_dict() == jax_get_cfg().to_dict()
    assert yaml.safe_load(get_cfg().dump()) == jax_get_cfg().to_dict()


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: Path(p).stem)
def test_every_yaml_merges_to_the_same_tree(path):
    port, ref = get_cfg(), jax_get_cfg()
    port.merge_from_file(path)
    ref.merge_from_file(path)
    assert port.to_dict() == ref.to_dict()
    # the port's dump (JSON, no PyYAML) reads back to the same tree
    assert yaml.safe_load(port.dump()) == ref.to_dict()


def test_merge_from_list_matches_jax():
    opts = ["epochs", 12, "hyp.lr0", 0.02, "noval", True,
            "Model.anchors", [[10, 13], [16, 30]], "Dataset.names",
            ["a", "b"], "name", "run 3", "hyp.lrf", 1, "nosave", 1,
            "Model.width_multiple", 0.5, "Dataset.np", 0.0]
    port, ref = get_cfg(), jax_get_cfg()
    port.merge_from_list(opts)
    ref.merge_from_list(opts)
    assert port.to_dict() == ref.to_dict()
    assert port.hyp.lr0 == 0.02 and port.noval is True
    with pytest.raises(KeyError):
        port.merge_from_list(["hyp.no_such_key", 1])
    port.freeze()
    with pytest.raises(AttributeError):
        port.epochs = 3


@pytest.mark.parametrize("key,text", [
    ("epochs", "12"), ("hyp.lr0", "0.02"), ("noval", "true"),
    ("Model.anchors", "[[10, 13], [16, 30]]"), ("Dataset.np", "0")])
def test_string_override_of_a_typed_key_is_refused(key, text):
    # no longer refused: parsed as YAML, as the JAX package parses it (the
    # CLIs pass every override as a string)
    port, ref = get_cfg(), jax_get_cfg()
    port.merge_from_list([key, text])
    ref.merge_from_list([key, text])
    assert port.to_dict() == ref.to_dict()
    node = port
    for part in key.split("."):
        node = node[part]
    assert not isinstance(node, str)


def test_dump_round_trips_awkward_values():
    cfg = get_cfg()
    cfg.name = "on"           # a YAML 1.1 boolean word, as a string
    cfg.project = "a: b # c"
    cfg.Dataset.names = ["x", "yes", "1"]
    assert yaml.safe_load(cfg.dump()) == cfg.to_dict()
    cfg.hyp.lr0 = 1e-05       # repr without a dot: YAML 1.1 reads a string
    assert json.loads(cfg.dump()) == cfg.to_dict()


def test_chip_smoke_overrides_reproduce_the_main_yaml():
    import chip_smoke

    ref = jax_get_cfg()
    ref.merge_from_file(str(MAIN_YAML))
    assert chip_smoke.ssod_cfg().to_dict() == ref.to_dict()
