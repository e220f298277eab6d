"""Backbone factory (reference models/backbone/__init__.py:8-23). Holds the
backbones ported so far; YOLOv6, YOLOv7 and ResNet raise (ROADMAP
Q1.10)."""

from .yolov5 import YoloV5BackBone
from .yolov8 import YoloV8BackBone

_REGISTRY = {"YoloV5": YoloV5BackBone, "YoloV8": YoloV8BackBone}


def build_backbone_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (ROADMAP Q1.10); ported: "
            f"{sorted(_REGISTRY)}") from None
