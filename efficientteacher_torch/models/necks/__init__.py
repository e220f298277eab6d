"""Neck factory (reference models/neck/__init__.py:23-39). Holds the necks
ported so far; YOLOv6 and YOLOv7 raise (ROADMAP Q1.10)."""

from .yolov5 import YoloV5Neck
from .yolov8 import YoloV8Neck

_REGISTRY = {"YoloV5": YoloV5Neck, "YoloV8": YoloV8Neck}


def build_neck_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"neck {name!r} is not ported yet (ROADMAP Q1.10); ported: "
            f"{sorted(_REGISTRY)}") from None
