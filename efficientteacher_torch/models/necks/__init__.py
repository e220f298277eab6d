"""Neck factory (reference models/neck/__init__.py:23-39). Holds every
neck of the JAX package's registry."""

from .yolov5 import YoloV5Neck
from .yolov6 import YoloV6Neck
from .yolov7 import YoloV7Neck
from .yolov8 import YoloV8Neck

_REGISTRY = {"YoloV5": YoloV5Neck, "YoloV6": YoloV6Neck, "YoloV7": YoloV7Neck,
             "YoloV8": YoloV8Neck}


def build_neck_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"neck {name!r} is not ported yet (ROADMAP Q1.10); ported: "
            f"{sorted(_REGISTRY)}") from None
