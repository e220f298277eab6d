"""Neck factory (reference models/neck/__init__.py:23-39). Holds every
neck of the JAX package's registry; `register_neck` adds one."""

from .yolov5 import YoloV5Neck
from .yolov6 import YoloV6Neck
from .yolov7 import YoloV7Neck
from .yolov8 import YoloV8Neck

_REGISTRY = {"YoloV5": YoloV5Neck, "YoloV6": YoloV6Neck, "YoloV7": YoloV7Neck,
             "YoloV8": YoloV8Neck}


def register_neck(name, cls):
    """Add a neck class under `name`."""
    _REGISTRY[name] = cls


def build_neck_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"neck {name!r} is in no registry; registered: "
            f"{sorted(_REGISTRY)}") from None
