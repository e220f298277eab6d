"""Backbone factory (reference models/backbone/__init__.py:8-23). Holds every
backbone of the JAX package's registry; `register_backbone` adds one."""

from .resnet import ResNet50BackBone
from .yolov5 import YoloV5BackBone
from .yolov6 import YoloV6BackBone
from .yolov7 import YoloV7BackBone
from .yolov8 import YoloV8BackBone

_REGISTRY = {"YoloV5": YoloV5BackBone, "YoloV6": YoloV6BackBone,
             "YoloV7": YoloV7BackBone, "YoloV8": YoloV8BackBone,
             "ResNet50": ResNet50BackBone, "resnet50": ResNet50BackBone}


def register_backbone(name, cls):
    """Add a backbone class under `name`."""
    _REGISTRY[name] = cls


def build_backbone_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"backbone {name!r} is in no registry; registered: "
            f"{sorted(_REGISTRY)}") from None
