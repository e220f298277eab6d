"""Backbone factory (reference models/backbone/__init__.py:8-23). Holds the
backbones ported so far."""

from .yolov5 import YoloV5BackBone

_REGISTRY = {"YoloV5": YoloV5BackBone}


def build_backbone_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"backbone {name!r}; ported: {sorted(_REGISTRY)}"
        ) from None
