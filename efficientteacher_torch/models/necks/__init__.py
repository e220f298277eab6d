"""Neck factory (reference models/neck/__init__.py:23-39). Holds the necks
ported so far."""

from .yolov5 import YoloV5Neck

_REGISTRY = {"YoloV5": YoloV5Neck}


def build_neck_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"neck {name!r}; ported: {sorted(_REGISTRY)}"
        ) from None
