"""Head factory (reference models/head/__init__.py:12-27). Holds the heads
ported so far."""

from .yolov5 import YoloV5Detect

_REGISTRY = {"YoloV5": YoloV5Detect}


def build_head_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"head {name!r}; ported: {sorted(_REGISTRY)}"
        ) from None
