"""Head factory (reference models/head/__init__.py:12-27). Holds every
head of the JAX package's registry; `register_head` adds one.

`head_model_type` is the detector's model_type dispatch (reference
yolo.py:66-82; JAX heads/__init__.py `_MODEL_TYPE`): anchor heads ->
'yolov5', the YOLOX head -> 'yolox', the TAL heads -> 'tal'."""

from .yolov5 import YoloV5Detect
from .yolov6 import YoloV6Detect
from .yolov7 import YoloV7Detect
from .yolov8 import YoloV8Detect
from .yolox import YoloXDetect

_REGISTRY = {"YoloV5": YoloV5Detect, "YoloV6": YoloV6Detect,
             "YoloV7": YoloV7Detect, "YoloV8": YoloV8Detect,
             "YoloX": YoloXDetect}

_MODEL_TYPE = {
    "YoloV5": "yolov5",
    "YoloV7": "yolov5",   # IDetect is anchor-based like Detect
    "YoloX": "yolox",
    "YoloV6": "tal",
    "YoloV8": "tal",
}


def register_head(name, cls, model_type: str):
    """Add a head class under `name`, with the loss family it trains with
    ('yolov5', 'yolox' or 'tal')."""
    _REGISTRY[name] = cls
    _MODEL_TYPE[name] = model_type


def build_head_cls(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"head {name!r} is in no registry; registered: "
            f"{sorted(_REGISTRY)}") from None


def head_model_type(name: str) -> str:
    return _MODEL_TYPE.get(name, "yolov5")
