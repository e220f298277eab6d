from .detector import Model, build_model
from .spec import ModelSpec, spec_from_cfg

__all__ = ["Model", "ModelSpec", "build_model", "spec_from_cfg"]
