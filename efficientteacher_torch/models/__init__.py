from .detector import Model, SSODModel, build_model
from .spec import ModelSpec, spec_from_cfg

__all__ = ["Model", "ModelSpec", "SSODModel", "build_model", "spec_from_cfg"]
