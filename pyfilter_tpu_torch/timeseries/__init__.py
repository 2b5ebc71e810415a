"""The model layer of the port (the subset the SISR main path uses)."""

from . import models
from .affine import affine_transform
from .process import AffineEulerMaruyama, AffineProcess, StructuralStochasticProcess
from .ssm import StateSpaceModel
from .state import TimeseriesState

__all__ = [
    "TimeseriesState",
    "StructuralStochasticProcess",
    "AffineProcess",
    "AffineEulerMaruyama",
    "StateSpaceModel",
    "affine_transform",
    "models",
]
