"""The model layer of the port."""

from . import models
from .affine import affine_transform
from .joint import JointDistribution, JointProcess, joint_process
from .process import AffineEulerMaruyama, AffineProcess, LinearModel, StructuralStochasticProcess
from .ssm import LinearStateSpaceModel, StateSpaceModel
from .state import StateSpacePath, TimeseriesState

__all__ = [
    "TimeseriesState",
    "StateSpacePath",
    "StructuralStochasticProcess",
    "AffineProcess",
    "AffineEulerMaruyama",
    "LinearModel",
    "StateSpaceModel",
    "LinearStateSpaceModel",
    "affine_transform",
    "JointDistribution",
    "JointProcess",
    "joint_process",
    "models",
]
