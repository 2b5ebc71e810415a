"""Proposal distributions: the bootstrap proposal, the optimal proposal for
linear-Gaussian observations, the linearized and nested proposals, the
Gaussian-approximate proposals of the GPF and the local linearization of a
nonlinear observation mean."""

from . import utils
from .approximate import GaussianLinear, GaussianLinearized, GaussianProposal
from .base import Proposal, get_pre_weight_func
from .bootstrap import Bootstrap
from .linear import LinearGaussianObservations
from .linearized import Linearized
from .local_linearization import LocalLinearization
from .nested import NestedProposal

__all__ = [
    "Proposal",
    "Bootstrap",
    "LinearGaussianObservations",
    "Linearized",
    "NestedProposal",
    "GaussianProposal",
    "GaussianLinearized",
    "GaussianLinear",
    "LocalLinearization",
    "get_pre_weight_func",
    "utils",
]
