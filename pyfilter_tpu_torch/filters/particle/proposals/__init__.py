"""Proposal distributions: the bootstrap proposal and the optimal proposal
for linear-Gaussian observations."""

from . import utils
from .base import Proposal, get_pre_weight_func
from .bootstrap import Bootstrap
from .linear import LinearGaussianObservations

__all__ = ["Proposal", "Bootstrap", "LinearGaussianObservations", "get_pre_weight_func", "utils"]
