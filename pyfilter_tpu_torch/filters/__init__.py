"""Filters of the port."""

from . import particle
from .base import BaseFilter
from .particle import APF, GPF, SISR, ParticleFilter
from .result import FilterHistory, FilterResult
from .state import ParticleFilterCorrection, ParticleFilterPrediction

__all__ = [
    "BaseFilter",
    "ParticleFilter",
    "SISR",
    "APF",
    "GPF",
    "FilterResult",
    "FilterHistory",
    "ParticleFilterCorrection",
    "ParticleFilterPrediction",
    "particle",
]
