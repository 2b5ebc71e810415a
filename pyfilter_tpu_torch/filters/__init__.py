"""Filters of the port."""

from . import particle
from .base import BaseFilter
from .particle import APF, SISR, ParticleFilter
from .result import FilterHistory, FilterResult
from .state import ParticleFilterCorrection, ParticleFilterPrediction

__all__ = [
    "BaseFilter",
    "ParticleFilter",
    "SISR",
    "APF",
    "FilterResult",
    "FilterHistory",
    "ParticleFilterCorrection",
    "ParticleFilterPrediction",
    "particle",
]
