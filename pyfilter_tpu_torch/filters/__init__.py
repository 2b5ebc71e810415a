"""Filters of the port: the particle filters and the predictive diagnostics
(PIT, CRPS)."""

from . import particle
from .base import BaseFilter
from .diagnostics import crps, predictive_pit
from .particle import APF, GPF, SISR, ParticleFilter
from .result import FilterHistory, FilterResult
from .state import ParticleFilterCorrection, ParticleFilterPrediction

# the reference's import-path aliases, as the JAX package keeps them
Prediction = ParticleFilterPrediction
Correction = ParticleFilterCorrection

__all__ = [
    "BaseFilter",
    "predictive_pit",
    "crps",
    "ParticleFilter",
    "SISR",
    "APF",
    "GPF",
    "FilterResult",
    "FilterHistory",
    "ParticleFilterCorrection",
    "ParticleFilterPrediction",
    "Prediction",
    "Correction",
    "particle",
]
