"""Sequential inference: SMC² with its PMMH rejuvenation kernel."""

from . import kernels
from .base import SequentialParticleAlgorithm
from .kernels import ParticleMetropolisHastings, TooManyIncreases
from .smc2 import SMC2
from .threshold import ConstantThreshold, Thresholder

__all__ = [
    "SequentialParticleAlgorithm",
    "SMC2",
    "ParticleMetropolisHastings",
    "TooManyIncreases",
    "Thresholder",
    "ConstantThreshold",
    "kernels",
]
