"""Sequential inference: SMC² with its PMMH rejuvenation kernel, NESS and
FixedWidthNESS with the online jittering kernel, and their hybrids NESSMC2
and SMC2FW."""

from . import kernels, threshold
from .base import CombinedSequentialParticleAlgorithm, SequentialParticleAlgorithm
from .kernels import ParticleMetropolisHastings, TooManyIncreases
from .ness import NESS, BaseOnlineAlgorithm, FixedWidthNESS
from .nessmc2 import NESSMC2, SMC2FW
from .smc2 import SMC2
from .threshold import ConstantThreshold, DecayingThreshold, IntervalThreshold, Thresholder

__all__ = [
    "SequentialParticleAlgorithm",
    "CombinedSequentialParticleAlgorithm",
    "BaseOnlineAlgorithm",
    "NESS",
    "FixedWidthNESS",
    "SMC2",
    "NESSMC2",
    "SMC2FW",
    "ParticleMetropolisHastings",
    "TooManyIncreases",
    "Thresholder",
    "ConstantThreshold",
    "DecayingThreshold",
    "IntervalThreshold",
    "kernels",
    "threshold",
]
