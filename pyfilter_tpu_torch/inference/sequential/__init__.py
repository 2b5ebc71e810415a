"""Sequential inference: SMC² with its PMMH rejuvenation kernel (waste-free
or not), NESS and FixedWidthNESS with the online jittering kernel, their
hybrids NESSMC2 and SMC2FW, the collectors, and the Storvik filter."""

from . import collectors, kernels, threshold
from .base import CombinedSequentialParticleAlgorithm, SequentialParticleAlgorithm
from .collectors import Collector, MeanCollector, ParameterPosterior, Standardizer
from .kernels import ParticleMetropolisHastings, TooManyIncreases
from .ness import NESS, BaseOnlineAlgorithm, FixedWidthNESS
from .nessmc2 import NESSMC2, SMC2FW
from .smc2 import SMC2
from .storvik import (
    NIGARUnknownObsVariance,
    NIGAutoregression,
    NIGVectorAutoregression,
    PoissonGammaCounts,
    StorvikFilter,
    StorvikResult,
)
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
    "StorvikFilter",
    "StorvikResult",
    "NIGAutoregression",
    "NIGARUnknownObsVariance",
    "NIGVectorAutoregression",
    "PoissonGammaCounts",
    "Collector",
    "MeanCollector",
    "Standardizer",
    "ParameterPosterior",
    "kernels",
    "threshold",
    "collectors",
]
