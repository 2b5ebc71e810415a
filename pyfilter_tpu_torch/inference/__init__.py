"""Parameter inference: the context, priors, PMMH pieces, SMC², NESS and
their hybrids (counterpart of ``pyfilter_tpu/inference``, the subset the SMC²
and NESS paths run)."""

from . import batch, logging, prior, sequential
from .base import BaseAlgorithm
from .batch.mcmc import SymmetricMH
from .context import InferenceContext, make_context
from .parameter import PriorBoundParameter
from .sequential import (
    NESS,
    NESSMC2,
    SMC2,
    SMC2FW,
    BaseOnlineAlgorithm,
    CombinedSequentialParticleAlgorithm,
    FixedWidthNESS,
    ParticleMetropolisHastings,
    SequentialParticleAlgorithm,
    TooManyIncreases,
)
from .state import RunningFilterResult, SequentialAlgorithmState, SMC2State, scrub_lane_increment
from .utils import calc_mean_chol, construct_mvn

__all__ = [
    "batch",
    "logging",
    "prior",
    "sequential",
    "BaseAlgorithm",
    "SymmetricMH",
    "InferenceContext",
    "make_context",
    "PriorBoundParameter",
    "SMC2",
    "NESS",
    "FixedWidthNESS",
    "NESSMC2",
    "SMC2FW",
    "BaseOnlineAlgorithm",
    "CombinedSequentialParticleAlgorithm",
    "ParticleMetropolisHastings",
    "SequentialParticleAlgorithm",
    "TooManyIncreases",
    "RunningFilterResult",
    "SequentialAlgorithmState",
    "SMC2State",
    "scrub_lane_increment",
    "calc_mean_chol",
    "construct_mvn",
]
