"""Parameter inference: the context (plain and quasi-random), priors, batch
PMMH and its proposals, SMC², NESS and their hybrids (counterpart of
``pyfilter_tpu/inference``, the subset those paths run)."""

from . import batch, logging, plot, prior, qmc, sequential
from .base import BaseAlgorithm
from .batch.mcmc import PMMH, AdaptiveRandomWalk, PMMHResult, RandomWalk, SymmetricMH
from .context import InferenceContext, QuasiInferenceContext, make_context
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
from .qmc import EngineContainer
from .utils import QuasiMultivariateNormal, calc_mean_chol, construct_mvn

__all__ = [
    "batch",
    "logging",
    "plot",
    "prior",
    "qmc",
    "sequential",
    "BaseAlgorithm",
    "PMMH",
    "PMMHResult",
    "RandomWalk",
    "AdaptiveRandomWalk",
    "SymmetricMH",
    "InferenceContext",
    "QuasiInferenceContext",
    "make_context",
    "EngineContainer",
    "QuasiMultivariateNormal",
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
