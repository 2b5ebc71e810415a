"""Parameter inference: the context, priors, PMMH pieces and SMC²
(counterpart of ``pyfilter_tpu/inference``, the subset the SMC² path runs)."""

from . import batch, logging, prior, sequential
from .base import BaseAlgorithm
from .batch.mcmc import SymmetricMH
from .context import InferenceContext, make_context
from .parameter import PriorBoundParameter
from .sequential import SMC2, ParticleMetropolisHastings, SequentialParticleAlgorithm, TooManyIncreases
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
