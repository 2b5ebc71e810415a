"""Parameter inference: the context (plain and quasi-random), priors, batch
PMMH and its proposals, density-tempered SMC, IF2, SMC², NESS and their hybrids, variational inference
and maximum likelihood through the filter, the online score and streaming
maximum likelihood, and chain diagnostics (counterpart of
``pyfilter_tpu/inference``, the subset those paths run)."""

from . import batch, diagnostics, logging, plot, prior, qmc, score, sequential, variational
from .base import BaseAlgorithm
from .batch import IF2, IF2Result, TemperedSMC, TemperedSMCResult
from .batch.mcmc import PMMH, AdaptiveRandomWalk, GradientBasedProposal, PMMHResult, RandomWalk, SymmetricMH, run_pmmh
from .diagnostics import effective_sample_size, potential_scale_reduction, summarize_chains
from .context import InferenceContext, NotSamePriorError, ParameterDoesNotExist, QuasiInferenceContext, make_context
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
from .state import (
    AlgorithmState,
    FilterAlgorithmState,
    RunningFilterResult,
    SequentialAlgorithmState,
    SMC2State,
    scrub_lane_increment,
)
from .qmc import EngineContainer
from .utils import QuasiMultivariateNormal, calc_mean_chol, construct_mvn
from .score import OnlineScoreResult, StreamingMLEResult, fit_mle_streaming, online_score
from .variational import GuideState, MLEResult, SVIResult, fit_mle, fit_svi

__all__ = [
    "batch",
    "logging",
    "plot",
    "prior",
    "qmc",
    "score",
    "sequential",
    "variational",
    "diagnostics",
    "BaseAlgorithm",
    "PMMH",
    "PMMHResult",
    "IF2",
    "IF2Result",
    "TemperedSMC",
    "TemperedSMCResult",
    "RandomWalk",
    "AdaptiveRandomWalk",
    "SymmetricMH",
    "GradientBasedProposal",
    "run_pmmh",
    "InferenceContext",
    "QuasiInferenceContext",
    "make_context",
    "NotSamePriorError",
    "ParameterDoesNotExist",
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
    "AlgorithmState",
    "FilterAlgorithmState",
    "RunningFilterResult",
    "SequentialAlgorithmState",
    "SMC2State",
    "scrub_lane_increment",
    "calc_mean_chol",
    "construct_mvn",
    "fit_svi",
    "fit_mle",
    "online_score",
    "fit_mle_streaming",
    "OnlineScoreResult",
    "StreamingMLEResult",
    "GuideState",
    "SVIResult",
    "MLEResult",
    "potential_scale_reduction",
    "effective_sample_size",
    "summarize_chains",
]
