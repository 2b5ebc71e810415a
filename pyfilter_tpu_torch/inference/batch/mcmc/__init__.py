"""Particle MCMC: batch PMMH, its proposals and the transition SMC² shares."""

from . import proposals
from .pmmh import PMMH
from .proposals import AdaptiveRandomWalk, BaseProposal, GradientBasedProposal, RandomWalk, SymmetricMH
from .state import PMMHResult
from .utils import PMMHStep, pmmh_accept, run_pmmh

__all__ = [
    "PMMH",
    "PMMHResult",
    "BaseProposal",
    "RandomWalk",
    "AdaptiveRandomWalk",
    "SymmetricMH",
    "GradientBasedProposal",
    "PMMHStep",
    "pmmh_accept",
    "run_pmmh",
    "proposals",
]
