"""Particle MCMC: batch PMMH, its proposals and the transition SMC² shares,
and PGAS."""

from . import proposals
from .pgas import PGAS, PGASResult, csmc_sweep
from .pmmh import PMMH
from .proposals import AdaptiveRandomWalk, BaseProposal, GradientBasedProposal, RandomWalk, SymmetricMH
from .state import PMMHResult
from .utils import PMMHStep, pmmh_accept, run_pmmh

__all__ = [
    "PMMH",
    "PGAS",
    "PGASResult",
    "csmc_sweep",
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
