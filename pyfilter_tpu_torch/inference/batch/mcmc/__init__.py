"""PMMH building blocks (the proposal and the transition SMC² uses)."""

from .proposals import BaseProposal, SymmetricMH
from .utils import PMMHStep, pmmh_accept, run_pmmh

__all__ = ["BaseProposal", "SymmetricMH", "PMMHStep", "pmmh_accept", "run_pmmh"]
