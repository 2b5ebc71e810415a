"""The resampling ops of the SMC hot path, and the hand-written CUDA kernel
that carries the fused resample + gather on the card."""

from .expand import expand_from_counts, fused_expand, systematic_expand
from .resample import prob_cumsum, systematic_counts

__all__ = [
    "systematic_counts",
    "systematic_expand",
    "expand_from_counts",
    "fused_expand",
    "prob_cumsum",
]
