"""The resampling ops of the SMC hot path, the hand-written CUDA kernels
that carry the fused resample + gather on the card (single lane and lane
batches), the Hilbert-curve sort of SQMC, and FFBSi's exact fallback
(:mod:`.backward`, a hand-written CUDA kernel too)."""

from .expand import (
    fused_expand,
    fused_expand_lanes,
    systematic_expand,
    systematic_expand_lanes,
)
from .hilbert import hilbert_argsort, hilbert_keys
from .resample import prob_cumsum, systematic_counts

__all__ = [
    "systematic_counts",
    "systematic_expand",
    "fused_expand",
    "systematic_expand_lanes",
    "fused_expand_lanes",
    "prob_cumsum",
    "hilbert_argsort",
    "hilbert_keys",
]
