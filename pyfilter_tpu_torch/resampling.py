"""Resampling schemes: ``systematic`` (the search-based one) and
``systematic_m`` (``m`` draws from one lane's ``N`` weights).

Counterpart of ``pyfilter_tpu/resampling.py`` (``systematic`` and
``systematic_m``; the other schemes come later). SMC²'s rejuvenation
resamples its parameter lanes with ``systematic``, the smoothers draw ``M !=
N`` trajectory ends with ``systematic_m``; the particle clouds take the
counts-based expansion in ``ops``.
Conventions: ``(N, *batch)`` unnormalized log-weights with the particle axis
first (``normalized=True`` for probabilities), one uniform per lane from an
explicit ``torch.Generator`` unless ``u`` is given, int32 indices of the
weights' shape.
"""

from __future__ import annotations

import torch

from .ops.resample import prob_cumsum
from .utils import normalize

__all__ = ["systematic", "systematic_m"]


def systematic(
    generator: torch.Generator | None,
    weights: torch.Tensor,
    normalized: bool = False,
    u: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Systematic resampling: positions ``(i + u) / N``, cumulative weights
    (the exact fixed-point sum of ``ops.resample.prob_cumsum``, as every
    resampler of the port takes them) with the last one forced to 1, and
    ``searchsorted(side="right")`` (a position on a tie never selects a
    zero-weight particle)."""
    probs = weights if normalized else normalize(weights, dim=0)
    n, batch_shape = probs.shape[0], tuple(probs.shape[1:])
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand(batch_shape, generator=generator, dtype=probs.dtype, device=probs.device)
    u = torch.as_tensor(u, dtype=probs.dtype, device=probs.device).expand(batch_shape)

    cumw = prob_cumsum(probs.movedim(0, -1)).movedim(-1, 0)
    cumw[-1] = 1.0
    offsets = torch.arange(n, dtype=probs.dtype, device=probs.device).reshape((n,) + (1,) * len(batch_shape))
    positions = ((offsets + u) / n).expand(probs.shape)
    # lanes leading, (B, N): searchsorted runs along the last axis
    idx = torch.searchsorted(cumw.reshape(n, -1).T.contiguous(), positions.reshape(n, -1).T.contiguous(), right=True)
    return torch.clamp(idx, max=n - 1).to(torch.int32).T.reshape(probs.shape)


def systematic_m(
    generator: torch.Generator | None,
    weights: torch.Tensor,
    m: int,
    normalized: bool = False,
    u: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """``m`` systematic draws from the ``N`` weights of one lane: positions
    ``(i + u) / m`` against the same exact fixed-point cumulative weights as
    :func:`systematic`. Returns int32 indices ``(m,)``."""
    probs = weights if normalized else normalize(weights, dim=0)
    if probs.dim() != 1:
        raise ValueError("systematic_m supports 1-D weights only")
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand((), generator=generator, dtype=probs.dtype, device=probs.device)
    u = torch.as_tensor(u, dtype=probs.dtype, device=probs.device)
    cumw = prob_cumsum(probs)
    cumw[-1] = 1.0
    positions = (torch.arange(m, dtype=probs.dtype, device=probs.device) + u) / m
    idx = torch.searchsorted(cumw, positions, right=True)
    return torch.clamp(idx, max=probs.shape[0] - 1).to(torch.int32)
