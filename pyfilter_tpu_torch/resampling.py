"""Resampling schemes: ``systematic``, ``stratified``, ``multinomial``,
``residual``, ``metropolis`` and ``rejection``, and ``systematic_m`` (``m``
draws from one lane's ``N`` weights).

Counterpart of ``pyfilter_tpu/resampling.py``. SMC²'s rejuvenation
resamples its parameter lanes with ``systematic``, the smoothers draw ``M !=
N`` trajectory ends with ``systematic_m``; the particle clouds take the
counts-based expansion in ``ops`` unless a filter is given one of these as
its ``resampling_method``.

Conventions: ``(N, *batch)`` unnormalized log-weights with the particle axis
first (``normalized=True`` for probabilities), randomness from an explicit
``torch.Generator`` (uniforms injectable through ``u`` where the JAX package
takes them), int32 indices of the weights' shape. Every cumulative weight is
the exact fixed-point sum of ``ops.resample.prob_cumsum`` with the last one
forced to 1, and every search is ``searchsorted(side="right")``: a position
on a tie never selects a zero-weight particle.

Where the JAX package draws a categorical by Gumbel-max over an ``(N, N)``
noise array (``multinomial`` and ``residual``'s remainder), the port inverts
the cumulative weights at ``N`` uniforms: the same law at O(N log N) work,
where ``N^2`` draws would not fit on the card at N = 1e5.
``rejection`` draws its rounds in blocks over the slots still open, reading
how many remain once a block (the JAX package's ``while_loop`` reads "all
done" on the device each round).
"""

from __future__ import annotations

import torch

from .ops.resample import prob_cumsum
from .utils import normalize

__all__ = ["systematic", "stratified", "multinomial", "residual", "metropolis", "rejection", "systematic_m"]

#: candidate draws a block of ``rejection`` rounds may hold (rounds x open slots)
_ROUND_BUDGET = 1 << 20


def _as_probs(weights: torch.Tensor, normalized: bool) -> torch.Tensor:
    return weights if normalized else normalize(weights, dim=0)


def _cumulative(probs: torch.Tensor) -> torch.Tensor:
    """Cumulative weights along the particle axis 0 by the exact fixed-point
    sum, the last forced to 1."""
    cumw = prob_cumsum(probs.movedim(0, -1)).movedim(-1, 0)
    cumw[-1:] = 1.0  # a slice: a fill on the device (a 0-d element would be a synchronising copy)
    return cumw


def _search(cumw: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``searchsorted(side="right")`` of ``positions`` ``(M, *batch)`` in each
    lane's ``cumw`` ``(N, *batch)``, clamped to ``N - 1``: int32 ``(M, *batch)``."""
    n, m = cumw.shape[0], positions.shape[0]
    # lanes leading, (B, N): searchsorted runs along the last axis
    idx = torch.searchsorted(cumw.reshape(n, -1).T.contiguous(), positions.reshape(m, -1).T.contiguous(), right=True)
    return torch.clamp(idx, max=n - 1).to(torch.int32).T.reshape(positions.shape)


def _offsets(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device).reshape((n,) + (1,) * (like.dim() - 1))


def _uniforms(generator, u, shape, like: torch.Tensor) -> torch.Tensor:
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)
    return torch.as_tensor(u, dtype=like.dtype, device=like.device).expand(shape)


def systematic(
    generator: torch.Generator | None,
    weights: torch.Tensor,
    normalized: bool = False,
    u: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Systematic resampling: one uniform per lane, positions ``(i + u) / N``."""
    probs = _as_probs(weights, normalized)
    n = probs.shape[0]
    u = _uniforms(generator, u, tuple(probs.shape[1:]), probs)
    return _search(_cumulative(probs), ((_offsets(n, probs) + u) / n).expand(probs.shape))


def stratified(
    generator: torch.Generator | None,
    weights: torch.Tensor,
    normalized: bool = False,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Stratified resampling: an independent uniform per stratum, positions
    ``(i + u_i) / N``; ``u`` of the weights' shape when given."""
    probs = _as_probs(weights, normalized)
    n = probs.shape[0]
    u = _uniforms(generator, u, tuple(probs.shape), probs)
    return _search(_cumulative(probs), (_offsets(n, probs) + u) / n)


def multinomial(generator: torch.Generator, weights: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """Multinomial resampling: ``N`` i.i.d. categorical draws per lane, each
    the inverse of the cumulative weights at a uniform."""
    probs = _as_probs(weights, normalized)
    return _search(_cumulative(probs), _uniforms(generator, None, tuple(probs.shape), probs))


def residual(generator: torch.Generator, weights: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """Residual resampling, every lane at once: ``floor(N w_i)`` copies of
    each particle in order, then multinomial draws from the remainders
    ``w_i - floor(N w_i) / N`` for the slots left."""
    probs = _as_probs(weights, normalized)
    n = probs.shape[0]
    flat = probs.reshape(n, -1)  # (N, B)
    counts = torch.floor(n * flat)
    n_det = counts.sum(dim=0)  # (B,)
    # slot j takes the particle whose cumulative count first exceeds j
    cum_counts = counts.to(torch.int64).cumsum(dim=0)
    slots = torch.arange(n, device=probs.device)
    det_idx = torch.searchsorted(cum_counts.T.contiguous(), slots.expand(flat.shape[1], n).contiguous(), right=True)
    det_idx = torch.clamp(det_idx, max=n - 1).T

    remainder = flat - counts / n
    res_sum = remainder.sum(dim=0)
    res_probs = torch.where(res_sum > 0, remainder / torch.clamp(res_sum, min=1e-38), 1.0 / n)
    mult_idx = multinomial(generator, res_probs, normalized=True)
    idx = torch.where(slots.unsqueeze(1) < n_det, det_idx, mult_idx)
    return idx.to(torch.int32).reshape(probs.shape)


def _as_log_weights(weights: torch.Tensor, normalized: bool) -> torch.Tensor:
    """Log-weights for the ratio-based schemes: NaN and +inf become -inf, and
    a lane whose weights are all -inf becomes uniform (0)."""
    lw = torch.log(weights) if normalized else weights
    lw = torch.where(torch.isnan(lw) | torch.isposinf(lw), -torch.inf, lw)
    return torch.where(torch.isneginf(lw).all(dim=0, keepdim=True), 0.0, lw)


def metropolis(
    generator: torch.Generator, weights: torch.Tensor, normalized: bool = False, n_iter: int = 32
) -> torch.Tensor:
    """Metropolis resampling (Murray, Lee & Jacob, arXiv:1202.6163 §3.2):
    each slot runs an ``n_iter``-step independent Metropolis chain from
    itself, proposing a uniform particle ``j`` and accepting with probability
    ``min(1, w_j / w_k)``. Weight ratios only; the law tends to the
    multinomial one as ``n_iter`` grows."""
    lw = _as_log_weights(weights, normalized)
    n = lw.shape[0]
    k = torch.arange(n, device=lw.device).reshape((n,) + (1,) * (lw.dim() - 1)).expand(lw.shape)
    for _ in range(int(n_iter)):
        j = torch.randint(0, n, lw.shape, generator=generator, device=lw.device)
        log_u = torch.log(torch.rand(lw.shape, generator=generator, dtype=lw.dtype, device=lw.device))
        accept = log_u <= torch.gather(lw, 0, j) - torch.gather(lw, 0, k)
        k = torch.where(accept, j, k)
    return k.to(torch.int32)


def rejection(
    generator: torch.Generator, weights: torch.Tensor, normalized: bool = False, max_rounds: int = 10_000
) -> torch.Tensor:
    """Rejection resampling (Murray, Lee & Jacob, arXiv:1202.6163 §3.3): slot
    ``i`` first keeps itself with probability ``w_i / w_max``, then draws
    uniform candidates ``j``, each accepted with probability ``w_j / w_max``.
    Expected offspring counts are exactly ``N w``. A slot still open after
    ``max_rounds`` candidates keeps itself.

    The rounds come in blocks over the slots still open, as many rounds a
    block as ``_ROUND_BUDGET`` candidate draws allow (at least 16); each slot
    takes its first acceptance in the block, which is the law of the JAX
    package's round-by-round loop. One host read a block: how many slots
    remain."""
    lw = _as_log_weights(weights, normalized)
    n, dev = lw.shape[0], lw.device
    flat = lw.reshape(n, -1)
    lanes = flat.shape[1]
    gap = flat - torch.amax(flat, dim=0, keepdim=True)  # log(w / w_max) <= 0
    idx = torch.arange(n, device=dev).unsqueeze(1).expand(n, lanes).contiguous()
    done = torch.log(torch.rand(flat.shape, generator=generator, dtype=lw.dtype, device=dev)) <= gap
    open_slots = torch.nonzero(~done.reshape(-1)).squeeze(1)  # the first host read
    rounds = 0
    while open_slots.numel() and rounds < max_rounds:
        r = open_slots.numel()
        b = min(int(max_rounds) - rounds, max(16, _ROUND_BUDGET // r))
        j = torch.randint(0, n, (b, r), generator=generator, device=dev)
        log_u = torch.log(torch.rand((b, r), generator=generator, dtype=lw.dtype, device=dev))
        acc = log_u <= gap[j, open_slots % lanes]
        first = torch.argmax(acc.to(torch.uint8), dim=0)
        hit = acc.any(dim=0)
        chosen = torch.gather(j, 0, first.unsqueeze(0))[0]
        idx.view(-1)[open_slots] = torch.where(hit, chosen, idx.view(-1)[open_slots])
        open_slots = open_slots[~hit]  # the block's host read
        rounds += b
    return idx.to(torch.int32).reshape(lw.shape)


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
    probs = _as_probs(weights, normalized)
    if probs.dim() != 1:
        raise ValueError("systematic_m supports 1-D weights only")
    u = _uniforms(generator, u, (), probs)
    positions = (torch.arange(m, dtype=probs.dtype, device=probs.device) + u) / m
    return _search(_cumulative(probs), positions)
