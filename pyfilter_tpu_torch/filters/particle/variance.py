"""Single-run genealogy-based variance estimators for particle filters.

Counterpart of ``pyfilter_tpu/filters/particle/variance.py``: the Monte
Carlo variance of the log-likelihood estimate and of the filter means from
ONE pass, through its recorded ancestry (``FilterHistory.prev_indices``),
by Chan & Lai (2013) / Lee & Whiteley (2018) — each particle's time-0
"Eve" — or Olsson & Douc's (2019) fixed-lag variant, the ancestor ``lag``
generations back. Any recorded history serves: SISR, the APF and SQMC, lanes
included.

The JAX package scans over time with one ``segment_sum`` a step. Here the
ancestor maps are composed by gathers over whole ``(T, N, *lanes)`` tensors
(:func:`lag_ancestor_indices` takes ``lag - 1`` of them, not ``T x lag``),
and every step's segment sums are ONE ``index_add_`` into ``T·N·L``
segments. The sums accumulate in float64, so that the card's atomic order
and the CPU's serial order agree to float32's last bit; the estimates come
back as float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ...utils import batched_gather, normalize
from ..result import FilterHistory, FilterResult


class VarianceEstimate(NamedTuple):
    """Per-step genealogy variance estimates: ``sigma2`` the asymptotic
    variance (the CLT constant), ``variance = sigma2 / N`` the estimator's
    variance at the run's particle count, ``n_unique_ancestors`` the distinct
    Eve (or lag-ancestor) indices per step — once it reaches 1 the full-Eve
    estimator has collapsed and a ``lag`` (or more particles) is needed."""

    sigma2: torch.Tensor
    variance: torch.Tensor
    n_unique_ancestors: torch.Tensor


def _history_of(states: Union[FilterResult, FilterHistory]) -> FilterHistory:
    history = states.states if isinstance(states, FilterResult) else states
    if history is None:
        raise ValueError("variance estimation requires record_states=True on the filter")
    return history


def _identity(prev: torch.Tensor) -> torch.Tensor:
    """The identity ancestry of one step, ``prev.shape[1:]``."""
    n = prev.shape[1]
    ar = torch.arange(n, dtype=prev.dtype, device=prev.device)
    return ar.reshape((n,) + (1,) * (prev.dim() - 2)).expand(prev.shape[1:])


def eve_indices(prev_indices: torch.Tensor) -> torch.Tensor:
    """Time-0 ("Eve") ancestor of every particle after every step.

    ``prev_indices`` ``(T, N, *batch)``: at step ``t``, particle ``i``'s
    parent in the step ``t - 1`` cloud. Returns the same shape, indices into
    the initial cloud: one gather a step composing the maps."""
    prev = torch.as_tensor(prev_indices)
    out = torch.empty_like(prev)
    eve = _identity(prev)
    for t in range(prev.shape[0]):
        eve = batched_gather(eve, prev[t])
        out[t] = eve
    return out


def lag_ancestor_indices(prev_indices: torch.Tensor, lag: int) -> torch.Tensor:
    """Ancestor ``lag`` generations back of every particle at every step.

    At step ``t`` the index points into the cloud at step ``max(t - lag,
    initial)``: the last ``lag`` ancestry maps composed, identity before step
    0. Vectorized over ``t``: ``lag - 1`` gathers over the whole ``(T, N,
    *batch)`` tensor, each stepping every row one generation further back."""
    if lag < 1:
        raise ValueError("lag must be >= 1")
    prev = torch.as_tensor(prev_indices)
    t_total = prev.shape[0]
    lag = min(int(lag), t_total)
    wide = prev.long()
    ident = _identity(wide).unsqueeze(0)
    idx = wide
    for s in range(1, lag):
        # row t steps back through prev[t - s]; rows t < s are past step 0 and keep their index
        back = torch.cat([ident.expand((s,) + tuple(prev.shape[1:])), wide[: t_total - s]], dim=0)
        idx = torch.gather(back, 1, idx)
    return idx.to(prev.dtype)


def _segment_square_sum(contrib: torch.Tensor, ancestors: torch.Tensor):
    """``sum_j (sum_{i: E_i = j} c_i)^2`` and the unique-ancestor count, per
    step and lane.

    ``contrib`` ``(T, N, *batch[, *event])``, ``ancestors`` ``(T, N,
    *batch)``: steps, lanes (and event components of ``contrib``) are folded
    into the segment id, one float64 scatter-add in all. Returns ``(sq
    (T, *batch[, *event]) float64, n_unique (T, *batch) int32)``."""
    t_len, n = ancestors.shape[:2]
    lanes = tuple(ancestors.shape[2:])
    n_lanes = 1
    for d in lanes:
        n_lanes *= int(d)
    ev_shape = tuple(contrib.shape[2 + len(lanes):])

    anc = ancestors.reshape(t_len, n, n_lanes).long()
    lane_ids = torch.arange(n_lanes, device=anc.device)
    step_ids = torch.arange(t_len, device=anc.device).reshape(t_len, 1, 1) * (n * n_lanes)
    ids = (step_ids + anc * n_lanes + lane_ids).reshape(-1)  # (T*N*L,)

    c = contrib.reshape((t_len * n * n_lanes,) + ev_shape).to(torch.float64)
    sums = torch.zeros_like(c).index_add_(0, ids, c)
    sq = torch.sum(torch.square(sums.reshape((t_len, n, n_lanes) + ev_shape)), dim=1).reshape((t_len,) + lanes + ev_shape)

    occupied = torch.zeros(t_len * n * n_lanes, dtype=torch.int32, device=anc.device)
    occupied.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    n_unique = torch.sum((occupied > 0).reshape(t_len, n, n_lanes), dim=1, dtype=torch.int32).reshape((t_len,) + lanes)
    return sq, n_unique


def _ancestors_for(history: FilterHistory, lag: Optional[int]) -> torch.Tensor:
    if lag is None:
        return eve_indices(history.prev_indices)
    return lag_ancestor_indices(history.prev_indices, lag)


def log_likelihood_variance(states: Union[FilterResult, FilterHistory], lag: Optional[int] = None
                            ) -> VarianceEstimate:
    """Variance of the log-likelihood estimate, from one run's genealogy.

    Per-step estimates aligned with the recorded history, ``(T+1, *batch)``
    (index 0 the initial cloud): ``sigma2[t]`` estimates ``N Var(L_t^N) /
    L_t^2`` and ``variance[t] = sigma2[t] / N ~ Var(log L_t^N)``, the
    cumulative quantity. ``lag=None`` is the full Eve estimator; an integer
    ``lag`` the Olsson–Douc truncated one (stable under coalescence, but it
    only sees the variance accumulated within the window)."""
    history = _history_of(states)
    n = history.prev_indices.shape[1]
    w = normalize(history.log_weights, dim=1)  # (T, N, *batch)
    sq, n_unique = _segment_square_sum(w, _ancestors_for(history, lag))
    sigma2 = (n * sq - 1.0).to(torch.float32)
    return VarianceEstimate(sigma2, sigma2 / n, n_unique)


def filter_mean_variance(states: Union[FilterResult, FilterHistory], lag: Optional[int] = None,
                         event_ndim: int | None = None) -> VarianceEstimate:
    """Variance of the per-step filter means, from one run's genealogy.

    ``sigma2`` is ``(T+1, *batch, *event)``, aligned with the history (so
    ``variance[t+1]`` matches ``FilterResult.filter_means[t]``): the
    Chan–Lai estimate of the asymptotic variance of ``sum_i W_t^i x_t^i``;
    ``variance = sigma2 / N``. ``event_ndim`` (0 or 1) is inferred from the
    recorded arrays when omitted."""
    history = _history_of(states)
    n = history.prev_indices.shape[1]
    w = normalize(history.log_weights, dim=1)  # (T, N, *batch)
    values = history.values  # (T, N, *batch, *event)
    if event_ndim is None:
        event_ndim = values.dim() - w.dim()
    if event_ndim not in (0, 1):
        raise ValueError("event_ndim must be 0 or 1")
    we = w.unsqueeze(-1) if event_ndim else w
    mean = torch.sum(we * values, dim=1, keepdim=True)
    sq, n_unique = _segment_square_sum(we * (values - mean), _ancestors_for(history, lag))
    sigma2 = (n * sq).to(torch.float32)
    return VarianceEstimate(sigma2, sigma2 / n, n_unique)
