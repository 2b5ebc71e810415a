"""Predictive model criticism for filters: PIT and CRPS.

Counterpart of ``pyfilter_tpu/filters/diagnostics.py``: one-step-ahead
probability integral transforms (under a well-specified model iid
Uniform(0, 1)) and the sample-based continuous ranked probability score,
both from the particle predictive: each recorded t-1 cloud pushed through
the transition. The JAX package maps a per-step function over time; here
every t-1 cloud of the history is propagated at once, as one batch with time
leading: one transition for the first observation (the filters' first-step
timing) and ``observe_every_step`` for each later one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..timeseries import TimeseriesState
from ..utils import normalize
from .result import FilterHistory, FilterResult


def _history(states, n_obs: int) -> FilterHistory:
    hist = states.states if isinstance(states, FilterResult) else states
    if hist is None:
        raise ValueError("predictive diagnostics need record_states=True")
    if hist.values.shape[0] != n_obs + 1:
        raise ValueError(
            f"history has {hist.values.shape[0]} recorded states for {n_obs} "
            "observations — pass a record_states=True (NOT record_intermediary) "
            "history whose entries align one-to-one with the observations"
        )
    return hist


def _propagated(generator, model, hist: FilterHistory, n_obs: int) -> TimeseriesState:
    """The clouds of steps 0..n_obs-1 of ``hist``, each propagated to its
    observation's time, stacked ``(n_obs, N, *batch, *event)``."""
    ev = int(model.hidden.event_ndim)
    values = hist.values[:n_obs]
    lead = values.dim() - ev
    times = hist.time_indexes[:n_obs].to(values.device).reshape((n_obs,) + (1,) * (lead - 1))
    oes = int(model.observe_every_step)
    if oes == 1:
        return model.hidden.propagate_substeps(generator, TimeseriesState(times, values, ev), 1)
    first = model.hidden.propagate_substeps(generator, TimeseriesState(times[:1], values[:1], ev), 1)
    rest = model.hidden.propagate_substeps(generator, TimeseriesState(times[1:], values[1:], ev), oes)
    return TimeseriesState(torch.cat([first.time_index, rest.time_index]), torch.cat([first.value, rest.value]), ev)


def _observations(y, density, device) -> torch.Tensor:
    """``y`` ``(T, *event_y)`` on ``device``, with singleton axes for the
    particle and lane axes of ``density``'s ``(T, N, *batch)`` batch."""
    y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    middle = len(density.batch_shape) - 1
    return y.reshape(y.shape[:1] + (1,) * middle + y.shape[1:])


def _weights_like(log_weights: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    w = normalize(log_weights, dim=1)
    return w.reshape(tuple(w.shape) + (1,) * (target.dim() - w.dim()))


def predictive_pit(generator, model, states, y) -> torch.Tensor:
    """One-step-ahead PIT values ``u_t = sum_k w_{t-1,k} F(y_t | x_t^k)``, with
    ``x_t^k`` the recorded t-1 cloud propagated through the transition
    (``observe_every_step`` sub-steps included).

    ``states``: a ``FilterResult`` of a ``record_states=True`` filter (or its
    ``FilterHistory``); ``y``: the filtered observations ``(T, ...)``.
    Returns ``(T,)`` for scalar observations (``(T, d_y)`` per-margin values
    where the observation density's ``cdf`` is elementwise)."""
    y_host = np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y, dtype=np.float32)
    n_obs = y_host.shape[0]
    hist = _history(states, n_obs)
    density = model.build_density(_propagated(generator, model, hist, n_obs))
    u = density.cdf(_observations(y_host, density, hist.values.device))  # (T, N, *batch, ...)
    return torch.sum(_weights_like(hist.log_weights[:n_obs], u) * u, dim=1)


def crps(generator, model, states, y) -> torch.Tensor:
    """Per-step continuous ranked probability scores of the one-step-ahead
    particle predictive, the weighted sample estimator

    ``CRPS_t = sum_k w_k |s_k - y_t| - 1/2 sum_jk w_j w_k |s_j - s_k|``

    with one simulated observation ``s_k ~ p(y_t | x_t^k)`` a particle (the
    pairwise term is ``(T, N, N)``: keep N moderate). Scalar observations of
    one lane; returns ``(T,)`` (lower is better)."""
    y_host = np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y, dtype=np.float32)
    n_obs = y_host.shape[0]
    hist = _history(states, n_obs)
    density = model.build_density(_propagated(generator, model, hist, n_obs))
    s = density.sample(generator).reshape(n_obs, -1)  # (T, N)
    y_t = torch.as_tensor(y_host, device=s.device).reshape(n_obs, 1)
    w = normalize(hist.log_weights[:n_obs], dim=1).reshape(n_obs, -1)
    e_xy = torch.sum(w * torch.abs(s - y_t), dim=1)
    e_xx = torch.einsum("tj,tk,tjk->t", w, w, torch.abs(s[:, :, None] - s[:, None, :]))
    return e_xy - 0.5 * e_xx
