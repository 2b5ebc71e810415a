"""O(N) particle smoothing: rejection-sampling FFBSi and PaRIS.

Counterpart of ``pyfilter_tpu/filters/particle/smoothing.py``. Each
trajectory draws ancestor candidates uniformly, ``i ~ Uniform{0..N-1}``, and
accepts with probability ``(w_i / max w) · p(x_{t+1} | x_i) / sup p``: the
accepted law is exactly the backward kernel's, ``∝ w_i p(x_{t+1} | x_i)``.
All ``max_rounds`` rounds are drawn at once (one ``randint``, one gather, one
density evaluation) and each target takes its first acceptance; targets with
none are finished exactly by a Gumbel-max categorical: for a scalar affine
process with a Normal increment, all of a step's in one call of
:func:`~pyfilter_tpu_torch.ops.backward.ffbsi_fallback` (a CUDA kernel on the
card), otherwise streamed over particle blocks in passes. The bound comes
from :func:`transition_log_sup` (homoscedastic affine processes, probed on
the host), :func:`transition_log_sup_traced` (the same bound from the
current parameters on the device, unprobed) or the caller.

:func:`paris` smooths an additive functional online (Olsson & Westerborn
2017): per-particle statistics ride the filter pass, each particle averaging
the statistics it inherits through ``n_tilde`` backward draws of the same
rejection kernel, with no recorded history.

Where the JAX package decides on the device (``lax.cond`` on every target
accepted, a ``while_loop`` over the failed slots), the port reads the number
of failed slots once per backward draw, one host sync, and from it sizes the
fallback: one kernel's grid, or the number of streamed passes. A violated bound is accumulated on the device
and poisons the output with NaN without a read. ``ffbsi_smooth.host_syncs``
and ``ffbsi_smooth.fallback_passes`` count both (for PaRIS's draws too) since
they were last set to 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ...distributions import Independent, MultivariateNormal, Normal
from ...ops.backward import ffbsi_fallback, streamed_argmax
from ...timeseries import AffineProcess, TimeseriesState
from ...timeseries.models import parameter
from ...tracing import span
from ...utils import batched_gather
from ..result import FilterResult
from .base import trajectory_ends

_LOG_2PI = math.log(2.0 * math.pi)


def _max_log_prob(dist) -> torch.Tensor:
    """Log of the density at its mode, for the Gaussian increment families;
    anything else needs an explicit ``log_density_sup``."""
    if isinstance(dist, Normal):
        return -torch.log(torch.as_tensor(dist.scale)) - 0.5 * _LOG_2PI
    if isinstance(dist, Independent) and isinstance(dist.base_dist, Normal):
        base = dist.base_dist
        per = (-torch.log(torch.as_tensor(base.scale)) - 0.5 * _LOG_2PI).expand(base.batch_shape)
        k = dist.reinterpreted_batch_ndims
        return torch.sum(per, dim=tuple(range(-k, 0))) if k else per
    if isinstance(dist, MultivariateNormal):
        diag = torch.diagonal(dist.scale_tril, dim1=-2, dim2=-1)
        return -0.5 * diag.shape[-1] * _LOG_2PI - torch.sum(torch.log(diag), dim=-1)
    raise ValueError(f"no analytic density bound for {type(dist).__name__}; pass log_density_sup explicitly")


def transition_log_sup(model) -> torch.Tensor:
    """Upper bound on ``log p(x' | x)`` over all ``(x, x', t)`` for an affine
    process whose diffusion depends on neither state nor time: the density
    of ``loc(x) + scale · W`` peaks at ``max density(W) / |det scale|``.

    Homoscedasticity is checked by probing ``mean_scale`` at three states
    and three times (host values); a state- or time-dependent scale, or a
    process that is not affine, raises: pass ``log_density_sup`` then."""
    hidden = model.hidden
    if not hasattr(hidden, "mean_scale") or not hasattr(hidden, "increment_distribution"):
        raise ValueError(
            "transition_log_sup needs an affine process (mean_scale + increment_distribution); "
            "pass log_density_sup explicitly"
        )
    ev = int(hidden.event_ndim)
    d = int(hidden.initial_distribution().event_shape[0]) if ev == 1 else 1
    device = hidden.device

    def scale_at(v, t):
        value = torch.full((d,) if ev == 1 else (), v, dtype=torch.float32, device=device)
        _, scale = hidden.mean_scale(TimeseriesState(t, value, ev))
        return torch.as_tensor(scale, dtype=torch.float64, device=device)

    probes = [scale_at(v, t) for v in (0.0, 0.7, -1.3) for t in (0.0, 1.0, 7.0)]
    shapes = [p.shape for p in probes]
    host = torch.cat([p.reshape(-1) for p in probes]).cpu().split([p.numel() for p in probes])
    scale0 = host[0].reshape(shapes[0])
    for s, shape in zip(host[1:], shapes[1:]):
        if shape != shapes[0] or not torch.allclose(s.reshape(shape), scale0, rtol=1e-5, atol=1e-7):
            raise ValueError(
                "state- or time-dependent diffusion scale: no generic transition-density bound; "
                "pass log_density_sup explicitly (e.g. from the scale's known infimum)"
            )

    return _log_sup(hidden, probes[0].to(torch.float32), d, ev)


def _log_sup(hidden, scale: torch.Tensor, d: int, ev: int) -> torch.Tensor:
    """``max log density(W) - log |det scale|``: a matrix scale's
    log-determinant, or an elementwise scale's log summed over the ``d``
    event components."""
    mlp = _max_log_prob(hidden.increment_distribution)
    if scale.dim() >= 2 and scale.shape[-1] == scale.shape[-2] == d:
        logdet = torch.linalg.slogdet(scale)[1]
    else:
        per = torch.log(torch.abs(scale))
        if per.dim() == 0:
            logdet = d * per
        else:
            logdet = torch.sum(per.expand(per.shape[:-1] + (d,)) if ev == 1 else per, dim=-1)
    return (mlp - logdet).to(torch.float32)


def transition_log_sup_traced(model) -> torch.Tensor:
    """:func:`transition_log_sup` from the process's current parameters, on
    the device: the scale is read at one state and time and not probed, so
    no value goes to the host. The caller has checked once, at a concrete
    parameter point, that the scale depends on neither state nor time (a
    property of the model family, not of the parameter values):
    :func:`~pyfilter_tpu_torch.inference.score.fit_mle_streaming` runs
    :func:`transition_log_sup` at its start and this at every window."""
    hidden = model.hidden
    ev = int(hidden.event_ndim)
    d = int(hidden.initial_distribution().event_shape[0]) if ev == 1 else 1
    probe = torch.zeros((d,) if ev == 1 else (), device=hidden.device)
    _, scale = hidden.mean_scale(TimeseriesState(0.0, probe, ev))
    return _log_sup(hidden, parameter(scale, hidden.device), d, ev)


def _streaming_categorical(generator, model, vals_t, lw_t, time_index: float, targets, ev: int, block: int):
    """The exact backward kernel's draw for every target, Gumbel-max streamed
    over particle blocks: O(N·J) work, O(J · block) memory."""

    def score(start, stop):
        density = model.hidden.build_density(TimeseriesState(time_index, vals_t[start:stop], ev))
        return lw_t[start:stop].unsqueeze(0) + density.log_prob(targets.unsqueeze(1))  # (J, B, *batch)

    j_shape = tuple(targets.shape[: targets.dim() - ev])
    return streamed_argmax(generator, score, vals_t.shape[0], block, j_shape, lw_t)


def _fallback_kernel_takes(hidden, vals_t, lw_t, targets) -> bool:
    """Whether the exact fallback goes through :func:`ffbsi_fallback` (one
    call a step): a scalar affine process whose density is its own
    ``Normal`` increment pushed forward, and laneless float32 inputs. Every
    other input streams :func:`_streaming_categorical` in passes."""
    inc = getattr(hidden, "increment_distribution", None)
    return (isinstance(hidden, AffineProcess) and type(hidden).build_density is AffineProcess.build_density
            and isinstance(inc, Normal) and hidden.event_ndim == 0 and not inc.batch_shape
            and vals_t.dim() == lw_t.dim() == targets.dim() == 1
            and vals_t.dtype == lw_t.dtype == targets.dtype == torch.float32)


def transition_tables(hidden, vals_t: torch.Tensor, lw_t: torch.Tensor, time_index: float) -> torch.Tensor:
    """The tables ``(3, N)`` float32 (rows ``c``, ``a``, ``b``) that
    :func:`ffbsi_fallback` draws against, for a process
    :func:`_fallback_kernel_takes` takes (an affine ``hidden`` with a
    ``Normal(mu0, s0)`` increment) at the scalar states ``vals_t`` ``(N,)``
    with log-weights ``lw_t`` ``(N,)``: from one ``mean_scale`` call,
    ``c = loc + scale mu0``, ``a = 1 / |scale s0|``, ``b = lw - log |scale s0|``."""
    inc = hidden.increment_distribution
    with torch.no_grad():
        loc, scale = hidden.mean_scale(TimeseriesState(time_index, vals_t, 0))
        sd = torch.abs(scale * inc.scale)
        rows = (loc + scale * inc.loc, 1.0 / sd, lw_t - torch.log(sd))
        return torch.stack([r.expand(vals_t.shape) for r in rows]).to(torch.float32).contiguous()


def backward_indices(
    generator,
    model,
    vals_t,
    lw_t,
    time_index: float,
    targets,
    log_sup,
    max_rounds: int = 16,
    block: int = 64,
):
    """One backward-kernel draw per target, index ``i`` with probability
    ``∝ w_t^i p(target | x_t^i)``. ``vals_t`` ``(N, *batch, *event)``,
    ``lw_t`` ``(N, *batch)`` unnormalised log-weights, ``targets`` ``(J,
    *batch, *event)`` (J may differ from N only without lanes). Returns
    ``(indices (J, *batch) int64, violated)``: ``violated`` is a 0-d bool
    tensor on the device, True when a candidate's density exceeded
    ``log_sup`` (the accepted law would then be biased)."""
    ev = model.hidden.event_ndim
    j_shape = tuple(targets.shape[: targets.dim() - ev])
    j = j_shape[0]
    if j_shape[1:] != tuple(lw_t.shape[1:]):
        raise ValueError(f"lane axes mismatch: targets {j_shape} vs weights {tuple(lw_t.shape)}")
    if j != lw_t.shape[0] and len(j_shape) > 1:
        raise ValueError("J != N requires laneless inputs")
    n, r, dev = vals_t.shape[0], int(max_rounds), lw_t.device
    lw_shift = lw_t - torch.amax(lw_t, dim=0, keepdim=True)  # log(w_i / max w)

    if r > 0:
        cand = torch.randint(0, n, (r,) + j_shape, generator=generator, device=dev)
        flat = cand.reshape((r * j,) + j_shape[1:])
        if len(j_shape) == 1 and ev <= 1:
            # one packed gather of (value..., log-weight) rows
            packed = torch.cat([vals_t if ev == 1 else vals_t[:, None], lw_shift[:, None]], dim=-1)
            g = packed.index_select(0, flat).reshape(r, j, -1)
            x_c, lw_c = (g[..., :-1] if ev == 1 else g[..., 0]), g[..., -1]
        else:
            x_c = batched_gather(vals_t, flat, ev).reshape((r,) + tuple(targets.shape))
            lw_c = batched_gather(lw_shift, flat, 0).reshape((r,) + j_shape)
        density = model.hidden.build_density(TimeseriesState(time_index, x_c, ev))
        lp = density.log_prob(targets.unsqueeze(0))  # (R, J, *batch)
        violated = torch.any(lp > log_sup + 1e-4)
        log_u = torch.log(torch.rand((r,) + j_shape, generator=generator, dtype=lp.dtype, device=dev))
        acc = log_u < lw_c + lp - log_sup
        first = torch.argmax(acc.to(torch.uint8), dim=0)  # the first accepting round
        idx = torch.gather(cand, 0, first.unsqueeze(0))[0]
        failed = ~torch.any(acc, dim=0)
    else:  # everything goes through the exact fallback
        idx = torch.zeros(j_shape, dtype=torch.int64, device=dev)
        failed = torch.ones(j_shape, dtype=torch.bool, device=dev)
        violated = torch.zeros((), dtype=torch.bool, device=dev)

    with span("ffbsi.read"):
        n_fail = int(failed.sum())  # the host sync of the step
    ffbsi_smooth.host_syncs += 1
    if n_fail == 0:
        return idx, violated
    if len(j_shape) > 1:
        # lanes: one exact pass over every target, kept on the failed ones
        ffbsi_smooth.fallback_passes += 1
        with span("ffbsi.fallback"):
            exact = _streaming_categorical(generator, model, vals_t, lw_t, time_index, targets, ev, block)
            return torch.where(failed, exact, idx), violated

    # laneless: only the failed slots; each failed slot goes to its rank
    # among the failures (a cumsum), so the first n_fail entries of `order`
    # are the failed slots, with no second read
    rank = torch.where(failed, torch.cumsum(failed, dim=0) - 1, j)
    order = torch.full((j + 1,), j, dtype=torch.int64, device=dev).scatter_(0, rank, torch.arange(j, device=dev))
    if _fallback_kernel_takes(model.hidden, vals_t, lw_t, targets):
        ffbsi_smooth.fallback_passes += 1
        with span("ffbsi.fallback"):
            tables = transition_tables(model.hidden, vals_t, lw_shift, time_index)
            return ffbsi_fallback(generator, tables, targets.contiguous(), order, n_fail, idx), violated
    # any other process: passes of k_sub failed slots each
    k_sub = min(j, max(128, j // 512))
    block_eff = max(int(block), min(n, (1 << 25) // max(k_sub, 1)))
    for start in range(0, n_fail, k_sub):
        ffbsi_smooth.fallback_passes += 1
        with span("ffbsi.fallback"):
            sel = order[start : min(start + k_sub, n_fail)]
            exact = _streaming_categorical(
                generator, model, vals_t, lw_t, time_index, targets.index_select(0, sel), ev, block_eff
            )
            idx = idx.index_copy(0, sel, exact)
    return idx, violated


def ffbsi_smooth(
    generator,
    model,
    history,
    resampler,
    log_density_sup=None,
    max_rounds: int = 16,
    block: int = 64,
    n_trajectories: int | None = None,
    check_bound: bool = True,
) -> torch.Tensor:
    """Rejection-FFBSi trajectories ``(T, M, *batch, *event)`` over a
    recorded history, the exact FFBS's law at O(N) expected work per step;
    ``M = n_trajectories`` (laneless histories only; default N), the
    realistic configuration at large N. A transition density observed above
    the bound (a wrong ``log_density_sup``) poisons the whole output with
    NaN unless ``check_bound=False``."""
    ev = model.hidden.event_ndim
    values, log_w = history.values, history.log_weights
    times = history.time_indexes.tolist()
    if log_density_sup is None:
        log_sup = transition_log_sup(model)
    else:
        log_sup = torch.as_tensor(log_density_sup, dtype=values.dtype, device=values.device)

    idx_last = trajectory_ends(generator, resampler, log_w[-1], n_trajectories)
    traj_last = batched_gather(values[-1], idx_last, ev)
    out = torch.empty((values.shape[0],) + tuple(traj_last.shape), dtype=values.dtype, device=values.device)
    out[-1] = traj_last
    violated = torch.zeros((), dtype=torch.bool, device=values.device)
    for t in range(values.shape[0] - 2, -1, -1):
        with span("ffbsi.step"):
            idx, v = backward_indices(
                generator, model, values[t], log_w[t], times[t], out[t + 1], log_sup, max_rounds, block
            )
            out[t] = batched_gather(values[t], idx, ev)
            violated |= v
    if check_bound:
        out = torch.where(violated, math.nan, out)
    return out


ffbsi_smooth.host_syncs = 0
ffbsi_smooth.fallback_passes = 0


def paris(
    filt,
    generator,
    y,
    h_fn,
    h0_fn=None,
    n_tilde: int = 2,
    log_density_sup=None,
    max_rounds: int = 16,
    block: int = 64,
    h_obs_fn=None,
    initial_state=None,
    first_step: bool = True,
):
    """Online PaRIS smoothing of an additive functional, with O(1) memory in
    the number of observations.

    Estimates ``E[h_0(x_0) + sum_{t >= 1} h(x_{t-1}, x_t) | y_{1:T}]`` from
    per-particle statistics updated inside the filter pass: at each
    transition every particle draws ``n_tilde`` backward indices from the
    previous cloud through :func:`backward_indices` and averages the
    statistics it inherits plus ``h`` of the transition (``n_tilde >= 2`` is
    the stable regime).

    ``h_fn(x_prev_values, x_values, t)`` returns a tensor (or a pytree of
    tensors) with leaves ``(N, *batch, ...)``, both values being whole
    clouds and ``t`` the host time index of ``x_values``; ``h0_fn(x0_values)``
    is the optional initial term. With ``observe_every_step > 1`` every
    sub-step is its own backward update against the sub-step cloud, which
    carries the post-resample weights (propagation alone never reweights),
    and ``h_fn`` is called once per sub-step transition: a functional of the
    observation times only gates on ``t``. ``h_obs_fn(x_values, y_t, t)``
    is an optional term added once per observation after the update, ``y_t``
    the observation on the device as it stands (its NaN handling is the
    caller's).

    ``initial_state`` with ``first_step=False`` continues from a carried
    filter state, its first observation a full ``observe_every_step`` move.

    A density above the bound at any candidate turns the statistics and the
    estimate to NaN at the end; the flag stays on the device. Returns
    ``(estimate, stats, result)``: the weighted estimate, the final
    per-particle statistics and the pass's :class:`FilterResult` (no
    history)."""
    model = filt.model
    ev = model.hidden.event_ndim
    log_sup = transition_log_sup(model) if log_density_sup is None else parameter(log_density_sup, filt.device)

    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y_host = np.asarray(y, dtype=np.float32)
    n_steps = y_host.shape[0]
    if n_steps == 0:
        raise ValueError("empty observation sequence")
    nan_mask = np.isnan(y_host.reshape(n_steps, -1))
    y_dev = torch.as_tensor(y_host, device=filt.device)

    state = filt.initialize(generator) if initial_state is None else initial_state
    x0 = state.x
    if h0_fn is not None:
        stats = h0_fn(x0.value)
    else:
        stats = tree_map(torch.zeros_like, h_fn(x0.value, x0.value, x0.time_index))

    def backward_update(vals_p, lw_p, t_p, targets, t_new, stats):
        """The statistics averaged over ``n_tilde`` backward draws against
        the cloud ``(vals_p, lw_p)`` at time ``t_p``."""
        draws, viol = [], None
        for _ in range(int(n_tilde)):
            idx, v = backward_indices(generator, model, vals_p, lw_p, t_p, targets, log_sup, max_rounds, block)
            inherited = tree_map(lambda leaf: batched_gather(leaf, idx, leaf.dim() - lw_p.dim()), stats)
            inc = h_fn(batched_gather(vals_p, idx, ev), targets, t_new)
            draws.append(tree_map(torch.add, inherited, inc))
            viol = v if viol is None else viol | v
        return tree_map(lambda *leaves: sum(leaves) / float(n_tilde), *draws), viol

    violated = torch.zeros((), dtype=torch.bool, device=filt.device)
    lls, means, variances = [], [], []
    for t in range(n_steps):
        subs = []
        new = filt._filter(generator, y_dev[t], filt._nan_row(nan_mask[t]), state, first_step and t == 0,
                           on_substep=subs.append)
        # the chain state -> sub_1 -> ... -> sub_{oes-1} -> correction, one
        # backward update per link
        chain = [state.x, *(p.x for p in subs), new.x]
        weights = [state.log_weights, *(p.log_weights for p in subs)]
        for prev, lw_p, cur in zip(chain[:-1], weights, chain[1:]):
            stats, v = backward_update(prev.value, lw_p, prev.time_index, cur.value, cur.time_index, stats)
            violated = violated | v
        if h_obs_fn is not None:
            stats = tree_map(torch.add, stats, h_obs_fn(new.x.value, y_dev[t], new.x.time_index))
        lls.append(new.log_likelihood)
        means.append(new.mean)
        variances.append(new.variance)
        state = new

    w = state.normalized_weights()
    stats = tree_map(lambda leaf: torch.where(violated, math.nan, leaf), stats)
    estimate = tree_map(lambda leaf: torch.sum(leaf * w.reshape(tuple(w.shape) + (1,) * (leaf.dim() - w.dim())), dim=0),
                        stats)
    step_lls = torch.stack(lls)
    result = FilterResult(
        log_likelihood=torch.sum(step_lls, dim=0),
        step_log_likelihoods=step_lls,
        filter_means=torch.stack(means),
        filter_variances=torch.stack(variances),
        latest_state=state,
    )
    return estimate, stats, result
