"""Explicit-SPMD particle filtering, smoothing and prediction over a process group.

Counterpart of ``pyfilter_tpu/parallel/spmd.py``, the scaling tier of the
particle filters. The JAX package runs the whole filter scan inside one
``shard_map``; here every rank is a process that holds ``N/P`` particles of
its own, calls the entry point with the same arguments and the same
generator, and loops over time itself. Unlike ``parallel.sharding``, whose
draws are made at the global shape and sliced (``_shards.ShardedDraws``) and
whose resample gathers the whole cloud, nothing here is ever of size ``N`` on
one rank but the all-gather fallback of a resample:

- memory O(N/P) a rank: the initial sample, the sub-steps and the proposal
  draw at the local size from the rank's own generator
  (:func:`_rank_stream`, the JAX ``fold_in`` of the axis index);
- communication O(1) scalars a step: the weight reductions are all-reduces
  (``parallel.collective``), and the normalized weights of a step's end are
  carried into the next step's ESS gate;
- a resample exchanges ``2 * halo`` ring shifts of one shard a leaf
  (``collective.halo_systematic`` / ``halo_take``), the copy counts bit-equal
  to the one-process counts of the same probabilities; when the ancestors do
  not fit the window, the whole cloud is gathered and resampled on every rank
  by K1 (``ops.systematic_expand``, a float32 cloud under 2^24 particles) or
  by ``allgather_systematic`` + ``allgather_take``, each rank keeping its
  slots.

Every rank must call the same collectives in the same order, or the group
hangs. So each branch is decided on the host, the same on every rank: the
all-NaN skip from the host copy of ``y``, the ESS gate from one read of the
all-reduced ESS a step, the halo route from one read of ``fits`` a fire, and
FFBSi's fallback from one read of its failed slots a backward step (all of
them replicated values). The shared generator, drawn alike on every rank,
gives the resample uniforms and FFBSi's candidates.

The smoothers keep the M trajectories replicated and the history sharded:
FFBS re-selects each ancestor with ``collective.distributed_categorical``
and ``distributed_take_rows``, O(M) scalars a backward step, never O(N).

Module counters (host ints, set to 0 freely): ``spmd_batch_filter.fires``
and ``.fallbacks`` (resamples, and those that took the all-gather route);
``spmd_smooth.host_reads`` and ``.fallback_passes`` (FFBSi's reads of its
failed slots, and its exact passes).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..distributions import MultivariateNormal, Normal, robust_cholesky
from ..filters._lane import model_leaves, rebuild
from ..filters.particle import base as pbase
from ..filters.particle.base import ffbs_logits, smoothed_joint_log_likelihood
from ..filters.particle.proposals import Bootstrap
from ..filters.state import ParticleFilterPrediction
from ..ops import systematic_expand
from ..timeseries import TimeseriesState
from ..utils import get_mean_and_variance, same_device
from . import _comm
from . import collective as col
from ._shards import ParticleShard
from .sharding import mesh_device

__all__ = ["spmd_batch_filter", "spmd_smooth", "spmd_predict", "spmd_smoothed_log_likelihood"]


def _rank_stream(generator: torch.Generator, group) -> torch.Generator:
    """The rank's own generator, from one draw of the shared ``generator``
    mixed with the rank (``collective._rank_generator``, the JAX ``fold_in``
    of the axis index). Every draw of the rank's particles comes from it:
    the initial sample, the sub-steps, the proposal, the GPF's collapse and
    the prediction's propagation."""
    return col._rank_generator(generator, group)


def _axis(mesh, axis_name: str, n_total: int | None = None, what: str = "n_particles") -> tuple:
    """``(group, size, device)`` of the mesh axis ``axis_name``; ``n_total``,
    when given, must split evenly over it."""
    group = mesh.get_group(axis_name)
    size = dist.get_world_size(group)
    if n_total is not None and n_total % size:
        raise ValueError(f"{what} {n_total} must divide mesh axis size {size}")
    return group, size, mesh_device(mesh)


def _check_model(model, device) -> None:
    if not same_device(model.device, device):
        raise ValueError(f"the model lies on {model.device}, the mesh's shards on {device}")


def _host_observations(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y = np.asarray(y, dtype=np.float32)
    if y.shape[0] == 0:
        raise ValueError("empty observation sequence")
    return y


class _History:
    """The SPMD history: one row a transition (the initial cloud first, then
    every sub-step and every corrected state), preallocated on the device as
    ``_HistoryRecorder`` does; the times stay the host's floats."""

    def __init__(self, x: TimeseriesState, lw: torch.Tensor, rows: int):
        self.values = torch.empty((rows,) + tuple(x.value.shape), dtype=x.value.dtype, device=x.value.device)
        self.log_weights = torch.empty((rows,) + tuple(lw.shape), dtype=lw.dtype, device=lw.device)
        self.times: list[float] = []
        self.write(x, lw)

    def write(self, x: TimeseriesState, lw: torch.Tensor) -> None:
        row = len(self.times)
        self.values[row] = x.value
        self.log_weights[row] = lw
        self.times.append(float(x.time_index))

    def leaves(self) -> tuple:
        return self.values, self.log_weights, torch.tensor(self.times, dtype=torch.float64)


class _FilterRun:
    """One rank's filtering pass (:func:`spmd_batch_filter`)."""

    def __init__(self, model, n_particles, generator, group, size, device, ess_threshold, halo, proposal, resampler,
                 metropolis_iters):
        self.model, self.generator, self.group = model, generator, group
        self.n_total, self.n_local, self.device = n_particles, n_particles // size, device
        self.ess_threshold, self.halo = float(ess_threshold), int(halo)
        self.proposal = Bootstrap() if proposal is None else proposal
        self.resampler, self.metropolis_iters = resampler, int(metropolis_iters)
        self.ev = model.hidden.event_ndim
        self.local = _rank_stream(generator, group)
        self.history: _History | None = None

    # -- the weight operations over every rank's particles --------------------
    def normalize(self, lw: torch.Tensor) -> torch.Tensor:
        return col.psum_normalize(lw, self.group)

    def weighted_mean(self, probs: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        pb = probs.reshape(probs.shape + (1,) * self.ev)
        return _comm.all_reduce(torch.sum(pb * value, dim=0), "sum", self.group)

    # -- the resample ----------------------------------------------------------
    def resample(self, log_weights: torch.Tensor, values, probs: torch.Tensor | None = None):
        """``values`` (a tensor or a tuple) resampled by ``log_weights`` (or by
        their normalized ``probs``) over every rank's particles: this rank's
        output slots, and their global ancestors."""
        spmd_batch_filter.fires += 1
        if self.resampler == "metropolis":
            return col.distributed_metropolis(self.generator, log_weights, values, self.group, self.halo,
                                              self.metropolis_iters)
        probs = self.normalize(log_weights) if probs is None else probs
        u = torch.rand((), generator=self.generator, device=self.device)
        g_idx, w_idx, fits = col.halo_systematic(None, probs, self.group, self.halo, normalized=True, u=u)
        if bool(fits):  # the host read of the fire
            return col._tree_map(lambda v: col.halo_take(v, w_idx, self.group, self.halo), values), g_idx
        spmd_batch_filter.fallbacks += 1
        first = values[0] if isinstance(values, tuple) else values
        if first.dtype == torch.float32 and self.n_total < pbase.FUSED_ENTRIES:
            shard = ParticleShard(self.group, self.n_local)
            return shard.resample(probs, values, lambda p, v: systematic_expand(None, p, v, normalized=True, u=u))
        idx = col.allgather_systematic(None, probs, self.group, normalized=True, u=u)
        return col._tree_map(lambda v: col.allgather_take(v, idx, self.group), values), idx

    # -- the steps: each returns (state, log-weights, log-likelihood increment) --
    def substeps(self, x: TimeseriesState, lw: torch.Tensor, n_sub: int) -> TimeseriesState:
        """``n_sub`` uncorrected transitions: one batched draw, or one a
        sub-step while recording (each then a history row)."""
        if not n_sub:
            return x
        if self.history is None:
            return self.model.hidden.propagate_substeps(self.local, x, n_sub)
        for _ in range(n_sub):
            x = self.model.hidden.propagate(self.local, x)
            self.history.write(x, lw)
        return x

    def sisr_step(self, n_sub, x, lw, probs, y_t, skip: bool):
        """ESS-gated resample, sub-steps, then the proposal's draw and weight."""
        ess = col.distributed_ess(probs, self.group, normalized=True)
        if bool(ess < self.ess_threshold * self.n_total):  # the host read of the step
            vals, _ = self.resample(lw, x.value, probs)
            x, lw = x.copy(values=vals), torch.zeros_like(lw)
            probs = torch.full_like(probs, 1.0 / self.n_total)
        x = self.substeps(x, lw, n_sub)
        if skip:
            return self.model.hidden.propagate(self.local, x), lw, None
        shim = ParticleFilterPrediction(x, lw, probs, None)
        x_new, inc = self.proposal.sample_and_weight(self.local, self.model, y_t, shim)
        return x_new, inc + lw, col.distributed_log_likelihood(inc, probs, self.group, normalized=True)

    def apf_step(self, n_sub, x, lw, probs, y_t, skip: bool):
        """Pre-weight, resample ``(values, pre-weights)`` by one distributed
        resample, propose, subtract the gathered pre-weights; the increment
        adds the all-reduced auxiliary normalizer."""
        x = self.substeps(x, lw, n_sub)
        if skip:
            return self.model.hidden.propagate(self.local, x), lw, None
        pre_w = self.proposal.pre_weight(self.model, y_t, x)
        (vals, prew_res), _ = self.resample(pre_w + lw, (x.value, pre_w))
        zeros = torch.zeros_like(lw)
        shim = ParticleFilterPrediction(x.copy(values=vals), zeros, zeros + 1.0 / self.n_total, None)
        x_new, inc = self.proposal.sample_and_weight(self.local, self.model, y_t, shim)
        w = inc - prew_res
        aux = torch.log(_comm.all_reduce(torch.sum(probs * torch.exp(pre_w), dim=0), "sum", self.group))
        return x_new, w, col.distributed_log_likelihood(w, None, self.group) + aux

    def gpf_step(self, n_sub, x, lw, probs, y_t, skip: bool):
        """The Gaussian particle filter: on an observed step the propagated
        cloud collapses to a Gaussian of its all-reduced weighted moments,
        which the rank samples at its local size; no resample."""
        x = self.substeps(x, lw, n_sub)
        x_prop = self.model.hidden.propagate(self.local, x)
        if skip:
            return x_prop, lw, None
        mean, cov = get_mean_and_variance(x_prop.value, probs, event_ndim=self.ev, covariance=True,
                                          reduce=lambda t: _comm.all_reduce(t, "sum", self.group))
        if self.ev == 0:
            predictive = Normal(mean, torch.sqrt(cov))
        else:
            predictive = MultivariateNormal(mean, scale_tril=robust_cholesky(cov))
        x_new = x_prop.copy(values=predictive.expand((self.n_local,)).sample(self.local))
        w = self.model.build_density(x_new).log_prob(y_t)
        return x_new, w, col.distributed_log_likelihood(w, None, self.group)

    # -- the pass ----------------------------------------------------------------
    def run(self, y, filter_type: str, record: bool):
        y_host = _host_observations(y)
        n_steps = y_host.shape[0]
        skips = np.isnan(y_host.reshape(n_steps, -1)).all(axis=1)
        y_dev = torch.as_tensor(y_host, device=self.device)
        oes = int(self.model.observe_every_step)
        step = {"sisr": self.sisr_step, "apf": self.apf_step, "gpf": self.gpf_step}[filter_type]

        x = self.model.hidden.initial_sample(self.local, (self.n_local,))
        lw = torch.zeros((self.n_local,), dtype=x.value.dtype, device=self.device)
        if record:
            self.history = _History(x, lw, 2 + (n_steps - 1) * oes)
        probs = self.normalize(lw)
        incs, means = [], []
        zero = torch.zeros((), dtype=lw.dtype, device=self.device)
        for t in range(n_steps):
            # the first observation is corrected after one transition from t = 0
            x, lw, inc = step(0 if t == 0 else oes - 1, x, lw, probs, y_dev[t], bool(skips[t]))
            incs.append(zero if inc is None else inc)
            probs = self.normalize(lw)
            means.append(self.weighted_mean(probs, x.value))
            if record:
                self.history.write(x, lw)
        ll = torch.sum(torch.stack(incs))
        out = (x.value, lw, ll, torch.stack(means))
        return out + (self.history.leaves(),) if record else out


def spmd_batch_filter(
    model,
    n_particles: int,
    generator,
    y,
    mesh,
    axis_name: str = "particles",
    ess_threshold: float = 0.9,
    halo: int = 1,
    proposal=None,
    resampler: str = "systematic",
    metropolis_iters: int = 32,
    filter_type: str = "sisr",
    record_history: bool = False,
):
    """A whole filtering pass on this rank's ``n_particles / P`` particles of
    the mesh axis ``axis_name`` (module docstring); every rank calls it with
    the same arguments and a ``generator`` in the same state.

    ``filter_type``: ``"sisr"`` (ESS-gated, ``ess_threshold`` relative to the
    global N), ``"apf"`` (resamples every observed step) or ``"gpf"`` (the
    moment-matched Gaussian collapse, no resample). ``proposal`` (default
    Bootstrap) must move each particle on its own (Bootstrap,
    ``LinearGaussianObservations``): one that fits the whole cloud would need
    the other ranks' particles. ``resampler``: ``"systematic"`` (the halo
    exchange with the all-gather fallback, ``halo`` neighbours a side; the
    exact law) or ``"metropolis"`` (``collective.distributed_metropolis``,
    ring shifts only, ``metropolis_iters`` steps a slot; approximately
    multinomial).

    Returns ``(values, log_weights, log_likelihood, filter_means)``: this
    rank's shard of the final cloud, and the log-likelihood and the per-step
    weighted means of the whole cloud, the same on every rank. With
    ``record_history`` a fifth element ``(values, log_weights, times)``: the
    rank's shard at every transition ``(2 + (T - 1) * observe_every_step,
    N/P, ...)``, the initial cloud first, and the times as a float64 CPU
    tensor (the host's clock), the input of :func:`spmd_smooth`. The JAX
    package's GPF records no sub-step; here every filter type records the
    same layout."""
    group, size, device = _axis(mesh, axis_name, int(n_particles))
    if filter_type not in ("sisr", "apf", "gpf"):
        raise ValueError(f"unknown filter_type '{filter_type}'")
    if resampler not in ("systematic", "metropolis"):
        raise ValueError(f"unknown resampler '{resampler}'")
    _check_model(model, device)
    run = _FilterRun(model, int(n_particles), generator, group, size, device, ess_threshold, halo, proposal,
                     resampler, metropolis_iters)
    return run.run(y, filter_type, bool(record_history))


spmd_batch_filter.fires = 0
spmd_batch_filter.fallbacks = 0


def _ffbs_draw(generator, model, vals_t, lw_t, time_index: float, targets, group) -> torch.Tensor:
    """The exact backward draw of every trajectory over the sharded cloud:
    Gumbel-max over each rank's logits, two max all-reduces."""
    return col.distributed_categorical(generator, ffbs_logits(model, vals_t, lw_t, time_index, targets), group)


def _ffbsi_draw(generator, model, vals_t, lw_t, time_index: float, targets, group, n_total: int, log_sup,
                max_rounds: int):
    """Rejection-FFBSi's draw of every trajectory: ``max_rounds`` rounds of
    uniform global candidates drawn at once from the shared generator (the
    same on every rank), their values and weights fetched by one
    ``distributed_take_rows`` of packed rows, accepted with probability
    ``(w_i / max w) p(target | x_i) / sup p`` against the all-reduced max;
    slots that accept in no round take the exact draw. Returns ``(indices,
    violated)``, ``violated`` True on the device when a candidate's density
    passed the bound."""
    m, r, dev = targets.shape[0], int(max_rounds), lw_t.device
    ev = model.hidden.event_ndim
    lw_shift = lw_t - _comm.all_reduce(torch.amax(lw_t, dim=0), "max", group)
    if r > 0:
        cand = torch.randint(0, n_total, (r, m), generator=generator, device=dev)
        flat_vals = vals_t.reshape(vals_t.shape[0], -1)
        rows = col.distributed_take_rows(torch.cat([flat_vals, lw_shift[:, None]], dim=-1), cand.reshape(-1), group)
        rows = rows.reshape(r, m, -1)
        x_c = rows[..., :-1].reshape((r, m) + tuple(vals_t.shape[1:]))
        lp = model.hidden.build_density(TimeseriesState(time_index, x_c, ev)).log_prob(targets.unsqueeze(0))
        violated = torch.any(lp > log_sup + 1e-4)
        log_u = torch.log(torch.rand((r, m), generator=generator, dtype=lp.dtype, device=dev))
        acc = log_u < rows[..., -1] + lp - log_sup
        idx = torch.gather(cand, 0, torch.argmax(acc.to(torch.uint8), dim=0).unsqueeze(0))[0]
        failed = ~torch.any(acc, dim=0)
    else:
        idx = torch.zeros((m,), dtype=torch.int64, device=dev)
        failed = torch.ones((m,), dtype=torch.bool, device=dev)
        violated = torch.zeros((), dtype=torch.bool, device=dev)
    spmd_smooth.host_reads += 1
    if int(failed.sum()):  # the host read of the step, the same on every rank
        spmd_smooth.fallback_passes += 1
        exact = _ffbs_draw(generator, model, vals_t, lw_t, time_index, targets, group)
        idx = torch.where(failed, exact.to(idx.dtype), idx)
    return idx, violated


def spmd_smooth(
    model,
    generator,
    history,
    mesh,
    n_trajectories: int = 256,
    axis_name: str = "particles",
    method: str = "ffbs",
    log_density_sup=None,
    max_rounds: int = 32,
):
    """Smoothed trajectories ``(T, n_trajectories, *event)``, the same on every
    rank, from :func:`spmd_batch_filter`'s sharded ``history`` (``values``,
    ``log_weights``, ``times``). Every rank calls it with the same arguments
    and a ``generator`` in the same state.

    ``method="ffbs"``: the exact backward pass, O(M * N/P) density work and
    O(M) scalars of communication a rank and a step. ``method="ffbsi"``: the
    rejection sampler of :func:`_ffbsi_draw`, ``max_rounds`` rounds a step,
    one host read a step, the exact pass for slots that never accept;
    ``log_density_sup`` defaults to ``transition_log_sup(model)``, and a
    density observed above it poisons the output with NaN. ``n_trajectories``
    defaults to 256: at the N this path is for, M = N would build an ``(N,
    N/P)`` matrix a rank and a step. The history holds one row a transition,
    so sub-stepped models smooth through single transitions."""
    vals, lws, times = history
    group, size, device = _axis(mesh, axis_name)
    for leaf in (vals, lws):
        if not same_device(leaf.device, device):
            raise ValueError(f"the history lies on {leaf.device}, the mesh's shards on {device}")
    _check_model(model, device)
    method = method.lower()
    if method not in ("ffbs", "ffbsi"):
        raise NotImplementedError(f"unsupported spmd smoothing method '{method}'")
    times = [float(t) for t in (times.tolist() if hasattr(times, "tolist") else times)]
    m, n_local = int(n_trajectories), vals.shape[1]
    if method == "ffbsi":
        if log_density_sup is None:
            from ..filters.particle.smoothing import transition_log_sup

            log_density_sup = transition_log_sup(model)
        log_sup = torch.as_tensor(log_density_sup, dtype=vals.dtype, device=device)

    idx = col.distributed_categorical(generator, lws[-1].unsqueeze(0).expand(m, n_local), group)
    last = col.distributed_take_rows(vals[-1], idx, group)
    out = torch.empty((vals.shape[0],) + tuple(last.shape), dtype=vals.dtype, device=device)
    out[-1] = last
    violated = torch.zeros((), dtype=torch.bool, device=device)
    for t in range(vals.shape[0] - 2, -1, -1):
        if method == "ffbs":
            idx = _ffbs_draw(generator, model, vals[t], lws[t], times[t], out[t + 1], group)
        else:
            idx, bad = _ffbsi_draw(generator, model, vals[t], lws[t], times[t], out[t + 1], group, n_local * size, log_sup,
                                   max_rounds)
            violated = violated | bad
        out[t] = col.distributed_take_rows(vals[t], idx, group)
    return torch.where(violated, torch.nan, out) if method == "ffbsi" else out


spmd_smooth.host_reads = 0
spmd_smooth.fallback_passes = 0


def spmd_predict(model, generator, values, log_weights, n_steps: int, mesh, time_index, axis_name: str = "particles"):
    """``n_steps``-ahead predictive moments of a sharded filter cloud: this
    rank's ``values`` propagated with its own generator (no exchange), and
    each step's weighted mean and variance all-reduced. Returns ``(means,
    variances)`` ``(n_steps, *event)``, the same on every rank.

    ``time_index`` is required: the time the cloud was filtered to, the last
    of a recorded history's times (``1 + (T - 1) * observe_every_step`` after
    T observations: the first is corrected after one transition). A
    time-dependent model reads it."""
    group, _, device = _axis(mesh, axis_name)
    _check_model(model, device)
    local = _rank_stream(generator, group)
    probs = col.psum_normalize(log_weights, group)
    x = TimeseriesState(float(time_index), values, model.hidden.event_ndim)
    means, variances = [], []
    for _ in range(int(n_steps)):
        x = model.hidden.propagate(local, x)
        mean, var = get_mean_and_variance(x.value, probs, event_ndim=x.event_ndim,
                                          reduce=lambda t: _comm.all_reduce(t, "sum", group))
        means.append(mean)
        variances.append(var)
    return torch.stack(means), torch.stack(variances)


def spmd_smoothed_log_likelihood(
    model,
    n_particles: int,
    generator,
    y,
    mesh,
    n_trajectories: int = 256,
    axis_name: str = "particles",
    **filter_kwargs,
):
    """The VI factor at scale (``ParticleFilter.smoothed_log_likelihood``'s):
    the filter and FFBS run sharded under ``torch.no_grad()`` on a copy of
    ``model`` with detached leaves, and the replicated smoothed trajectories
    are scored by ``smoothed_joint_log_likelihood`` under ``model``, whose
    parameters carry the gradient. The gradient flows through the densities
    only, never through a collective."""
    frozen = rebuild(model, [t.detach() for t in model_leaves(model)])
    with torch.no_grad():
        *_, history = spmd_batch_filter(frozen, n_particles, generator, y, mesh, axis_name=axis_name,
                                        record_history=True, **filter_kwargs)
        smoothed = spmd_smooth(frozen, generator, history, mesh, n_trajectories, axis_name)
    return smoothed_joint_log_likelihood(model, history[2], smoothed.detach(), _host_observations(y),
                                         oes=int(model.observe_every_step))
