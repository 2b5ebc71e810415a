"""Particle filter base: particle shapes, initialisation, the fused-resample
rule, and smoothing over a recorded history.

Counterpart of ``pyfilter_tpu/filters/particle/base.py``. Particles are
``(N, *batch_shape)``: particle axis 0, lane axes next. The smoothers walk the
history backwards in a Python loop (the JAX package's reverse ``lax.scan``)
and write each step's draws into one output preallocated on the device.
"""

from __future__ import annotations

import math

import torch

from ...ops import systematic_counts, systematic_expand, systematic_expand_lanes
from ...resampling import systematic_m
from ...timeseries import TimeseriesState
from ...tracing import span
from ...utils import batched_gather, get_ess, gumbel, log_likelihood, normalize, normalize_log, same_device
from ..base import BaseFilter
from ..result import FilterHistory, FilterResult
from ..state import ParticleFilterCorrection
from .proposals import Bootstrap, Proposal


#: the fused kernels index a whole cloud (every rank's particles, every lane)
#: of fewer entries than this exactly in float32
FUSED_ENTRIES = 1 << 24


def categorical(generator, logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw over the last axis of ``logits`` per leading
    index, by Gumbel-max: ``argmax(logits + g)``, as ``jax.random.categorical``
    draws it."""
    return torch.argmax(logits + gumbel(generator, logits.shape, logits), dim=-1)


def trajectory_ends(generator, resampler, log_w: torch.Tensor, n_trajectories: int | None) -> torch.Tensor:
    """The smoothers' draws at the last step from its log-weights ``log_w``:
    ``resampler``'s N, or ``systematic_m``'s ``n_trajectories`` (one lane only)."""
    if n_trajectories is None:
        return resampler(generator, log_w)
    if log_w.dim() > 1:
        raise ValueError("n_trajectories requires a laneless history")
    return systematic_m(generator, log_w, int(n_trajectories))


def ffbs_logits(model, vals_t, lw_t, time_index: float, traj_next) -> torch.Tensor:
    """The exact backward kernel's logits ``w_t^i + log p(x_{t+1}^j | x_t^i)``
    for every trajectory ``j`` and particle ``i``: ``(M, *batch, N)``."""
    ev = model.hidden.event_ndim
    density = model.hidden.build_density(TimeseriesState(time_index, vals_t, ev))  # batch (N, *batch)
    w_state = density.log_prob(traj_next.unsqueeze(1))  # (M, N, *batch)
    return torch.movedim(lw_t.unsqueeze(0) + w_state, 1, -1)


def smoothed_joint_log_likelihood(model, times, smoothed: torch.Tensor, y, oes: int = 1) -> torch.Tensor:
    """The joint log-density of smoothed trajectories under ``model``'s
    (differentiable) parameters, averaged over the trajectory axis: the
    transitions from every recorded step, the observations at every
    ``oes``-th recorded state, the initial density at the first.

    ``smoothed``: ``(T+1, M, *lanes, *event)``; ``times``: ``(T+1,)``, shaped
    here to broadcast against the trajectory and lane axes (a time per step,
    not per trajectory, for a model whose density reads the time); ``y``:
    ``(T, *event_y)``, host or device. Returns ``(*lanes)``."""
    ev = model.hidden.event_ndim
    extra = smoothed.dim() - 1 - ev  # trajectory and lane axes
    times = torch.as_tensor(times, dtype=smoothed.dtype, device=smoothed.device)
    t_shaped = times.reshape(times.shape[:1] + (1,) * extra)
    hidden_density = model.hidden.build_density(TimeseriesState(t_shaped[:-1], smoothed[:-1], ev))
    obs_density = model.build_density(TimeseriesState(t_shaped[1::oes], smoothed[1::oes], ev))

    y = torch.as_tensor(y, dtype=smoothed.dtype, device=smoothed.device)
    y_event_ndim = len(model.event_shape)
    y_shaped = y.reshape(y.shape[:1] + (1,) * extra + y.shape[1 : 1 + y_event_ndim])
    ll = (
        torch.sum(hidden_density.log_prob(smoothed[1:]), dim=0)
        + torch.sum(obs_density.log_prob(y_shaped), dim=0)
        + model.hidden.initial_distribution().log_prob(smoothed[0])
    )
    return torch.mean(ll, dim=0)


class ParticleFilter(BaseFilter):
    """Particle filter with ``particles`` particles on particle axis 0 and
    ``batch_shape`` lanes after it. ``ess_threshold`` is the relative ESS
    below which the cloud resamples.

    A float32 cloud of fewer than 2^24 particles in all, with the default
    ``systematic_counts`` resampler, resamples and gathers in one pass
    (:meth:`_fused_resample`: ``ops.systematic_expand`` for one lane,
    ``ops.systematic_expand_lanes`` for a lane batch, each a hand-written
    CUDA kernel on the card); a larger cloud, or any other resampler, runs
    the resampler followed by a gather, as the JAX package does.

    ``differentiable=True`` carries the Ścibior–Wood correction
    (:meth:`_ancestor_correction`) through every resample, so that the
    log-likelihood estimate is differentiable in the model's parameters with
    the right expected gradient; its forward values are those of the default
    path.

    ``parallel.sharding`` runs a filter over one rank's shard of the particle
    axis by setting ``_shard`` (a ``parallel`` particle shard; None, the
    default, holds the whole cloud): ``n_particles`` is then the rank's count,
    the weight operations of a step (:meth:`_normalize`, :meth:`_ess`,
    :meth:`_log_likelihood`, the moments) reduce over every rank's particles,
    and every resample runs over the gathered cloud (:meth:`_resample_cloud`)."""

    #: the particle shard this filter runs on (``parallel.sharding``)
    _shard = None

    def __init__(
        self,
        model,
        particles: int,
        resampling_method=systematic_counts,
        proposal: Proposal = None,
        ess_threshold: float = 0.9,
        record_states=False,
        record_intermediary: bool = False,
        record_moments: bool = True,
        nan_strategy: str = "skip",
        batch_shape=(),
        differentiable: bool = False,
        device=None,
    ):
        super().__init__(
            model,
            record_states=record_states,
            record_intermediary=record_intermediary,
            nan_strategy=nan_strategy,
            batch_shape=batch_shape,
            device=device,
        )
        self.n_particles = int(particles)
        self.resampler = resampling_method
        self.proposal = proposal if proposal is not None else Bootstrap()
        self.ess_threshold = float(ess_threshold)
        self.record_moments = record_moments
        self.differentiable = bool(differentiable)
        #: resample fires since construction (host counter; reset freely)
        self.n_resamples = 0
        #: device-to-host reads of the ESS gate since construction (host
        #: counter; reset freely)
        self.n_host_syncs = 0
        self._identity_cache = None

    @property
    def _identity(self) -> torch.Tensor:
        """Identity ancestry ``(N, *batch)`` (cached per particle shape)."""
        if self._identity_cache is None or tuple(self._identity_cache.shape) != self.particles:
            lo = 0 if self._shard is None else self._shard.rank * self.n_particles
            ar = torch.arange(lo, lo + self.n_particles, dtype=torch.int32, device=self.device)
            self._identity_cache = ar.reshape((-1,) + (1,) * len(self.batch_shape)).expand(self.particles)
        return self._identity_cache

    def _use_fused_resample(self, value: torch.Tensor) -> bool:
        return (value.dtype == torch.float32 and self.resampler is systematic_counts
                and math.prod(self.particles) * self._n_total // self.n_particles < FUSED_ENTRIES)

    @property
    def _n_total(self) -> int:
        """The particles of the whole cloud, every rank's shard included."""
        return self.n_particles if self._shard is None else self.n_particles * self._shard.size

    def _filter(self, generator, y, nan_row, state, first_step: bool, on_substep=None):
        if self._shard is not None:
            self._shard.n_local = self.n_particles
        return super()._filter(generator, y, nan_row, state, first_step, on_substep=on_substep)

    # -- weight operations over the whole cloud (every rank's, when sharded) --
    def _normalize(self, log_weights: torch.Tensor) -> torch.Tensor:
        return normalize(log_weights) if self._shard is None else self._shard.normalize(log_weights)

    def _ess(self, probs: torch.Tensor) -> torch.Tensor:
        return get_ess(probs, normalized=True) if self._shard is None else self._shard.ess(probs)

    def _log_likelihood(self, inc_weights: torch.Tensor, probs: torch.Tensor | None = None) -> torch.Tensor:
        if self._shard is None:
            return log_likelihood(inc_weights, probs)
        return self._shard.log_likelihood(inc_weights, probs)

    def _correction(self, x, log_weights, ll, indices) -> ParticleFilterCorrection:
        return ParticleFilterCorrection.from_weighted_particles(
            x, log_weights, ll, indices, compute_moments=self.record_moments, shard=self._shard
        )

    def resample_uniform(self, generator) -> torch.Tensor:
        """The fused systematic resample's uniforms, one per lane, drawn from
        ``generator``."""
        return torch.rand(self.batch_shape, generator=generator, device=self.device)

    def _fused_resample(self, generator, weights, values, normalized: bool = False):
        """Resample + gather ``values`` by ``weights`` of the whole cloud in
        one pass: the lane kernel for a lane batch, the single-lane kernel
        otherwise."""
        u = self.resample_uniform(generator)
        expand = systematic_expand_lanes if self.batch_shape else systematic_expand
        return expand(None, weights, values, normalized=normalized, u=u)

    def _resample_cloud(self, generator, weights, values, normalized: bool = False):
        """Resampled ``values`` (a tensor or a tuple, particle axis 0) and
        ancestor indices by ``weights`` (probabilities with ``normalized``):
        the fused pass for a float32 cloud with the default resampler
        (:meth:`_use_fused_resample`), else the resampler and a gather. A
        sharded cloud is resampled whole by either route, over every rank's
        particles gathered, each rank keeping its slots
        (``parallel._shards.ParticleShard.resample``)."""
        with span("filter.resample"):
            if self._shard is None:
                return self._resample_whole(generator, weights, values, normalized)
            probs = weights if normalized else self._shard.normalize(weights)
            return self._shard.resample(probs, values, lambda p, v: self._resample_whole(generator, p, v, True))

    def _resample_whole(self, generator, weights, values, normalized: bool):
        if self._use_fused_resample(values[0] if isinstance(values, tuple) else values):
            return self._fused_resample(generator, weights, values, normalized=normalized)
        indices = self.resampler(generator, weights, normalized=normalized)

        def take(v):
            return batched_gather(v, indices, v.dim() - weights.dim())

        return (tuple(map(take, values)) if isinstance(values, tuple) else take(values)), indices

    def _ancestor_correction(self, log_weights: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """Per-slot log-weight terms that are exactly 0 in value but carry the
        gradient of each slot's ancestor's normalised log-weight, ``log w̄^{a_i}
        - stop_gradient(log w̄^{a_i})`` (arXiv:2106.10314). The filters add it
        to the post-resample weights and take ``softmax`` of it as the
        normalised weights (the value 1/N, with a live gradient)."""
        gathered = batched_gather(normalize_log(log_weights), indices, 0)
        # a zero-mass ancestor is chosen only through a tie at a copy-count
        # boundary; its -inf would give -inf - (-inf) = NaN
        gathered = torch.where(torch.isfinite(gathered), gathered, 0.0)
        return gathered - gathered.detach()

    @property
    def particles(self) -> tuple:
        return (self.n_particles, *self.batch_shape)

    @property
    def resample_threshold(self) -> float:
        return self.ess_threshold * self._n_total

    def increase_particles(self, factor: int) -> "ParticleFilter":
        """A filter with ``factor`` times the particles."""
        return self.replace(n_particles=int(factor * self.n_particles))

    def initialize(self, generator) -> ParticleFilterCorrection:
        """Initial cloud with zero log-weights and identity ancestry."""
        if self._shard is not None:
            self._shard.n_local = self.n_particles
        x = self.model.hidden.initial_sample(generator, self.particles)
        weights = torch.zeros(self.particles, dtype=x.value.dtype, device=self.device)
        ll = torch.zeros(self.batch_shape, dtype=x.value.dtype, device=self.device)
        return self._correction(x, weights, ll, self._identity)

    # -- smoothing ------------------------------------------------------------
    def smooth(self, generator, states, method: str = "ffbs", **kwargs) -> torch.Tensor:
        """Smoothed trajectories ``(T, M, *batch, *event)`` from a recorded
        history (a ``FilterResult`` of ``record_states=True`` or its
        ``FilterHistory``), on the filter's device. ``method``:

        - ``"ffbs"``: exact forward-filter backward-sampling, an ``(M, N)``
          weight matrix per step; ``n_trajectories`` sets ``M`` (default N,
          laneless histories only otherwise);
        - ``"ffbsi"``: rejection-sampling FFBSi, the same law at O(N) expected
          work per step (``smoothing.ffbsi_smooth`` and its arguments);
        - ``"fl"``: fixed-lag genealogy tracing through the recorded indices.
        """
        history = states.states if isinstance(states, FilterResult) else states
        if history is None:
            raise ValueError("smoothing requires record_states=True on the filter")
        for leaf in history[1:]:
            if not same_device(leaf.device, self.device):
                raise ValueError(f"the history lies on {leaf.device}, the filter on {self.device}")
        method = method.lower()
        if method == "ffbs":
            return self._smooth_ffbs(generator, history, **kwargs)
        if method == "ffbsi":
            from .smoothing import ffbsi_smooth

            return ffbsi_smooth(generator, self.model, history, self.resampler, **kwargs)
        if method == "fl":
            return self._smooth_fl(history, **kwargs)
        raise NotImplementedError(f"unsupported smoothing method '{method}'")

    def _smooth_ffbs(self, generator, history: FilterHistory, n_trajectories: int | None = None) -> torch.Tensor:
        """Exact backward sampling: at each step every trajectory re-selects
        its ancestor from the ``(M, N)`` logits of :func:`ffbs_logits` by one
        :func:`categorical` draw."""
        ev = self.model.hidden.event_ndim
        values, log_w = history.values, history.log_weights
        times = history.time_indexes.tolist()
        idx_last = trajectory_ends(generator, self.resampler, log_w[-1], n_trajectories)
        traj_last = batched_gather(values[-1], idx_last, ev)
        out = torch.empty((values.shape[0],) + tuple(traj_last.shape), dtype=values.dtype, device=values.device)
        out[-1] = traj_last
        for t in range(values.shape[0] - 2, -1, -1):
            logits = ffbs_logits(self.model, values[t], log_w[t], times[t], out[t + 1])
            out[t] = batched_gather(values[t], categorical(generator, logits), ev)
        return out

    def _smooth_fl(self, history: FilterHistory) -> torch.Tensor:
        """Fixed-lag smoothing: trace each final particle's genealogy back
        through the recorded ancestor indices."""
        ev = self.model.hidden.event_ndim
        values, prev_inds = history.values, history.prev_indices
        out = torch.empty_like(values)
        out[-1] = values[-1]
        inds = self._identity
        for t in range(values.shape[0] - 2, -1, -1):
            inds = batched_gather(prev_inds[t + 1], inds, 0)
            out[t] = batched_gather(values[t], inds, ev)
        return out

    # -- VI bridge -------------------------------------------------------------
    def smoothed_log_likelihood(self, generator, y, model=None, smoothing: str = "ffbs",
                                **smooth_kwargs) -> torch.Tensor:
        """The reference's pyro VI factor without pyro: filter ``y`` and smooth
        (``smoothing``, :meth:`smooth`'s methods and arguments) outside the
        graph, then evaluate :func:`smoothed_joint_log_likelihood` of the
        smoothed trajectories under ``model`` (this filter's by default), whose
        parameters carry the gradient. The filter and the smoother run under
        ``torch.no_grad()`` and what they return is detached: the FFBS pass
        writes into one preallocated tensor in place, outside any graph.
        Returns ``(*batch)``."""
        model = self.model if model is None else model
        filt = self.replace(model=model, record_states=True, record_intermediary=model.observe_every_step > 1)
        with torch.no_grad():
            result = filt.batch_filter(generator, y)
            smoothed = filt.smooth(generator, result, method=smoothing, **smooth_kwargs)
        return smoothed_joint_log_likelihood(model, result.states.time_indexes, smoothed.detach(), y,
                                             oes=model.observe_every_step)
