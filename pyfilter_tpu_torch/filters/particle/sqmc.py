"""SQMC — sequential quasi-Monte Carlo filtering (Gerber & Chopin 2015).

Counterpart of ``pyfilter_tpu/filters/particle/sqmc.py``. Replaces the
particle filter's i.i.d. randomness with randomized low-discrepancy point
sets: at every step the cloud is ordered along a Hilbert curve
(``ops/hilbert.py``), the ancestors are drawn by inverse CDF against the
FIRST coordinate of an RQMC point set sorted the same way, and the
propagation noise comes from the remaining coordinates through the
increment distribution's inverse CDF. Same filtering law, ``o(N^-1/2)``
error.

``proposal="linear_gaussian"`` is guided SQMC: the last sub-step is drawn
from the exact conditional posterior (the optimal linear-Gaussian proposal)
by its componentwise inverse CDF, weighted by the closed-form predictive.
The hidden process must be an :class:`AffineProcess` whose increment and
initial distributions have ``icdf`` (Gaussian increments for the guided
proposal); other models raise at construction.

The randomization is a Cranley-Patterson shift of one scrambled-Sobol base
set, built on the host by ``scipy.stats.qmc.Sobol`` exactly as the JAX
package builds it (so a pass can be replayed against it), cached as numpy
and copied to the device once per ``(n, dim, seed, device)``. The shifts
come from the filter's generator through :meth:`SQMC.shift_uniform`, the
replay seam. The step launches no resample kernel: two stable sorts (the
Hilbert keys, the point set's first coordinate), the float32 cumulative sum
of the sorted weights by the exact fixed-point prefix sum of
``ops/resample.py`` (``prob_cumsum``: the same bits on the card and the CPU,
within float32 rounding of the JAX package's sum), one ``searchsorted`` and
gathers; it reads nothing back to the host.

Lanes (``batch_shape=(K,)``, the form PMMH uses) are batched natively: the
cloud is ``(N, K, *event)``, particle axis first as everywhere in the port,
every lane sorted along the particle axis on its own and searched in one
``searchsorted`` over ``(K, N)``, each lane with its own shifts; the lane
axes of the model's parameters broadcast as in SISR. The JAX package vmaps
the single-lane pass instead; the two agree lane for lane on the same shifts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ...distributions import Independent, Normal
from ...ops.hilbert import cloud_argsort
from ...ops.resample import prob_cumsum
from ...timeseries import AffineProcess, TimeseriesState
from ...utils import batched_gather, normalize
from ..base import BaseFilter
from ..result import FilterHistory, FilterResult


class SQMCState(NamedTuple):
    """An SQMC (or twisted-pass) cloud: ``values`` ``(N, *lanes, *event)``,
    ``log_weights`` ``(N, *lanes)``, the host's ``time_index``, the running
    ``log_likelihood`` ``(*lanes)`` and the state's event rank."""

    values: torch.Tensor
    log_weights: torch.Tensor
    time_index: float
    log_likelihood: torch.Tensor
    event_ndim: int = 0

    def moments(self) -> tuple:
        """The weighted mean and variance over the particle axis."""
        w = normalize(self.log_weights)
        we = w.unsqueeze(-1) if self.event_ndim else w
        m = torch.sum(we * self.values, dim=0)
        return m, torch.sum(we * torch.square(self.values - m), dim=0)

    def get_mean(self) -> torch.Tensor:
        return self.moments()[0]

    def get_variance(self) -> torch.Tensor:
        return self.moments()[1]

    # -- lane surgery: lane axis 1 of the particle-indexed leaves, 0 of the log-likelihood
    def exchange(self, other: "SQMCState", mask: torch.Tensor) -> "SQMCState":
        """Lanes where ``mask`` ``(K,)`` is True take ``other``'s leaves."""

        def mix(mine, theirs, lead):
            m = mask.reshape((1,) * lead + tuple(mask.shape) + (1,) * (mine.dim() - lead - mask.dim()))
            return torch.where(m, theirs, mine)

        return self._replace(values=mix(self.values, other.values, 1),
                             log_weights=mix(self.log_weights, other.log_weights, 1),
                             log_likelihood=mix(self.log_likelihood, other.log_likelihood, 0))

    def resample(self, indices: torch.Tensor, entire_history: bool = True) -> "SQMCState":
        """Gather the lanes by ``indices`` ``(K,)``."""
        idx = indices.long()
        return self._replace(values=self.values.index_select(1, idx), log_weights=self.log_weights.index_select(1, idx),
                             log_likelihood=self.log_likelihood.index_select(0, idx))

    @staticmethod
    def lane_concat(states) -> "SQMCState":
        """States concatenated along the lane axis; the first one's time index."""
        s0 = states[0]
        return s0._replace(values=torch.cat([s.values for s in states], dim=1),
                           log_weights=torch.cat([s.log_weights for s in states], dim=1),
                           log_likelihood=torch.cat([s.log_likelihood for s in states], dim=0))


def _flat_dim(shape) -> int:
    return math.prod(int(s) for s in shape)


#: scrambled-Sobol base sets keyed by (n, dim, seed), numpy float32 on the host
_POINT_SETS: dict = {}
#: the same sets on a device, keyed by (n, dim, seed, device)
_DEVICE_SETS: dict = {}


def _sobol_base(n: int, dim: int, seed: int) -> np.ndarray:
    """Host-side scrambled Sobol ``(n, dim)``, as the JAX package builds it,
    with the quasi engine's degeneracy squeeze into the open unit cube."""
    cache_key = (n, dim, seed)
    if cache_key not in _POINT_SETS:
        import warnings

        from scipy.stats import qmc

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            probs = qmc.Sobol(dim, scramble=True, seed=seed).random(n)
        eps = float(np.finfo(np.float32).eps)
        _POINT_SETS[cache_key] = np.asarray(0.5 + (1.0 - eps) * (probs - 0.5), np.float32)
    return _POINT_SETS[cache_key]


def sobol_base(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """:func:`_sobol_base` on ``device``, copied there once."""
    device = torch.device(device)
    cache_key = (n, dim, seed, str(device))
    if cache_key not in _DEVICE_SETS:
        _DEVICE_SETS[cache_key] = torch.as_tensor(_sobol_base(n, dim, seed), device=device)
    return _DEVICE_SETS[cache_key]


def _strip_lanes(shape: tuple, lanes: tuple) -> tuple:
    """``shape`` without a leading ``lanes`` (a distribution whose parameters
    carry the lane axes)."""
    return shape[len(lanes):] if lanes and shape[: len(lanes)] == lanes else shape


def obs_log_weight(model, x: TimeseriesState, y_t: torch.Tensor) -> torch.Tensor:
    """Observation log-weights ``(N, *lanes)`` with exact partial-NaN
    marginalization for a factorized density and the all-NaN skip otherwise
    (``nan_strategy="skip"``), decided on the device."""
    density = model.build_density(x)
    nan = torch.isnan(y_t)
    y_safe = torch.where(nan, 0.0, y_t)
    if isinstance(density, Independent) and density.reinterpreted_batch_ndims == 1:
        lp = density.base_dist.log_prob(y_safe)
        return torch.sum(torch.where(nan, 0.0, lp), dim=-1)
    lp = density.log_prob(y_safe)
    return torch.where(torch.all(nan), 0.0, lp)


def elementwise_normal(dist) -> bool:
    """A Normal, or an Independent over one: an increment whose pushforward
    is ``loc + scale * eps`` componentwise."""
    return isinstance(dist, Normal) or (isinstance(dist, Independent) and isinstance(dist.base_dist, Normal))


class SQMC(BaseFilter):
    """Sequential quasi-Monte Carlo filter (bootstrap or guided), on
    ``device`` (the card unless ``device="cpu"``).

    ``bits`` sets the Hilbert grid (default: the largest fitting the 64-bit
    key, capped at 16); ``scramble_seed`` fixes the Sobol scrambling (each
    pass still draws fresh Cranley-Patterson shifts from its generator, so
    repeated passes are independent RQMC replicates). Takes a model or a
    model builder, and ``batch_shape=(K,)`` lanes (module docstring), so it
    serves PMMH as its likelihood estimator."""

    def __init__(self, model, particles: int, bits: int | None = None, scramble_seed: int = 0,
                 record_states: bool = False, proposal: str = "bootstrap", batch_shape=(), device=None):
        if proposal not in ("bootstrap", "linear_gaussian"):
            raise ValueError("proposal must be 'bootstrap' or 'linear_gaussian'")
        super().__init__(model, record_states=record_states, batch_shape=batch_shape, device=device)
        self.n_particles = int(particles)
        self.bits = bits
        self.scramble_seed = int(scramble_seed)
        self.proposal = proposal
        if self.model is not None:
            self._validate(self.model)

    def _validate(self, model):
        hidden = model.hidden
        if not isinstance(hidden, AffineProcess):
            raise ValueError("SQMC needs an AffineProcess hidden process")
        inc = hidden.increment_distribution
        init = hidden.initial_distribution()
        if not (inc.has_icdf and init.has_icdf):
            raise ValueError("SQMC needs icdf-able increment and initial distributions (inverse-Rosenblatt "
                             "propagation)")
        if self.proposal == "linear_gaussian":
            if not elementwise_normal(inc):
                raise ValueError("proposal='linear_gaussian' needs elementwise Normal increments")
            if len(getattr(model, "parameters", ())) != 3:
                raise ValueError("proposal='linear_gaussian' needs the LinearStateSpaceModel (a, b, s) observation "
                                 "layout")
            if torch.as_tensor(model.parameters[0]).dim() >= 2:
                raise ValueError("proposal='linear_gaussian' supports scalar/per-component observation maps (matrix "
                                 "A couples components — use bootstrap, or the non-QMC APF with the optimal proposal)")

    def initialize_model(self, context) -> "SQMC":
        new = super().initialize_model(context)
        new._validate(new.model)
        return new

    # -- the model's shapes ----------------------------------------------------
    @property
    def _ev(self) -> int:
        return int(self.model.hidden.event_ndim)

    @property
    def _noise_shape(self) -> tuple:
        inc = self.model.hidden.increment_distribution
        return _strip_lanes(tuple(inc.batch_shape) + tuple(inc.event_shape), self.batch_shape)

    @property
    def _init_shape(self) -> tuple:
        init = self.model.hidden.initial_distribution()
        return _strip_lanes(tuple(init.batch_shape) + tuple(init.event_shape), self.batch_shape)

    @property
    def _d_noise(self) -> int:
        return _flat_dim(self._noise_shape)

    @property
    def _dim_step(self) -> int:
        return 1 + int(self.model.observe_every_step) * self._d_noise

    @property
    def _base(self) -> torch.Tensor:
        return sobol_base(self.n_particles, self._dim_step, self.scramble_seed, self.device)

    @property
    def _base_init(self) -> torch.Tensor:
        return sobol_base(self.n_particles, _flat_dim(self._init_shape), self.scramble_seed + 1, self.device)

    @property
    def _inc_var(self) -> torch.Tensor:
        inc = self.model.hidden.increment_distribution
        inc_base = inc.base_dist if isinstance(inc, Independent) else inc
        return torch.as_tensor(inc_base.variance)

    # -- pieces ---------------------------------------------------------------
    def shift_uniform(self, generator, dim: int) -> torch.Tensor:
        """The Cranley-Patterson shift of one point set, ``(*lanes, dim)``
        uniforms drawn from ``generator`` (the replay seam: a test feeds the
        JAX run's shifts here)."""
        return torch.rand(self.batch_shape + (dim,), generator=generator, device=self.device)

    def _shift(self, generator, base: torch.Tensor) -> torch.Tensor:
        """``base`` ``(N, dim)`` shifted mod 1 by each lane's shift: ``(N,
        *lanes, dim)``, squeezed strictly inside (0, 1) (``icdf(0)`` is
        -inf; the quasi engine's squeeze, re-applied after the shift)."""
        n, dim = base.shape
        s = self.shift_uniform(generator, dim)
        out = torch.remainder(base.reshape((n,) + (1,) * len(self.batch_shape) + (dim,)) + s, 1.0)
        eps = float(torch.finfo(out.dtype).eps)
        return 0.5 + (1.0 - eps) * (out - 0.5)

    def _guided_step(self, x: TimeseriesState, y_t: torch.Tensor, us: torch.Tensor):
        """The last sub-step from the exact conditional posterior
        ``p(x_t | x_{t-1}, y_t)`` (componentwise precision form), drawn by
        inverse CDF; the weight is the closed-form predictive ``N(y; b + a
        loc, a^2 h_var + o_var)``. NaN observation components fall back to
        the prior with zero weight."""
        loc, scale = self.model.hidden.mean_scale(x)
        h_var = torch.square(scale) * self._inc_var
        a, b, s_obs = self.model.parameters
        o_var = torch.square(s_obs)

        nan = torch.isnan(y_t)
        yd = torch.where(nan, 0.0, y_t - b)
        eff_o_prec = torch.where(nan, 0.0, 1.0 / o_var)  # missing -> prior

        post_var = 1.0 / (1.0 / h_var + torch.square(a) * eff_o_prec)
        post_mean = post_var * (loc / h_var + a * eff_o_prec * yd)

        z = torch.special.ndtri(us.reshape(self.particles + self._noise_shape))
        x = x.propagate_from(values=post_mean + torch.sqrt(post_var) * z, time_increment=1.0)

        pred_var = o_var + torch.square(a) * h_var
        lp = -0.5 * torch.square(y_t - (b + a * loc)) / pred_var - 0.5 * torch.log(2.0 * math.pi * pred_var)
        lp = torch.where(nan, 0.0, lp)
        if self._ev:
            lp = torch.sum(lp, dim=-1)
        return x, lp

    @property
    def particles(self) -> tuple:
        return (self.n_particles, *self.batch_shape)

    def initialize(self, generator) -> SQMCState:
        """The initial cloud: the initial distribution's inverse CDF at the
        shifted initial point set."""
        u = self._shift(generator, self._base_init).reshape(self.particles + self._init_shape)
        x0 = self.model.hidden.initial_distribution().icdf(u)
        zeros = torch.zeros(self.particles, device=self.device)
        return SQMCState(x0.to(torch.float32), zeros, 0.0, torch.zeros(self.batch_shape, device=self.device),
                         self._ev)

    def filter(self, generator, y_t: torch.Tensor, state: SQMCState, n_transitions: int | None = None):
        """One SQMC move on a device observation ``y_t``: Hilbert sort,
        inverse-CDF resample on the sorted RQMC first coordinate, icdf
        propagation, reweight. Returns ``(new_state, ancestors (N, *lanes)
        int32)``."""
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)
        n, ev = self.n_particles, self._ev
        hidden = self.model.hidden

        u = self._shift(generator, self._base)  # (N, *lanes, 1 + oes * d')
        order = torch.argsort(u[..., 0], dim=0, stable=True)
        u = torch.gather(u, 0, order.unsqueeze(-1).expand_as(u))  # sorted by coordinate 0

        sigma = cloud_argsort(state.values.reshape(self.particles + (-1,)), self.bits)  # Hilbert order
        w_sorted = torch.gather(normalize(state.log_weights), 0, sigma.long())
        cum = prob_cumsum(w_sorted.movedim(0, -1))  # (*lanes, N)
        cum[..., -1].fill_(1.0)  # absorb the drift (a fill: setting it from a Python number copies from the host)
        a = torch.searchsorted(cum, u[..., 0].movedim(0, -1).contiguous(), right=False)
        ancestors = torch.gather(sigma, 0, torch.clamp(a, 0, n - 1).movedim(-1, 0))

        x = TimeseriesState(state.time_index, batched_gather(state.values, ancestors, ev), ev)
        guided = self.proposal == "linear_gaussian"
        prior_steps = n_transitions - 1 if guided else n_transitions
        d_noise = self._d_noise
        for s in range(prior_steps):
            loc, scale = hidden.mean_scale(x)
            us = u[..., 1 + s * d_noise: 1 + (s + 1) * d_noise]
            w = hidden.increment_distribution.icdf(us.reshape(self.particles + self._noise_shape))
            x = x.propagate_from(values=loc + scale * w, time_increment=1.0)

        if guided:
            x, lw = self._guided_step(x, y_t, u[..., 1 + prior_steps * d_noise:])
        else:
            lw = obs_log_weight(self.model, x, y_t)
        inc = torch.logsumexp(lw, dim=0) - math.log(n)
        new = SQMCState(x.value.to(torch.float32), lw, x.time_index, state.log_likelihood + inc, ev)
        return new, ancestors

    def batch_filter(self, generator, y, initial_state=None) -> FilterResult:
        """The whole sequence ``y`` (time axis leading; host or device),
        drawing from ``generator`` the initial shift, then one shift a step.

        With ``record_states=True`` the result carries a standard
        :class:`FilterHistory` (the initial cloud first, with an identity
        ``prev_indices`` row), so the FFBS/FFBSi smoothers and the genealogy
        variance estimators take it unchanged. With ``batch_shape=(K,)``
        every lane is an independent RQMC randomization; the moments stack
        ``(T, K, *event)``, the history ``(T + 1, N, K, ...)``."""
        if initial_state is not None:
            raise ValueError("SQMC does not accept an initial_state")
        if len(self.batch_shape) > 1:
            raise ValueError("SQMC lane batching supports one lane axis")
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y_dev = torch.as_tensor(np.asarray(y, dtype=np.float32), device=self.device)
        n_steps = y_dev.shape[0]
        if n_steps == 0:
            raise ValueError("empty observation sequence")

        state0 = self.initialize(generator)
        history = None
        if self.record_states:
            leaves = (state0.values, state0.log_weights,
                      torch.arange(self.n_particles, dtype=torch.int32, device=self.device)
                      .reshape((-1,) + (1,) * len(self.batch_shape)).expand(self.particles))
            history = [torch.empty((n_steps + 1,) + tuple(a.shape), dtype=a.dtype, device=a.device) for a in leaves]
            for buf, leaf in zip(history, leaves):
                buf[0] = leaf
        times = [state0.time_index]

        state, lls, means, variances = state0, [], [], []
        for t in range(n_steps):
            new, anc = self.filter(generator, y_dev[t], state, n_transitions=1 if t == 0 else None)
            lls.append(new.log_likelihood - state.log_likelihood)
            mean, variance = new.moments()
            means.append(mean)
            variances.append(variance)
            if history is not None:
                for buf, leaf in zip(history, (new.values, new.log_weights, anc)):
                    buf[t + 1] = leaf
            times.append(new.time_index)
            state = new

        states = None
        if history is not None:
            states = FilterHistory(torch.tensor(times, dtype=torch.float32), *history)
        return FilterResult(state.log_likelihood, torch.stack(lls), torch.stack(means), torch.stack(variances), state,
                            states)
