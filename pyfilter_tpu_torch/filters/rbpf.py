"""Rao-Blackwellized particle filter (marginalized PF / mixture Kalman
filter).

Counterpart of ``pyfilter_tpu/filters/rbpf.py``. For conditionally
linear-Gaussian models

.. math::
    n_{t+1} &\\sim p(\\cdot \\mid n_t)                        \\\\
    l_{t+1} &= F(n_{t+1})\\, l_t + b(n_{t+1}) + w,\\quad w \\sim N(0, Q(n_{t+1})) \\\\
    y_t     &= d(n_t) + H(n_t)\\, l_t + v,\\quad v \\sim N(0, R(n_t))

each particle carries a Kalman belief ``(m, P)`` over the linear block beside
its sampled nonlinear state and is weighted by the exact innovation
likelihood (Chen & Liu 2000; Doucet, de Freitas, Murphy & Russell 2000).

The substructure's callables are evaluated per particle by
``torch.func.vmap``; the Kalman moves are batched ``(N, d_l, d_l)`` tensor
algebra. A resample fire moves the cloud, the conditional means and the
covariances together: on the default route through the fused kernel (K1,
``ops.systematic_expand``) as ``d_n + d_l + d_l^2`` float32 value planes, on
the other through the resampler's indices and a gather; both give the same
bits. The ESS gate is one host read a step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..constants import MAX_EXACT_INDEX
from ..ops import systematic_counts
from ..ops.expand import systematic_expand
from ..timeseries import TimeseriesState
from ..utils import batched_gather, get_ess, log_likelihood, normalize, resolve_device, same_device
from ._masked import cho_solve, cholesky_or_nan, observations
from .result import FilterResult


@dataclasses.dataclass(frozen=True)
class LinearSubstructure:
    """Conditionally linear-Gaussian block, as functions of ONE particle's
    nonlinear :class:`TimeseriesState` (the filter vmaps them over the
    cloud): ``trans_matrix(n) -> (d_l, d_l)``, ``trans_offset(n) -> (d_l,)``,
    ``trans_cov(n) -> (d_l, d_l)``, ``obs_matrix(n) -> (d_y, d_l)``,
    ``obs_offset(n) -> (d_y,)``, ``obs_cov(n) -> (d_y, d_y)``; ``init_mean``
    / ``init_cov`` the prior over ``l_0``. Tensors on the filter's device."""

    trans_matrix: Callable
    trans_offset: Callable
    trans_cov: Callable
    obs_matrix: Callable
    obs_offset: Callable
    obs_cov: Callable
    init_mean: torch.Tensor
    init_cov: torch.Tensor


class RBPFState(NamedTuple):
    n: TimeseriesState  # nonlinear particles, values (N, *event_n)
    m: torch.Tensor  # (N, d_l) conditional means over l
    p: torch.Tensor  # (N, d_l, d_l) conditional covariances
    log_weights: torch.Tensor  # (N,)
    log_likelihood: torch.Tensor

    def normalized_weights(self):
        return normalize(self.log_weights)


def _mv(mat, vec):
    return (mat @ vec[..., None])[..., 0]


class RaoBlackwellizedPF:
    """Marginalized particle filter over ``nonlinear`` x ``linear`` on
    ``device`` (the card unless ``device="cpu"``; the process's).

    ``nonlinear`` is any process of the ``timeseries`` layer (its density
    must not depend on ``l``); ``linear`` a :class:`LinearSubstructure`.
    Single lane; ``ess_threshold`` gates the resample as in :class:`SISR`.
    A fire takes the fused kernel whenever the resampler is
    ``systematic_counts``, the cloud float32 and N < 2^24;
    ``fused_resample`` overrides that rule."""

    def __init__(self, nonlinear, linear: LinearSubstructure, particles: int, resampling_method=systematic_counts,
                 ess_threshold: float = 0.9, fused_resample: bool | None = None, device=None):
        self.device = resolve_device(device)
        if not same_device(nonlinear.device, self.device):
            raise ValueError(f"the process lies on {nonlinear.device}, the filter on {self.device}")
        self.nonlinear = nonlinear
        self.linear = linear
        self.n_particles = int(particles)
        self.resampler = resampling_method
        self.ess_threshold = float(ess_threshold)
        self.fused_resample = fused_resample
        self._d_l = int(torch.atleast_1d(torch.as_tensor(linear.init_mean)).shape[0])
        #: resample fires since the count was set to 0
        self.n_resamples = 0

    def _use_fused_resample(self, values: torch.Tensor) -> bool:
        if self.fused_resample is not None:
            return bool(self.fused_resample)
        return (values.dtype == torch.float32 and self.resampler is systematic_counts
                and self.n_particles < MAX_EXACT_INDEX)

    def resample_uniform(self, generator) -> torch.Tensor:
        """The fused resample's uniform, drawn from ``generator``."""
        return torch.rand((), generator=generator, device=self.device)

    # -- init ---------------------------------------------------------------
    def initialize(self, generator) -> RBPFState:
        n, d = self.n_particles, self._d_l
        n0 = self.nonlinear.initial_sample(generator, (n,))
        m0 = torch.atleast_1d(torch.as_tensor(self.linear.init_mean, dtype=torch.float32)).expand(n, d)
        p0 = torch.as_tensor(self.linear.init_cov, dtype=torch.float32).reshape(d, d).expand(n, d, d)
        zero = torch.zeros((), device=self.device)
        return RBPFState(n0, m0, p0, torch.zeros((n,), device=self.device), zero)

    # -- the cloud's Kalman moves ------------------------------------------
    def _per_particle(self, fn, values, ev, t):
        """``fn`` of each particle's state, stacked ``(N, ...)``."""
        out = torch.func.vmap(lambda v: torch.as_tensor(fn(TimeseriesState(t, v, ev)), dtype=torch.float32))(values)
        return out.expand((values.shape[0],) + tuple(out.shape[1:]))

    def _kalman_move(self, n_new: TimeseriesState, m, p, y_t):
        lin, ev, t = self.linear, self.nonlinear.event_ndim, n_new.time_index
        vals = n_new.value
        f_mat = self._per_particle(lin.trans_matrix, vals, ev, t)
        b = self._per_particle(lin.trans_offset, vals, ev, t)
        q = self._per_particle(lin.trans_cov, vals, ev, t)
        m_pred = _mv(f_mat, m) + b
        p_pred = f_mat @ p @ f_mat.transpose(-1, -2) + q

        h_mat = self._per_particle(lin.obs_matrix, vals, ev, t)
        d_off = self._per_particle(lin.obs_offset, vals, ev, t)
        r = self._per_particle(lin.obs_cov, vals, ev, t)
        s_mat = h_mat @ p_pred @ h_mat.transpose(-1, -2) + r
        chol = cholesky_or_nan(s_mat)
        innov = torch.where(torch.isnan(y_t), 0.0, y_t - (d_off + _mv(h_mat, m_pred)))

        solved = cho_solve(chol, innov[..., None])[..., 0]
        d_y = y_t.shape[0]
        log_det = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        ll_inc = -0.5 * (torch.sum(innov * solved, dim=-1) + log_det + d_y * math.log(2.0 * math.pi))

        eye = torch.eye(d_y, dtype=s_mat.dtype, device=s_mat.device)
        k_gain = p_pred @ h_mat.transpose(-1, -2) @ cho_solve(chol, eye.expand(s_mat.shape))
        m_new = m_pred + _mv(k_gain, innov)
        p_new = p_pred - k_gain @ h_mat @ p_pred
        return m_new, p_new, m_pred, p_pred, ll_inc

    # -- one filter step -------------------------------------------------------
    def step(self, generator, y_t, state: RBPFState, observed: bool = True) -> RBPFState:
        """One move: the ESS gate (the step's host read) and, on a fire, the
        resample of ``(n, m, P)``; the propagation; the Kalman moves.
        ``observed=False`` (an all-NaN row, known on the host) only predicts."""
        normalized = state.normalized_weights()
        ess = get_ess(normalized, normalized=True)
        if bool(ess < self.ess_threshold * self.n_particles):
            self.n_resamples += 1
            values = state.n.value
            if self._use_fused_resample(values):
                (n_vals, m, p), _ = systematic_expand(None, normalized, (values, state.m, state.p), normalized=True,
                                                      u=self.resample_uniform(generator))
            else:
                idx = self.resampler(generator, normalized, normalized=True)
                n_vals = batched_gather(values, idx, self.nonlinear.event_ndim)
                m, p = state.m.index_select(0, idx.long()), state.p.index_select(0, idx.long())
            lw = torch.zeros_like(state.log_weights)
            norm_prev = torch.full_like(normalized, 1.0 / self.n_particles)
        else:
            n_vals, m, p, lw, norm_prev = state.n.value, state.m, state.p, state.log_weights, normalized

        n_new = self.nonlinear.propagate(generator, state.n.copy(values=n_vals))
        m_new, p_new, m_pred, p_pred, ll_inc = self._kalman_move(n_new, m, p, y_t)
        if not observed:
            zero = torch.zeros((), device=self.device)
            return RBPFState(n_new, m_pred, p_pred, lw, state.log_likelihood + zero)
        return RBPFState(n_new, m_new, p_new, lw + ll_inc, state.log_likelihood + log_likelihood(ll_inc, norm_prev))

    # -- whole sequence ----------------------------------------------------------
    def batch_filter(self, generator, y) -> FilterResult:
        """Marginalized filtering over the whole sequence (time axis leading):
        the initial cloud's draws, then per step the resample's uniform (on a
        fire) and the propagation's draws, all from ``generator``.
        ``filter_means`` / ``filter_variances`` stack the weighted nonlinear
        moments and the linear block's marginal moments (the law of total
        variance over the mixture) as ``(T, d_n + d_l)``."""
        y = observations(y, self.device)
        observed = (~torch.isnan(y).all(dim=1)).cpu().tolist()  # the pass's one read of the observations
        state = self.initialize(generator)
        n = self.n_particles
        lls, means, variances = [], [], []
        for i in range(y.shape[0]):
            new = self.step(generator, y[i], state, observed=observed[i])
            lls.append(new.log_likelihood - state.log_likelihood)
            w = new.normalized_weights()
            n_flat = new.n.value.reshape(n, -1)
            n_mean = w @ n_flat
            l_mean = w @ new.m
            means.append(torch.cat([n_mean, l_mean]))
            diag_p = torch.diagonal(new.p, dim1=-2, dim2=-1)
            variances.append(torch.cat([w @ torch.square(n_flat - n_mean), w @ (diag_p + torch.square(new.m - l_mean))]))
            state = new
        return FilterResult(state.log_likelihood, torch.stack(lls), torch.stack(means), torch.stack(variances),
                            state, None)
