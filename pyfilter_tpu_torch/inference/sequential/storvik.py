"""Storvik filter — online parameter learning via sufficient statistics.

Counterpart of ``pyfilter_tpu/inference/sequential/storvik.py`` (Storvik
2002; particle learning, Carvalho, Johannes, Lopes & Polson 2010): when the
parameter posterior given the state path lies in a conjugate family indexed
by a fixed-size sufficient statistic, each particle carries its own
statistic, and every step

1. draws ``theta^i ~ p(theta | s_{t-1}^i)`` afresh from the exact
   conditional posterior,
2. propagates ``x_t^i ~ f(. | x_{t-1}^i, theta^i)`` and weights by
   ``g(y_t | x_t^i, theta^i)``,
3. updates ``s_t^i = S(s_{t-1}^i, x_{t-1}^i, x_t^i, y_t)`` and, when the ESS
   falls below ``ess_threshold * N``, resamples the particles together with
   their statistics.

The JAX package's ``lax.scan`` over time is a Python loop here. The resample
decision is one host read a step (``n_host_syncs``), as the port's SISR ESS
gate is. A fire follows the port's filters' rule: the default ``systematic``
resampler on a float32 cloud below 2^24 particles resamples the state and
every statistic leaf as value planes of one ``ops.systematic_expand`` (the
hand-written expand kernel on the card: 9 planes for the NIG AR block);
``fused_resample=False`` (or any other resampler) runs the resampler and
then a gather. The 2x2 Cholesky factor and solves of the AR blocks are
closed-form elementwise arithmetic over the particle axis, as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...constants import MAX_EXACT_INDEX
from ...distributions import Gamma, Normal, Poisson
from ...ops import systematic_expand
from ...resampling import systematic
from ...timeseries import LinearModel, LinearStateSpaceModel, StateSpaceModel, TimeseriesState, models
from ...utils import get_ess, normalize, resolve_device, same_device


class StorvikResult(NamedTuple):
    """``param_means``: the posterior means of the learned parameters after
    every step, a tuple of ``(T, ...)`` tensors; ``stats``: the final
    per-particle sufficient statistics; ``values`` / ``log_weights``: the
    final cloud; ``log_likelihood``: the marginal-likelihood estimate;
    ``ess``: ``(T,)``."""

    param_means: tuple
    stats: tuple
    values: torch.Tensor
    log_weights: torch.Tensor
    log_likelihood: torch.Tensor
    ess: torch.Tensor


def _gamma(generator, concentration: torch.Tensor) -> torch.Tensor:
    """Standard gamma draws of shape ``concentration``'s."""
    return Gamma(concentration, torch.ones_like(concentration)).sample(generator)


def _standard_normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, dtype=like.dtype, device=like.device)


def _chol2x2(lam):
    """Closed-form Cholesky factor of a batch of ``(..., 2, 2)`` SPD
    matrices, as the triple ``(l11, l21, l22)``."""
    a, b, c = lam[..., 0, 0], lam[..., 1, 0], lam[..., 1, 1]
    l11 = torch.sqrt(a)
    l21 = b / l11
    l22 = torch.sqrt(torch.clamp(c - l21 * l21, min=1e-30))
    return l11, l21, l22


def _cho_solve2x2(chol, rhs):
    """Solve ``L L' m = rhs`` for a batch of 2-vectors."""
    l11, l21, l22 = chol
    z1 = rhs[..., 0] / l11
    z2 = (rhs[..., 1] - l21 * z1) / l22
    m2 = z2 / l22
    m1 = (z1 - l21 * m2) / l11
    return torch.stack([m1, m2], dim=-1)


def _solve_upper2x2(chol, rhs):
    """Solve ``L' u = rhs`` (back substitution) for a batch of 2-vectors."""
    l11, l21, l22 = chol
    u2 = rhs[..., 1] / l22
    u1 = (rhs[..., 0] - l21 * u2) / l11
    return torch.stack([u1, u2], dim=-1)


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


class NIGAutoregression:
    r"""Normal-inverse-gamma block for an AR(1) hidden process with unknown
    ``(alpha, beta, sigma^2)``, observed as ``y = a x + s v`` with known
    ``a`` and ``s``: :math:`\sigma^2 \sim IG(a_0, b_0)`, :math:`(\alpha,
    \beta) | \sigma^2 \sim N(m_0, \sigma^2 V_0)`. The statistic per particle
    is ``(Lambda (N, 2, 2), eta (N, 2), ssq (N,), n (N,))``, the Bayesian
    linear regression's on ``z = [1, x_{t-1}]``."""

    def __init__(self, obs_coeff=1.0, obs_scale=0.1, m0=(0.0, 0.0), v0=10.0, a0=2.0, b0=1.0, device=None):
        self.device = resolve_device(device)
        self.obs_coeff = _f32(obs_coeff, self.device)
        self.obs_scale = _f32(obs_scale, self.device)
        m0 = np.asarray(m0, np.float32)
        v0 = np.asarray(v0, np.float32)
        v0 = v0 * np.eye(2, dtype=np.float32) if v0.ndim == 0 else v0
        lam0 = np.linalg.inv(v0.astype(np.float64))
        self.m0, self.v0 = _f32(m0, self.device), _f32(v0, self.device)
        self.a0, self.b0 = float(a0), float(b0)
        self._lam0 = _f32(lam0, self.device)
        self._eta0 = _f32(lam0 @ m0, self.device)
        self._quad0 = float(m0 @ (lam0 @ m0))

    # -- sufficient statistics ------------------------------------------------
    def initial_stats(self, n_particles: int):
        n = int(n_particles)
        zeros = torch.zeros((n,), device=self.device)
        return (self._lam0.expand(n, 2, 2).clone(), self._eta0.expand(n, 2).clone(), zeros, zeros.clone())

    def update_stats(self, stats, x_prev, x_new, y_t):
        lam, eta, ssq, n = stats
        z = torch.stack([torch.ones_like(x_prev), x_prev], dim=-1)  # (N, 2)
        lam = lam + z.unsqueeze(-1) * z.unsqueeze(-2)
        eta = eta + z * x_new.unsqueeze(-1)
        return lam, eta, ssq + torch.square(x_new), n + 1.0

    def _posterior(self, stats):
        lam, eta, ssq, n = stats
        chol = _chol2x2(lam)
        m = _cho_solve2x2(chol, eta)
        a = self.a0 + 0.5 * n
        b = self.b0 + 0.5 * (self._quad0 + ssq - torch.sum(eta * m, dim=-1))
        return m, chol, a, torch.clamp(b, min=1e-8)

    def sample_params(self, generator, stats):
        """One draw ``(alpha, beta, sigma) ~ p(theta | s)`` per particle: the
        gamma draw, then the coefficients' normals."""
        m, chol, a, b = self._posterior(stats)
        g = _gamma(generator, a)
        sigma2 = b / torch.clamp(g, min=1e-12)
        eps = _standard_normal(generator, m.shape, m)
        # (alpha, beta) = m + sigma L^{-T} eps, with Lambda = L L'
        coef = m + torch.sqrt(sigma2).unsqueeze(-1) * _solve_upper2x2(chol, eps)
        return coef[..., 0], coef[..., 1], torch.sqrt(sigma2)

    def posterior_mean(self, stats):
        """The per-particle conditional posterior means ``(E alpha, E beta,
        E sigma^2)``."""
        m, _, a, b = self._posterior(stats)
        return m[..., 0], m[..., 1], b / torch.clamp(a - 1.0, min=1e-6)

    # -- model boundary ---------------------------------------------------------
    def build_model(self, theta) -> LinearStateSpaceModel:
        alpha, beta, sigma = theta
        return LinearStateSpaceModel(models.AR(alpha, beta, sigma, device=self.device),
                                     (self.obs_coeff, self.obs_scale))


class NIGARUnknownObsVariance(NIGAutoregression):
    r"""The AR(1) block that also learns the observation variance:
    ``s^2 | x_{0:t}, y_{1:t} ~ IG(c_0 + n_y / 2, d_0 + \sum (y - a x)^2 / 2)``,
    independent of the transition's NIG block. The statistic gains
    ``(ssq_y, n_y)``; a NaN observation updates the transition's statistic
    only. ``theta = (alpha, beta, sigma, s)``."""

    def __init__(self, obs_coeff=1.0, m0=(0.0, 0.0), v0=10.0, a0=2.0, b0=1.0, c0: float = 2.0, d0: float = 0.1,
                 device=None):
        super().__init__(obs_coeff=obs_coeff, obs_scale=1.0, m0=m0, v0=v0, a0=a0, b0=b0, device=device)
        self.c0, self.d0 = float(c0), float(d0)

    def initial_stats(self, n_particles: int):
        zeros = torch.zeros((int(n_particles),), device=self.device)
        return super().initial_stats(n_particles) + (zeros, zeros.clone())

    def update_stats(self, stats, x_prev, x_new, y_t):
        lam, eta, ssq, n = super().update_stats(stats[:4], x_prev, x_new, y_t)
        ssq_y, n_y = stats[4], stats[5]
        y = y_t.reshape(())
        finite = torch.isfinite(y_t).all()
        resid2 = torch.square(y - self.obs_coeff * x_new)
        ssq_y = ssq_y + torch.where(finite, resid2, 0.0)
        n_y = n_y + finite.to(n_y.dtype)
        return lam, eta, ssq, n, ssq_y, n_y

    def _obs_posterior(self, stats):
        ssq_y, n_y = stats[4], stats[5]
        return self.c0 + 0.5 * n_y, torch.clamp(self.d0 + 0.5 * ssq_y, min=1e-8)

    def sample_params(self, generator, stats):
        alpha, beta, sigma = super().sample_params(generator, stats[:4])
        c, d = self._obs_posterior(stats)
        s2 = d / torch.clamp(_gamma(generator, c), min=1e-12)
        return alpha, beta, sigma, torch.sqrt(s2)

    def posterior_mean(self, stats):
        ea, eb, es2 = super().posterior_mean(stats[:4])
        c, d = self._obs_posterior(stats)
        return ea, eb, es2, d / torch.clamp(c - 1.0, min=1e-6)

    def build_model(self, theta) -> LinearStateSpaceModel:
        alpha, beta, sigma, s = theta
        return LinearStateSpaceModel(models.AR(alpha, beta, sigma, device=self.device), (self.obs_coeff, s))


def _poisson_log_intensity_obs(x, lam):
    return Poisson(lam * torch.exp(x.value))


class PoissonGammaCounts:
    r"""Counts ``y_t ~ Poisson(lambda exp(x_t))`` over a known log-intensity
    process ``hidden`` with ``lambda ~ Gamma(a_0, b_0)``: given the state
    path, ``lambda ~ Gamma(a_0 + \sum y_t, b_0 + \sum exp(x_t))``, two
    scalars a particle. A NaN observation updates nothing."""

    def __init__(self, hidden, a0: float = 2.0, b0: float = 1.0):
        self.hidden = hidden
        self.device = hidden.device
        self.a0, self.b0 = float(a0), float(b0)

    def initial_stats(self, n_particles: int):
        zeros = torch.zeros((int(n_particles),), device=self.device)
        return zeros, zeros.clone()

    def update_stats(self, stats, x_prev, x_new, y_t):
        sum_y, sum_g = stats
        y = y_t.reshape(())
        finite = torch.isfinite(y)
        return sum_y + torch.where(finite, y, 0.0), sum_g + torch.where(finite, torch.exp(x_new), 0.0)

    def _posterior(self, stats):
        sum_y, sum_g = stats
        return self.a0 + sum_y, self.b0 + sum_g

    def sample_params(self, generator, stats):
        a, b = self._posterior(stats)
        return (_gamma(generator, a) / b,)

    def posterior_mean(self, stats):
        a, b = self._posterior(stats)
        return (a / b,)

    def build_model(self, theta) -> StateSpaceModel:
        (lam,) = theta
        return StateSpaceModel(self.hidden, _poisson_log_intensity_obs, (lam,))


class NIGVectorAutoregression:
    r"""Normal-inverse-gamma block for a vector AR(1) with noise per row,
    ``x_t = b + A x_{t-1} + diag(sigma) eps``, observed through a known
    ``y = B x + s v``. Each row is a Bayesian linear regression on the
    shared ``z = [1, x_{t-1}]`` with its own NIG prior, so the rows share one
    ``(p, p)`` precision (``p = d + 1``). ``theta = (A (N, d, d), b (N, d),
    sigma (N, d))``."""

    def __init__(self, dim: int, obs_coeff=None, obs_scale=0.1, v0: float = 10.0, a0: float = 2.0, b0: float = 0.5,
                 initial_scale: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.dim = int(dim)
        p = self.dim + 1
        self.obs_coeff = (torch.eye(self.dim, device=self.device) if obs_coeff is None
                          else _f32(obs_coeff, self.device))
        self.obs_scale = _f32(obs_scale, self.device)
        self.a0, self.b0 = float(a0), float(b0)
        self.initial_scale = float(initial_scale)
        self._lam0 = torch.eye(p, device=self.device) / float(v0)

    def initial_stats(self, n_particles: int):
        n, d, p = int(n_particles), self.dim, self.dim + 1
        return (self._lam0.expand(n, p, p).clone(), torch.zeros((n, d, p), device=self.device),
                torch.zeros((n, d), device=self.device), torch.zeros((n,), device=self.device))

    def update_stats(self, stats, x_prev, x_new, y_t):
        lam, eta, ssq, n = stats
        z = torch.cat([torch.ones_like(x_prev[..., :1]), x_prev], dim=-1)  # (N, p)
        lam = lam + z.unsqueeze(-1) * z.unsqueeze(-2)
        eta = eta + x_new.unsqueeze(-1) * z.unsqueeze(-2)
        return lam, eta, ssq + torch.square(x_new), n + 1.0

    def _posterior(self, stats):
        lam, eta, ssq, n = stats
        chol, _ = torch.linalg.cholesky_ex(lam)  # no error check: no host read
        m = torch.cholesky_solve(eta.transpose(-1, -2), chol).transpose(-1, -2)  # (N, d, p)
        a = self.a0 + 0.5 * n
        b = self.b0 + 0.5 * (ssq - torch.sum(eta * m, dim=-1))
        return m, chol, a, torch.clamp(b, min=1e-8)

    def sample_params(self, generator, stats):
        m, chol, a, b = self._posterior(stats)
        g = _gamma(generator, a.unsqueeze(-1).expand(b.shape).contiguous())
        sigma2 = b / torch.clamp(g, min=1e-12)  # (N, d)
        eps = _standard_normal(generator, m.shape, m)  # (N, d, p)
        # the rows share the regressor's precision: one multi-column solve
        solved = torch.linalg.solve_triangular(chol.transpose(-1, -2), eps.transpose(-1, -2), upper=True)
        coef = m + torch.sqrt(sigma2).unsqueeze(-1) * solved.transpose(-1, -2)
        return coef[..., 1:], coef[..., 0], torch.sqrt(sigma2)

    def posterior_mean(self, stats):
        m, _, a, b = self._posterior(stats)
        return m[..., 1:], m[..., 0], b / torch.clamp(a - 1.0, min=1e-6).unsqueeze(-1)

    def build_model(self, theta) -> LinearStateSpaceModel:
        a_mat, offset, sigma = theta
        d, dev = self.dim, self.device
        scale0 = self.initial_scale
        hidden = LinearModel(
            (a_mat, offset, sigma),
            Normal(torch.zeros(d, device=dev), torch.ones(d, device=dev)).to_event(1),
            lambda *_: Normal(torch.zeros(d, device=dev), scale0 * torch.ones(d, device=dev)).to_event(1),
            event_ndim=1,
        )
        return LinearStateSpaceModel(hidden, (self.obs_coeff, self.obs_scale), event_shape=(self.obs_coeff.shape[0],))


class StorvikFilter:
    """Online parameter learning over a conjugate block (``initial_stats``,
    ``sample_params``, ``update_stats``, ``posterior_mean``,
    ``build_model``): :class:`NIGAutoregression`,
    :class:`NIGARUnknownObsVariance`, :class:`PoissonGammaCounts` or
    :class:`NIGVectorAutoregression`. The statistics travel with their
    particles through every resample (module docstring for the route a
    fire takes). ``device`` (the card unless ``"cpu"``) must be the
    block's."""

    def __init__(self, conjugate, n_particles: int, resampler=systematic, ess_threshold: float = 0.9,
                 fused_resample: bool | None = None, device=None):
        self.device = resolve_device(device)
        if not same_device(conjugate.device, self.device):
            raise ValueError(f"the conjugate block lies on {conjugate.device}, the filter on {self.device}")
        self.conjugate = conjugate
        self.n_particles = int(n_particles)
        self.resampler = resampler
        self.ess_threshold = float(ess_threshold)
        self.fused_resample = fused_resample
        #: resample fires and device-to-host reads since the counts were set to 0
        self.n_resamples = 0
        self.n_host_syncs = 0

    def _use_fused_resample(self, values: torch.Tensor) -> bool:
        """The port's filters' rule: the default ``systematic`` resampler on
        a float32 cloud below 2^24 particles (``fused_resample`` overrides
        it)."""
        if self.fused_resample is not None:
            return bool(self.fused_resample)
        return values.dtype == torch.float32 and self.resampler is systematic and self.n_particles < MAX_EXACT_INDEX

    def resample_uniform(self, generator) -> torch.Tensor:
        """The fused resample's uniform, drawn from ``generator``."""
        return torch.rand((), generator=generator, device=self.device)

    def _resample(self, generator, log_weights, values, stats):
        """Resample the cloud and every statistic leaf by ``log_weights``."""
        self.n_resamples += 1
        if self._use_fused_resample(values):
            out, _ = systematic_expand(None, log_weights, (values, *stats), u=self.resample_uniform(generator))
            return out[0], tuple(out[1:])
        idx = self.resampler(generator, log_weights).long()
        return values.index_select(0, idx), tuple(s.index_select(0, idx) for s in stats)

    def fit(self, generator, y) -> StorvikResult:
        """One pass over the observations ``y`` (time axis leading; numpy or a
        tensor), drawing from ``generator``: the initial statistics' draw of
        theta, then the initial cloud, then per step the theta draw, the
        propagation and, on a fire, the resample's uniform."""
        conj, n = self.conjugate, self.n_particles
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y_host = np.asarray(y, dtype=np.float32)
        y_dev = torch.tensor(y_host, device=self.device)
        nan_rows = np.isnan(y_host.reshape(y_host.shape[0], -1)).all(axis=1)

        stats = conj.initial_stats(n)
        model0 = conj.build_model(conj.sample_params(generator, stats))
        x0 = model0.hidden.initial_sample(generator)
        ev = model0.hidden.event_ndim
        vals = x0.value
        if vals.dim() == ev:  # a constant initial kernel: no particle axis yet
            vals = vals.expand((n,) + tuple(vals.shape)).contiguous()
        lw = torch.zeros((n,), device=self.device)
        ll = torch.zeros((), device=self.device)
        threshold = np.float32(self.ess_threshold * n)
        t = 0.0
        means, esss = [], []
        for i in range(y_host.shape[0]):
            y_t = y_dev[i]
            theta = conj.sample_params(generator, stats)
            model = conj.build_model(theta)
            x_new = model.hidden.propagate(generator, TimeseriesState(t, vals, ev))
            if nan_rows[i]:
                w_tot = lw
            else:
                w_tot = lw + model.build_density(x_new).log_prob(y_t)
                ll = ll + torch.logsumexp(w_tot, dim=0) - torch.logsumexp(lw, dim=0)
            stats = conj.update_stats(stats, vals, x_new.value, y_t)
            ess = get_ess(w_tot)
            probs = normalize(w_tot)
            means.append(tuple(torch.sum(probs.reshape((n,) + (1,) * (leaf.dim() - 1)) * leaf, dim=0)
                               for leaf in conj.posterior_mean(stats)))
            esss.append(ess)
            self.n_host_syncs += 1
            if bool(ess < threshold):  # the step's host read
                vals, stats = self._resample(generator, w_tot, x_new.value, stats)
                lw = torch.zeros_like(w_tot)
            else:
                vals, lw = x_new.value, w_tot
            t = x_new.time_index
        param_means = tuple(torch.stack(parts) for parts in zip(*means))
        return StorvikResult(param_means, stats, vals, lw, ll, torch.stack(esss))
