"""Controlled SMC — the iterated auxiliary particle filter with learned
exp-quadratic twisting functions.

Counterpart of ``pyfilter_tpu/filters/particle/twisted.py`` (Guarniero,
Johansen & Lee 2017; Heng, Bishop, Deligiannidis & Doucet 2020): each
transition density is multiplied by a learned twist ``psi_t(x) = exp(-(x'a_t
x + b_t'x + c_t))`` (diagonal quadratic) that approximates the backward
information filter. With the optimal psi the likelihood estimate has zero
variance; a learned one gets orders of magnitude of the way, and the
estimate stays unbiased for ANY psi, so every iterate is a valid
pseudo-marginal likelihood. The quadratic fit needs only log-density values
on the cloud, so nonlinear observation densities are fine.

- The twisted kernel of an affine-Gaussian transition ``N(m(x), s(x)^2)``
  per component is Gaussian-conjugate: ``s~^2 = 1/(1/s^2 + 2a)``, ``m~ =
  s~^2 (m/s^2 - b)``, with the normalizer ``f(psi)(x_prev)`` in closed form.
- Incremental weights (``psi_{T+1} = 1``): ``w_0 = f(psi_1)(x_0)`` and
  ``w_t = g(y_t | x_t) f(psi_{t+1})(x_t) / psi_t(x_t)``.
- :func:`learn_twist` is the backward least-squares recursion of both
  papers, a Python loop over ``t = T..1``: each step's ``(2d+1)^2`` normal
  equations solved in float32 by ``torch.linalg.solve_ex`` (no host read),
  with ``a >= 0`` clamped so the twisted kernel never widens past the prior.

Every step of a pass resamples on the carried twisted weights. The default
resampler is the fused systematic resample and gather,
``ops.systematic_expand`` on the ``(N, d)`` cloud — on the card the
hand-written kernel ``ops/csrc/expand.cu`` (K1), one launch a step, on the
CPU its plain version; its uniform comes from the module-level
:func:`_uniform` and the propagation's standard normals from
:func:`_standard_normal` (the replay seams). A resampler passed in takes its
indices and a gather, with no launch. These are module-level functions, not
package exports, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ...distributions import Independent
from ...ops import systematic_expand
from ...timeseries import AffineProcess, TimeseriesState
from ...utils import batched_gather, normalize, resolve_device, same_device
from ..result import FilterResult
from .sqmc import SQMCState, elementwise_normal, obs_log_weight


class TwistCoefficients(NamedTuple):
    """Diagonal-quadratic twist ``psi_t(x) = exp(-(sum_d a_td x_d^2 + b_td
    x_d) - c_t)`` for each observation step ``t = 1..T`` (leading axis T).
    :meth:`identity` (zeros) reproduces the untwisted filter."""

    a: torch.Tensor  # (T, d) >= 0
    b: torch.Tensor  # (T, d)
    c: torch.Tensor  # (T,)

    @staticmethod
    def identity(t: int, d: int, device=None) -> "TwistCoefficients":
        device = resolve_device(device)
        return TwistCoefficients(torch.zeros((t, d), device=device), torch.zeros((t, d), device=device),
                                 torch.zeros((t,), device=device))


def _model_spec(model):
    """``(event_ndim, d, increment base)`` of a model twisting supports;
    raises where the JAX package raises."""
    hidden = model.hidden
    if not isinstance(hidden, AffineProcess):
        raise ValueError("twisting needs an AffineProcess hidden process")
    inc = hidden.increment_distribution
    if not elementwise_normal(inc):
        raise ValueError("twisting needs elementwise Normal increments")
    if int(model.observe_every_step) != 1:
        raise ValueError("twisting supports observe_every_step == 1")
    ev = int(hidden.event_ndim)
    if ev not in (0, 1):
        raise ValueError("twisting supports event rank 0 or 1")
    inc_base = inc.base_dist if isinstance(inc, Independent) else inc
    d = int(hidden.initial_distribution().event_shape[0]) if ev else 1
    return ev, d, inc_base


def _resolve(model, device) -> torch.device:
    """The device of an entry point: ``device`` (the card by default), which
    the model must lie on."""
    device = resolve_device(device)
    if not same_device(model.device, device):
        raise ValueError(f"the model lies on {model.device}, the pass on {device}")
    return device


def _uniform(generator, device) -> torch.Tensor:
    """A step's resample uniform (0-d), drawn from ``generator``."""
    return torch.rand((), generator=generator, device=device)


def _standard_normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    """A step's propagation noise, standard normals of ``shape`` with
    ``like``'s dtype and device, drawn from ``generator``."""
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _psi_log(values2d, a_t, b_t, c_t):
    """log psi_t at ``values2d`` (N, d) -> (N,)."""
    return -(torch.sum(a_t * torch.square(values2d) + b_t * values2d, dim=-1) + c_t)


def _twisted_moments(m, s2, a_t, b_t):
    """Conjugate twisted-kernel moments and log-normalizer, per component:
    ``m`` / ``s2`` (N, d) the transition's mean and variance; returns
    ``(m_twist, s2_twist, log_norm (N,))``, ``log_norm = log int N(x; m, s2)
    exp(-(a x^2 + b x)) dx`` (the caller adds ``-c_t``)."""
    s2_t = 1.0 / (1.0 / s2 + 2.0 * a_t)
    m_t = s2_t * (m / s2 - b_t)
    log_norm = 0.5 * (torch.log(s2_t / s2) + torch.square(m_t) / s2_t - torch.square(m) / s2)
    return m_t, s2_t, torch.sum(log_norm, dim=-1)


def _moments2d(hidden, state: TimeseriesState, inc_var, ev: int):
    """The transition's mean and variance at ``state``, as ``(N, d)``."""
    m, sc = hidden.mean_scale(state)
    ones = torch.ones_like(state.value)
    m, s2 = m * ones, torch.square(sc) * inc_var * ones
    return (m, s2) if ev else (m.unsqueeze(-1), s2.unsqueeze(-1))


class _TwistedPass(NamedTuple):
    result: FilterResult
    clouds: torch.Tensor  # (T+1, N, d): the regression sites of learn_twist


def twisted_pass(model, particles: int, generator, y, psi: TwistCoefficients, resampler=None, device=None
                 ) -> _TwistedPass:
    """One psi-twisted APF pass, resampling every step on the twisted
    weights, on ``device`` (the card unless ``device="cpu"``). ``y`` is
    ``(T, *event_y)``, host or device. Draws from ``generator``: the
    initial cloud, then each step's resample uniform (the default resampler)
    and propagation normals.

    Returns the FilterResult (its log-likelihood unbiased for ANY psi) and
    the per-step clouds, the regression sites of :func:`learn_twist`."""
    device = _resolve(model, device)
    ev, d, inc_base = _model_spec(model)
    hidden = model.hidden
    n = int(particles)
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    t_steps = y.shape[0]
    inc_var = torch.square(torch.as_tensor(inc_base.scale))

    def from2d(v):
        return v if ev else v[:, 0]

    x0 = hidden.initial_sample(generator, (n,))
    vals = x0.value.to(torch.float32)
    vals = vals if ev else vals.unsqueeze(-1)
    clouds = torch.empty((t_steps + 1, n, d), dtype=torch.float32, device=device)
    clouds[0] = vals

    # step 0: the lookahead weight f(psi_1)(x_0), resampled before the first move
    m0, s2_0 = _moments2d(hidden, TimeseriesState(x0.time_index, from2d(vals), ev), inc_var, ev)
    _, _, ln0 = _twisted_moments(m0, s2_0, psi.a[0], psi.b[0])
    lw = ln0 - psi.c[0]
    ll = torch.logsumexp(lw, dim=0) - math.log(n)
    t_idx = float(x0.time_index)

    lls, means, variances = [], [], []
    for t in range(t_steps):
        is_last = t == t_steps - 1
        a_t, b_t, c_t = psi.a[t], psi.b[t], psi.c[t]
        probs = normalize(lw)
        if resampler is None:
            vals, _ = systematic_expand(None, probs, vals, normalized=True, u=_uniform(generator, device))
        else:
            vals = batched_gather(vals, resampler(generator, probs, normalized=True), 1)

        # the twisted propagation
        m, s2 = _moments2d(hidden, TimeseriesState(t_idx, from2d(vals), ev), inc_var, ev)
        m_t, s2_t, _ = _twisted_moments(m, s2, a_t, b_t)
        new_vals = m_t + torch.sqrt(s2_t) * _standard_normal(generator, (n, m_t.shape[-1]), m_t)
        new_state = TimeseriesState(t_idx + 1.0, from2d(new_vals), ev)

        # weight: g f(psi_next) / psi_t, with f(psi_next) = 1 on the last step
        log_target = obs_log_weight(model, new_state, y[t])
        if not is_last:
            m2, s2_2 = _moments2d(hidden, new_state, inc_var, ev)
            _, _, ln_next = _twisted_moments(m2, s2_2, psi.a[t + 1], psi.b[t + 1])
            log_target = log_target + (ln_next - psi.c[t + 1])
        lw = log_target - _psi_log(new_vals, a_t, b_t, c_t)

        ll_inc = torch.logsumexp(lw, dim=0) - math.log(n)
        we = normalize(lw).unsqueeze(-1)
        mean = torch.sum(we * new_vals, dim=0)
        lls.append(ll_inc)
        means.append(mean)
        variances.append(torch.sum(we * torch.square(new_vals - mean), dim=0))
        clouds[t + 1] = new_vals
        vals, t_idx, ll = new_vals, t_idx + 1.0, ll + ll_inc

    means, variances = torch.stack(means), torch.stack(variances)
    latest = SQMCState(from2d(vals), lw, t_idx, ll, ev)
    result = FilterResult(ll, torch.stack(lls), means if ev else means[:, 0], variances if ev else variances[:, 0],
                          latest, None)
    return _TwistedPass(result, clouds)


def learn_twist(model, clouds: torch.Tensor, y, ridge: float = 1e-6) -> TwistCoefficients:
    """Fit psi by the backward recursion (GJL §3 / Heng et al. §3), on the
    clouds' device: at each ``t = T..1`` the target ``log(g_t f(psi_{t+1}))``
    on the step-``t`` cloud, with ``psi_{t+1}`` the coefficients fitted one
    step earlier in this recursion, is least-squares projected (negated) onto
    ``(1, x_d, x_d^2)`` by ridge-regularized float32 normal equations
    (``(2d+1)^2``). ``a`` is clamped at 0."""
    ev, d, inc_base = _model_spec(model)
    hidden = model.hidden
    device = clouds.device
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    n = clouds.shape[1]
    t_steps = y.shape[0]
    inc_var = torch.square(torch.as_tensor(inc_base.scale))
    eye = torch.eye(1 + 2 * d, device=device)

    a = torch.empty((t_steps, d), device=device)
    b = torch.empty((t_steps, d), device=device)
    c = torch.empty((t_steps,), device=device)
    for t in range(t_steps - 1, -1, -1):
        x = clouds[t + 1]  # the step-t cloud, (N, d); y[t] its observation
        state = TimeseriesState(float(t + 1), x if ev else x[:, 0], ev)
        target = obs_log_weight(model, state, y[t])
        if t < t_steps - 1:
            m, s2 = _moments2d(hidden, state, inc_var, ev)
            _, _, ln_next = _twisted_moments(m, s2, a[t + 1], b[t + 1])
            target = target + (ln_next - c[t + 1])
        feats = torch.cat([torch.ones((n, 1), dtype=x.dtype, device=device), x, torch.square(x)], dim=-1)
        gram = feats.T @ feats + ridge * eye
        coef, _ = torch.linalg.solve_ex(gram, feats.T @ (-target))
        c[t] = coef[0]
        b[t] = coef[1: 1 + d]
        a[t] = torch.clamp(coef[1 + d:], min=0.0)
    return TwistCoefficients(a, b, c)


def iterated_apf(model, particles: int, generator, y, iterations: int = 2, resampler=None, return_psi: bool = False,
                 device=None):
    """The iterated auxiliary particle filter: an identity-twist pass, then
    ``iterations`` rounds of fitting psi on the last pass's clouds and a pass
    under it. Returns the last (lowest-variance) pass's FilterResult — its
    log-likelihood unbiased at every iterate — and, with ``return_psi``,
    the learned psi."""
    device = _resolve(model, device)
    _, d, _ = _model_spec(model)
    t_steps = len(y)
    psi = TwistCoefficients.identity(t_steps, d, device)
    out = twisted_pass(model, particles, generator, y, psi, resampler, device)
    for _ in range(iterations):
        psi = learn_twist(model, out.clouds, y)
        out = twisted_pass(model, particles, generator, y, psi, resampler, device)
    if return_psi:
        return out.result, psi
    return out.result
