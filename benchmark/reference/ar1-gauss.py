"""Plain reference of the linear-Gaussian AR(1) configuration: the exact
Kalman filter and Rauch-Tung-Striebel smoother.

Plain PyTorch and NumPy, written from the model's equations: it imports
nothing of the program. ``dtype`` is the precision of every quantity; the
check runs it in float64, the control in bfloat16.

Model (``configs/ar1-gauss.json``): ``x_0 ~ N(alpha, sigma^2)``, ``x_t =
alpha + beta x_{t-1} + sigma e_t`` and ``y_t = x_t + obs_sd v_t`` for ``t =
1..T``; the observation ``y[t - 1]`` sees ``x_t``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def simulate(cfg: dict, rng: np.random.Generator, n_series: int) -> np.ndarray:
    """``(n_series, T)`` float32 observations drawn from the model."""
    alpha, beta, sigma, obs_sd = (cfg[k] for k in ("alpha", "beta", "sigma", "obs_sd"))
    t_obs = int(cfg["observations"])
    x = alpha + sigma * rng.normal(size=n_series)
    ys = np.empty((n_series, t_obs))
    for t in range(t_obs):
        x = alpha + beta * x + sigma * rng.normal(size=n_series)
        ys[:, t] = x + obs_sd * rng.normal(size=n_series)
    return ys.astype(np.float32)


def kalman_rts(cfg: dict, y: np.ndarray, dtype=torch.float64) -> tuple:
    """The exact log-likelihood of ``y`` and the smoothed expectation of the
    additive functional ``sum_t x_{t-1} x_t`` (the Kalman filter, then the
    Rauch-Tung-Striebel smoother's means and lag-one covariances), every
    operation in ``dtype`` on the host."""

    def c(v):
        return torch.tensor(v, dtype=dtype)

    alpha, beta, sigma, obs_sd = (c(cfg[k]) for k in ("alpha", "beta", "sigma", "obs_sd"))
    ys = torch.as_tensor(np.asarray(y, np.float64)).to(dtype)
    n = ys.shape[0]
    m, p = alpha, sigma * sigma
    fm, fp, pm, pp = [m], [p], [c(0.0)], [c(0.0)]
    ll = c(0.0)
    log_2pi = c(math.log(2.0 * math.pi))
    for t in range(n):
        m_pred, p_pred = alpha + beta * m, beta * beta * p + sigma * sigma
        s = p_pred + obs_sd * obs_sd
        r = ys[t] - m_pred
        ll = ll - 0.5 * (log_2pi + torch.log(s) + r * r / s)
        gain = p_pred / s
        m, p = m_pred + gain * r, (c(1.0) - gain) * p_pred
        fm.append(m), fp.append(p), pm.append(m_pred), pp.append(p_pred)
    sm, sp, cross = [fm[n]], [fp[n]], []
    for t in range(n - 1, -1, -1):
        g = fp[t] * beta / pp[t + 1]
        cross.append(g * sp[-1])  # Cov(x_t, x_{t+1} | y)
        sm.append(fm[t] + g * (sm[-1] - pm[t + 1]))
        sp.append(fp[t] + g * g * (sp[-1] - pp[t + 1]))
    sm, sp, cross = sm[::-1], sp[::-1], cross[::-1]
    # the additive functional sum_t x_{t-1} x_t: its smoothed expectation
    lag_product = c(0.0)
    for t in range(1, n + 1):
        lag_product = lag_product + sm[t - 1] * sm[t] + cross[t - 1]
    return float(ll), float(lag_product)


def lag_product(traj: torch.Tensor) -> torch.Tensor:
    """The mean over the trajectories ``traj`` ``(T + 1, M)`` of ``sum_t
    x_{t-1} x_t``, in float64 on ``traj``'s device: how the check reads
    smoothed trajectories (a functional of their joint law, not only of
    their marginals)."""
    x = traj.to(torch.float64)
    return torch.sum(torch.mean(x[:-1] * x[1:], dim=1))
