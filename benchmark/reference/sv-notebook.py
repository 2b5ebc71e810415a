"""Plain reference of the stochastic-volatility configuration.

Plain PyTorch and NumPy, written from the model's equations: it imports
nothing of the program. ``dtype`` is the precision of every state, weight
and running sum; the check runs it in float32 (resampling prefix sums in
float64). The SMC2 control keeps the lane weights, the lanes'
log-likelihoods, the Cholesky factor and the PMMH moves in float32 and runs
each lane's filter (states, particle weights, increments) in bfloat16
(``filter_dtype``), its resampling prefix sums in float32; the filter
control runs in bfloat16 throughout.

Model (``configs/sv-notebook.json``): the volatility ``x`` follows the
Verhulst SDE ``dx = kappa (gamma - x) x dt + sigma x dW``, Euler-Maruyama
at ``dt``, ``1 / dt`` sub-steps an observation (one before the first),
``x_0 ~ N(gamma, sigma / sqrt(2 kappa))``; ``y = mu + x sinh((asinh(z) +
nu) tau)``, ``z ~ N(0, 1)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PARAMETERS = ("kappa", "gamma", "sigma", "mu", "nu", "tau")
_LOG_2PI = math.log(2.0 * math.pi)


def simulate(cfg: dict, rng: np.random.Generator, n_series: int) -> np.ndarray:
    """``(n_series, T)`` float32 observations: the volatility starts at
    gamma, takes ``1 / dt`` Euler sub-steps (floored at 1e-4) before each
    observation, then one sinh-arcsinh draw."""
    kappa, gamma, sigma, mu, nu, tau, dt = (cfg[k] for k in (*PARAMETERS, "dt"))
    sub, t_obs = int(round(1.0 / dt)), int(cfg["observations"])
    vol = np.full(n_series, gamma)
    ys = np.empty((n_series, t_obs))
    for t in range(t_obs):
        for _ in range(sub):
            vol = vol + kappa * (gamma - vol) * vol * dt + sigma * vol * math.sqrt(dt) * rng.normal(size=n_series)
            vol = np.maximum(vol, 1e-4)
        z = rng.normal(size=n_series)
        ys[:, t] = mu + vol * np.sinh((np.arcsinh(z) + nu) * tau)
    return ys.astype(np.float32)


def obs_log_prob(y, x, mu, nu, tau):
    """``log p(y | x)`` of the sinh-arcsinh observation with scale ``x``
    (``|x|``: the Euler scheme can take the volatility below 0)."""
    u = torch.asinh((y - mu) / x)
    z = torch.sinh(u / tau - nu)
    ladj = torch.log(tau) + torch.log(torch.cosh(u)) - 0.5 * torch.log1p(z * z) + torch.log(torch.abs(x))
    return -0.5 * z * z - 0.5 * _LOG_2PI - ladj


def normalize(lw, dim: int = 0):
    """Probabilities from log-weights; NaN and +inf carry no mass."""
    return torch.softmax(torch.where(torch.isnan(lw) | (lw == math.inf), -math.inf, lw), dim=dim)


def euler(x, kappa, gamma, sigma, dt, noise):
    return x + kappa * (gamma - x) * x * dt + sigma * x * math.sqrt(dt) * noise


def _systematic(probs, u, acc):
    """Systematic ancestors over axis 0 of ``probs`` ``(n, *lanes)``, one
    uniform per lane, from prefix sums in ``acc``."""
    n = probs.shape[0]
    cum = torch.cumsum(probs.to(acc), dim=0)
    cum = cum / cum[-1:]
    pos = (torch.arange(n, device=probs.device, dtype=acc).reshape((n,) + (1,) * (probs.dim() - 1)) + u.to(acc)) / n
    if probs.dim() == 1:
        return torch.searchsorted(cum, pos, right=True).clamp_(max=n - 1)
    idx = torch.searchsorted(cum.T.contiguous(), pos.expand_as(cum).T.contiguous(), right=True).T
    return idx.clamp_(max=n - 1)


def _acc(dtype):
    return torch.float64 if dtype == torch.float32 else dtype


def sisr(cfg: dict, y: np.ndarray, n: int, generator: torch.Generator, dtype=torch.float32,
         ess_threshold: float = 0.9) -> tuple:
    """Bootstrap SISR over ``y`` with ``n`` particles, systematic
    resampling when the ESS falls below ``ess_threshold * n``. Returns the
    log-likelihood estimate and the filtered mean of the last volatility,
    as Python floats."""
    dev = generator.device
    kappa, gamma, sigma, mu, nu, tau, dt = (cfg[k] for k in (*PARAMETERS, "dt"))
    sub = int(round(1.0 / dt))
    tau_t = torch.tensor(tau, dtype=dtype, device=dev)
    ys = torch.as_tensor(y, dtype=dtype, device=dev)
    x = (gamma + sigma / math.sqrt(2.0 * kappa) * torch.randn(n, generator=generator, device=dev)).to(dtype)
    lw = torch.zeros(n, dtype=dtype, device=dev)
    total = torch.zeros((), dtype=dtype, device=dev)
    for t in range(ys.shape[0]):
        probs = normalize(lw, dim=0)
        if t and bool(1.0 / torch.sum(probs * probs) < ess_threshold * n):
            u = torch.rand((), generator=generator, device=dev)
            x = x[_systematic(probs, u, _acc(dtype))]
            lw = torch.zeros_like(lw)
            probs = torch.full_like(probs, 1.0 / n)
        for _ in range(1 if t == 0 else sub):
            x = euler(x, kappa, gamma, sigma, dt, torch.randn(n, generator=generator, device=dev).to(dtype))
        inc = obs_log_prob(ys[t], x, mu, nu, tau_t)
        total = total + torch.logsumexp(inc + torch.log(probs), dim=0)
        lw = lw + inc
    probs = normalize(lw, dim=0)
    return float(total), float(torch.sum(probs * x))


# -- SMC2 -----------------------------------------------------------------------


class TooManyIncreases(RuntimeError):
    pass


def _log_prior(cfg: dict, u: torch.Tensor) -> torch.Tensor:
    """Log prior density of the unconstrained parameters ``u`` ``(K, 6)``:
    the log of each positive parameter, the others as they are."""
    total = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for j, name in enumerate(PARAMETERS):
        kind, *args = cfg["priors"][name]
        v = u[:, j]
        if kind == "Exponential":  # on log(rate-distributed value), Jacobian included
            total = total + math.log(args[0]) - args[0] * torch.exp(v) + v
        else:  # Normal, or LogNormal on the log scale: a normal density
            loc, scale = args
            total = total - 0.5 * ((v - loc) / scale) ** 2 - math.log(scale) - 0.5 * _LOG_2PI
    return total


def _prior_draw(cfg: dict, k: int, generator, dtype) -> torch.Tensor:
    dev = generator.device
    cols = []
    for name in PARAMETERS:
        kind, *args = cfg["priors"][name]
        if kind == "Exponential":
            e = -torch.log1p(-torch.rand(k, generator=generator, device=dev, dtype=torch.float64)) / args[0]
            cols.append(torch.log(e))
        else:
            cols.append(args[0] + args[1] * torch.randn(k, generator=generator, device=dev, dtype=torch.float64))
    return torch.stack(cols, dim=1).to(dtype)


def _constrained(u: torch.Tensor) -> dict:
    """The parameters by name, each ``(K,)``, from their unconstrained values."""
    out = {}
    for j, name in enumerate(PARAMETERS):
        out[name] = torch.exp(u[:, j]) if name in ("kappa", "gamma", "sigma", "tau") else u[:, j]
    return out


def _mvn(u: torch.Tensor, w: torch.Tensor, scale: float = 1.1) -> tuple:
    """Weighted mean and scaled Cholesky factor of ``u`` ``(K, D)``; the
    square root of the diagonal where the covariance is not positive
    definite. The factorisation runs in float32 at least (no bfloat16
    Cholesky)."""
    mean = w @ u
    c = u - mean
    cov = (w[:, None] * c).T @ c
    fdt = torch.float32 if cov.dtype == torch.bfloat16 else cov.dtype
    eye = torch.eye(cov.shape[0], dtype=fdt, device=cov.device)
    chol, info = torch.linalg.cholesky_ex(cov.to(fdt) + 1e-9 * eye)
    if int(info) != 0 or bool(torch.isnan(chol).any()):
        chol = torch.sqrt(torch.clamp(cov.to(fdt) * eye, min=0.0) + 1e-9 * eye)
    return mean, (scale * chol).to(u.dtype)


def _mvn_log_prob(v, mean, chol):
    fdt = torch.float32 if v.dtype == torch.bfloat16 else v.dtype
    diff = (v - mean).to(fdt).T
    z = torch.linalg.solve_triangular(chol.to(fdt), diff, upper=False)
    half_logdet = torch.sum(torch.log(torch.diagonal(chol.to(fdt))))
    return (-0.5 * torch.sum(z * z, dim=0) - half_logdet - 0.5 * v.shape[1] * _LOG_2PI).to(v.dtype)


class _LaneFilter:
    """The APF over ``K`` parameter lanes of ``n`` particles each: pre-weight
    at the mean of the next Euler step, systematic resampling of every lane
    on every observation, then one Euler step and the reweight."""

    def __init__(self, cfg, u, n, generator, dtype):
        self.cfg, self.n, self.gen, self.dtype = cfg, n, generator, dtype
        p = _constrained(u)
        self.p = {k: v[None, :].to(dtype) for k, v in p.items()}
        k = u.shape[0]
        dev = generator.device
        scale = self.p["sigma"] / torch.sqrt(2.0 * self.p["kappa"])
        self.x = (self.p["gamma"] + scale * torch.randn((n, k), generator=generator, device=dev).to(dtype))
        # resampling prefix sums: in bfloat16 they step by 0.0039 past 0.5
        # against probabilities of 1 / n, and leave particles unreachable
        self.acc = torch.float64 if dtype == torch.float32 else torch.float32
        self.lw = torch.zeros((n, k), dtype=dtype, device=dev)
        self.first = True

    def step(self, yt) -> torch.Tensor:
        """One observation; returns each lane's log-likelihood increment."""
        cfg, p, n, dev = self.cfg, self.p, self.n, self.gen.device
        yt = yt.to(self.dtype)
        dt = cfg["dt"]
        sub = int(round(1.0 / dt))
        probs = normalize(self.lw, dim=0)
        x = self.x
        for _ in range(0 if self.first else sub - 1):
            x = euler(x, p["kappa"], p["gamma"], p["sigma"], dt, torch.randn(x.shape, generator=self.gen,
                                                                             device=dev).to(self.dtype))
        pre = obs_log_prob(yt, x + p["kappa"] * (p["gamma"] - x) * x * dt, p["mu"], p["nu"], p["tau"])
        u = torch.rand(x.shape[1], generator=self.gen, device=dev)
        idx = _systematic(normalize(pre + self.lw, dim=0), u, self.acc)
        x = torch.gather(x, 0, idx)
        pre_g = torch.gather(pre, 0, idx)
        x = euler(x, p["kappa"], p["gamma"], p["sigma"], dt,
                  torch.randn(x.shape, generator=self.gen, device=dev).to(self.dtype))
        w = obs_log_prob(yt, x, p["mu"], p["nu"], p["tau"]) - pre_g
        inc = torch.logsumexp(w, dim=0) - math.log(n) + torch.log(torch.sum(probs * torch.exp(pre), dim=0))
        self.x, self.lw, self.first = x, w, False
        return inc

    def take(self, idx):
        self.x, self.lw = self.x[:, idx], self.lw[:, idx]
        self.p = {k: v[:, idx] for k, v in self.p.items()}

    def where(self, accept, other: "_LaneFilter"):
        self.x = torch.where(accept[None, :], other.x, self.x)
        self.lw = torch.where(accept[None, :], other.lw, self.lw)
        self.p = {k: torch.where(accept[None, :], other.p[k], v) for k, v in self.p.items()}


def _refilter(cfg, u, n, ys, generator, filter_dtype) -> tuple:
    filt = _LaneFilter(cfg, u, n, generator, filter_dtype)
    ll = torch.zeros(u.shape[0], dtype=u.dtype, device=generator.device)
    for yt in ys:
        ll = ll + filt.step(yt)
    return filt, ll


def smc2(cfg: dict, y: np.ndarray, lanes: int, n: int, generator: torch.Generator, dtype=torch.float32,
         threshold: float = 0.2, num_steps: int = 2, acceptance_threshold: float = 0.2,
         max_increases: int = 5, filter_dtype=None) -> dict:
    """SMC2 (Chopin, Jacob and Papaspiliopoulos) over ``y`` with ``lanes``
    parameter lanes, each an APF of ``n`` particles, as pyfilter writes it:
    the lane weights gather each step's log-likelihood; when their ESS
    falls below ``threshold * lanes`` or one is not finite, the lanes are
    resampled and moved by ``num_steps`` PMMH steps, each proposing from the
    cloud's weighted normal (Cholesky factor scaled by 1.1) and re-filtering
    the whole history; a running acceptance under ``acceptance_threshold``
    doubles ``n`` and re-filters once more; one doubling more than
    ``max_increases`` raises :class:`TooManyIncreases`, as pyfilter does.
    ``filter_dtype`` (``dtype`` where None) is the precision of each
    lane's filter. Returns the posterior mean and sd of each parameter and
    the posterior mean of the lanes' log-likelihood, as Python floats."""
    dev = generator.device
    filter_dtype = filter_dtype or dtype
    ys = torch.as_tensor(y, dtype=dtype, device=dev)
    u = _prior_draw(cfg, lanes, generator, dtype)
    filt = _LaneFilter(cfg, u, n, generator, filter_dtype)
    lane_w = torch.zeros(lanes, dtype=dtype, device=dev)
    lane_ll = torch.zeros(lanes, dtype=dtype, device=dev)
    increases = 0

    def rejuvenate(t_end):
        nonlocal u, filt, lane_w, lane_ll, n, increases
        w = normalize(lane_w, dim=0)
        mean, chol = _mvn(u, w)
        idx = _systematic(w[:, None], torch.rand(1, generator=generator, device=dev), _acc(dtype))[:, 0]
        u, lane_ll = u[idx], lane_ll[idx]
        filt.take(idx)
        rate = 0.0
        for i in range(num_steps):
            z = torch.randn((lanes, u.shape[1]), generator=generator, device=dev).to(dtype)
            cand = mean + z @ chol.T
            cand_filt, cand_ll = _refilter(cfg, cand, n, ys[:t_end], generator, filter_dtype)
            log_u = torch.log(torch.rand(lanes, generator=generator, device=dev)).to(dtype)
            c_mean, c_chol = _mvn(cand, torch.full((lanes,), 1.0 / lanes, dtype=dtype, device=dev))
            diff = (_mvn_log_prob(u, c_mean, c_chol) - _mvn_log_prob(cand, mean, chol)
                    + _log_prior(cfg, cand) - _log_prior(cfg, u) + cand_ll - lane_ll)
            accept = log_u < diff
            u = torch.where(accept[:, None], cand, u)
            lane_ll = torch.where(accept, cand_ll, lane_ll)
            filt.where(accept, cand_filt)
            rate = (float(accept.float().mean()) + i * rate) / (i + 1)
            if rate < acceptance_threshold:
                increases += 1
                if increases > max_increases:
                    raise TooManyIncreases(f"more than {max_increases} particle doublings")
                n *= 2
                filt, new_ll = _refilter(cfg, u, n, ys[:t_end], generator, filter_dtype)
                lane_w, lane_ll = new_ll - lane_ll, new_ll
                return
        lane_w = torch.zeros_like(lane_w)

    for t in range(ys.shape[0]):
        inc = filt.step(ys[t])
        lane_ll = lane_ll + inc
        lane_w = lane_w + torch.where(torch.isnan(inc) | (inc == math.inf), -math.inf, inc)
        w = normalize(lane_w, dim=0)
        ess, finite = torch.stack([1.0 / torch.sum(w * w), torch.isfinite(lane_w).all().to(w.dtype)]).tolist()
        if finite == 0.0 or ess < threshold * lanes:
            rejuvenate(t + 1)
    if not bool(torch.isfinite(lane_w).all()):
        rejuvenate(ys.shape[0])

    w = normalize(lane_w.to(torch.float64), dim=0)
    out = {}
    for name, v in _constrained(u).items():
        v = v.to(torch.float64)
        m = float(w @ v)
        out[f"mean.{name}"] = m
        out[f"sd.{name}"] = math.sqrt(max(float(w @ (v - m) ** 2), 1e-24))
    out["loglik"] = float(w @ torch.where(w > 0, lane_ll.to(torch.float64), 0.0))
    return out
