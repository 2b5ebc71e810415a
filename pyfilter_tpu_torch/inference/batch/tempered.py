"""Density-tempered SMC: batch posterior sampling by likelihood annealing
(Duan & Fulop 2015; Del Moral, Doucet & Jasra 2006, with an adaptive
temperature ladder).

Counterpart of ``pyfilter_tpu/inference/batch/tempered.py``. A swarm of K
parameter particles moves from the prior to the posterior through the
bridges :math:`\\pi_\\lambda(\\theta) \\propto p(\\theta)\\, \\hat p(y|\\theta)^\\lambda`;
each stage's increment keeps the incremental weights' ESS at ``target_ess``,
the swarm is resampled and refreshed by random-walk MH moves against the
tempered target, and the summed log-mean incremental weights estimate the
log evidence.

Every log-likelihood is one ``batch_filter`` over the K lanes of one filter
(the lane kernel, once per lane resample). The MH refresh is a Python loop
with no host sync; the ladder's bisection runs on the host, from one
device-to-host copy of the K log-likelihoods a stage, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...distributions.mvn import _cholesky_or_nan
from ...resampling import systematic, systematic_m
from ...utils import normalize
from .. import prior as prior_ops
from ..base import BaseAlgorithm
from ..logging import TQDMWrapper


def _standard_normal(generator, like: torch.Tensor) -> torch.Tensor:
    """Standard normals shaped like ``like`` (the MH proposal's noise)."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def _uniform(generator, like: torch.Tensor) -> torch.Tensor:
    """Uniforms on [0, 1) shaped like ``like`` (the MH acceptance draws)."""
    return torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def _host_ess(log_w: np.ndarray) -> float:
    w = log_w - log_w.max()
    p = np.exp(w)
    p = p / p.sum()
    return float(1.0 / np.square(p).sum())


def find_increment(loglik: np.ndarray, lam: float, target: float) -> float:
    """Largest increment ``<= 1 - lam`` whose incremental weights
    ``increment * loglik`` keep ``ESS >= target * K`` (bisection on the
    host)."""
    lo, hi = 0.0, 1.0 - lam
    k = loglik.shape[0]
    if _host_ess(hi * loglik) >= target * k:
        return hi
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if _host_ess(mid * loglik) >= target * k:
            lo = mid
        else:
            hi = mid
    return max(lo, 1e-6)


class TemperedSMCResult:
    """``samples[name]``: the final equal-weight swarm ``(K, *event)``
    (constrained, numpy); ``lambdas``: the temperature ladder (ends at 1);
    ``acceptance_rates``: the MH acceptance of each stage; ``log_evidence``:
    ``sum_s log mean_k exp(increment_s * loglik_k)``."""

    def __init__(self, samples, lambdas, acceptance_rates, log_evidence):
        self.samples = samples
        self.lambdas = lambdas
        self.acceptance_rates = acceptance_rates
        self.log_evidence = float(log_evidence)


class TemperedSMC(BaseAlgorithm):
    """Adaptive density-tempered SMC over a model-builder filter.

    ``target_ess`` is each stage's incremental-weight ESS fraction;
    ``num_mh_steps`` random-walk MH moves follow every resample, with
    proposal covariance ``mh_scale^2 Cov(swarm)`` (``mh_scale=None``: 2.38 /
    sqrt(D)). ``waste_free=True`` (Dau & Chopin 2022) resamples
    ``K / (num_mh_steps + 1)`` chain roots a stage, moves only those, and
    keeps every chain state as the next swarm; ``num_particles`` must then be
    divisible by ``num_mh_steps + 1``.
    """

    def __init__(
        self,
        filter_,
        num_particles: int,
        target_ess: float = 0.5,
        num_mh_steps: int = 2,
        mh_scale: float = None,
        max_stages: int = 1000,
        resampler=systematic,
        waste_free: bool = False,
        context=None,
        generator=None,
        device=None,
    ):
        super().__init__(filter_, context=context, generator=generator, device=device)
        self.num_particles = int(num_particles)
        self.target_ess = float(target_ess)
        self.num_mh_steps = int(num_mh_steps)
        self.mh_scale = mh_scale
        self.max_stages = int(max_stages)
        self._resampler = resampler
        self.waste_free = bool(waste_free)
        if self.waste_free:
            chain_len = self.num_mh_steps + 1
            if self.num_particles % chain_len:
                raise ValueError(
                    f"waste_free needs num_particles ({self.num_particles}) "
                    f"divisible by num_mh_steps + 1 ({chain_len})"
                )
            self._n_roots = self.num_particles // chain_len
        self.context.set_batch_shape((self.num_particles,))
        self._filter = self._filter.set_batch_shape((self.num_particles,))

    def _lane_logliks(self, ctx, filt, theta, y):
        """Each lane's log-likelihood (one ``batch_filter`` over the lanes)
        and unconstrained log-prior at the unconstrained stacked ``theta``."""
        ctx2 = ctx.unstack_parameters(theta, constrained=False)
        res = filt.initialize_model(ctx2).batch_filter(self.generator, y)
        return res.log_likelihood, ctx2.eval_priors(constrained=False)

    def _mh_refresh(self, ctx, filt, y, theta, loglik, logprior, chol, lam, scale):
        """``num_mh_steps`` random-walk MH moves against the ``lam``-tempered
        target. Returns the moved swarm (every chain state when waste-free)
        and the mean acceptance, all on the device."""
        chain, rates = [(theta, loglik, logprior)], []
        for _ in range(self.num_mh_steps):
            theta_star = theta + scale * _standard_normal(self.generator, theta) @ chol.T
            ll_star, lp_star = self._lane_logliks(ctx, filt, theta_star, y)
            log_acc = lam * (ll_star - loglik) + (lp_star - logprior)
            accept = torch.log(_uniform(self.generator, loglik)) < log_acc
            theta = torch.where(accept[:, None], theta_star, theta)
            loglik = torch.where(accept, ll_star, loglik)
            logprior = torch.where(accept, lp_star, logprior)
            chain.append((theta, loglik, logprior))
            rates.append(accept.to(theta.dtype).mean())
        rate = torch.stack(rates).mean()
        if self.waste_free:
            # the roots and every MH state, (L, M, ...) flattened
            return tuple(torch.cat(parts, dim=0) for parts in zip(*chain)) + (rate,)
        return theta, loglik, logprior, rate

    def fit(self, y, logging=None) -> TemperedSMCResult:
        """Temper from the prior to the posterior of the observations ``y``
        (time axis leading; kept on the host)."""
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, dtype=np.float32)
        ctx = self.context
        self._filter = self._filter.initialize_model(ctx)
        ctx.initialize_parameters()
        filt = self._filter.initialize_model(ctx)

        theta = ctx.stack_parameters(constrained=False)  # (K, D)
        d = theta.shape[1]
        scale = self.mh_scale if self.mh_scale is not None else 2.38 / math.sqrt(d)
        if self.waste_free:
            # the MH chains move the M roots only: M-lane views of the context
            # and the filter, so the re-filters run M lanes, not K
            ctx_m = ctx._clone_registry()
            ctx_m.batch_shape = (self._n_roots,)
            filt_m = filt.set_batch_shape((self._n_roots,))
        else:
            ctx_m, filt_m = ctx, filt
        eye = torch.eye(d, dtype=theta.dtype, device=theta.device)

        loglik, logprior = self._lane_logliks(ctx, filt, theta, y)
        lam, log_evidence = 0.0, 0.0
        lambdas, rates = [], []
        logger = logging if logging is not None else TQDMWrapper()
        with logger.initialize(self, self.max_stages):
            for stage in range(self.max_stages):
                ll_np = loglik.double().cpu().numpy()  # the stage's one host read
                ll_np = np.where(np.isfinite(ll_np), ll_np, -1e300)
                dlam = find_increment(ll_np, lam, self.target_ess)
                lam = min(lam + dlam, 1.0)
                lambdas.append(lam)

                inc = dlam * ll_np
                m = inc.max()
                log_evidence += m + np.log(np.mean(np.exp(inc - m)))

                # proposal covariance from the whole, equally weighted swarm
                centered = theta - theta.mean(dim=0)
                chol = _cholesky_or_nan(centered.T @ centered / (theta.shape[0] - 1) + 1e-8 * eye)
                probs = normalize(dlam * loglik)
                if self.waste_free:
                    indices = systematic_m(self.generator, probs, self._n_roots, normalized=True)
                else:
                    indices = self._resampler(self.generator, probs, normalized=True)
                idx = indices.long()
                theta, loglik, logprior = (a.index_select(0, idx) for a in (theta, loglik, logprior))

                theta, loglik, logprior, rate = self._mh_refresh(
                    ctx_m, filt_m, y, theta, loglik, logprior, chol, lam, scale
                )
                rates.append(rate)
                logger.do_log(stage + 1, None)
                if lam >= 1.0:
                    break
        if lam < 1.0:
            # a truncated ladder targets the wrong distribution
            raise RuntimeError(
                f"temperature ladder stalled at lambda={lam:.4g} after "
                f"{self.max_stages} stages (the swarm still targets the "
                "partially-tempered bridge, not the posterior) — raise "
                "max_stages, increase num_particles, or lower target_ess"
            )

        samples = {}
        index = 0
        for name in ctx.parameters:
            shape = ctx.get_shape(name, constrained=False)
            numel = math.prod(shape)
            block = theta[:, index : index + numel].reshape((theta.shape[0],) + shape)
            samples[name] = prior_ops.get_constrained(ctx.get_prior(name), block).cpu().numpy()
            index += numel

        ctx.absorb(ctx.unstack_parameters(theta, constrained=False))
        return TemperedSMCResult(samples, np.asarray(lambdas), torch.stack(rates).cpu().numpy(), log_evidence)
