"""MCMC proposal builders for PMMH updates: ``RandomWalk``, ``SymmetricMH``
(quasi-random on a quasi context), ``AdaptiveRandomWalk`` and the MALA-style
``GradientBasedProposal``.

Counterpart of ``pyfilter_tpu/inference/batch/mcmc/proposals.py``. Kernels
live on the unconstrained parameter space. ``build(context, state, filter_,
y, generator)`` fits a kernel to the context (``SymmetricMH``: and the
state's lane weights; ``GradientBasedProposal``: and the filter's recorded
history, smoothed with draws from ``generator``); ``exchange`` gives the
kernel of the next transition, its accepted lanes taking the candidate's.
The JAX package's ``jit_compatible`` and ``uses_quasi_engine`` flags and its
structural ``__eq__``/``__hash__`` exist only for XLA's static arguments and
are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ....distributions import MultivariateNormal, Normal, robust_cholesky
from ....filters.particle.base import smoothed_joint_log_likelihood
from ....filters.particle.proposals.utils import _per_particle_hessian
from ...utils import construct_mvn


class BaseProposal:
    """Builds candidate kernels :math:`q(\\theta^* | \\theta)`."""

    def build(self, context, state, filter_, y, generator=None):
        """The kernel for ``context``'s lanes; ``filter_`` is the filter built
        on ``context``, ``y`` the host observations, ``generator`` the source
        of any draw the build needs (the proposals without one ignore it)."""
        raise NotImplementedError

    def exchange(self, latest, candidate, mask: torch.Tensor):
        """The kernel whose lanes where ``mask`` take ``candidate``'s."""
        raise NotImplementedError


class RandomWalk(BaseProposal):
    """Independent Normal random walk on the unconstrained parameters, of
    standard deviation ``scale`` (broadcast to every lane and parameter)."""

    def __init__(self, scale: float = 1e-2):
        self._scale = scale

    @property
    def scale(self):
        return self._scale

    def build(self, context, state, filter_, y, generator=None):
        loc = context.stack_parameters(constrained=False)
        return Normal(loc, torch.full_like(loc, self._scale)).to_event(1)

    def exchange(self, latest, candidate, mask):
        m = mask[..., None]
        loc = torch.where(m, candidate.base_dist.loc, latest.base_dist.loc)
        scale = torch.where(m, candidate.base_dist.scale, latest.base_dist.scale)
        return Normal(loc, scale).to_event(1)


class SymmetricMH(BaseProposal):
    """The weighted parameter cloud's MVN with its Cholesky factor scaled by
    1.1: SMC²'s rejuvenation proposal, sampled from the context's Sobol
    engine when it has one."""

    def build(self, context, state, filter_, y, generator=None):
        """The fit on every lane: a lane-sharded state's ``lanes`` gather the
        rank's parameters first (``state.normalized_weights`` are every
        lane's)."""
        params = state.lanes.gather(context.stack_parameters(constrained=False))
        return construct_mvn(params, state.normalized_weights(), scale=1.1,
                             quasi_engine=getattr(context, "quasi_engine", None))

    def exchange(self, latest, candidate, mask):
        return latest


class _AdaptiveRWKernel(NamedTuple):
    """:class:`AdaptiveRandomWalk`'s kernel: the chain position and the
    Welford moments of the whole chain. ``count`` (transitions absorbed) is a
    host number."""

    loc: torch.Tensor  # (K, D) current chain position
    scale_tril: torch.Tensor  # (K, D, D) proposal Cholesky factor
    mean: torch.Tensor  # (K, D) running sample mean per chain
    m2: torch.Tensor  # (K, D, D) running scatter matrix per chain
    count: float

    @property
    def batch_shape(self):
        return tuple(self.loc.shape[:-1])

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, eps)

    def log_prob(self, value):
        """0: within a transition both directions share one covariance, so
        the Hastings correction cancels exactly."""
        shape = torch.broadcast_shapes(value.shape[:-1], self.batch_shape)
        return torch.zeros(shape, dtype=value.dtype, device=value.device)


class AdaptiveRandomWalk(BaseProposal):
    r"""Haario et al.'s adaptive-Metropolis random walk: the proposal
    covariance is the chain's running covariance scaled by :math:`2.38^2/D`,
    plus ``eps`` on the diagonal. Adaptation starts once ``2 D`` transitions
    have been absorbed (the isotropic ``initial_scale`` walk before) and,
    with ``adapt_until``, freezes after that many."""

    def __init__(self, initial_scale: float = 1e-2, adapt_until: int | None = None, eps: float = 1e-6):
        self._scale0 = float(initial_scale)
        self._adapt_until = None if adapt_until is None else int(adapt_until)
        self._eps = float(eps)

    def build(self, context, state, filter_, y, generator=None):
        loc = context.stack_parameters(constrained=False)  # (K, D)
        d = loc.shape[-1]
        eye = torch.eye(d, dtype=loc.dtype, device=loc.device)
        return _AdaptiveRWKernel(loc, (self._scale0 * eye).expand(loc.shape + (d,)), loc,
                                 torch.zeros(loc.shape + (d,), dtype=loc.dtype, device=loc.device), 0.0)

    def exchange(self, latest, candidate, mask):
        x = torch.where(mask[..., None], candidate.loc, latest.loc)
        d = x.shape[-1]
        n1 = latest.count + 1.0
        delta = x - latest.mean
        mean = latest.mean + delta / n1
        m2 = latest.m2 + torch.einsum("...i,...j->...ij", delta, x - mean)
        adapting = n1 >= 2.0 * d and (self._adapt_until is None or n1 <= self._adapt_until)
        tril = latest.scale_tril
        if adapting:
            eye = torch.eye(d, dtype=x.dtype, device=x.device)
            tril = robust_cholesky(2.38**2 / d * m2 / max(n1 - 1.0, 1.0) + self._eps * eye)
        return _AdaptiveRWKernel(x, tril, mean, m2, n1)


class GradientBasedProposal(RandomWalk):
    r"""MALA-style proposal :math:`\theta^* \sim N(\theta + \epsilon \nabla
    S(\theta), \sigma)`, :math:`\epsilon = \sigma^2 / 2`, with :math:`S` the
    joint log-density of FFBS-smoothed trajectories of the filter's recorded
    history plus the log-prior, per lane (the reference's ``gradient.py``).
    The filter must record its states.

    ``use_second_order=True`` preconditions the drift and the noise by the
    inverse of each lane's damped negative Hessian :math:`H` of :math:`S`:
    :math:`\theta^* \sim N(\theta + \epsilon H^{-1} \nabla S, \sigma^2
    H^{-1})` (the JAX package's simplified-manifold variant). The PMMH
    transition builds the kernel again on the candidate's side, which gives
    the reverse density of the Metropolis-Hastings ratio."""

    def __init__(self, scale: float = 1e-2, use_second_order: bool = False):
        super().__init__(scale=scale)
        self._eps = scale**2.0 / 2.0
        self._use_second_order = bool(use_second_order)

    def build(self, context, state, filter_, y, generator=None):
        """The kernel at ``context``'s lanes. The FFBS pass over the recorded
        history draws from ``generator`` (seeded 0 when not given) and runs
        outside the graph; the gradient (and the Hessian's rows, by
        ``torch.func.vjp``) is ``torch.func.grad`` of :math:`S` through a
        rebuild of the model from the unstacked parameters."""
        result = state.filter_state
        if getattr(result, "states", None) is None:
            raise ValueError("GradientBasedProposal requires record_states=True on the filter")
        if generator is None:
            generator = torch.Generator(device=filter_.device).manual_seed(0)
        with torch.no_grad():
            smoothed = filter_.smooth(generator, result, method="ffbs")
        times = result.states.time_indexes

        def joint(vec):
            ctx2 = context.unstack_parameters(vec, constrained=False)
            model = filter_.initialize_model(ctx2).model
            # observations at every recorded step, as the JAX package's build takes them
            per_lane = smoothed_joint_log_likelihood(model, times, smoothed, y, oes=1)
            return torch.sum(per_lane + ctx2.eval_priors(constrained=False))

        vec = context.stack_parameters(constrained=False).detach()
        grad_fn = torch.func.grad(joint)
        grad = grad_fn(vec)
        if not self._use_second_order:
            loc = vec + self._eps * grad
            return Normal(loc, torch.full_like(loc, self._scale)).to_event(1)

        # S sums independent lanes, so its Hessian is block-diagonal by lane:
        # the pull-back of e_j on every lane is row j of every block
        blocks = _per_particle_hessian(grad_fn, vec, 1)  # (K, D, D)
        neg_h = -0.5 * (blocks + blocks.transpose(-1, -2))
        # torch's eigh raises on a non-finite matrix where JAX's gives NaN: such
        # a lane's matrix goes in as the identity and its kernel comes out NaN
        eye = torch.eye(neg_h.shape[-1], dtype=neg_h.dtype, device=neg_h.device)
        bad = ~torch.isfinite(neg_h).all(dim=(-2, -1))[..., None, None]
        evals, evecs = torch.linalg.eigh(torch.where(bad, eye, neg_h))
        # damped to positive definite as the mode finder does: eigenvalues
        # clipped from below at 1e-3 of the spectral radius
        floor = 1e-3 * torch.clamp(torch.amax(torch.abs(evals), dim=-1, keepdim=True), min=1e-6)
        evals = torch.maximum(evals, floor)
        h_inv = torch.einsum("...ij,...j,...kj->...ik", evecs, 1.0 / evals, evecs)
        h_inv = torch.where(bad, math.nan, h_inv)

        loc = vec + self._eps * torch.einsum("...ij,...j->...i", h_inv, grad)
        return MultivariateNormal(loc, scale_tril=robust_cholesky(self._scale**2.0 * h_inv))

    def exchange(self, latest, candidate, mask):
        if not self._use_second_order:
            return super().exchange(latest, candidate, mask)
        loc = torch.where(mask[..., None], candidate.loc, latest.loc)
        tril = torch.where(mask[..., None, None], candidate.scale_tril, latest.scale_tril)
        return MultivariateNormal(loc, scale_tril=tril)
