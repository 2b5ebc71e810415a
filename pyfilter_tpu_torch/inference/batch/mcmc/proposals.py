"""MCMC proposal builders for PMMH updates: ``RandomWalk``, ``SymmetricMH``
(quasi-random on a quasi context) and ``AdaptiveRandomWalk``.

Counterpart of ``pyfilter_tpu/inference/batch/mcmc/proposals.py``. Kernels
live on the unconstrained parameter space. ``build`` fits a kernel to the
context (and, for ``SymmetricMH``, the state's lane weights); ``exchange``
gives the kernel of the next transition, its accepted lanes taking the
candidate's. The JAX package's ``jit_compatible`` and ``uses_quasi_engine``
flags and its structural ``__eq__``/``__hash__`` exist only for XLA's static
arguments and are not ported. ``GradientBasedProposal`` is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ....distributions import Normal, robust_cholesky
from ...utils import construct_mvn


class BaseProposal:
    """Builds candidate kernels :math:`q(\\theta^* | \\theta)`."""

    def build(self, context, state, filter_, y):
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

    def build(self, context, state, filter_, y):
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

    def build(self, context, state, filter_, y):
        return construct_mvn(context.stack_parameters(constrained=False), state.normalized_weights(), scale=1.1,
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

    def build(self, context, state, filter_, y):
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
