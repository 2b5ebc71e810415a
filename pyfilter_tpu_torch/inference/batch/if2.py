"""IF2: iterated filtering for maximum likelihood (Ionides, Nguyen, Atchadé,
Stoev & King 2015; pomp's ``mif2``).

Counterpart of ``pyfilter_tpu/inference/batch/if2.py``. A swarm of K
parameter particles rides the filter's lane axis: at every observation each
lane's parameters take a random-walk step on the unconstrained space, the
model is rebuilt from them, the filter moves (the lane kernel resamples the
state particles), and the lanes are resampled by their one-step likelihood.
Each pass cools the perturbation scale geometrically.

The JAX package runs a pass as one ``lax.scan``; here it is a Python loop
over the observations with no host sync: the observations are copied to the
device once a pass (the filter's single-step ``filter`` would copy each row
from pageable host memory, a stream sync a step), and the pass's
log-likelihood accumulates on the device and is read, with the swarm mean,
once a pass. The lane-level resample is plain PyTorch, as it is plain
``jnp`` there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...resampling import systematic
from ...utils import normalize
from .. import prior as prior_ops
from ..logging import TQDMWrapper
from ..sequential.base import SequentialParticleAlgorithm


def _standard_normal(generator, like: torch.Tensor) -> torch.Tensor:
    """Standard normals shaped like ``like`` (the parameter perturbations)."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


class IF2Result:
    """``theta_trace[name]``: each pass's swarm mean ``(M, *event)``
    (constrained); ``swarm[name]``: the final swarm ``(K, *event)``;
    ``mle[name]``: the final swarm's mean; ``log_likelihoods``: ``(M,)`` each
    pass's log-likelihood estimate at the perturbed models (a convergence
    trace, not the likelihood at the MLE). All numpy."""

    def __init__(self, theta_trace, swarm, mle, log_likelihoods):
        self.theta_trace = theta_trace
        self.swarm = swarm
        self.mle = mle
        self.log_likelihoods = log_likelihoods


class IF2(SequentialParticleAlgorithm):
    """Iterated filtering over a model-builder filter.

    ``sigma``: the first pass's random-walk scale on the unconstrained space
    (a number or one per flat parameter); each of the ``num_iterations``
    passes multiplies it by ``cooling``; ``sigma_init`` scales the extra
    perturbation at the start of every pass."""

    def __init__(
        self,
        filter_,
        num_particles: int,
        num_iterations: int = 30,
        sigma: float = 0.1,
        cooling: float = 0.9,
        sigma_init: float = 2.0,
        resampler=systematic,
        context=None,
        generator=None,
        device=None,
    ):
        super().__init__(filter_, num_particles, context=context, generator=generator, record_moments=False,
                         device=device)
        self.num_iterations = int(num_iterations)
        self.sigma = sigma
        self.cooling = float(cooling)
        self.sigma_init = float(sigma_init)
        self._resampler = resampler

    def _perturb(self, theta, sd):
        return theta + sd * _standard_normal(self.generator, theta)

    def _move(self, theta, corr, y_t, nan_row, sd, first_step: bool):
        """Perturb, rebuild the model, move the filter on the device row
        ``y_t`` (its NaN handling ``nan_row`` decided on the host), resample
        the lanes by their one-step likelihood. Returns the new swarm and
        cloud and the step's ``log mean_k exp(increment_k)``."""
        theta = self._perturb(theta, sd)
        f_t = self._filter.initialize_model(self.context.unstack_parameters(theta, constrained=False))
        new = f_t._filter(self.generator, y_t, nan_row, corr, first_step)
        inc = new.log_likelihood  # (K,)
        indices = self._resampler(self.generator, normalize(inc), normalized=True)
        idx = indices.long()
        ll_t = torch.logsumexp(inc, dim=0) - math.log(inc.shape[0])
        return theta.index_select(0, idx), new.resample(idx), ll_t

    def _one_pass(self, theta, y, sd):
        """One pass over the host observations ``y``."""
        y_dev = torch.as_tensor(y, device=theta.device)
        nan_rows = [self._filter._nan_row(m) for m in np.isnan(y.reshape(len(y), -1))]
        theta = self._perturb(theta, self.sigma_init * sd)  # the start-of-pass overdispersion
        f0 = self._filter.initialize_model(self.context.unstack_parameters(theta, constrained=False))
        corr = f0.initialize(self.generator)
        theta, corr, ll = self._move(theta, corr, y_dev[0], nan_rows[0], sd, True)
        for t in range(1, len(y)):
            theta, corr, ll_t = self._move(theta, corr, y_dev[t], nan_rows[t], sd, False)
            ll = ll + ll_t
        return theta, ll

    def fit(self, y, logging=None) -> IF2Result:
        """``num_iterations`` passes over the observations ``y`` (time axis
        leading; kept on the host)."""
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, dtype=np.float32)
        self.initialize()  # registers the priors; the swarm ~ prior over (K,)
        ctx = self.context

        theta = ctx.stack_parameters(constrained=False)  # (K, D)
        sd0 = torch.as_tensor(self.sigma, dtype=theta.dtype, device=theta.device).expand(theta.shape[1:])
        trace, lls = [], []
        logger = logging if logging is not None else TQDMWrapper()
        with logger.initialize(self, self.num_iterations):
            for m in range(self.num_iterations):
                theta, ll = self._one_pass(theta, y, sd0 * (self.cooling**m))
                row = torch.cat([theta.mean(dim=0), ll.reshape(1)]).cpu().numpy()  # the pass's one host read
                trace.append(row[:-1])
                lls.append(float(row[-1]))
                logger.do_log(m + 1, None)

        trace = torch.from_numpy(np.stack(trace)).to(theta.device)  # (M, D) unconstrained swarm means
        theta_trace, swarm, mle = {}, {}, {}
        index = 0
        for name in ctx.parameters:
            shape = ctx.get_shape(name, constrained=False)
            numel = math.prod(shape)
            prior = ctx.get_prior(name)
            tr = trace[:, index : index + numel].reshape((trace.shape[0],) + shape)
            sw = theta[:, index : index + numel].reshape((theta.shape[0],) + shape)
            theta_trace[name] = prior_ops.get_constrained(prior, tr).cpu().numpy()
            swarm[name] = prior_ops.get_constrained(prior, sw).cpu().numpy()
            mle[name] = swarm[name].mean(axis=0)
            index += numel

        ctx.absorb(ctx.unstack_parameters(theta, constrained=False))
        return IF2Result(theta_trace, swarm, mle, np.asarray(lls))
