"""The PMMH transition (counterpart of ``pyfilter_tpu/inference/batch/mcmc/utils.py``,
its eager body).

``run_pmmh`` draws a candidate parameter vector per lane, rebuilds the model,
re-filters the data under it and accepts or rejects per lane;
:func:`pmmh_accept` is its arithmetic once the draws and the re-filter are
in hand.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ....utils import draws_of


class PMMHStep(NamedTuple):
    accepted: torch.Tensor
    context: object
    filter_state: object
    proposal_kernel: object


def _uniform(generator, like: torch.Tensor) -> torch.Tensor:
    """The acceptance uniforms, ``like``'s shape (lanes leading), dtype and
    device."""
    with draws_of(lanes=like.shape):
        return torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def pmmh_accept(context, state, proposal, proposal_kernel, rvs, proposal_context, proposal_filter, new_res, log_u,
                y, generator, mutate_kernel: bool = False) -> PMMHStep:
    """Accept lane ``k`` when ``log_u[k] < diff_proposal + diff_prior +
    diff_loglik``, all on the unconstrained space; accepting lanes take the
    candidate's filter state and parameters. With ``mutate_kernel`` the
    returned kernel is ``proposal.exchange(kernel, candidate's kernel,
    accepted)``, else the kernel given.

    ``rvs``: the candidate ``(K, D)``; ``proposal_context``: the context
    holding it; ``proposal_filter``: the filter built on it; ``new_res``: its
    re-filter of the host observations ``y``; ``log_u``: ``(K,)``. The
    candidate's kernel, whose density at the current parameters is the
    reverse move's, is built from all of these, its draws (the gradient
    proposal's smoothing) from ``generator``."""
    diff_logl = new_res.log_likelihood - state.filter_state.log_likelihood
    diff_prior = proposal_context.eval_priors(constrained=False) - context.eval_priors(constrained=False)
    new_prop_kernel = proposal.build(proposal_context, state.replicate(new_res), proposal_filter, y, generator)
    params = context.stack_parameters(constrained=False)
    diff_prop = new_prop_kernel.log_prob(params) - proposal_kernel.log_prob(rvs)

    accepted = log_u < diff_prop + diff_prior + diff_logl
    kernel = proposal.exchange(proposal_kernel, new_prop_kernel, accepted) if mutate_kernel else proposal_kernel
    return PMMHStep(
        accepted,
        context.exchange(proposal_context, accepted),
        state.filter_state.exchange(new_res, accepted),
        kernel,
    )


def run_pmmh(generator, context, state, proposal, proposal_kernel, filter_, y: np.ndarray, size=(),
             mutate_kernel: bool = False) -> PMMHStep:
    """One PMMH update over all lanes: draw the candidate, re-filter ``y``
    (host observations) under it, draw the log-uniforms, then
    :func:`pmmh_accept`, whose build of the candidate's kernel draws last.
    Every draw comes from ``generator``, in that order. ``size``, for a
    kernel without lanes, is every lane's: a lane-sharded ``state`` keeps its
    own lanes of the candidate, computed as the one-process run computes it
    (a product over the lanes can round by their count)."""
    with draws_of(lanes=tuple(size) or tuple(proposal_kernel.batch_shape)):
        rvs = proposal_kernel.sample(generator, tuple(size))
    if size:
        rvs = state.lanes.local(rvs)
    proposal_context = context.unstack_parameters(rvs, constrained=False)
    proposal_filter = filter_.initialize_model(proposal_context)
    new_res = proposal_filter.batch_filter(generator, y)
    log_u = torch.log(_uniform(generator, new_res.log_likelihood))
    return pmmh_accept(context, state, proposal, proposal_kernel, rvs, proposal_context, proposal_filter, new_res,
                       log_u, y, generator, mutate_kernel=mutate_kernel)
