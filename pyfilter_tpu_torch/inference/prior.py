"""Prior helpers: constrained <-> unconstrained transforms of a distribution.

Counterpart of ``pyfilter_tpu/inference/prior.py``: free functions over any
:class:`~pyfilter_tpu_torch.distributions.Distribution`.
"""

from __future__ import annotations

import math

import torch

from ..distributions import Distribution, TransformedDistribution, biject_to
from ..distributions.bijectors import Bijector


def bijection(prior: Distribution) -> Bijector:
    """Bijector from the unconstrained reals onto the prior's support."""
    return biject_to(prior.support)


def unconstrained_prior(prior: Distribution) -> Distribution:
    """The prior pushed to the unconstrained space."""
    return TransformedDistribution(prior, bijection(prior).inv)


def get_constrained(prior: Distribution, unconstrained_value: torch.Tensor) -> torch.Tensor:
    return bijection(prior).forward(unconstrained_value)


def get_unconstrained(prior: Distribution, constrained_value: torch.Tensor) -> torch.Tensor:
    return bijection(prior).inverse(constrained_value)


def eval_prior(prior: Distribution, constrained_value: torch.Tensor, constrained: bool = True) -> torch.Tensor:
    """Prior log-density of a constrained value, on the constrained space or
    (with the Jacobian of the bijection) on the unconstrained one."""
    if constrained:
        return prior.log_prob(constrained_value)
    return unconstrained_prior(prior).log_prob(get_unconstrained(prior, constrained_value))


def unconstrained_event_shape(prior: Distribution) -> tuple:
    return tuple(unconstrained_prior(prior).event_shape)


def get_numel(prior: Distribution, constrained: bool = True) -> int:
    """Number of elements of one parameter draw."""
    return math.prod(prior.event_shape if constrained else unconstrained_event_shape(prior))


def inverse_sample(prior: Distribution, probs: torch.Tensor, constrained: bool = True) -> torch.Tensor:
    """Inverse-CDF sample from uniform probabilities, on the constrained space
    or the unconstrained one (the quasi-random start)."""
    if constrained:
        return prior.icdf(probs)
    return unconstrained_prior(prior).icdf(probs)
