"""Affine pushforward of a distribution: the law of ``loc + scale * eps``.

Counterpart of ``pyfilter_tpu/timeseries/affine.py``: a Normal base stays a
closed-form Normal; anything else becomes a transformed distribution.
"""

from __future__ import annotations

import torch

from ..distributions import Affine, Distribution, Normal, TransformedDistribution


def affine_transform(dist: Distribution, loc, scale) -> Distribution:
    """Distribution of ``loc + scale * X`` for ``X ~ dist`` (elementwise scale)."""
    if isinstance(dist, Normal):
        return Normal(loc + scale * dist.loc, torch.abs(scale) * dist.scale)
    return TransformedDistribution(dist, Affine(loc, scale))
