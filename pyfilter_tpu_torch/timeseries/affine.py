"""Affine pushforward of a distribution: the law of ``loc + scale * eps``.

Counterpart of ``pyfilter_tpu/timeseries/affine.py``: a Normal base (plain
or made ``Independent``) stays a closed-form Normal, a multivariate normal
base stays one; anything else becomes a transformed distribution.
"""

from __future__ import annotations

import torch

from ..distributions import Affine, Distribution, Independent, MultivariateNormal, Normal, TransformedDistribution


def affine_transform(dist: Distribution, loc, scale) -> Distribution:
    """Distribution of ``loc + scale * X`` for ``X ~ dist``: ``scale`` is a
    scalar or an elementwise scale, or a matrix for a multivariate normal."""
    if isinstance(dist, Normal):
        return Normal(loc + scale * dist.loc, abs(scale) * dist.scale)

    if isinstance(dist, Independent) and isinstance(dist.base_dist, Normal):
        base = dist.base_dist
        return Independent(Normal(loc + scale * base.loc, abs(scale) * base.scale), dist.reinterpreted_batch_ndims)

    if isinstance(dist, MultivariateNormal):
        scale = torch.as_tensor(scale, dtype=dist.loc.dtype, device=dist.loc.device)
        if scale.dim() >= 2 and scale.shape[-1] == scale.shape[-2] == dist.event_shape[0]:
            new_loc = loc + torch.einsum("...ij,...j->...i", scale, dist.loc)
            new_tril = scale @ dist.scale_tril
        else:
            new_loc = loc + scale * dist.loc
            new_tril = scale[..., None] * dist.scale_tril if scale.dim() >= 1 else scale * dist.scale_tril
        return MultivariateNormal(new_loc, new_tril)

    return TransformedDistribution(dist, Affine(loc, scale))
