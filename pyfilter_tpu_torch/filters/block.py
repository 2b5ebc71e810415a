"""Block particle filter — dimension-robust filtering via localized resampling.

Counterpart of ``pyfilter_tpu/filters/block.py`` (Rebeschini & van Handel
2015): partition a ``d``-dimensional state into ``B`` blocks and resample
each block independently, with weights built from that block's own
observation likelihood. The plain particle filter collapses exponentially in
``d``; the block filter's error stays uniform in ``d``, at the price of a bias
from severing cross-block dependence at the block boundaries.

Requirements on the model, as in the JAX package: a vector state (event rank
1), whose transition may couple blocks arbitrarily (propagation stays joint
and exact); an observation density that factorizes per component (an
``Independent`` over a scalar-batch base, ``d_y == d``). NaN components are
marginalized exactly; a block with no observed component skips its resample.

Blocks are a trailing axis ``(N, *lanes, B, k)``: the per-block weights are
one reduction, and the ``B`` resamples of every lane are ONE lane-batched
resample-and-gather, ``ops.systematic_expand_lanes`` over ``L = lanes x B``
lanes of ``k`` value planes — on the card the hand-written lane kernel
(``ops/csrc/expand_lanes.cu``), one launch a step, on the CPU its plain
version. One uniform per (lane, block) comes from
:meth:`BlockParticleFilter.resample_uniform` (the replay seam). The unobserved
blocks keep their values by a ``where`` on the device, which equals the JAX
package's identity indices. Any other resampler (by name from
``resampling`` or a callable) takes its indices and a gather, with no launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resampling
from ..distributions import Independent
from ..ops import systematic_counts
from ..ops.expand import systematic_expand_lanes
from ..timeseries import TimeseriesState
from ..utils import normalize, resolve_device, same_device
from .result import FilterResult


class BlockPFState(NamedTuple):
    """The uniformly weighted cloud after the block resample: ``values``
    ``(N, *lanes, d)``, the host's ``time_index``, the running
    ``log_likelihood`` ``(*lanes)`` and ``block_ess`` ``(*lanes, B)``, each
    block's relative ESS at its last correction (the degeneracy the
    blocking keeps bounded away from ``1/N`` as ``d`` grows)."""

    values: torch.Tensor
    time_index: float
    log_likelihood: torch.Tensor
    block_ess: torch.Tensor

    def get_mean(self) -> torch.Tensor:
        return self.values.mean(dim=0)

    def get_variance(self) -> torch.Tensor:
        return self.values.var(dim=0, correction=0)


class BlockParticleFilter:
    """Block particle filter over a :class:`StateSpaceModel`, on ``device``
    (the card unless ``device="cpu"``).

    ``block_size`` partitions the ``d`` components into contiguous equal
    blocks (``d % block_size == 0``); ``blocks`` instead gives an explicit
    partition as equal-length index tuples (the state is permuted into that
    order once a step and back). ``block_size=d`` is the bootstrap filter
    resampling every step; ``block_size=1`` the most local. The default
    resampler is the lane kernel's systematic resample (module docstring);
    ``resampling_method`` takes any of ``resampling``'s names or a callable
    ``(generator, probs, normalized=True) -> indices``."""

    def __init__(self, model, particles: int, block_size: int | None = None, blocks=None,
                 resampling_method=systematic_counts, batch_shape=(), device=None):
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"the model lies on {model.device}, the filter on {self.device}")
        self.model = model
        self.n_particles = int(particles)
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.resampler = (getattr(resampling, resampling_method) if isinstance(resampling_method, str)
                          else resampling_method)

        if int(model.hidden.event_ndim) != 1:
            raise ValueError("BlockParticleFilter needs a vector state (event rank 1)")
        d = int(model.hidden.initial_distribution().event_shape[0])
        self.dim = d
        if (block_size is None) == (blocks is None):
            raise ValueError("pass exactly one of block_size / blocks")
        self._perm = self._inv_perm = None
        if blocks is not None:
            blocks = tuple(tuple(int(i) for i in b) for b in blocks)
            sizes = {len(b) for b in blocks}
            if len(sizes) != 1:
                raise ValueError("blocks must have equal sizes (static shapes)")
            flat = [i for b in blocks for i in b]
            if sorted(flat) != list(range(d)):
                raise ValueError("blocks must partition range(d)")
            self.block_size = sizes.pop()
            self.n_blocks = len(blocks)
            self._perm = torch.tensor(flat, dtype=torch.long, device=self.device)
            self._inv_perm = torch.argsort(self._perm)
        else:
            if d % int(block_size) != 0:
                raise ValueError(f"block_size {block_size} must divide d={d}")
            self.block_size = int(block_size)
            self.n_blocks = d // self.block_size

    @property
    def particles(self) -> tuple:
        return (self.n_particles, *self.batch_shape)

    def resample_uniform(self, generator) -> torch.Tensor:
        """The lane kernel's uniforms, one per (lane, block): ``(*lanes, B)``
        drawn from ``generator``."""
        return torch.rand(self.batch_shape + (self.n_blocks,), generator=generator, device=self.device)

    def _component_log_probs(self, x: TimeseriesState, y_t: torch.Tensor) -> torch.Tensor:
        """Per-component observation log-probs ``(N, *lanes, d)``, NaN
        components contributing exactly 0."""
        density = self.model.build_density(x)
        if not (isinstance(density, Independent) and density.reinterpreted_batch_ndims == 1):
            raise ValueError("BlockParticleFilter needs a componentwise-factorized observation density (Independent "
                             "with one reinterpreted batch dim, e.g. Normal(loc, s).to_event(1))")
        nan = torch.isnan(y_t)
        lp = density.base_dist.log_prob(torch.where(nan, 0.0, y_t))
        return torch.where(nan, 0.0, lp)

    def initialize(self, generator) -> BlockPFState:
        x0 = self.model.hidden.initial_sample(generator, self.particles)
        val = x0.value.to(torch.float32)
        zeros = torch.zeros(self.batch_shape, dtype=val.dtype, device=self.device)
        ess = torch.ones(self.batch_shape + (self.n_blocks,), dtype=val.dtype, device=self.device)
        return BlockPFState(val, x0.time_index, zeros, ess)

    def filter(self, generator, y_t: torch.Tensor, state: BlockPFState, n_transitions: int | None = None
               ) -> BlockPFState:
        """One predict and blockwise correct-resample move on a device
        observation ``y_t`` ``(d,)``: the propagation's draws, then the
        resample's uniforms, from ``generator``."""
        if n_transitions is None:
            n_transitions = int(self.model.observe_every_step)
        x = TimeseriesState(state.time_index, state.values, 1)
        x = self.model.hidden.propagate_substeps(generator, x, n_transitions)
        vals = x.value.to(torch.float32)  # (N, *lanes, d)
        lp = self._component_log_probs(x.copy(values=vals), y_t)

        obs_mask = ~torch.isnan(y_t)
        if self._perm is not None:
            lp, vals, obs_mask = (v.index_select(-1, self._perm) for v in (lp, vals, obs_mask))
        nb, k = self.n_blocks, self.block_size
        lead = lp.shape[:-1]  # (N, *lanes)
        lw = torch.sum(lp.reshape(lead + (nb, k)), dim=-1)  # (N, *lanes, B)

        # block log-likelihood increments; a block with no observed component
        # has lw == 0 identically and increment 0
        block_observed = torch.any(obs_mask.reshape(obs_mask.shape[:-1] + (nb, k)), dim=-1)
        inc = torch.logsumexp(lw, dim=0) - math.log(self.n_particles)
        inc = torch.where(block_observed, inc, 0.0)
        ll = state.log_likelihood + torch.sum(inc, dim=-1)

        probs = normalize(lw, dim=0)
        ess = 1.0 / (torch.sum(torch.square(probs), dim=0) * self.n_particles)
        blocked = vals.reshape(lead + (nb, k))
        if self.resampler is systematic_counts:
            # one lane-batched resample and gather of every (lane, block)
            resampled, _ = systematic_expand_lanes(None, probs, blocked, normalized=True,
                                                   u=self.resample_uniform(generator))
        else:
            idx = self.resampler(generator, probs, normalized=True)  # (N, *lanes, B)
            resampled = torch.gather(blocked, 0, idx.long().unsqueeze(-1).expand_as(blocked))
        new_vals = torch.where(block_observed.unsqueeze(-1), resampled, blocked).reshape(lead + (nb * k,))
        if self._inv_perm is not None:
            new_vals = new_vals.index_select(-1, self._inv_perm)
        return BlockPFState(new_vals, x.time_index, ll, ess)

    def batch_filter(self, generator, y) -> FilterResult:
        """Filter the whole sequence ``y`` ``(T, d)`` (host or device; copied
        to the device once): the initial cloud's draws, then each step's.
        ``aux`` carries the per-step per-block relative ESS ``(T, *lanes, B)``."""
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, dtype=np.float32)
        if y.ndim == 1:
            raise ValueError("block filtering needs vector observations (T, d)")
        y_dev = torch.as_tensor(y, device=self.device)
        state = self.filter(generator, y_dev[0], self.initialize(generator), n_transitions=1)
        lls, means, variances, ess = [state.log_likelihood], [state.get_mean()], [state.get_variance()], [state.block_ess]
        for t in range(1, y_dev.shape[0]):
            new = self.filter(generator, y_dev[t], state)
            lls.append(new.log_likelihood - state.log_likelihood)
            means.append(new.get_mean())
            variances.append(new.get_variance())
            ess.append(new.block_ess)
            state = new
        return FilterResult(state.log_likelihood, torch.stack(lls), torch.stack(means), torch.stack(variances), state,
                            None, torch.stack(ess))
