"""One rank's shard of a particle cloud or of a lane batch, and the draws
that keep the shards of one run in step.

Every rank runs the same program on the same arguments with the same seed.
:class:`ShardedDraws` makes each random tensor the one-process run would
draw: a draw that carries the sharded particle or lane axis is made at the
global size and the rank keeps its own rows and lanes; any other draw is the
same on every rank. So the generators of all ranks stay in step, the
resample uniforms and the rejuvenation's draws are shared, and each shard's
noise is its slice of the one-process noise. Which draws carry a sharded
axis, and where, is declared by the code that makes them
(``utils.draws_of``), never guessed from a size.

:class:`ParticleShard` is what a particle filter consults for the weight
operations of its step (``parallel.collective``) and for its resample: the
probabilities and values are all-gathered, the whole cloud is resampled on
every rank alike (by the fused kernel, K1 on one lane and K2 on a lane
batch, where it applies) and the rank keeps its own output slots, as XLA
runs the unpartitioned Pallas call under a particle sharding.
:class:`LaneShard` gathers and slices the lane axis for the cross-lane
operations of SMC², NESS and PMMH.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from ..utils import _DRAW_MODES
from . import _comm, collective


class ParticleShard:
    """This rank's shard of a particle axis on ``group``. ``n_local`` is the
    particle count a rank of the filter that last ran on it (a filter sets it
    when it starts or steps: the copies of one filter share their shard,
    and SMC² doubles the count of a copy)."""

    #: resample fires of every particle shard since the count was set to 0 (a
    #: class-level host counter, as ``APF.corrections``: the sharded filter
    #: and its shard are made inside the entry points)
    fires = 0

    def __init__(self, group, n_local: int):
        self.group = group
        self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.n_local = int(n_local)

    @property
    def lo(self) -> int:
        return self.rank * self.n_local

    @property
    def n_total(self) -> int:
        return self.n_local * self.size

    def normalize(self, log_weights: torch.Tensor) -> torch.Tensor:
        return collective.psum_normalize(log_weights, self.group)

    def ess(self, probs: torch.Tensor) -> torch.Tensor:
        return collective.distributed_ess(probs, self.group, normalized=True)

    def log_likelihood(self, inc_weights: torch.Tensor, probs: torch.Tensor | None = None) -> torch.Tensor:
        return collective.distributed_log_likelihood(inc_weights, probs, self.group, normalized=True)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return _comm.all_reduce(t, "sum", self.group)

    def resample(self, probs: torch.Tensor, values, resample):
        """The resample of the whole cloud from this rank's probabilities
        ``(n_local, *batch)`` and values (a tensor or a tuple): everything
        all-gathered, ``resample(probs, values)`` of all N particles (a
        one-process resample, the same on every rank: its draws are shared),
        this rank's output slots kept. Returns ``(values, global indices)``."""
        full = _comm.all_gather(probs.contiguous(), self.group)
        vals = tuple(_comm.all_gather(v, self.group) for v in (values if isinstance(values, tuple) else (values,)))
        out, idx = resample(full, vals if isinstance(values, tuple) else vals[0])
        n = probs.shape[0]
        own = slice(self.rank * n, (self.rank + 1) * n)
        out = tuple(v[own] for v in out) if isinstance(values, tuple) else out[own]
        ParticleShard.fires += 1
        return out, idx[own]


class LaneShard:
    """This rank's lanes ``[lo, lo + k_local)`` of ``k`` lanes split evenly
    over ``group``."""

    def __init__(self, group, k: int):
        self.group = group
        self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        if k % self.size:
            raise ValueError(f"{k} lanes do not split evenly over {self.size} ranks")
        self.k = int(k)
        self.k_local = self.k // self.size
        self.lo = self.rank * self.k_local

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's lanes of ``t`` (lane axis ``dim``), all ``k``."""
        return _comm.all_gather(t, self.group, dim)

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's lanes of a tensor that holds all ``k``."""
        return t.narrow(dim, self.lo, self.k_local)

    def take(self, t: torch.Tensor, indices: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``t``'s lanes gathered, then those at ``indices``: the global ids of
        this rank's new lanes (``local`` of a lane resample's indices)."""
        return self.gather(t, dim).index_select(dim, indices.long())


class WholeLanes:
    """The lanes of a one-process run: :class:`LaneShard`'s operations on a
    rank that holds them all."""

    size, rank, lo = 1, 0, 0

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    def take(self, t: torch.Tensor, indices: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t.index_select(dim, indices.long())


#: the lanes of every one-process run
WHOLE_LANES = WholeLanes()


def lane_shard(mesh, lane_axis: str, k: int):
    """This rank's share of ``k`` lanes on the mesh axis ``lane_axis``
    (:data:`WHOLE_LANES` without a mesh or without that axis)."""
    if mesh is None or lane_axis not in (mesh.mesh_dim_names or ()):
        return WHOLE_LANES
    return LaneShard(mesh.get_group(lane_axis), k)


#: draws whose shape is their size argument, and the tensor methods that fill
#: their tensor with draws
_SIZED = {torch.randn, torch.rand, torch.randint}
_FILLS = {torch.Tensor.exponential_, torch.Tensor.cauchy_, torch.Tensor.uniform_, torch.Tensor.normal_,
          torch.Tensor.log_normal_, torch.Tensor.geometric_, torch.Tensor.random_, torch.Tensor.bernoulli_}
#: draws whose law is a tensor of parameters, one per output element
_PARAMETRIZED = {torch.normal, torch.bernoulli, torch.poisson, torch._standard_gamma, torch.binomial,
                 torch.multinomial, torch.Tensor.multinomial, torch._sample_dirichlet}


class ShardedDraws(TorchFunctionMode):
    """While active, every random draw is the one-process run's (module
    docstring). ``particles`` (a :class:`ParticleShard`) and ``lanes`` (a
    :class:`LaneShard`) are the sharded axes, read at each draw; a shard of
    one rank is no sharding. The innermost ``utils.draws_of`` decides a draw's
    sharded axes. A draw that matches none of its layouts, or is made outside
    any, and has an axis of a sharded local size raises: it would be sliced or
    repeated wrongly, whichever was meant. So does a draw whose law is a
    tensor of parameters along a sharded axis: the other ranks' parameters
    are not here."""

    def __init__(self, particles: ParticleShard | None = None, lanes: LaneShard | None = None):
        super().__init__()
        self.particles = particles if particles is not None and particles.size > 1 else None
        self.lanes = lanes if lanes is not None and lanes.size > 1 else None
        self._layouts = []

    def __enter__(self):
        _DRAW_MODES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _DRAW_MODES.pop()
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def declared(self, layouts):
        """Inside, the draws' layouts are ``layouts``: ``(kind, shape, lead)``
        each, ``shape`` starting after ``lead`` leading axes (None:
        undeclared)."""
        self._layouts.append(layouts)
        try:
            yield
        finally:
            self._layouts.pop()

    def shifted(self, n_lead: int):
        layouts = self._layouts[-1] if self._layouts else None
        return self.declared(None if layouts is None else tuple((k, s, lead + n_lead) for k, s, lead in layouts))

    def _layout_dims(self, kind: str, layout: tuple, lead: int) -> dict:
        """``{dim: (local size, first index, global size)}`` of a declared
        layout's sharded axes."""
        dims, lane_dim = {}, 0
        if kind == "particles":
            lane_dim = 1
            if self.particles is not None and layout[0] == self.particles.n_local:
                dims[lead] = (self.particles.n_local, self.particles.lo, self.particles.n_total)
        if self.lanes is not None and len(layout) > lane_dim and layout[lane_dim] == self.lanes.k_local:
            dims[lead + lane_dim] = (self.lanes.k_local, self.lanes.lo, self.lanes.k)
        return dims

    def _sharded_dims(self, shape) -> dict:
        shape = tuple(shape)
        layouts = self._layouts[-1] if self._layouts else None
        if layouts is not None:
            for kind, layout, lead in layouts:
                if shape[lead:lead + len(layout)] == layout:
                    return self._layout_dims(kind, layout, lead)
            if not layouts:
                return {}
        sizes = [s.n_local for s in (self.particles,) if s is not None] + \
                [s.k_local for s in (self.lanes,) if s is not None]
        if any(d in sizes for d in shape):
            raise ValueError(f"a draw of shape {shape} has an axis of a sharded size {sizes} and no declared layout "
                             f"that it matches ({layouts}): make it inside utils.draws_of")
        return {}

    @staticmethod
    def _slice(t: torch.Tensor, dims: dict) -> torch.Tensor:
        for d, (local, lo, _) in dims.items():
            t = t.narrow(d, lo, local)
        return t.contiguous()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SIZED:
            kwargs = dict(kwargs)
            if "size" in kwargs:
                shape = tuple(kwargs.pop("size"))
            elif func is torch.randint:
                shape, args = tuple(args[-1]), args[:-1]
            elif len(args) == 1 and isinstance(args[0], (tuple, list, torch.Size)):
                shape, args = tuple(args[0]), ()
            else:
                shape, args = tuple(args), ()
            dims = self._sharded_dims(shape)
            full = [dims[d][2] if d in dims else s for d, s in enumerate(shape)]
            # the draw itself bypasses every mode below this one, so that a
            # run's inner scope (the waste-free chains' lanes) decides alone
            with torch._C.DisableTorchFunction():
                out = func(*args, full, **kwargs)
            return self._slice(out, dims) if dims else out
        if func in _FILLS:
            target = args[0]
            dims = self._sharded_dims(target.shape)
            full = [dims[d][2] if d in dims else s for d, s in enumerate(target.shape)]
            buf = torch.empty(full, dtype=target.dtype, device=target.device) if dims else target
            with torch._C.DisableTorchFunction():
                func(buf, *args[1:], **kwargs)
            return target.copy_(self._slice(buf, dims)) if dims else target
        if func in _PARAMETRIZED:
            law = next((a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)), None)
            if law is not None and self._sharded_dims(law.shape):
                raise NotImplementedError(f"{func.__name__} along a sharded axis cannot draw the one-process "
                                          "run's values: the other ranks' parameters are not here")
        return func(*args, **kwargs)
