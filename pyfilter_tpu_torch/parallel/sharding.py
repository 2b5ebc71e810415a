"""Particle-axis and lane-axis sharding over ``torch.distributed``.

Counterpart of ``pyfilter_tpu/parallel/sharding.py``. The JAX package
annotates a state's leaves with shardings and lets XLA insert the
collectives; here each rank is a process that holds one shard, and the
filters call the collectives themselves (``filters/particle/base.py``
``_shard``). JAX's single-controller ``Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions, and a
mesh axis is its process group (``mesh.get_group(name)``).

The contract of :func:`sharded_filter_step` and :func:`sharded_batch_filter`:
every rank calls them with the same full arguments and the same seed, and
each returns the per-lane results (log-likelihoods, filter means and
variances) whole, the same on every rank, and its own shard of the cloud.
Every random draw is the one-process run's (``_shards.ShardedDraws``): the
rank keeps its slice of each draw of the sharded axes, so the shards of one
run are the one-process run's clouds but for the rounding of the weight
sums, which are all-reduced in another order.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..filters._lane import model_leaves, rebuild
from ..filters.particle import APF, SISR
from ..filters.particle.proposals.approximate import GaussianLinear, GaussianLinearized, GaussianProposal
from ..filters.state import ParticleFilterCorrection
from ..ops import systematic_counts
from . import _comm
from ._shards import LaneShard, ParticleShard, ShardedDraws


def make_mesh(axis_sizes: Sequence[int] = None, axis_names: Sequence[str] = ("particles",),
              device_type: str | None = None) -> DeviceMesh:
    """A device mesh over every rank of the process group, one named
    dimension per axis (all ranks on one ``"particles"`` axis by default).

    Starts the process group from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``: NCCL on the card, gloo on the
    CPU) when none is running. ``device_type`` is ``"cuda"`` unless the caller
    asks for ``"cpu"``; on the card each rank's shards lie on
    ``cuda:{LOCAL_RANK % device_count}``, the one card when ranks share it.
    Every group of the mesh times out after ``_comm.TIMEOUT``."""
    device_type = "cuda" if device_type is None else device_type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' to run on the CPU")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://",
                                timeout=_comm.TIMEOUT)
    world = dist.get_world_size()
    sizes = (world,) if axis_sizes is None else tuple(int(s) for s in axis_sizes)
    if math.prod(sizes) != world:
        raise ValueError(f"mesh sizes {sizes} != {world} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count())
    mesh = init_device_mesh(device_type, sizes, mesh_dim_names=tuple(axis_names))
    for name in axis_names:
        dist.distributed_c10d._set_pg_timeout(_comm.TIMEOUT, mesh.get_group(name))
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards lie on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh: DeviceMesh, name: Optional[str]):
    """``(size, rank)`` of the mesh axis ``name``, or None without one."""
    if name is None or name not in (mesh.mesh_dim_names or ()):
        return None
    group = mesh.get_group(name)
    return dist.get_world_size(group), dist.get_rank(group)


def _rows(t: torch.Tensor, dim: int, axis, device) -> torch.Tensor:
    """This rank's share of ``t`` along ``dim`` (all of it without an axis)."""
    t = t.to(device)
    if axis is None or t.dim() <= dim:
        return t
    size, rank = axis
    if t.shape[dim] % size:
        raise ValueError(f"axis {dim} of size {t.shape[dim]} does not split evenly over {size} ranks")
    step = t.shape[dim] // size
    return t.narrow(dim, rank * step, step).contiguous()


def shard_filter_state(state: ParticleFilterCorrection, mesh: DeviceMesh, particle_axis: str = "particles",
                       lane_axis: Optional[str] = None, n_lane_dims: int = 0) -> ParticleFilterCorrection:
    """This rank's shard of a whole correction state, on its device: the
    particle-indexed leaves (``x.value``, ``log_weights``, ``prev_indices``)
    split on axis 0 over ``particle_axis`` and, with ``n_lane_dims``, on axis
    1 over ``lane_axis``; the per-lane leaves (``log_likelihood``, ``mean``,
    ``variance``) on axis 0 over ``lane_axis``."""
    dev = mesh_device(mesh)
    parts = _axis(mesh, particle_axis)
    lanes = _axis(mesh, lane_axis) if n_lane_dims > 0 else None

    def particle_leaf(t):
        return _rows(_rows(t, 0, parts, dev), 1, lanes, dev)

    def lane_leaf(t):
        return _rows(t, 0, lanes, dev)

    return ParticleFilterCorrection(
        state.x.copy(values=particle_leaf(state.x.value)),
        particle_leaf(state.log_weights),
        lane_leaf(state.log_likelihood),
        particle_leaf(state.prev_indices),
        lane_leaf(state.mean),
        lane_leaf(state.variance),
    )


def particle_sharded_filter(filt, mesh: DeviceMesh, particle_axis: str = "particles"):
    """``filt`` over this rank's shard of its particles on the mesh axis
    ``particle_axis``: SISR or the APF with the systematic resampler, with a
    proposal that moves each particle on its own (the moment-matched
    Gaussian proposals fit the whole cloud and are not sharded). Every
    resample runs over the gathered cloud: the fused kernel where it applies
    (a float32 cloud under 2^24 entries), the resampler and a gather
    otherwise (``ParticleFilter._resample_cloud``)."""
    if not isinstance(filt, (SISR, APF)) or isinstance(filt.proposal, (GaussianProposal, GaussianLinearized,
                                                                        GaussianLinear)):
        raise NotImplementedError(f"{type(filt).__name__} with {type(filt.proposal).__name__} has no particle sharding")
    if filt.resampler is not systematic_counts or filt.differentiable:
        raise NotImplementedError("a sharded cloud resamples by the systematic resampler, not differentiably")
    size, _ = _axis(mesh, particle_axis)
    if filt.n_particles % size:
        raise ValueError(f"{filt.n_particles} particles do not split evenly over {size} ranks")
    n_local = filt.n_particles // size
    if n_local in filt.batch_shape:
        raise ValueError(f"the local particle count {n_local} must differ from the lane count {filt.batch_shape}")
    return filt.replace(_shard=ParticleShard(mesh.get_group(particle_axis), n_local), n_particles=n_local,
                        _identity_cache=None)


def sharded_draws(filt, lanes: LaneShard | None = None):
    """The draws of a run of ``filt`` (a particle-sharded filter, or one with
    a lane shard ``lanes``) as the one-process run's (``ShardedDraws``)."""
    shard = getattr(filt, "_shard", None)
    if shard is None and lanes is None:
        return contextlib.nullcontext()
    return ShardedDraws(shard, lanes)


def _shard_run(filt, mesh: DeviceMesh, particle_axis: Optional[str], lane_axis: Optional[str]):
    """The filter of this rank, and its lane shard."""
    lanes = None
    if _axis(mesh, lane_axis) is not None:
        lanes = LaneShard(mesh.get_group(lane_axis), filt.batch_shape[0])
        filt = lane_sharded_filter(filt, mesh, lane_axis)
    if _axis(mesh, particle_axis) is not None:
        filt = particle_sharded_filter(filt, mesh, particle_axis)
    return filt, lanes


def sharded_filter_step(filt, generator, y, state: ParticleFilterCorrection, mesh: DeviceMesh,
                        particle_axis: str = "particles", lane_axis: Optional[str] = None,
                        first_step: bool = False) -> ParticleFilterCorrection:
    """One filter move from the whole ``state`` with the particle axis (and
    the lane axis, with ``lane_axis``) sharded over ``mesh``. Returns this
    rank's shard of the corrected state; its log-likelihood, means and
    variances are the whole cloud's (module docstring)."""
    sharded, lanes = _shard_run(filt, mesh, particle_axis, lane_axis)
    state = shard_filter_state(state, mesh, particle_axis, lane_axis, len(filt.batch_shape))
    with sharded_draws(sharded, lanes):
        return sharded.filter(generator, y, state, first_step=first_step)


def sharded_batch_filter(filt, generator, y, mesh: DeviceMesh, particle_axis: str = "particles",
                         lane_axis: Optional[str] = None):
    """A whole filtering pass with the particle axis (and the lane axis, with
    ``lane_axis``) sharded over ``mesh``: every rank starts its shard of the
    initial cloud and filters it. Returns a ``FilterResult`` whose
    log-likelihoods, means and variances are the whole cloud's, the same on
    every rank, and whose ``latest_state`` is this rank's shard (module
    docstring)."""
    sharded, lanes = _shard_run(filt, mesh, particle_axis, lane_axis)
    with sharded_draws(sharded, lanes):
        return sharded.batch_filter(generator, y)


def lane_sharded_filter(filt, mesh: DeviceMesh, lane_axis: str = "lanes"):
    """``filt`` over this rank's lanes of the mesh axis ``lane_axis``: every
    model leaf whose axis 0 is the lane count keeps this rank's lanes, and
    the filter's lane count becomes the rank's."""
    if not filt.batch_shape:
        raise ValueError("filter has no lane axis; call set_batch_shape first")
    k = filt.batch_shape[0]
    axis = _axis(mesh, lane_axis)
    dev = mesh_device(mesh)
    leaves = [_rows(t, 0, axis, dev) if t.dim() >= 1 and t.shape[0] == k else t.to(dev)
              for t in model_leaves(filt.model)]
    return filt.replace(model=rebuild(filt.model, leaves), batch_shape=(k // axis[0],) + filt.batch_shape[1:],
                        _identity_cache=None)
