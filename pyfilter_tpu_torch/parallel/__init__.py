"""Multi-rank parallelism: process-group meshes, sharded filtering, the
collective resamplers and the explicit-SPMD tier.

Counterpart of ``pyfilter_tpu/parallel/``. One process per rank, each
holding its shard, over ``torch.distributed``:

- ``sharding``: the particle axis ``N`` shards with the weight reductions
  all-reduced and the resample run over the gathered cloud; the
  parameter-lane axis ``K`` of SMC², NESS and PMMH shards with the small
  cross-lane operations (ESS, proposal fits, lane resamples) on gathered lane
  vectors (``inference.sequential.base``, ``batch.mcmc.pmmh``: ``mesh=``);
- ``spmd`` and ``enkf``: the scaling tier, each rank drawing and holding
  only its ``N/P`` particles (or ``M/P`` ensemble members), with all-reduced
  moments and a halo-exchange resample.
"""

from . import collective
from .enkf import spmd_enkf
from .sharding import (
    lane_sharded_filter,
    make_mesh,
    shard_filter_state,
    sharded_batch_filter,
    sharded_filter_step,
)
from .spmd import (
    spmd_batch_filter,
    spmd_predict,
    spmd_smooth,
    spmd_smoothed_log_likelihood,
)

__all__ = [
    "make_mesh",
    "shard_filter_state",
    "sharded_batch_filter",
    "sharded_filter_step",
    "lane_sharded_filter",
    "spmd_batch_filter",
    "spmd_enkf",
    "spmd_predict",
    "spmd_smooth",
    "spmd_smoothed_log_likelihood",
    "collective",
]
