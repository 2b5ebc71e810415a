"""Multi-rank parallelism: process-group meshes, sharded filtering and the
collective resamplers.

Counterpart of ``pyfilter_tpu/parallel/`` (its ``spmd.py`` and ``enkf.py``
are not ported yet). One process per rank, each holding its shard, over
``torch.distributed``: the particle axis ``N`` shards with the weight
reductions all-reduced and the resample run over the gathered cloud; the
parameter-lane axis ``K`` of SMC², NESS and PMMH shards with the small
cross-lane operations (ESS, proposal fits, lane resamples) on gathered lane
vectors (``inference.sequential.base``, ``batch.mcmc.pmmh``: ``mesh=``).
"""

from . import collective
from .sharding import (
    lane_sharded_filter,
    make_mesh,
    shard_filter_state,
    sharded_batch_filter,
    sharded_filter_step,
)

__all__ = [
    "make_mesh",
    "shard_filter_state",
    "sharded_batch_filter",
    "sharded_filter_step",
    "lane_sharded_filter",
    "collective",
]
