"""Collective weight operations and distributed resampling over a process group.

Counterpart of ``pyfilter_tpu/parallel/collective.py``. The JAX package runs
these inside ``shard_map`` over a mesh axis; here every rank is a process
that holds its shard of the particle axis (axis 0) and calls the same
function with the same arguments, and the mesh axis becomes a
``torch.distributed`` process group (``mesh.get_group(name)``). Every
exchange goes through ``_comm``, which counts it.

- The weight operations (:func:`psum_normalize`, :func:`distributed_ess`,
  :func:`distributed_log_likelihood`) take a local max and sum, then an
  ``all_reduce`` of each, over axis 0 (a lane batch keeps its lanes).
- The systematic routes (:func:`allgather_systematic`, :func:`halo_systematic`,
  :func:`distributed_systematic`) build the cumulative weights from the
  port's exact fixed-point prefix sum (``ops/resample.py``): each rank sums its
  own ``round(p * 2^60)`` in int64 and takes its offset as the exact int64 sum
  of the lower ranks' totals, all-gathered. Integer addition is associative,
  so at the same probabilities and the same uniform the copy counts, and so
  the indices, are bit-equal to the one-process ``copy_counts`` and
  ``invert_counts`` for any number of ranks. (The JAX package sums the shard
  totals in float32, so its offsets can move a boundary by one ULP.) The
  uniform is shared: a ``generator`` drawn identically on every rank, or an
  injected ``u``, takes the place of the JAX ``key``.
- The collective-free tier (:func:`local_metropolis`,
  :func:`distributed_categorical`, :func:`distributed_take_rows`,
  :func:`distributed_metropolis`) draws on per-rank generators derived from
  the shared one (the JAX ``fold_in`` of the axis index).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.resample import fixed_point, invert_counts, prefix_to_cumw
from ..utils import _scrub
from . import _comm

__all__ = [
    "psum_normalize",
    "distributed_ess",
    "distributed_log_likelihood",
    "allgather_systematic",
    "allgather_take",
    "ring_window",
    "halo_systematic",
    "halo_take",
    "distributed_systematic",
    "local_metropolis",
    "distributed_categorical",
    "distributed_take_rows",
    "distributed_metropolis",
]


def _size_rank(group) -> tuple:
    return dist.get_world_size(group), dist.get_rank(group)


def _tree_map(fn, values):
    """``fn`` of every tensor in a tensor, a tuple or list, or a dict of them."""
    if isinstance(values, dict):
        return {k: _tree_map(fn, v) for k, v in values.items()}
    if isinstance(values, (tuple, list)):
        return type(values)(_tree_map(fn, v) for v in values)
    return fn(values)


def _rank_generator(generator: torch.Generator, group) -> torch.Generator:
    """A generator of this rank's own: one seed drawn from the shared
    ``generator`` (the same draw on every rank, which keeps it in step), mixed
    with the rank (the JAX ``fold_in(key, axis_index)``)."""
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(hash((seed, dist.get_rank(group))) & (2**63 - 1))


def _shared_uniform(generator, u, like: torch.Tensor) -> torch.Tensor:
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand((), generator=generator, dtype=torch.float32, device=like.device)
    return torch.as_tensor(u, dtype=torch.float32, device=like.device).reshape(())


def psum_normalize(log_weights: torch.Tensor, group) -> torch.Tensor:
    """Normalized probabilities of a particle-sharded log-weight tensor
    ``(N/P, *batch)``: a max-stabilized softmax over axis 0 with an
    all-reduced max and total. A lane whose weights are all dead on every
    rank takes the uniform ``1 / N`` (``utils.normalize``'s backfill)."""
    p, _ = _size_rank(group)
    lw = _scrub(log_weights)
    m = _comm.all_reduce(torch.amax(lw, dim=0), "max", group)
    e = torch.exp(lw - torch.where(torch.isneginf(m), 0.0, m))
    total = _comm.all_reduce(torch.sum(e, dim=0), "sum", group)
    return torch.where(total > 0, e / total, 1.0 / (lw.shape[0] * p))


def distributed_ess(weights: torch.Tensor, group, normalized: bool = False) -> torch.Tensor:
    """The effective sample size of a sharded cloud: ``1 / sum w^2`` over every
    rank's particles; ``weights`` are log-weights unless ``normalized``."""
    probs = weights if normalized else psum_normalize(weights, group)
    return 1.0 / _comm.all_reduce(torch.sum(torch.square(probs), dim=0), "sum", group)


def distributed_log_likelihood(inc_weights: torch.Tensor, prev_weights: torch.Tensor | None, group,
                               normalized: bool = False) -> torch.Tensor:
    """The step's log-likelihood increment ``log sum_i w_i exp(v_i)`` over
    every rank's particles, from the incremental log-weights ``v`` and the
    previous log-weights (probabilities with ``normalized``; the uniform
    ``1 / N`` when None)."""
    if prev_weights is None:
        p, _ = _size_rank(group)
        v = _scrub(inc_weights) - math.log(inc_weights.shape[0] * p)
    else:
        probs = prev_weights if normalized else psum_normalize(prev_weights, group)
        v = _scrub(inc_weights) + torch.log(probs)
    m = _comm.all_reduce(torch.amax(v, dim=0), "max", group)
    m = torch.where(torch.isneginf(m), 0.0, m)
    s = _comm.all_reduce(torch.sum(torch.exp(v - m), dim=0), "sum", group)
    return m + torch.log(s)


def _global_prefix(probs_local: torch.Tensor, group) -> tuple:
    """This rank's inclusive fixed-point prefix sums in the global order, and
    every rank's int64 total ``(P,)``."""
    s = torch.cumsum(fixed_point(probs_local), dim=0)
    totals = _comm.all_gather(s[-1:], group)
    _, me = _size_rank(group)
    return s + torch.sum(totals[:me]), totals


def _counts(s: torch.Tensor, u: torch.Tensor, n: int, last: torch.Tensor | None = None) -> torch.Tensor:
    """``ops/resample.py``'s counts rule on global prefix sums ``s``: the
    global last particle (the positions where ``last`` is True) has
    cumulative weight 1 and boundary ``n``."""
    cumw = prefix_to_cumw(s)
    if last is not None:
        cumw = torch.where(last, 1.0, cumw)
    counts = torch.clamp(torch.ceil(n * cumw - u), 0, n).to(torch.int32)
    return counts if last is None else torch.where(last, n, counts)


def allgather_systematic(generator, log_weights: torch.Tensor, group, normalized: bool = False,
                         u=None) -> torch.Tensor:
    """Distributed systematic resampling, the all-gather route.

    ``log_weights`` is this rank's shard ``(N/P,)`` (probabilities with
    ``normalized``); every rank takes the same uniform (from ``generator``,
    or ``u``). Returns this rank's output slots' global ancestor indices
    ``(N/P,)`` int32, bit-equal to the one-process ``copy_counts`` +
    ``invert_counts`` at the same probabilities and ``u``. Gather values with
    :func:`allgather_take`."""
    p, me = _size_rank(group)
    n_local = log_weights.shape[0]
    n = n_local * p
    probs = log_weights if normalized else psum_normalize(log_weights, group)
    u = _shared_uniform(generator, u, probs)
    s, _ = _global_prefix(probs, group)
    last = torch.zeros(n_local, dtype=torch.bool, device=s.device)
    last[-1] = me == p - 1
    counts = _counts(s, u, n, last)
    # every rank's counts, then the one-process inversion over all N slots
    idx = invert_counts(_comm.all_gather(counts, group))
    return idx[me * n_local:(me + 1) * n_local]


def allgather_take(values: torch.Tensor, global_indices: torch.Tensor, group) -> torch.Tensor:
    """``values[global_indices]`` of a particle-sharded ``values``: every
    rank's shard all-gathered (N rows), then a local take."""
    return _comm.all_gather(values, group).index_select(0, global_indices.long())


def ring_window(x: torch.Tensor, group, halo: int) -> torch.Tensor:
    """The ring neighbourhood ``[me - halo, me + halo]`` of a sharded axis-0
    tensor, concatenated: ``2 * halo`` ring shifts of one shard each. Blocks
    that wrap past the global ends carry other shards: callers mask them by
    source."""
    parts = [_comm.ring_shift(x, group, h) for h in range(halo, 0, -1)]
    parts.append(x)
    parts += [_comm.ring_shift(x, group, -h) for h in range(1, halo + 1)]
    return torch.cat(parts, dim=0)


def halo_systematic(generator, log_weights: torch.Tensor, group, halo: int = 1, normalized: bool = False,
                    u=None) -> tuple:
    """Distributed systematic resampling with an ``O(halo * N/P)`` exchange.

    Returns ``(global_indices, window_indices, fits)``: this rank's output
    slots' global ancestors ``(N/P,)``, the same ancestors as positions in the
    :func:`ring_window` of a value shard (for :func:`halo_take`), and a 0-d
    bool tensor, the same on every rank, that is True when every rank's
    ancestors lie in its window. When ``fits``, the indices are bit-equal to
    :func:`allgather_systematic`'s: the same prefix sums, the same uniform,
    the same counts. The window carries the int64 prefix sums, so its counts
    are the global ones."""
    p, me = _size_rank(group)
    n_local = log_weights.shape[0]
    n = n_local * p
    base = me * n_local
    probs = log_weights if normalized else psum_normalize(log_weights, group)
    u = _shared_uniform(generator, u, probs)
    s, totals = _global_prefix(probs, group)
    dev = s.device

    src = (me - halo) + torch.repeat_interleave(torch.arange(2 * halo + 1, device=dev), n_local)
    front, back = src < 0, src >= p
    ws = ring_window(s, group, halo)
    last = (src == p - 1) & (torch.arange(ws.shape[0], device=dev) % n_local == n_local - 1)
    counts = _counts(ws, u, n, last)
    # wrapped blocks: front ones are zero-weight particles before global slot
    # 0, back ones sentinels past the end
    counts = torch.where(front, 0, torch.where(back, n, counts))
    # the count boundary before the window's first entry: 0 when the window
    # reaches (or wraps past) shard 0, else the count of the last particle of
    # the shard below the window, whose prefix is the lower shards' total
    if me - halo <= 0:
        boundary0 = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        boundary0 = _counts(torch.sum(totals[:me - halo]).reshape(1), u, n)
    starts = torch.cat([boundary0, counts[:-1]])

    last_valid = (min(me + halo, p - 1) - (me - halo) + 1) * n_local - 1
    bottom_ok = me - halo <= 0 or bool(boundary0[0] <= base)
    top_ok = me + halo >= p - 1 or bool(counts[last_valid] >= base + n_local)
    bad = torch.tensor(int(not (bottom_ok and top_ok)), dtype=torch.int32, device=dev)
    fits = _comm.all_reduce(bad, "sum", group) == 0

    # the counts inversion restricted to this rank's slots: a 1 at each window
    # particle's first owned slot; front fillers count (they shift window
    # positions by their block), back sentinels never do
    start_local = torch.clamp(starts - base, 0, n_local)
    hit = (start_local < n_local) & ~back
    scat = torch.zeros(n_local, dtype=torch.int32, device=dev).scatter_add_(
        0, torch.clamp(start_local, max=n_local - 1).long(), hit.to(torch.int32))
    window_indices = torch.cumsum(scat, dim=0, dtype=torch.int32) - 1
    return (me - halo) * n_local + window_indices, window_indices, fits


def halo_take(values: torch.Tensor, window_indices: torch.Tensor, group, halo: int = 1) -> torch.Tensor:
    """Gather a particle-sharded ``values`` at :func:`halo_systematic`'s window
    positions: ``2 * halo`` ring shifts and a local take."""
    return ring_window(values, group, halo).index_select(0, window_indices.long())


def distributed_systematic(generator, log_weights: torch.Tensor, values, group, halo: int = 1,
                           normalized: bool = False, u=None) -> tuple:
    """Resample particle-sharded ``values`` (a tensor, or a tuple, list or dict
    of them, axis 0 the local shard) by ``log_weights`` (probabilities with
    ``normalized``): the halo exchange when the ancestors fit the window,
    the all-gather route otherwise, on one shared uniform. The route is a
    Python branch on one host read of ``fits``. Returns
    ``(resampled_values, global_indices)``."""
    u = _shared_uniform(generator, u, log_weights)
    probs = log_weights if normalized else psum_normalize(log_weights, group)
    g_idx, w_idx, fits = halo_systematic(None, probs, group, halo, normalized=True, u=u)
    if bool(fits):
        return _tree_map(lambda v: halo_take(v, w_idx, group, halo), values), g_idx
    idx = allgather_systematic(None, probs, group, normalized=True, u=u)
    return _tree_map(lambda v: allgather_take(v, idx, group), values), idx


def local_metropolis(generator, log_weights: torch.Tensor, group, halo: int = 1, n_iter: int = 32) -> tuple:
    """Window-restricted Metropolis ancestor selection (Murray, Lee & Jacob):
    each output slot runs ``n_iter`` independent-Metropolis steps over the
    rank's ring window, on this rank's own generator (:func:`_rank_generator`).
    Returns ``(global_indices, window_indices)``; the only exchange is the
    window's ``2 * halo`` ring shifts. When the window wraps a whole lap
    (``2 * halo + 1 > P``) the blocks past the first lap repeat shards and
    are masked, so that each shard is a candidate once."""
    p, me = _size_rank(group)
    n_local = log_weights.shape[0]
    n_win = (2 * halo + 1) * n_local
    dev = log_weights.device
    lw = _scrub(ring_window(log_weights, group, halo))
    dup = torch.repeat_interleave(torch.arange(2 * halo + 1, device=dev), n_local) >= p
    lw = torch.where(dup, -math.inf, lw)
    # an all-dead window: uniform over the blocks that are not duplicates
    lw = torch.where(~dup & torch.all(torch.isneginf(lw)), 0.0, lw)

    gen = _rank_generator(generator, group)
    k = (halo % p) * n_local + torch.arange(n_local, device=dev)
    for _ in range(n_iter):
        j = torch.randint(0, n_win, (n_local,), generator=gen, device=dev)
        log_u = torch.log(torch.rand((n_local,), generator=gen, dtype=lw.dtype, device=dev))
        k = torch.where(log_u <= lw[j] - lw[k], j, k)
    src_shard = torch.remainder(me - halo + k // n_local, p)
    return (src_shard * n_local + k % n_local).to(torch.int32), k.to(torch.int32)


def distributed_categorical(generator, logits: torch.Tensor, group) -> torch.Tensor:
    """Categorical draws over a sharded category axis by Gumbel-max:
    ``logits`` ``(rows, N/P)`` is this rank's shard of each row's categories;
    a local argmax of ``logits + G`` (Gumbel noise from this rank's own
    generator), then two ``all_reduce(max)`` of ``(rows,)``. NaN and +inf
    logits count as -inf. Returns ``(rows,)`` int32 global indices, the same
    on every rank."""
    _, me = _size_rank(group)
    n_local = logits.shape[-1]
    gen = _rank_generator(generator, group)
    g = -torch.log(torch.empty(logits.shape, dtype=logits.dtype, device=logits.device).exponential_(generator=gen))
    z = _scrub(logits) + g
    local_best, local_arg = torch.max(z, dim=-1)
    best = _comm.all_reduce(local_best, "max", group)
    vote = torch.where(local_best == best, me * n_local + local_arg.to(torch.int32), -1).to(torch.int32)
    return _comm.all_reduce(vote, "max", group)


def distributed_take_rows(values: torch.Tensor, global_indices: torch.Tensor, group) -> torch.Tensor:
    """``values[global_indices]`` from a particle-sharded ``values`` without an
    all-gather: the owning rank gives its row, the others zeros, and an
    ``all_reduce(sum)`` merges them. ``global_indices`` must be the same on
    every rank, and so is the result."""
    _, me = _size_rank(group)
    n_local = values.shape[0]
    local = global_indices.long() - me * n_local
    mine = (local >= 0) & (local < n_local)
    picked = values.index_select(0, torch.clamp(local, 0, n_local - 1))
    mine = mine.reshape(mine.shape + (1,) * (picked.dim() - 1))
    return _comm.all_reduce(torch.where(mine, picked, torch.zeros_like(picked)), "sum", group)


def distributed_metropolis(generator, log_weights: torch.Tensor, values, group, halo: int = 1,
                           n_iter: int = 32) -> tuple:
    """Resample particle-sharded ``values`` by :func:`local_metropolis`: ring
    shifts for the weight window and for each value leaf, no reduction.
    Returns ``(resampled_values, global_indices)``, as
    :func:`distributed_systematic`, with the approximate law of the
    collective-free tier."""
    g_idx, w_idx = local_metropolis(generator, log_weights, group, halo, n_iter)
    return _tree_map(lambda v: halo_take(v, w_idx, group, halo), values), g_idx
