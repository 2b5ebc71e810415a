"""Rejection FFBSi's exact fallback: the backward-kernel draw of every failed
target of a step in one call, and the streamed Gumbel-max that draws it off
the card.

The JAX package has no kernel here: it finishes the targets that failed every
rejection round of ``backward_indices`` in a ``lax.while_loop`` over passes of
a streamed Gumbel-max categorical. On the card the port draws them all in the
hand-written CUDA kernel of ``csrc/ffbsi_fallback.cu``; for tensors on the CPU
the wrapper runs its plain version, the same table arithmetic through
:func:`streamed_argmax`, which ``filters.particle.smoothing`` streams every
other process through too.

The kernel takes tables, not a model: a scalar state whose transition is
``Normal(c_i, 1 / a_i)`` given particle ``i``, ``b_i`` its log-weight plus
``log a_i`` (``filters.particle.smoothing`` builds them from an affine process
with a Normal increment). The draw for target ``y`` is
``argmax_i (b_i - (a_i (y - c_i))^2 / 2 + G_i)``, ``G`` standard Gumbel:
index ``i`` with probability ``∝ w_i p(y | x_i)`` (the ``-log sqrt(2π)`` of the
density is dropped, as it moves no argmax).
"""

from __future__ import annotations

import math

import torch

from ..utils import gumbel
from .expand import _check_cuda, _kernel, _query

__all__ = ["ffbsi_fallback", "streamed_argmax"]


def streamed_argmax(generator, score, n: int, block: int, j_shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """Gumbel-max over ``n`` particles streamed in blocks of ``block``:
    ``score(start, stop)`` gives the log-weights ``(J, stop - start, *batch)``
    of particles ``[start, stop)`` for every target; returns each target's
    ``argmax_i (score_i + G_i)`` ``(J, *batch)`` int64 (``j_shape``), ``G``
    standard Gumbel. O(N J) work, O(J block) memory; ``like`` gives the dtype
    and device."""
    best_val = torch.full(j_shape, -math.inf, dtype=like.dtype, device=like.device)
    best_idx = torch.zeros(j_shape, dtype=torch.int64, device=like.device)
    for start in range(0, n, block):
        tot = score(start, min(start + block, n))
        mv, mi = torch.max(tot + gumbel(generator, tot.shape, tot), dim=1)
        upd = mv > best_val
        best_val = torch.where(upd, mv, best_val)
        best_idx = torch.where(upd, mi + start, best_idx)
    return best_idx


def _fallback_plain(generator, tables, targets, order, n_fail: int, idx):
    """The kernel's plain version: the same draw for the targets
    ``targets[order[:n_fail]]``, streamed over particle blocks of at most
    2^25 pairs, written into ``idx`` at ``order[:n_fail]``."""
    sel = order[:n_fail]
    y = targets.index_select(0, sel)[:, None]
    c, a, b = tables

    def score(start, stop):
        z = a[start:stop] * (y - c[start:stop])
        return b[start:stop] - 0.5 * z * z

    block = max(1, (1 << 25) // max(n_fail, 1))
    return idx.index_copy_(0, sel, streamed_argmax(generator, score, c.shape[0], block, (n_fail,), tables))


def ffbsi_fallback(generator, tables: torch.Tensor, targets: torch.Tensor, order: torch.Tensor, n_fail: int,
                   idx: torch.Tensor) -> torch.Tensor:
    """Draw the exact backward index of the ``n_fail`` targets
    ``targets[order[:n_fail]]`` against the tables ``(3, N)`` (rows ``c``,
    ``a``, ``b``), and write each into ``idx`` ``(J,)`` int64 at
    its slot ``order[k]``; the other entries of ``idx`` are left as they are.
    Returns ``idx``.

    CUDA tensors launch the kernel (and count the launch in
    ``ffbsi_fallback.launches``), its Philox key drawn on the device from
    ``generator``; CPU tensors take the plain version."""
    if _check_cuda(tables, targets, order, idx):
        return _fallback_plain(generator, tables, targets, order, n_fail, idx)
    if tables.dtype != torch.float32 or tables.dim() != 2 or tables.shape[0] != 3 or not tables.is_contiguous():
        raise ValueError("tables must be a contiguous (3, N) float32 tensor")
    if targets.dtype != torch.float32 or targets.dim() != 1 or not targets.is_contiguous():
        raise ValueError("targets must be a contiguous 1-D float32 tensor")
    n, j = tables.shape[1], targets.shape[0]
    if idx.dtype != torch.int64 or idx.shape != (j,) or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous ({j},) int64 tensor")
    if order.dtype != torch.int64 or order.dim() != 1 or order.shape[0] < n_fail or not order.is_contiguous():
        raise ValueError(f"order must be a contiguous 1-D int64 tensor of at least {n_fail} slots")
    if not 0 <= n_fail <= j or not 0 < n < 2**31:
        raise ValueError(f"n_fail must lie in [0, {j}] and the particle count in [1, 2**31), got {n_fail}, {n}")
    if n_fail == 0:
        return idx
    dev = tables.device
    seed = torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        scratch = torch.empty(_query("ffbsi_fallback", "pf_ffbsi_fallback_scratch", n, n_fail), dtype=torch.int32,
                              device=dev)
        rc = _kernel("ffbsi_fallback", 6, 2)(tables.data_ptr(), targets.data_ptr(), order.data_ptr(),
                                             seed.data_ptr(), idx.data_ptr(), scratch.data_ptr(), n, n_fail,
                                             torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"FFBSi fallback kernel launch failed with CUDA error {rc}")
    ffbsi_fallback.launches += 1
    return idx


ffbsi_fallback.launches = 0
