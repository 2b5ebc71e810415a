"""The parallel layer's calls into ``torch.distributed``, one thin wrapper each.

Each wrapper counts its calls and the bytes this rank sends
(``all_reduce.calls``, ``.bytes``), as the kernels count their launches
(``ops.expand.fused_expand.launches``); :func:`counts` reads them all and
:func:`reset` sets them to 0. Each runs inside a ``pf.comm.<op>`` span
(:mod:`..tracing`): an exchange's time is read from a profiler's trace. No
wrapper waits for the device before its collective, so an exchange can
overlap the work queued before it.

Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only: on a gloo
group :func:`all_gather` and :func:`ring_shift` move a CUDA tensor to the
host and back, and count each copy in ``host_copies``. The choice follows
``dist.get_backend(group)``; NCCL keeps every tensor on the device.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..tracing import span

#: the timeout of every group the parallel layer creates: a collective whose
#: peer never arrives fails the run after this, rather than hang it
TIMEOUT = datetime.timedelta(seconds=120)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class _HostCopies:
    """The count of host copies gloo made this layer take (``host_copies.count``)."""

    count = 0


host_copies = _HostCopies()


def _count(fn, nbytes: int) -> None:
    fn.calls += 1
    fn.bytes += nbytes


def _staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` must travel through the host: a CUDA tensor on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host_copies.count += 1
    return t.cpu()


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    host_copies.count += 1
    return t.to(device)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` (``"sum"`` or ``"max"``) of ``t`` over the group's ranks, in a
    new tensor; ``t`` is left as it was."""
    out = t.clone()
    with span("comm.all_reduce"):
        dist.all_reduce(out, op=_OPS[op], group=group)
    _count(all_reduce, out.numel() * out.element_size())
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) concatenated along ``dim`` in the
    group's rank order."""
    with span("comm.all_gather"):
        src = _to_host(t) if _staged(t, group) else t
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        if out.device != t.device:
            out = _to_device(out, t.device)
    _count(all_gather, src.numel() * src.element_size())
    return out


def ring_shift(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """The ``t`` of the rank ``shift`` places below this one on the group's
    ring: each rank sends its own to the rank ``shift`` places above, by one
    ``batch_isend_irecv``."""
    ranks = dist.get_process_group_ranks(group)
    p, me = len(ranks), dist.get_rank(group)
    if shift % p == 0:
        return t.clone()
    with span("comm.ring_shift"):
        src = _to_host(t) if _staged(t, group) else t
        src = src.contiguous()
        recv = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, ranks[(me + shift) % p], group),
               dist.P2POp(dist.irecv, recv, ranks[(me - shift) % p], group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = recv if recv.device == t.device else _to_device(recv, t.device)
    _count(ring_shift, src.numel() * src.element_size())
    return out


def counts() -> dict:
    """Every wrapper's calls and bytes, and the host copies."""
    out = {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes}
           for fn in (all_reduce, all_gather, ring_shift)}
    out["host_copies"] = host_copies.count
    return out


def reset() -> None:
    """Set every count to 0."""
    for fn in (all_reduce, all_gather, ring_shift):
        fn.calls = fn.bytes = 0
    host_copies.count = 0


reset()
