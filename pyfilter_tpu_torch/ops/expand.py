"""Fused systematic resample + particle gather.

Counterpart of ``pyfilter_tpu/ops/expand.py``. Systematic ancestor indices
are monotone, so resampling is a streaming expansion of the copy-count
boundaries: output ``i`` takes source ``j`` with ``counts[j-1] <= i <
counts[j]``. On the card that runs in hand-written CUDA kernels that take the
PROBABILITIES and the uniforms and compute the copy counts themselves (the
exact fixed-point prefix sum of ``ops/resample.py``, so their counts are the
plain version's bit for bit); for a tensor on the CPU, each wrapper runs its
kernel's plain version: ``copy_counts``, then counts inversion plus a gather.

- Single lane: ``csrc/expand.cu`` (replaces the Pallas ``_expand_kernel`` and
  its counts prep). Values are PLANE-major ``(d, n)`` float32, so each plane
  is one dense row.
- Lane batches: ``csrc/expand_lanes.cu`` (replaces both Pallas lane kernels,
  ``_expand_lane_block_kernel`` and ``_expand_lane_band_kernel``, and their
  counts prep). Probabilities are ``(n, L)`` and values ``(d, n, L)`` float32,
  the package's particle-major layout with lanes contiguous, read with no
  transpose. The kernel takes every n, so there is no second path for large n.

The plain versions from counts (``_expand_plain``, ``_expand_lanes_plain``)
stay beside the ones from probabilities: the CPU tests feed them the JAX
package's own counts.

Both fused functions are differentiable in the values (a
``torch.autograd.Function`` each): the gradient of the gathered planes flows
back through the transpose of the gather, a scatter-add by the saved
indices, which on the card is a hand-written kernel too
(:func:`fused_expand_backward`, :func:`fused_expand_lanes_backward`, in the
same sources) and on the CPU its plain version, ``index_add_``
(``scatter_add_`` over lanes). The probabilities and the uniform get no
gradient: the copy counts are piecewise constant in them (a filter's
gradient through the weights takes the ancestor correction,
``filters/particle/base.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..constants import MAX_EXACT_INDEX
from ..utils import normalize
from .resample import copy_counts, invert_counts

__all__ = [
    "systematic_expand",
    "fused_expand",
    "fused_expand_backward",
    "systematic_expand_lanes",
    "fused_expand_lanes",
    "fused_expand_lanes_backward",
]


def _expand_plain(counts: torch.Tensor, v2d: torch.Tensor):
    """Expansion by copy-count boundaries ``counts`` ``(n,)``: counts
    inversion, then ``index_select`` of every plane. Returns ``(out (d, n),
    idx (n,) int32)``."""
    idx = invert_counts(counts)
    return v2d.index_select(1, idx), idx


def _expand_probs_plain(probs: torch.Tensor, u: torch.Tensor, v2d: torch.Tensor):
    """The single-lane kernel's plain version: ``copy_counts``, then
    :func:`_expand_plain`."""
    return _expand_plain(copy_counts(probs, u), v2d)


@functools.cache
def _cfunc(name: str, fn: str, argtypes: tuple, restype):
    """The C function ``fn`` of ``csrc/<name>.cu``, built and loaded at first use."""
    from . import _build

    f = getattr(_build.load(name), fn)
    f.argtypes, f.restype = list(argtypes), restype
    return f


def _kernel(name: str, n_ptrs: int, n_ints: int, entry: str | None = None):
    """The C entry point ``entry`` (default ``pf_<name>``) of ``csrc/<name>.cu``:
    ``n_ptrs`` device pointers, ``n_ints`` ints, then the stream."""
    argtypes = (ctypes.c_void_p,) * n_ptrs + (ctypes.c_int,) * n_ints + (ctypes.c_void_p,)
    return _cfunc(name, entry or f"pf_{name}", argtypes, ctypes.c_int)


def _query(name: str, fn: str, *ints: int) -> int:
    """An int64 size from the C function ``fn`` of ``csrc/<name>.cu``."""
    return int(_cfunc(name, fn, (ctypes.c_int,) * len(ints), ctypes.c_longlong)(*ints))


def _check_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs); raises
    unless they all lie on one CUDA device."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"a kernel's inputs must all lie on the CPU or on one CUDA device, got {devices}")
    return False


# the single-lane kernels' device state (the forward's look-back, the backward's
# tickets), one zeroed buffer per (device, stream[, "backward"]): the kernels
# reset it themselves, so it is allocated once
_lookback_states: dict = {}


def _expand_backward_plain(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The single-lane backward kernel's plain version: ``g`` ``(d, n)``
    scattered back onto the sources by ``idx`` ``(n,)``."""
    return torch.zeros_like(g).index_add_(1, idx.long(), g)


def fused_expand_backward(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`fused_expand`'s values: the gathered planes'
    gradient ``g`` ``(d, n)`` summed onto each source by the monotone indices
    ``idx`` ``(n,)``. Returns ``(d, n)``.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_expand_backward.launches``); CPU tensors take the plain version."""
    if _check_cuda(g, idx):
        return _expand_backward_plain(g, idx)
    d, n = g.shape
    g = g.contiguous()
    if g.dtype != torch.float32 or idx.dtype != torch.int32 or idx.shape != (n,) or not idx.is_contiguous():
        raise ValueError(f"the backward takes a (d, {n}) float32 gradient and ({n},) int32 indices")
    if n >= MAX_EXACT_INDEX:
        raise ValueError("particle count must stay below 2**24 for exact f32 indexing")
    out = torch.empty_like(g)
    words = _query("expand", "pf_expand_backward_scratch", n, d)
    scratch = torch.empty(words, dtype=torch.int64, device=g.device) if words else None
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = (g.device.index, stream, "backward")
        state = _lookback_states.get(key)
        if state is None:
            words = _query("expand", "pf_expand_backward_state_words")
            state = _lookback_states[key] = torch.zeros(words, dtype=torch.int64, device=g.device)
        rc = _kernel("expand", 5, 2, "pf_expand_backward")(
            g.data_ptr(), idx.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            state.data_ptr(), n, d, stream)
    if rc:
        _lookback_states.pop(key, None)  # a launch that failed half way leaves its ticket set
        raise RuntimeError(f"expand backward kernel launch failed with CUDA error {rc}")
    fused_expand_backward.launches += 1
    return out


fused_expand_backward.launches = 0


class _Expand(torch.autograd.Function):
    """:func:`fused_expand` with its backward (saved indices, scatter-add)."""

    @staticmethod
    def forward(ctx, probs, u, v2d):
        out, idx = _expand_forward(probs, u, v2d)
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, g_idx):
        (idx,) = ctx.saved_tensors
        return None, None, fused_expand_backward(g_out, idx)


def fused_expand(probs: torch.Tensor, u: torch.Tensor, v2d: torch.Tensor):
    """Resample the plane-major values ``v2d`` ``(d, n)`` systematically by the
    probabilities ``probs`` ``(n,)`` and the uniform ``u`` (a 0-d tensor).
    Returns ``(out (d, n), idx (n,) int32)``; ``out`` carries ``v2d``'s
    gradient back through :func:`fused_expand_backward`.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_expand.launches``); CPU tensors take the plain version. The
    autograd wrapper is entered only when ``v2d`` needs a gradient."""
    if torch.is_grad_enabled() and v2d.requires_grad:
        return _Expand.apply(probs, u, v2d)
    return _expand_forward(probs, u, v2d)


def _expand_forward(probs: torch.Tensor, u: torch.Tensor, v2d: torch.Tensor):
    """:func:`fused_expand`'s forward: the kernel, or the plain version on the CPU."""
    if _check_cuda(probs, u, v2d):
        return _expand_probs_plain(probs, u, v2d)
    if probs.dtype != torch.float32 or probs.dim() != 1 or not probs.is_contiguous():
        raise ValueError("probabilities must be a contiguous 1-D float32 tensor")
    n = probs.shape[0]
    if u.dtype != torch.float32 or u.numel() != 1:
        raise ValueError("u must be one float32 value")
    if v2d.dtype != torch.float32 or v2d.dim() != 2 or v2d.shape[1] != n or not v2d.is_contiguous():
        raise ValueError(f"values must be a contiguous (d, {n}) float32 tensor")
    if n >= MAX_EXACT_INDEX:
        raise ValueError("particle count must stay below 2**24 for exact f32 indexing")
    dev = probs.device
    out = torch.empty_like(v2d)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        key = (dev.index, stream)
        state = _lookback_states.get(key)
        if state is None:
            words = _query("expand", "pf_expand_state_words")
            state = _lookback_states[key] = torch.zeros(words, dtype=torch.int64, device=dev)
        scratch = torch.empty(_query("expand", "pf_expand_scratch", n), dtype=torch.int32, device=dev)
        rc = _kernel("expand", 7, 2)(probs.data_ptr(), u.data_ptr(), v2d.data_ptr(), out.data_ptr(),
                                     idx.data_ptr(), scratch.data_ptr(), state.data_ptr(), n, v2d.shape[0],
                                     stream)
    if rc:
        _lookback_states.pop(key, None)  # a launch that failed half way leaves its ticket set
        raise RuntimeError(f"expand kernel launch failed with CUDA error {rc}")
    fused_expand.launches += 1
    return out, idx


fused_expand.launches = 0


def _to_planes(values, n: int) -> torch.Tensor:
    """One array or a tuple of arrays, each ``(n, ...)``, as float32 planes ``(d, n)``."""
    vals_in = values if isinstance(values, (tuple, list)) else (values,)
    return torch.cat([v.to(torch.float32).reshape(n, -1).T for v in vals_in], dim=0).contiguous()


def _from_planes(planes: torch.Tensor, values):
    """The inverse of :func:`_to_planes`: the structure, shapes and dtypes of ``values``."""
    single = not isinstance(values, (tuple, list))
    outs, col = [], 0
    for v in (values,) if single else values:
        width = math.prod(v.shape[1:])
        outs.append(planes[col : col + width].T.reshape(v.shape).to(v.dtype))
        col += width
    return outs[0] if single else tuple(outs)


def systematic_expand(
    generator: torch.Generator | None,
    weights: torch.Tensor,
    values,
    normalized: bool = False,
    u: torch.Tensor | float | None = None,
):
    """Systematic resample + gather in one fused pass (single lane).

    ``weights``: ``(N,)`` log-weights (or probabilities with ``normalized=True``).
    ``values``: one array or a tuple of arrays, each ``(N, ...)``.
    Returns ``(resampled_values, indices)``, bit-identical to
    ``ops.systematic_counts`` + gather with the same uniform."""
    if weights.dim() != 1:
        raise ValueError("systematic_expand supports a single lane; got batched weights")
    probs = (weights if normalized else normalize(weights, dim=0)).to(torch.float32).contiguous()
    n = probs.shape[0]
    if n >= MAX_EXACT_INDEX:
        raise ValueError("particle count must stay below 2**24 for exact f32 indexing")
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand((), generator=generator, dtype=probs.dtype, device=probs.device)
    u = torch.as_tensor(u, dtype=probs.dtype, device=probs.device).reshape(())
    planes, idx = fused_expand(probs, u, _to_planes(values, n))
    return _from_planes(planes, values), idx


def _expand_lanes_plain(counts_ln: torch.Tensor, planes: torch.Tensor):
    """Expansion by each lane's copy-count boundaries ``counts_ln`` ``(L, n)``:
    counts inversion on each lane, then a gather of every plane ``(d, n, L)``.
    Returns ``(out (d, n, L), idx (n, L) int32)``."""
    idx = invert_counts(counts_ln).T.contiguous()
    return torch.gather(planes, 1, idx.long().unsqueeze(0).expand_as(planes)), idx


def _expand_lanes_probs_plain(probs_nl: torch.Tensor, u: torch.Tensor, planes: torch.Tensor):
    """The lane kernel's plain version: ``copy_counts`` of each lane of
    ``probs_nl`` ``(n, L)`` with its uniform ``u`` ``(L,)``, then
    :func:`_expand_lanes_plain`."""
    return _expand_lanes_plain(copy_counts(probs_nl.T, u), planes)


def _expand_lanes_backward_plain(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The lane backward kernel's plain version: ``g`` ``(d, n, L)`` scattered
    back onto each lane's sources by ``idx`` ``(n, L)``."""
    return torch.zeros_like(g).scatter_add_(1, idx.long().unsqueeze(0).expand_as(g), g)


def fused_expand_lanes_backward(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`fused_expand_lanes`'s values: the gathered
    planes' gradient ``g`` ``(d, n, L)`` summed onto each lane's sources by its
    monotone indices ``idx`` ``(n, L)``. Returns ``(d, n, L)``.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_expand_lanes_backward.launches``); CPU tensors take the plain
    version."""
    if _check_cuda(g, idx):
        return _expand_lanes_backward_plain(g, idx)
    d, n, n_lanes = g.shape
    g = g.contiguous()
    if g.dtype != torch.float32 or idx.dtype != torch.int32 or idx.shape != (n, n_lanes) or not idx.is_contiguous():
        raise ValueError(f"the backward takes a (d, {n}, {n_lanes}) float32 gradient and ({n}, {n_lanes}) int32 "
                         "indices")
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        rc = _kernel("expand_lanes", 3, 3, "pf_expand_lanes_backward")(
            g.data_ptr(), idx.data_ptr(), out.data_ptr(), n, n_lanes, d, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"lane expand backward kernel launch failed with CUDA error {rc}")
    fused_expand_lanes_backward.launches += 1
    return out


fused_expand_lanes_backward.launches = 0


class _ExpandLanes(torch.autograd.Function):
    """:func:`fused_expand_lanes` with its backward (saved indices, scatter-add)."""

    @staticmethod
    def forward(ctx, probs_nl, u, planes):
        out, idx = _expand_lanes_forward(probs_nl, u, planes)
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g_out, g_idx):
        (idx,) = ctx.saved_tensors
        return None, None, fused_expand_lanes_backward(g_out, idx)


def fused_expand_lanes(probs_nl: torch.Tensor, u: torch.Tensor, planes: torch.Tensor):
    """Resample the value planes ``planes`` ``(d, n, L)`` systematically, each
    lane by its probabilities ``probs_nl[:, l]`` ``(n, L)`` and its uniform
    ``u[l]`` ``(L,)``. Returns ``(out (d, n, L), idx (n, L) int32)``; ``out``
    carries ``planes``' gradient back through :func:`fused_expand_lanes_backward`.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_expand_lanes.launches``); CPU tensors take the plain version. The
    autograd wrapper is entered only when ``planes`` needs a gradient."""
    if torch.is_grad_enabled() and planes.requires_grad:
        return _ExpandLanes.apply(probs_nl, u, planes)
    return _expand_lanes_forward(probs_nl, u, planes)


def _expand_lanes_forward(probs_nl: torch.Tensor, u: torch.Tensor, planes: torch.Tensor):
    """:func:`fused_expand_lanes`'s forward: the kernel, or the plain version on the CPU."""
    if _check_cuda(probs_nl, u, planes):
        return _expand_lanes_probs_plain(probs_nl, u, planes)
    if probs_nl.dtype != torch.float32 or probs_nl.dim() != 2 or not probs_nl.is_contiguous():
        raise ValueError("probabilities must be a contiguous (n, L) float32 tensor")
    n, n_lanes = probs_nl.shape
    if u.dtype != torch.float32 or u.shape != (n_lanes,) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous ({n_lanes},) float32 tensor")
    if (planes.dtype != torch.float32 or planes.dim() != 3 or planes.shape[1:] != (n, n_lanes)
            or not planes.is_contiguous()):
        raise ValueError(f"values must be a contiguous (d, {n}, {n_lanes}) float32 tensor")
    if n >= MAX_EXACT_INDEX:
        raise ValueError("particle count must stay below 2**24 for exact f32 indexing")
    dev = planes.device
    out = torch.empty_like(planes)
    idx = torch.empty((n, n_lanes), dtype=torch.int32, device=dev)
    words = _query("expand_lanes", "pf_expand_lanes_scratch", n, n_lanes)
    scratch = torch.empty(words, dtype=torch.int32, device=dev) if words else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("expand_lanes", 6, 3)(probs_nl.data_ptr(), u.data_ptr(), planes.data_ptr(), out.data_ptr(),
                                           idx.data_ptr(), None if scratch is None else scratch.data_ptr(),
                                           n, n_lanes, planes.shape[0], stream)
    if rc:
        raise RuntimeError(f"lane expand kernel launch failed with CUDA error {rc}")
    fused_expand_lanes.launches += 1
    return out, idx


fused_expand_lanes.launches = 0


def systematic_expand_lanes(
    generator: torch.Generator | None,
    weights: torch.Tensor,
    values,
    normalized: bool = False,
    u: torch.Tensor | None = None,
):
    """Lane-batched systematic resample + gather in one fused pass.

    ``weights``: ``(N, *batch)`` log-weights (or probabilities with
    ``normalized=True``), particle axis first. Each lane resamples on its own
    with its own uniform (drawn from ``generator`` unless ``u`` is given), as
    ``ops.systematic_counts`` does. ``values``: one array or a tuple of
    arrays, each ``(N, *batch, ...)``. Returns ``(resampled_values, indices)``
    with the inputs' structure and shapes, indices ``(N, *batch)`` int32,
    bit-identical to ``ops.systematic_counts`` + gather with the same uniforms."""
    if weights.dim() < 2:
        raise ValueError("use systematic_expand for single-lane weights")
    probs = (weights if normalized else normalize(weights, dim=0)).to(torch.float32)
    n, batch_shape = probs.shape[0], tuple(probs.shape[1:])
    n_lanes = math.prod(batch_shape)
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand(batch_shape, generator=generator, dtype=probs.dtype, device=probs.device)
    u = torch.as_tensor(u, dtype=probs.dtype, device=probs.device).expand(batch_shape).reshape(n_lanes).contiguous()

    single = not isinstance(values, (tuple, list))
    vals_in = (values,) if single else tuple(values)
    widths = [math.prod(v.shape[1 + len(batch_shape):]) for v in vals_in]
    planes = torch.cat(
        [v.to(torch.float32).reshape(n, n_lanes, w).permute(2, 0, 1) for v, w in zip(vals_in, widths)], dim=0
    ).contiguous()  # (d, n, L)
    out_planes, idx = fused_expand_lanes(probs.reshape(n, n_lanes).contiguous(), u, planes)

    outs, col = [], 0
    for v, w in zip(vals_in, widths):
        outs.append(out_planes[col : col + w].permute(1, 2, 0).reshape(v.shape).to(v.dtype))
        col += w
    return (outs[0] if single else tuple(outs)), idx.reshape(n, *batch_shape)
