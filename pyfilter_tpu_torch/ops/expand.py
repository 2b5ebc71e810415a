"""Fused systematic resample + particle gather.

Counterpart of ``pyfilter_tpu/ops/expand.py``. Systematic ancestor indices
are monotone, so resampling is a streaming expansion of the copy-count
boundaries: output ``i`` takes source ``j`` with ``counts[j-1] <= i <
counts[j]``. On the card that runs in hand-written CUDA kernels; for a
tensor on the CPU, each wrapper runs its kernel's plain version, counts
inversion plus a gather.

- Single lane: ``csrc/expand.cu`` (replaces the Pallas ``_expand_kernel``).
  Values are PLANE-major ``(d, n)`` float32, so each plane is one dense row.
- Lane batches: ``csrc/expand_lanes.cu`` (replaces both Pallas lane kernels,
  ``_expand_lane_block_kernel`` and ``_expand_lane_band_kernel``). Values
  are ``(d, n, L)`` float32, the package's particle-major layout with lanes
  contiguous; counts are lanes-leading ``(L, n)`` int32, as ``copy_counts``
  makes them, so each lane's boundaries are one contiguous row to search.
  The kernel takes every n, so there is no second path for large n.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..constants import MAX_EXACT_INDEX
from ..utils import normalize
from .resample import copy_counts, invert_counts

__all__ = [
    "systematic_expand",
    "expand_from_counts",
    "fused_expand",
    "systematic_expand_lanes",
    "fused_expand_lanes",
]


def _counts_from_probs(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Copy-count boundaries ``counts[j] = #{i : (i+u)/n < cumw[j]}`` with the
    final boundary pinned to ``n`` (a uniform can round to exactly 1.0, which
    would leave the last output position selecting nothing)."""
    counts = copy_counts(probs, u)
    counts[-1] = probs.shape[0]
    return counts


def _expand_plain(counts: torch.Tensor, v2d: torch.Tensor):
    """The kernel's plain version: counts inversion, then ``index_select`` of
    every plane. Returns ``(out (d, n), idx (n,) int32)``."""
    idx = invert_counts(counts)
    return v2d.index_select(1, idx), idx


def _kernel(name: str = "expand", n_ints: int = 2):
    """The C entry point ``pf_<name>`` of ``csrc/<name>.cu``: four device
    pointers, ``n_ints`` ints, then the stream."""
    from . import _build

    fn = getattr(_build.load(name), f"pf_{name}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_expand(counts: torch.Tensor, v2d: torch.Tensor):
    """Expand the plane-major values ``v2d`` ``(d, n)`` by the monotone copy-count
    boundaries ``counts`` ``(n,)``. Returns ``(out (d, n), idx (n,) int32)``.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_expand.launches``); CPU tensors take the plain version."""
    if counts.device.type == "cpu" and v2d.device.type == "cpu":
        return _expand_plain(counts, v2d)
    if counts.device.type != "cuda" or counts.device != v2d.device:
        raise ValueError(
            f"counts and values must lie on one CUDA device, got {counts.device} and {v2d.device}"
        )
    if counts.dtype != torch.int32 or counts.dim() != 1 or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous 1-D int32 tensor")
    n = counts.shape[0]
    if v2d.dtype != torch.float32 or v2d.dim() != 2 or v2d.shape[1] != n or not v2d.is_contiguous():
        raise ValueError(f"values must be a contiguous (d, {n}) float32 tensor")
    if n >= MAX_EXACT_INDEX:
        raise ValueError("particle count must stay below 2**24 for exact f32 indexing")
    out = torch.empty_like(v2d)
    idx = torch.empty(n, dtype=torch.int32, device=counts.device)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(counts.data_ptr(), v2d.data_ptr(), out.data_ptr(), idx.data_ptr(),
                       n, v2d.shape[0], stream)
    if rc:
        raise RuntimeError(f"expand kernel launch failed with CUDA error {rc}")
    fused_expand.launches += 1
    return out, idx


fused_expand.launches = 0


def expand_from_counts(counts: torch.Tensor, values):
    """Expand one array or a tuple of arrays, each ``(n, ...)``, by the copy-count
    boundaries ``counts``. Returns ``(resampled_values, indices)`` with the
    structure of ``values``."""
    n = counts.shape[0]
    single = not isinstance(values, (tuple, list))
    vals_in = (values,) if single else tuple(values)
    v2d = torch.cat([v.to(torch.float32).reshape(n, -1).T for v in vals_in], dim=0)
    planes, idx = fused_expand(counts, v2d.contiguous())

    outs, col = [], 0
    for v in vals_in:
        width = math.prod(v.shape[1:])
        block = planes[col : col + width].T  # (n, width)
        outs.append(block.reshape(v.shape).to(v.dtype))
        col += width
    return (outs[0] if single else tuple(outs)), idx


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
    ``ops.systematic_counts`` + gather on the same copy-count boundaries."""
    if weights.dim() != 1:
        raise ValueError("systematic_expand supports a single lane; got batched weights")
    probs = (weights if normalized else normalize(weights, dim=0)).to(torch.float32)
    if probs.shape[0] >= MAX_EXACT_INDEX:
        raise ValueError("particle count must stay below 2**24 for exact f32 indexing")
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand((), generator=generator, dtype=probs.dtype, device=probs.device)
    u = torch.as_tensor(u, dtype=probs.dtype, device=probs.device).reshape(())
    return expand_from_counts(_counts_from_probs(probs, u), values)


def _lane_counts_from_probs(probs_nl: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-lane copy-count boundaries, lanes leading ``(L, n)`` int32, from
    probabilities ``(n, L)`` and one uniform per lane ``(L,)``; monotone (the
    running maximum of ``copy_counts``) with every lane's last boundary pinned
    to ``n``."""
    counts = copy_counts(probs_nl.T, u).contiguous()  # the running max's row view is strided
    counts[:, -1] = probs_nl.shape[0]
    return counts


def _expand_lanes_plain(counts_ln: torch.Tensor, planes: torch.Tensor):
    """The lane kernel's plain version: counts inversion on each lane, then a
    gather of every plane. ``counts_ln`` ``(L, n)``, ``planes`` ``(d, n, L)``.
    Returns ``(out (d, n, L), idx (n, L) int32)``."""
    idx = invert_counts(counts_ln).T.contiguous()
    return torch.gather(planes, 1, idx.long().unsqueeze(0).expand_as(planes)), idx


def fused_expand_lanes(counts_ln: torch.Tensor, planes: torch.Tensor):
    """Expand the value planes ``planes`` ``(d, n, L)`` by each lane's monotone
    copy-count boundaries ``counts_ln`` ``(L, n)``. Returns ``(out (d, n, L),
    idx (n, L) int32)``.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_expand_lanes.launches``); CPU tensors take the plain version."""
    if counts_ln.device.type == "cpu" and planes.device.type == "cpu":
        return _expand_lanes_plain(counts_ln, planes)
    if counts_ln.device.type != "cuda" or counts_ln.device != planes.device:
        raise ValueError(
            f"counts and values must lie on one CUDA device, got {counts_ln.device} and {planes.device}"
        )
    if counts_ln.dtype != torch.int32 or counts_ln.dim() != 2 or not counts_ln.is_contiguous():
        raise ValueError("counts must be a contiguous (L, n) int32 tensor")
    n_lanes, n = counts_ln.shape
    if (planes.dtype != torch.float32 or planes.dim() != 3 or planes.shape[1:] != (n, n_lanes)
            or not planes.is_contiguous()):
        raise ValueError(f"values must be a contiguous (d, {n}, {n_lanes}) float32 tensor")
    if n >= MAX_EXACT_INDEX or -(-n // 64) * -(-n_lanes // 32) >= 1 << 31:
        raise ValueError("particle count must stay below 2**24 and the launch grid below 2**31 blocks")
    out = torch.empty_like(planes)
    idx = torch.empty((n, n_lanes), dtype=torch.int32, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("expand_lanes", 3)(counts_ln.data_ptr(), planes.data_ptr(), out.data_ptr(),
                                        idx.data_ptr(), n, n_lanes, planes.shape[0], stream)
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
    bit-identical to counts inversion + gather on the same boundaries."""
    if weights.dim() < 2:
        raise ValueError("use systematic_expand for single-lane weights")
    probs = (weights if normalized else normalize(weights, dim=0)).to(torch.float32)
    n, batch_shape = probs.shape[0], tuple(probs.shape[1:])
    n_lanes = math.prod(batch_shape)
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand(batch_shape, generator=generator, dtype=probs.dtype, device=probs.device)
    u = torch.as_tensor(u, dtype=probs.dtype, device=probs.device).expand(batch_shape).reshape(n_lanes)

    single = not isinstance(values, (tuple, list))
    vals_in = (values,) if single else tuple(values)
    widths = [math.prod(v.shape[1 + len(batch_shape):]) for v in vals_in]
    planes = torch.cat(
        [v.to(torch.float32).reshape(n, n_lanes, w).permute(2, 0, 1) for v, w in zip(vals_in, widths)], dim=0
    ).contiguous()  # (d, n, L)
    counts = _lane_counts_from_probs(probs.reshape(n, n_lanes), u)
    out_planes, idx = fused_expand_lanes(counts, planes)

    outs, col = [], 0
    for v, w in zip(vals_in, widths):
        outs.append(out_planes[col : col + w].permute(1, 2, 0).reshape(v.shape).to(v.dtype))
        col += w
    return (outs[0] if single else tuple(outs)), idx.reshape(n, *batch_shape)
