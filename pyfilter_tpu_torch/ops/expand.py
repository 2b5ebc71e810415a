"""Fused systematic resample + particle gather.

Counterpart of ``pyfilter_tpu/ops/expand.py`` (single lane). Systematic
ancestor indices are monotone, so resampling is a streaming expansion of
the copy-count boundaries: output ``i`` takes source ``j`` with
``counts[j-1] <= i < counts[j]``. On the card that runs in one hand-written
CUDA kernel (``csrc/expand.cu``, which replaces the JAX package's Pallas
``_expand_kernel``); for a tensor on the CPU, the wrapper runs the kernel's
plain version, counts inversion plus ``index_select``.

Layout at the kernel: values are PLANE-major ``(d, n)`` float32, so each
plane is one dense row.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..constants import MAX_EXACT_INDEX
from ..utils import normalize
from .resample import copy_counts, invert_counts

__all__ = ["systematic_expand", "expand_from_counts", "fused_expand"]


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


def _kernel():
    from . import _build

    fn = _build.load("expand").pf_expand
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
