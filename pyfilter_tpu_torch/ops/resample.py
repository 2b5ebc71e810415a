"""Search-free systematic resampling via integer counts inversion.

Counterpart of ``pyfilter_tpu/ops/resample.py``. For systematic positions
``(i+u)/N`` the number of positions below each cumulative weight ``c_j`` is
``n_j = ceil(N c_j - u)`` (clipped to ``[0, N]``), and the ancestor indices
are the inverse of that monotone sequence: ``idx[i] = #{j : n_{j-1} <= i} - 1``,
one integer scatter-add and one integer cumsum.

The cumulative weights are an EXACT fixed-point prefix sum, so that every
implementation of them, in any order of addition, gives the same bits: the
plain versions here on either device, and the hand-written kernels of
``ops/expand.py``, which compute the copy counts themselves:

1. ``q_j = round(p_j * 2^K)`` as int64, K = ``FIXED_POINT_BITS`` = 60
   (float32 -> float64, a scale by a power of two, round half to even);
2. ``S_j = sum_{k <= j} q_k`` in int64: integer addition is associative, so a
   serial loop, a warp scan and ``torch.cumsum`` agree bit for bit;
3. ``cumw_j = float32(float64(S_j) * 2^-K)``: int64 -> float64 -> float32,
   never int64 -> float32 in one step (devices may round that differently);
4. ``cumw[-1] = 1``, ``counts = clamp(ceil(N * cumw - u), 0, N)`` as int32
   (``N * cumw`` and ``- u`` are two float32 roundings, no fused multiply-add),
   then ``counts[-1] = N``.

Every step is monotone, so the counts are non-decreasing by construction (no
running maximum) with the last boundary N. A particle's resolution is
2^-60 (about 8.7e-19), at most about 1e-12 over 1e6 particles, far below
float32's 6e-8 on ``cumw``; probabilities below about 1e-18 get no mass, and
would get no copy anyway. A total up to 8 fits in int64.

The JAX package sums in float32 in its own order, so at large N a boundary
``N c_j - u`` can land on the other side of an integer, and then differs by
exactly 1 (on the CPU, from the same probabilities, N(0, 2) log-weights,
seed 0, u = 0.37: none of 512 or 4096, 157 of 1e5, 803 of 2e5 and 17,884 of
1e6 boundaries differ, counted by ``PYTHONPATH=. python
tests/test_torch_port_ops.py``). On the same counts the two packages'
expansions agree bit for bit.
"""

from __future__ import annotations

import torch

from ..utils import normalize

#: bits of the fixed-point cumulative sum: ``q = round(p * 2**FIXED_POINT_BITS)``
FIXED_POINT_BITS = 60


def fixed_point(probs: torch.Tensor) -> torch.Tensor:
    """``q = round(p * 2^K)`` as int64 (step 1): float32 -> float64, an exact
    scale by a power of two, round half to even."""
    return torch.round(probs.to(torch.float32).to(torch.float64) * 2.0**FIXED_POINT_BITS).to(torch.int64)


def prefix_to_cumw(s: torch.Tensor) -> torch.Tensor:
    """Inclusive fixed-point prefix sums ``S`` (int64) -> float32 cumulative
    weights (step 3): int64 -> float64, an exact scale, float64 -> float32."""
    return (s.to(torch.float64) * 2.0**-FIXED_POINT_BITS).to(torch.float32)


def prob_cumsum(probs: torch.Tensor) -> torch.Tensor:
    """Float32 cumulative sum over the LAST axis by the exact fixed-point
    prefix sum (module docstring, steps 1-3): the same bits on every device
    and in every order of addition."""
    return prefix_to_cumw(torch.cumsum(fixed_point(probs), dim=-1))


def counts_from_prefix(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Copy-count boundaries from the inclusive fixed-point prefix sums ``S``
    ``(..., N)`` (step 4), ``u`` broadcasting against the leading axes."""
    n = s.shape[-1]
    cumw = prefix_to_cumw(s)
    cumw[..., -1] = 1.0
    counts = torch.clamp(torch.ceil(n * cumw - u.unsqueeze(-1)), 0, n).to(torch.int32)
    counts[..., -1] = n
    return counts


def copy_counts(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Monotone copy-count boundaries ``counts[..., j] = ceil(N * cumw[..., j] - u)``
    clipped to ``[0, N]``, int32, with the last cumulative weight forced to 1
    and the last boundary pinned to N (a uniform can round to exactly 1.0,
    which would leave the last output position selecting nothing).
    ``probs`` is ``(..., N)`` and ``u`` broadcasts against its leading axes."""
    return counts_from_prefix(torch.cumsum(fixed_point(probs), dim=-1), u)


def invert_counts(counts: torch.Tensor) -> torch.Tensor:
    """Monotone copy-count boundaries ``(..., N)`` -> ancestor indices:
    ``idx[i] = #{j : counts[j-1] <= i} - 1`` by scatter-add and cumsum. Positions
    past a boundary equal to N are dropped, so an unpinned last boundary
    (u == 1.0) clamps to the last source that has copies."""
    n = counts.shape[-1]
    n_prev = torch.cat([torch.zeros_like(counts[..., :1]), counts[..., :-1]], dim=-1)
    scat = torch.zeros_like(counts).scatter_add_(
        -1, torch.clamp(n_prev, max=n - 1).long(), (n_prev < n).to(counts.dtype)
    )
    return torch.cumsum(scat, dim=-1, dtype=torch.int32) - 1


def systematic_counts(
    generator: torch.Generator | None,
    weights: torch.Tensor,
    normalized: bool = False,
    u: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Systematic resampler by counts inversion. ``weights`` are ``(N, *batch)``
    log-weights (or probabilities with ``normalized=True``); one uniform per
    lane is drawn from ``generator`` unless ``u`` is given. Returns int32
    ancestor indices of the weights' shape."""
    probs = weights if normalized else normalize(weights, dim=0)
    n = probs.shape[0]
    batch_shape = probs.shape[1:]
    if u is None:
        if generator is None:
            raise ValueError("either generator or u must be provided")
        u = torch.rand(batch_shape, generator=generator, dtype=probs.dtype, device=probs.device)
    u = torch.as_tensor(u, dtype=probs.dtype, device=probs.device).expand(batch_shape)

    flat = probs.reshape(n, -1).T  # (B, N), lanes leading
    idx = invert_counts(copy_counts(flat, u.reshape(-1)))
    return idx.T.reshape(probs.shape)
