"""Search-free systematic resampling via integer counts inversion.

Counterpart of ``pyfilter_tpu/ops/resample.py``. For systematic positions
``(i+u)/N`` the number of positions below each cumulative weight ``c_j`` is
``n_j = ceil(N c_j - u)`` (clipped to ``[0, N]``), and the ancestor indices
are the inverse of that monotone sequence: ``idx[i] = #{j : n_{j-1} <= i} - 1``,
one integer scatter-add and one integer cumsum.

The cumulative sum keeps the JAX package's two-stage order above 2^17 (512-wide
rows). ``torch.cumsum`` and ``jnp.cumsum`` still add in different orders, so at
large N a copy-count boundary ``N c_j - u`` can land on the other side of an
integer, and then differs by exactly 1 (on the CPU, from the same
probabilities, N(0, 2) log-weights, seed 0, u = 0.37: none of 512, 157 of 1e5
and 12,833 of 1e6 boundaries differ, counted by
``PYTHONPATH=. python tests/test_torch_port_ops.py``). On the same counts
the two packages' expansions agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import normalize

_CUMSUM_TWO_STAGE_MIN = 1 << 17
_CUMSUM_ROW = 512


def prob_cumsum(probs: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the LAST axis, two-stage (row sums, a prefix over
    the rows, row cumsums) above ``_CUMSUM_TWO_STAGE_MIN``, as the JAX
    package sums. Shared by every counts-based resampler, so their copy-count
    boundaries agree bit for bit with each other."""
    n = probs.shape[-1]
    if n < _CUMSUM_TWO_STAGE_MIN:
        return torch.cumsum(probs, dim=-1)
    rows = -(-n // _CUMSUM_ROW)
    lead = probs.shape[:-1]
    v2 = F.pad(probs, (0, rows * _CUMSUM_ROW - n)).reshape(*lead, rows, _CUMSUM_ROW)
    row_sums = torch.sum(v2, dim=-1)
    prefix = torch.cumsum(row_sums, dim=-1) - row_sums
    cs = (torch.cumsum(v2, dim=-1) + prefix.unsqueeze(-1)).reshape(*lead, rows * _CUMSUM_ROW)
    return cs[..., :n]


def copy_counts(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Monotone copy-count boundaries ``counts[..., j] = ceil(N * cumw[..., j] - u)``
    clipped to ``[0, N]``, int32, with the last cumulative weight forced to 1.
    ``probs`` is ``(..., N)`` and ``u`` broadcasts against its leading axes."""
    n = probs.shape[-1]
    cumw = prob_cumsum(probs)
    cumw[..., -1] = 1.0
    counts = torch.clamp(torch.ceil(n * cumw - u.unsqueeze(-1)), 0, n).to(torch.int32)
    return _running_max(counts)


def _running_max(counts: torch.Tensor) -> torch.Tensor:
    """Running maximum over the last axis, in 512-wide rows plus a carry
    across rows: rows keep the scan parallel on the card, where one
    ``cummax`` over a single 1e6-long row runs nearly serially.

    A float cumsum is monotone only up to rounding (the two-stage sum's row
    seams, a parallel scan's order): a source of next to no mass can get a
    boundary one below its predecessor's (3 of 1e6+3 boundaries at N(0, 2)
    log-weights on the CPU, counted by ``tests/test_torch_port_ops.py`` run
    as a script). The running max gives such a source zero copies, as exact
    sums would, and keeps the boundaries monotone, which the expansion
    kernel relies on."""
    n = counts.shape[-1]
    rows = -(-n // _CUMSUM_ROW)
    lead = counts.shape[:-1]
    padded = F.pad(counts, (0, rows * _CUMSUM_ROW - n), value=n)
    cm = torch.cummax(padded.reshape(*lead, rows, _CUMSUM_ROW), dim=-1).values
    carry = F.pad(torch.cummax(cm[..., -1], dim=-1).values[..., :-1], (1, 0))
    return torch.maximum(cm, carry.unsqueeze(-1)).reshape(*lead, rows * _CUMSUM_ROW)[..., :n]


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
