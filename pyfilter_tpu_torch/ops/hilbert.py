"""Vectorized d-dimensional Hilbert-curve indexing (Skilling's algorithm).

Counterpart of ``pyfilter_tpu/ops/hilbert.py``: the support of SQMC, which
orders the particle cloud along a space-filling curve at every step so that
the inverse-CDF resampling consumes its low-discrepancy point set in a
locality-preserving order.

Skilling's AxesToTranspose is branch-free bitwise work over the whole
``(..., d)`` cloud at once, ``bits * d`` rounds of elementwise ops. The
JAX package holds each word as ``uint32``; torch's ``uint32`` lacks most
bitwise kernels, so each word here is an ``int64`` holding a value below
2^32, and every bit of the result is the JAX package's. The Hilbert integer
(up to 64 bits) comes back as the ``(hi, lo)`` pair of such words.

The sort key: ``hi`` reaches 2^31 and above at ``bits * d = 64``, so
``hi << 32 | lo`` in a signed ``int64`` would misorder. :func:`sort_key`
shifts ``hi`` down by 2^31 first (the sign-bit flip), which keeps the
lexicographic order of the pair in one signed word. Every argsort is
stable, as ``jnp.argsort`` and ``jnp.lexsort`` are: a coarse grid ties often.
"""

from __future__ import annotations

import torch


def _axes_to_transpose(coords: torch.Tensor, bits: int) -> list:
    """Skilling's AxesToTranspose on ``coords`` ``(..., d)`` (integers with
    ``bits`` significant bits each): the d transpose-format words, int64."""
    d = coords.shape[-1]
    cols = [coords[..., i].to(torch.int64) for i in range(d)]

    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(d):
            cond = (cols[i] & q) != 0
            if i == 0:
                # the exchange is a no-op for i == 0 (t = 0): only invert
                cols[0] = torch.where(cond, cols[0] ^ p, cols[0])
            else:
                t = torch.where(cond, torch.zeros_like(cols[0]), (cols[0] ^ cols[i]) & p)
                cols[0] = torch.where(cond, cols[0] ^ p, cols[0] ^ t)
                cols[i] = cols[i] ^ t
        q >>= 1

    # Gray encode
    for i in range(1, d):
        cols[i] = cols[i] ^ cols[i - 1]
    t = torch.zeros_like(cols[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((cols[d - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return [c ^ t for c in cols]


def hilbert_keys(coords: torch.Tensor, bits: int):
    """Hilbert index of integer grid coordinates, as a sortable word pair.

    ``coords``: ``(..., d)`` integer grid positions in ``[0, 2^bits)``;
    requires ``bits * d <= 64`` and ``bits >= 2``. Returns ``(hi, lo)``, the
    Hilbert integer's high and low 32-bit words, each an int64 tensor of
    values below 2^32; order them lexicographically (:func:`sort_key`)."""
    d = coords.shape[-1]
    if bits * d > 64:
        raise ValueError(f"bits*d = {bits * d} exceeds the 64-bit key budget")
    if bits < 2:
        raise ValueError("bits must be >= 2")
    words = torch.stack(_axes_to_transpose(torch.as_tensor(coords), bits), dim=-1)  # (..., d)

    # transpose format: bit q of word i is Hilbert bit q*d + (d-1-i); the
    # bits are distinct powers of two, so their sum is their OR
    q = torch.arange(bits, device=words.device).unsqueeze(-1)  # (bits, 1)
    pos = q * d + (d - 1 - torch.arange(d, device=words.device))  # (bits, d)
    bit = (words.unsqueeze(-2) >> q) & 1  # (..., bits, d)
    lo = torch.sum(torch.where(pos < 32, bit << torch.clamp(pos, max=31), 0), dim=(-2, -1))
    hi = torch.sum(torch.where(pos >= 32, bit << torch.clamp(pos - 32, min=0), 0), dim=(-2, -1))
    return hi, lo


def sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One signed int64 whose order is the lexicographic order of ``(hi,
    lo)``: ``(hi - 2^31) * 2^32 + lo`` spans the whole int64 range without
    overflow."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def hilbert_argsort(values: torch.Tensor, bits: int | None = None) -> torch.Tensor:
    """Permutation ordering a particle cloud along the Hilbert curve.

    ``values``: ``(N, d)`` real states, or ``(N,)``, whose order is the
    plain sort. Each dimension is min-max rescaled over the cloud onto the
    ``2^bits`` grid — ``(v - lo) / max(hi - lo, 1e-30) * span`` truncated to
    int32, the JAX package's order of operations, so that the keys match
    bit for bit on the same cloud — then indexed and stably argsorted.
    ``bits`` defaults to the largest grid fitting the 64-bit key (capped at
    16). Returns int32 indices."""
    v = torch.as_tensor(values)
    return cloud_argsort(v.unsqueeze(-1) if v.dim() == 1 else v, bits)


def cloud_argsort(flat: torch.Tensor, bits: int | None = None) -> torch.Tensor:
    """:func:`hilbert_argsort` of every lane of ``flat`` ``(N, *lanes, d)``
    at once, along the particle axis 0 (each lane its own min-max rescale).
    Returns ``(N, *lanes)`` int32 indices."""
    d = flat.shape[-1]
    if d == 1:
        return torch.argsort(flat[..., 0], dim=0, stable=True).to(torch.int32)
    if bits is None:
        bits = min(64 // d, 16)
    span = 1 << bits
    lo_v = torch.amin(flat, dim=0, keepdim=True)
    hi_v = torch.amax(flat, dim=0, keepdim=True)
    unit = (flat - lo_v) / torch.clamp(hi_v - lo_v, min=1e-30)
    grid = torch.clamp((unit * span).to(torch.int32), 0, span - 1)
    hi, lo = hilbert_keys(grid, bits)
    return torch.argsort(sort_key(hi, lo), dim=0, stable=True).to(torch.int32)
