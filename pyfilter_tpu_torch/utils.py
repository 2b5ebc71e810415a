"""Core weight numerics for sequential Monte Carlo, in PyTorch.

Counterpart of ``pyfilter_tpu/utils.py``: ``normalize``, ``normalize_log``,
``get_ess``, ``log_likelihood``, ``get_mean_and_variance``,
``construct_diag_from_flat`` and ``batched_gather``, with the same conventions — the PARTICLE axis is axis 0,
lane axes follow, event axes come last. ``normalize`` scrubs NaN and +inf
log-weights to -inf and backfills lanes whose weights are all -inf with the
uniform 1/N.

Also the port's device rule (:func:`resolve_device`): entry points run on
the card unless the caller asks for the CPU, and the CUDA-graph capture the
host-bound loops replay (:func:`cuda_graph`), :func:`draws_of`, with which
the code that makes a random draw declares which of its axes a sharded run
splits over its ranks, and the Gumbel noise of every Gumbel-max draw
(:func:`gumbel`; ``filters.particle.base`` imports it, and its ``gumbel`` is
the name a replay patches).
"""

from __future__ import annotations

import contextlib
import math

import torch


#: the draw modes of the sharded runs entered (``parallel._shards.ShardedDraws``),
#: innermost last: :func:`draws_of` declares to it
_DRAW_MODES: list = []


def draws_of(particles: tuple | None = None, lanes: tuple | None = None):
    """Declare the draws made inside to the draw mode of a sharded run (a
    no-op without one). A draw whose shape begins with ``particles`` (a
    filter's ``(N, *batch)``) carries the particle axis at 0 and the lane
    axis at 1; one whose shape begins with ``lanes`` (``(K, ...)``) carries
    the lane axis at 0. Such an axis is sharded where it holds this rank's
    share: the particle axis when its extent is the shard's local count, the
    lane axis likewise (a draw over every lane is the same on every rank).
    ``draws_of()`` declares draws that carry no sharded axis."""
    if not _DRAW_MODES:
        return contextlib.nullcontext()
    layouts = tuple((kind, tuple(shape), 0) for kind, shape in (("particles", particles), ("lanes", lanes)) if shape)
    return _DRAW_MODES[-1].declared(layouts)


def draws_after(n_lead: int):
    """Declare that the draws inside carry ``n_lead`` leading axes (sub-steps,
    samples) before the layouts declared around them (:func:`draws_of`)."""
    if not _DRAW_MODES:
        return contextlib.nullcontext()
    return _DRAW_MODES[-1].shifted(n_lead)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device`` says
    otherwise. Raises when the card is asked for (or defaulted to) and no
    CUDA device is present — the port never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def cuda_graph(fn, inputs, device, generator=None):
    """``fn(*inputs)`` captured as a CUDA graph on ``device``: one eager call
    on a side stream first (the capture's warm-up, on copies of ``inputs``;
    ``generator``'s state is restored after it, so it consumes no draws),
    then the capture over the graph's own copies of ``inputs``, with
    ``generator`` registered so that every replay draws on from where the
    last left off. ``fn`` must not read the device back to the host.

    Returns ``(replay, warm)``: ``replay(*inputs)`` copies ``inputs`` into
    the graph's tensors, replays it and returns its outputs (the graph's own
    tensors, which the next replay overwrites); ``warm`` is the warm-up
    call's result."""
    static = [t.detach().clone() for t in inputs]
    rng = None if generator is None else generator.get_state()
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm = fn(*(t.clone() for t in static))
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        generator.set_state(rng)
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        out = fn(*static)

    def replay(*new):
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        return out

    return replay, warm


def same_device(a, b) -> bool:
    """``torch.device`` equality that treats ``cuda`` and ``cuda:<current>``
    as one device."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def _scrub(log_weights: torch.Tensor) -> torch.Tensor:
    """NaN / +inf log-weights -> -inf (one pass)."""
    return torch.nan_to_num(
        log_weights, nan=-math.inf, posinf=-math.inf, neginf=-math.inf
    )


def normalize_log(log_weights: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Normalized log-probabilities over ``dim``; dead lanes -> uniform log(1/N)."""
    lw = _scrub(log_weights)
    n = lw.shape[dim]
    norm = torch.logsumexp(lw, dim=dim, keepdim=True)
    return torch.where(torch.isneginf(norm), -math.log(n), lw - norm)


def normalize(log_weights: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Log-weights -> normalized probabilities over ``dim``.

    NaN/+inf are treated as zero mass; lanes with zero total mass are
    backfilled with the uniform distribution 1/N."""
    return torch.exp(normalize_log(log_weights, dim=dim))


def get_ess(weights: torch.Tensor, normalized: bool = False, dim: int = 0) -> torch.Tensor:
    """Effective sample size ``1 / sum_i w_i^2`` over ``dim``; ``weights`` are
    log-weights unless ``normalized`` is True."""
    w = weights if normalized else normalize(weights, dim=dim)
    return 1.0 / torch.sum(torch.square(w), dim=dim)


def log_likelihood(
    inc_weights: torch.Tensor, weights: torch.Tensor | None = None, dim: int = 0
) -> torch.Tensor:
    """Per-step log-likelihood estimate ``log sum_i w_i exp(v_i)`` from the
    incremental log-weights ``v`` and the previous normalized probabilities
    ``w`` (uniform 1/N when omitted)."""
    if weights is None:
        return torch.logsumexp(inc_weights, dim=dim) - math.log(inc_weights.shape[dim])
    return torch.logsumexp(inc_weights + torch.log(weights), dim=dim)


def get_mean_and_variance(
    x: torch.Tensor, probs: torch.Tensor, event_ndim: int = 0, covariance: bool = False, reduce=None
):
    """Weighted mean and variance (or, for ``event_ndim == 1`` with
    ``covariance=True``, covariance) of a particle cloud ``x`` of shape
    ``(N, *batch, *event)`` under probabilities ``probs`` of shape ``(N, *batch)``.
    ``reduce``, when given, takes each sum over the particle axis to the sum
    over the whole cloud (an all-reduce over the shards of a sharded one)."""
    if event_ndim > 1:
        raise ValueError("event_ndim must be 0 or 1")
    total = (lambda t: t) if reduce is None else reduce
    if event_ndim == 0:
        mean = total(torch.sum(probs * x, dim=0))
        var = total(torch.sum(probs * torch.square(x - mean), dim=0))
        return mean, var
    w = probs.unsqueeze(-1)
    mean = total(torch.sum(w * x, dim=0))
    centered = x - mean
    if not covariance:
        return mean, total(torch.sum(w * torch.square(centered), dim=0))
    return mean, total(torch.einsum("n...i,n...j->...ij", w * centered, centered))


def construct_diag_from_flat(x: torch.Tensor, event_ndim: int = 1) -> torch.Tensor:
    """Batched diagonal matrix from a flat scale: ``event_ndim`` 0 takes a
    scalar to ``(..., 1, 1)``, 1 takes ``(..., d)`` to ``(..., d, d)``."""
    if event_ndim == 0:
        return x[..., None, None]
    if event_ndim == 1:
        if x.shape[-1] == 1:
            return x[..., None]
        return x[..., None] * torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    raise ValueError("event rank must be <= 1")


def gumbel(generator, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise ``-log(E)``, ``E ~ Exp(1)`` drawn by
    ``exponential_`` (never 0, unlike a uniform whose ``-log(-log(U))`` can
    be infinite), with ``like``'s dtype and device."""
    return -torch.log(torch.empty(shape, dtype=like.dtype, device=like.device).exponential_(generator=generator))


def batched_gather(x: torch.Tensor, indices: torch.Tensor, event_ndim: int = 0) -> torch.Tensor:
    """Gather along the particle axis (axis 0), broadcasting over trailing
    event axes: ``x`` is ``(N, *batch, *event)``, ``indices`` ``(N, *batch)``."""
    idx = indices.long()
    while idx.dim() < x.dim():
        idx = idx.unsqueeze(-1)
    idx = idx.expand(*indices.shape, *x.shape[indices.dim():])
    return torch.gather(x, 0, idx)
