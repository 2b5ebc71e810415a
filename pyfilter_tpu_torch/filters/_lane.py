"""Lane surgery and lane-vmapped filtering shared by the Gaussian family.

Counterpart of ``pyfilter_tpu/filters/_lane.py``. The inference algorithms
run K independent filters through one set of tensor ops and perform "lane
surgery" on the results: ``resample(indices)`` permutes lanes,
``exchange(other, mask)`` swaps accepted lanes, ``lane_concat`` rebuilds a
swarm from chain segments. Every Gaussian-family state is a NamedTuple whose
tensor leaves are lane-leading once vmapped (the time index is the host's
float, the same for every lane), so one implementation serves them all.

``lane_vmap_batch_filter`` is the lane-batching engine: ``torch.func.vmap``
over the model's tensor leaves. A PyTorch model is a plain object, not a
pytree, and ``vmap`` batches only the tensors passed to it, so
:func:`model_leaves` walks the model's attributes for its tensors and
:func:`rebuild` puts new ones in their place (shallow copies, the functions
and other static parts shared). The leaves whose leading axis equals the lane
count ride the lane axis; the rest are broadcast constants. Inside the vmap
each filter sees single-lane shapes, so its shape probing is unchanged.
"""

from __future__ import annotations

import copy
import types

import torch

_STATIC = (str, bytes, int, float, complex, bool, type(None), torch.device, torch.dtype, torch.Generator,
           types.ModuleType)


def model_leaves(obj) -> list:
    """The tensors ``obj`` holds, in a fixed walk order: tuples, lists and
    dicts element by element, other objects attribute by attribute;
    functions and other callables are static and are not entered."""
    leaves: list = []
    _walk(obj, leaves.append, set())
    return leaves


def _walk(obj, visit, seen: set) -> None:
    if isinstance(obj, torch.Tensor):
        visit(obj)
    elif isinstance(obj, _STATIC) or callable(obj) or id(obj) in seen:
        return
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            _walk(item, visit, seen)
    elif isinstance(obj, dict):
        for item in obj.values():
            _walk(item, visit, seen)
    elif hasattr(obj, "__dict__"):
        seen.add(id(obj))
        for item in vars(obj).values():
            _walk(item, visit, seen)


def structure(obj, values: bool = False) -> str:
    """The classes and container shapes around ``obj``'s tensor leaves: two
    models with the same structure differ only in their leaves' values and,
    unless ``values``, in their static parts' (numbers, strings, which
    function a callable is: with ``values`` these are part of it too)."""
    if isinstance(obj, torch.Tensor):
        return "T"
    if isinstance(obj, _STATIC) or callable(obj):
        if not values or isinstance(obj, (torch.Generator, types.ModuleType)):
            return type(obj).__name__
        return repr(obj) if isinstance(obj, _STATIC) else f"{type(obj).__name__}:{_qualified(obj)}"
    if isinstance(obj, (tuple, list)):
        return f"{type(obj).__name__}({','.join(structure(i, values) for i in obj)})"
    if isinstance(obj, dict):
        return "{" + ",".join(f"{k}:{structure(v, values)}" for k, v in obj.items()) + "}"
    if hasattr(obj, "__dict__"):
        return f"{type(obj).__name__}<{','.join(f'{k}:{structure(v, values)}' for k, v in vars(obj).items())}>"
    return repr(obj) if values else type(obj).__name__


def _qualified(fn) -> str:
    """A callable's module and qualified name (its type's for an instance)."""
    named = fn if hasattr(fn, "__qualname__") else type(fn)
    return f"{getattr(named, '__module__', '')}.{named.__qualname__}"


def rebuild(obj, leaves):
    """``obj`` with its tensor leaves replaced, in :func:`model_leaves`'s
    order, by ``leaves``: containers and objects are rebuilt as shallow
    copies, everything static is shared."""
    it = iter(leaves)
    out = _rebuild(obj, it, {})
    if next(it, None) is not None:
        raise ValueError("more leaves than the object holds")
    return out


def _rebuild(obj, it, memo: dict):
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, _STATIC) or callable(obj):
        return obj
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, (tuple, list)):
        items = [_rebuild(i, it, memo) for i in obj]
        if isinstance(obj, list):
            return items
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    if isinstance(obj, dict):
        return type(obj)((k, _rebuild(v, it, memo)) for k, v in obj.items())
    if hasattr(obj, "__dict__"):
        new = memo[id(obj)] = copy.copy(obj)
        for name, value in list(vars(obj).items()):
            setattr(new, name, _rebuild(value, it, memo))
        return new
    return obj


def lane_exchange(state, other, mask):
    """Lanes where ``mask`` is True take ``other``'s values (tensor leaf by
    leaf, the mask broadcast over trailing event axes)."""

    def mix(mine, theirs):
        if not isinstance(mine, torch.Tensor):
            return mine
        m = mask.reshape(tuple(mask.shape) + (1,) * (mine.dim() - mask.dim()))
        return torch.where(m, theirs, mine)

    return type(state)(*(mix(a, b) for a, b in zip(state, other)))


def lane_resample(state, indices):
    """Permute the leading lane axis of every tensor leaf by ``indices``."""
    idx = indices.long()
    return type(state)(*(leaf.index_select(0, idx) if isinstance(leaf, torch.Tensor) else leaf for leaf in state))


def lane_concat(cls, states):
    """Concatenate states along the leading lane axis (a swarm rebuilt from
    chain segments)."""
    return cls(*(torch.cat(leaves, dim=0) if isinstance(leaves[0], torch.Tensor) else leaves[0]
                 for leaves in zip(*states)))


def lane_axes(model, k: int) -> list:
    """The vmap axis of each of ``model``'s tensor leaves: 0 where the leading
    axis equals the lane count, None (broadcast) otherwise.

    Heuristic caveat, as in the JAX package: a CONSTANT leaf whose leading
    dimension happens to equal ``k`` would be mis-batched; keep lane counts
    away from small structural sizes (regime counts, event dims), as real
    inference configurations (K in the hundreds) do."""
    return [0 if (leaf.dim() >= 1 and leaf.shape[0] == k) else None for leaf in model_leaves(model)]


def swap_result_lanes(res):
    """vmap puts the lane axis first; per-step ``FilterResult`` leaves are
    time-major with lanes second (the convention ``exchange``/``resample``
    rely on), so swap them. ``latest_state`` stays lane-leading."""

    def swap(a):
        return None if a is None else a.movedim(0, 1)

    return res._replace(
        step_log_likelihoods=swap(res.step_log_likelihoods),
        filter_means=swap(res.filter_means),
        filter_variances=swap(res.filter_variances),
        aux=swap(res.aux),
    )


def state_tensors(state) -> list:
    """A state NamedTuple's tensor fields, in order."""
    return [v for v in state if isinstance(v, torch.Tensor)]


def refill(template, tensors):
    """``template`` (a state NamedTuple) with its tensor fields, in order,
    replaced by ``tensors``; the host fields (the time index) kept."""
    it = iter(tensors)
    return type(template)(*(next(it) if isinstance(v, torch.Tensor) else v for v in template))


def _over_lanes(fn, model, k: int, extra=(), randomness: str = "error"):
    """``fn(model_lane, *extra_lane)`` for each of ``k`` lanes through one
    ``torch.func.vmap`` over ``model``'s lane leaves (:func:`lane_axes`) and
    the lane-leading tensors ``extra``."""
    leaves = model_leaves(model)
    axes = lane_axes(model, k)
    batched = [leaf for leaf, ax in zip(leaves, axes) if ax == 0]

    def one_lane(*args):
        it = iter(args[:len(batched)])
        return fn(rebuild(model, [next(it) if ax == 0 else leaf for leaf, ax in zip(leaves, axes)]),
                  *args[len(batched):])

    return torch.func.vmap(one_lane, randomness=randomness)(*batched, *extra)


def _started(filt, start):
    """``filt``, whose ``initialize()`` now returns ``start`` (when given)."""
    if start is not None:
        filt.initialize = lambda: start
    return filt


def lane_vmap_initialize(make_filter, model, batch_shape):
    """``make_filter(model_lane).initialize()`` per lane (one vmap, as
    :func:`lane_vmap_batch_filter`): the deterministic filters' initial
    states, lane-leading."""
    if not batch_shape:
        return make_filter(model).initialize()
    holder = {}

    def one_lane(mdl):
        holder["state"] = make_filter(mdl).initialize()
        return tuple(state_tensors(holder["state"]))

    out = _over_lanes(one_lane, model, int(batch_shape[0]))
    return refill(holder["state"], out)


def lane_vmap_batch_filter(make_filter, model, batch_shape, y, generator=None, stochastic: bool = False,
                           start=None):
    """``make_filter(model_lane).batch_filter(...)`` per lane through one
    ``torch.func.vmap`` over the model's tensor leaves.

    ``stochastic``: filters whose pass draws (EnKF, ETKF) are called with
    ``generator``, under ``randomness="different"`` (each lane its own
    draws); deterministic filters (GSF, IMM, EKF, UKF) as ``batch_filter(y)``.
    ``start``: the deterministic filters' initial state, lane-leading (from
    :func:`lane_vmap_initialize`), in place of each lane's ``initialize()``."""
    if len(batch_shape) > 1:
        raise ValueError("Gaussian-family lane batching supports one lane axis")

    def run(filt):
        return filt.batch_filter(generator, y) if stochastic else filt.batch_filter(y)

    if not batch_shape:
        return run(_started(make_filter(model), start))

    holder = {}

    def one_lane(mdl, *lane_start):
        res = run(_started(make_filter(mdl), refill(start, lane_start) if lane_start else None))
        # vmap returns tensors only: the host's time index and the absent
        # fields are put back outside
        holder["state"] = res.latest_state
        holder["aux"] = res.aux is not None
        extra = (res.aux,) if res.aux is not None else ()
        return (res.log_likelihood, res.step_log_likelihoods, res.filter_means, res.filter_variances,
                *state_tensors(res.latest_state), *extra)

    out = _over_lanes(one_lane, model, int(batch_shape[0]), () if start is None else state_tensors(start),
                      randomness="different" if stochastic else "error")
    ll, step_lls, means, variances = out[:4]
    n_state = len(state_tensors(holder["state"]))
    state = refill(holder["state"], out[4:4 + n_state])
    aux = out[4 + n_state] if holder["aux"] else None
    from .result import FilterResult

    return swap_result_lanes(FilterResult(ll, step_lls, means, variances, state, None, aux))
