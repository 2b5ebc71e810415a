"""Checkpoint persistence.

Counterpart of ``pyfilter_tpu/io.py``:

- :func:`save_state_dict` / :func:`load_state_dict` — the nested
  dict-of-arrays state dicts of the algorithm states and the inference
  context as one ``.npz`` file with a JSON manifest of the structure, numpy
  and json only. The file format is the JAX package's, so a checkpoint
  written by either package loads in the other. Tensors are written from
  whatever device they lie on; loading returns numpy arrays, which the
  states' and the context's ``load_state_dict`` put on their own device.
- :func:`save_pytree` / :func:`load_pytree` — any nested structure of
  tensors (a filter's correction, a model's parameters) as its ordered
  leaves, through ``torch.save`` and ``torch.load(weights_only=True)``;
  ``target=`` supplies the structure back.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

_SCALAR_TYPES = (int, float, bool, str)


def _flatten(obj: Any, prefix: str, out: Dict[str, np.ndarray], manifest: Dict[str, Any]):
    if isinstance(obj, dict):
        manifest[prefix] = {"type": "dict", "keys": list(obj.keys())}
        for k, v in obj.items():
            _flatten(v, f"{prefix}/{k}", out, manifest)
    elif isinstance(obj, (list, tuple)):
        manifest[prefix] = {"type": "list" if isinstance(obj, list) else "tuple", "len": len(obj)}
        for i, v in enumerate(obj):
            _flatten(v, f"{prefix}/{i}", out, manifest)
    elif isinstance(obj, _SCALAR_TYPES) and not isinstance(obj, np.generic):
        manifest[prefix] = {"type": "scalar", "value": obj}
    elif obj is None:
        manifest[prefix] = {"type": "none"}
    else:
        manifest[prefix] = {"type": "array"}
        out[prefix] = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)


def _unflatten(prefix: str, arrays: Dict[str, np.ndarray], manifest: Dict[str, Any]):
    info = manifest[prefix]
    t = info["type"]
    if t == "dict":
        return {k: _unflatten(f"{prefix}/{k}", arrays, manifest) for k in info["keys"]}
    if t in ("list", "tuple"):
        seq = [_unflatten(f"{prefix}/{i}", arrays, manifest) for i in range(info["len"])]
        return seq if t == "list" else tuple(seq)
    if t == "scalar":
        return info["value"]
    if t == "none":
        return None
    return arrays[prefix]


def save_state_dict(path: str, state_dict: dict) -> None:
    """Write a nested ``state_dict`` (dicts, lists and tuples of arrays or
    tensors, numbers, strings and ``None``) to one ``.npz`` file with an
    embedded structure manifest."""
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {}
    _flatten(state_dict, "root", arrays, manifest)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state_dict(path: str) -> dict:
    """The inverse of :func:`save_state_dict`; arrays come back as numpy."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode("utf-8"))
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    return _unflatten("root", arrays, manifest)


def _children(tree):
    """A node's children and a function rebuilding the node from new
    children, or None for a leaf. Nodes: dicts (sorted keys, as pytrees
    order them), lists, tuples, NamedTuples and objects holding a
    ``TimeseriesState``-like ``(time_index, value)`` pair."""
    from .timeseries import TimeseriesState

    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda ch: type(tree)(zip(keys, ch))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree), lambda ch: type(tree)(*ch)
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda ch: type(tree)(ch)
    if isinstance(tree, TimeseriesState):
        return [tree.time_index, tree.value], lambda ch: TimeseriesState(ch[0], ch[1], tree.event_ndim)
    return None


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order (:func:`_children`'s nodes)."""
    node = _children(tree)
    if node is None:
        return [] if tree is None else [tree]
    return [leaf for child in node[0] for leaf in tree_leaves(child)]


def _rebuild(target, leaves):
    node = _children(target)
    if node is None:
        if target is None:
            return None
        leaf = next(leaves)
        if isinstance(target, torch.Tensor):
            return leaf.to(device=target.device, dtype=target.dtype)
        return type(target)(leaf.item()) if isinstance(target, (int, float)) else leaf
    children, build = node
    return build([_rebuild(child, leaves) for child in children])


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree``'s ordered leaves (:func:`tree_leaves`) with
    ``torch.save``, each as a CPU tensor."""
    leaves = [leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
              for leaf in tree_leaves(tree)]
    torch.save(leaves, os.path.abspath(path))


def load_pytree(path: str, target: Any = None) -> Any:
    """Read what :func:`save_pytree` wrote: the list of CPU tensors, or, with
    ``target`` (an example of the structure), that structure with the
    loaded leaves, each on its target leaf's device and dtype."""
    leaves = torch.load(os.path.abspath(path), weights_only=True)
    if target is None:
        return leaves
    it = iter(leaves)
    out = _rebuild(target, it)
    if next(it, None) is not None:
        raise ValueError("the file holds more leaves than the target")
    return out
