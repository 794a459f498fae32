"""Checkpoint / resume at the smoother-sweep boundary (port of
rbslam_tpu/utils/checkpoint.py).

The natural restart point is the end of each CPF-AS sweep k: the state is
the sampled trajectory, the outputs so far and the random state, exactly
what sweep k+1 consumes. Format, shared with the JAX package: one
``ckpt_{step}.npz`` per step, written to a temporary file and renamed;
each leaf of a nested structure of dicts, lists, tuples and NamedTuples
is stored under the key ``jax.tree_util.keystr`` gives its path
(``['a']``, ``['b']['c']``, ``[0]``, ``.field``), so a file written by
either package loads in the other. numpy has no bfloat16: a bfloat16
tensor is stored as its bits (uint16) and gets its dtype back from the
``like`` structure on load.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _leaves(tree: Any, path: str = ""):
    """(key path, leaf) pairs in the order of the structure; None is an
    empty subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(like: Any, values: dict, path: str = ""):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), values,
                                     f"{path}.{f}") for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, f"{path}[{i}]")
                          for i, v in enumerate(like))
    return values[path]


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _restore(arr: np.ndarray, like: torch.Tensor, key: str,
             path: str) -> torch.Tensor:
    """``arr`` as a tensor of the dtype and device of ``like``; a dtype that
    differs is refused, never cast."""
    if like.dtype == torch.bfloat16:
        if arr.dtype != np.uint16:
            raise ValueError(f"{path} {key}: bfloat16 leaf stored as "
                             f"{arr.dtype}, expected its uint16 bits")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        want = torch.empty(0, dtype=like.dtype).numpy().dtype
        if arr.dtype != want:
            raise ValueError(f"{path} {key}: stored {arr.dtype}, "
                             f"expected {want}")
        t = torch.from_numpy(arr.copy())
    return t.to(like.device)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Save a nested structure of tensors as ckpt_{step}.npz (atomic
    rename). Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _to_numpy(v) for k, v in _leaves(tree)})
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest step saved in ``directory``; None if there is none or
    the directory does not exist."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _STEP_RE.search(f))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore a structure saved by save_checkpoint (either package's).
    ``like`` gives the structure, and each tensor leaf the dtype and device
    of the one restored in its place; its values and shapes are ignored."""
    path = os.path.join(directory, f"ckpt_{step}.npz")
    with np.load(path) as data:
        values = {}
        for key, leaf in _leaves(like):
            if key not in data.files:
                raise ValueError(f"{path} has no leaf {key}")
            values[key] = _restore(data[key], leaf, key, path)
    return _rebuild(like, values)
