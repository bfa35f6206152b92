"""Checkpoint / resume for the sampler's chain state.

Port of ``nuts_rs_tpu/checkpoint.py``.  The whole chain state is one tree
of tensors (``chain.ChainState``: the point, the transform, affine or a
flow's parameters, the diagonal estimators, the step-size state, the
good-draw window counters and the strategy's own state, such as a flow's
training window) and the integer draw index, so a checkpoint is a flatten
plus ``np.savez`` in the JAX package's layout: ``leaf_{i}``, the leaf count
``__num_leaves__``, the cursor ``__next_draw__`` and ``__key_leaves__``,
which is empty here.  There are no PRNG keys to save: every random number
of the port comes from the counter hash of (base seed, draw index,
purpose), so the draw index is the random state, and a resumed run is
bit-identical to an uninterrupted one.  Tensors come back on the device
and in the dtype of the tree they are loaded into, so a checkpoint written
on the card restores on the CPU and the other way round.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch


def state_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in a fixed order: tensors and Python numbers,
    through named tuples, tuples, lists and dicts (a flow's parameters);
    None is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, int, float, bool)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in state_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in state_leaves(v)]
    raise TypeError(f"checkpoint: unsupported state leaf {type(tree)!r}")


def rebuild_state(like, leaves):
    """``like`` with its leaves taken, in order, from the iterable
    ``leaves``."""
    return _rebuild(like, iter(leaves))


def _rebuild(like, leaves):
    if like is None:
        return None
    if isinstance(like, (torch.Tensor, int, float, bool)):
        return next(leaves)
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    return type(like)(_rebuild(v, leaves) for v in like)


def save_state(path: str, state: Any, next_draw: int) -> None:
    save_leaves(path, state_leaves(state), next_draw)


def save_leaves(path: str, leaves: List[Any], next_draw: int) -> None:
    """A checkpoint of the state whose leaves are ``leaves`` (tensors on
    any device, host copies included, and Python numbers)."""
    arrays = {}
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"] = (leaf.detach().cpu().numpy()
                               if isinstance(leaf, torch.Tensor)
                               else np.asarray(leaf))
    arrays["__key_leaves__"] = np.zeros(0, np.int64)
    arrays["__next_draw__"] = np.asarray(next_draw, np.int64)
    arrays["__num_leaves__"] = np.asarray(len(leaves), np.int64)
    np.savez(path, **arrays)


def load_state(path: str, like: Any) -> Tuple[Any, int]:
    """Restore a state saved by :func:`save_state`.

    ``like`` provides the tree's structure, and each tensor leaf's device
    and dtype; typically the freshly initialized state of a Sampler built
    with the same settings.  Raises ``ValueError`` for a checkpoint whose
    leaf count or a leaf's shape differs from ``like``'s."""
    with np.load(path) as data:
        n = int(data["__num_leaves__"])
        raw = [data[f"leaf_{i}"] for i in range(n)]
        next_draw = int(data["__next_draw__"])

    like_leaves = state_leaves(like)
    if len(like_leaves) != n:
        raise ValueError(
            f"checkpoint has {n} leaves, expected {len(like_leaves)} — "
            "was it written with different settings?")
    leaves = []
    for i, (arr, ref) in enumerate(zip(raw, like_leaves)):
        shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
        if arr.shape != shape:
            raise ValueError(
                f"checkpoint leaf {i} has shape {arr.shape}, expected "
                f"{shape} — different model/chain configuration?")
        if isinstance(ref, torch.Tensor):
            leaves.append(torch.from_numpy(np.array(arr)).to(
                device=ref.device, dtype=ref.dtype))
        else:
            leaves.append(type(ref)(arr))
    return rebuild_state(like, leaves), next_draw
