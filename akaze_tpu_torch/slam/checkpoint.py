"""Checkpoint / resume for SLAM map state.

Port of ``akaze_tpu/slam/checkpoint.py``, with the same file format, so
that a file written by either package loads in the other: a single
``.npz`` written atomically (tmp file + rename) holding ``leaf_<i>`` arrays
and a JSON metadata entry.  Leaves are ordered as ``jax.tree.flatten``
orders them (``tree_flatten``): dict entries by sorted key, list and tuple
entries in order, ``None`` a node with no leaves.  The ``treedef`` string
of the metadata is written for readers and never read back.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_META_KEY = "__checkpoint_meta__"


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, description of the structure)."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, desc = tree_flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for v in tree:
            sub, desc = tree_flatten(v)
            leaves += sub
            parts.append(desc)
        body = ", ".join(parts)
        return leaves, f"[{body}]" if isinstance(tree, list) else f"({body})"
    return [tree], "*"


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves are ``leaves`` in
    ``tree_flatten`` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else type(node)(vals))
        return next(it)

    return build(like)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _ckpt_files(path: str) -> List[str]:
    return sorted(f for f in os.listdir(path)
                  if f.startswith("ckpt_") and f.endswith(".npz"))


def save_checkpoint(path: str, state: Any, metadata: Dict | None = None,
                    keep: int = 3) -> str:
    """Atomically write ``state`` (a tree of arrays or tensors) to ``path``.

    If ``path`` ends with ``.npz`` it is written directly; otherwise it is
    a directory, and a monotonically numbered ``ckpt_NNNNNN.npz`` is
    created inside, keeping the last ``keep`` files.
    Returns the file written.
    """
    leaves, desc = tree_flatten(state)
    arrays = {f"leaf_{i}": _numpy(v) for i, v in enumerate(leaves)}
    meta = {"treedef": desc, "n_leaves": len(leaves),
            "metadata": metadata or {}}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)

    if path.endswith(".npz"):
        target = path
        directory = os.path.dirname(path) or "."
    else:
        os.makedirs(path, exist_ok=True)
        existing = _ckpt_files(path)
        step = (int(existing[-1][5:-4]) + 1) if existing else 0
        target = os.path.join(path, f"ckpt_{step:06d}.npz")
        directory = path

    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    if not path.endswith(".npz"):
        for old in _ckpt_files(path)[:-keep]:
            os.unlink(os.path.join(path, old))
    return target


def load_checkpoint(path: str, like: Any = None) -> Tuple[Any, Dict]:
    """Load a checkpoint.  ``path`` may be a ``.npz`` file or a directory
    (its latest checkpoint is read).  With ``like`` (a tree of the same
    structure) the result has that structure; otherwise it is the flat
    list of numpy arrays.

    Returns (state, metadata).
    """
    if not path.endswith(".npz"):
        files = _ckpt_files(path)
        if not files:
            raise FileNotFoundError(f"no checkpoints in {path}")
        path = os.path.join(path, files[-1])
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if like is None:
        return leaves, meta["metadata"]
    n = len(tree_flatten(like)[0])
    if n != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, prototype "
                         f"has {n}")
    return tree_unflatten(like, leaves), meta["metadata"]


def latest_step(path: str) -> int:
    """Highest checkpoint number in a directory, or -1 if none."""
    if not os.path.isdir(path):
        return -1
    files = _ckpt_files(path)
    return int(files[-1][5:-4]) if files else -1
