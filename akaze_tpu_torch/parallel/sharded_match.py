"""Descriptor matching sharded across a mesh.

Port of ``akaze_tpu/parallel/sharded_match.py``.  Query descriptors are
sharded over the ``data`` axis, train descriptors are all-gathered (in
mesh order), re-compacted to a valid prefix, and each shard runs K4
(``match.match``) on its block of queries against the whole train set.
"""

from __future__ import annotations

import torch

from ..match import Matches, match
from . import collectives as col
from .mesh import Mesh, normalize_axes


def prefix_rows(valid, size: int):
    """The rows of the first ``size`` valid entries, in order: (sel [size]
    int64, 0 past the valid count; live [size] bool, the valid prefix;
    the total valid count, int32).  A prefix sum and a scatter: no host
    synchronisation."""
    n = valid.shape[0]
    dev = valid.device
    pos = valid.to(torch.int64).cumsum(0) - 1
    slot = torch.where(valid & (pos < size), pos,
                       torch.full_like(pos, size))
    sel = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    sel.scatter_(0, slot, torch.arange(n, device=dev))
    total = valid.sum(dtype=torch.int32)
    live = torch.arange(size, device=dev) < total
    return (torch.where(live, sel[:size], torch.zeros_like(sel[:size])),
            live, total)


def compact_train(words, valid, x, y):
    """Re-compact a train set to a valid-prefix layout.

    A gathered multi-source set (per-shard prefixes concatenated by the
    all-gather) leaves dead slots between the shard prefixes; K4 bounds
    its scan by the last live row (``ops.hamming.last_live``), so the
    holes would be scanned at full cost.  A prefix-sum compaction restores
    the valid-prefix invariant, so the scan extent equals the live count.

    Returns (words, valid, x, y, sel): compacted tensors of the same
    capacity plus the source-index map (``sel[k]`` = original row of
    compacted row k, 0 for dead rows), for mapping match indices back to
    gathered order."""
    sel, live, _ = prefix_rows(valid, valid.shape[0])
    return (torch.where(live[:, None], words[sel],
                        torch.zeros_like(words[sel])),
            live, x[sel], y[sel], sel)


def _pieces(v, mesh: Mesh, axis) -> list:
    return list(v) if isinstance(v, (list, tuple)) else col.shard(v, mesh,
                                                                  axis)


def sharded_match(words1, valid1, words2, valid2, x2, y2, mesh: Mesh,
                  max_dist: int = 96, axis="data") -> list:
    """1-NN Hamming matching with queries sharded over ``axis``.

    Each argument is a global tensor (split over the axis here) or the
    list of this process's per-shard pieces.  The train set is
    all-gathered, compacted, and matched by each shard's K4 launch.
    Returns one ``Matches`` per local shard, for its block of queries;
    indices refer to the gathered (shard-major slot) order, as in the JAX
    package.  ``axis`` may be an innermost-first tuple."""
    axis = normalize_axes(axis)
    w1, v1, w2, v2, xx2, yy2 = (_pieces(v, mesh, axis) for v in (
        words1, valid1, words2, valid2, x2, y2))
    w2g, v2g, x2g, y2g = (col.all_gather(v, mesh, axis)
                          for v in (w2, v2, xx2, yy2))
    out = []
    for q, qv, tw, tv, tx, ty in zip(w1, v1, w2g, v2g, x2g, y2g):
        w2c, v2c, x2c, y2c, sel = compact_train(tw, tv, tx, ty)
        m = match(q, qv, w2c, v2c, x2c, y2c, max_dist)
        # compacted row -> gathered slot, so that callers index the
        # gathered train tensors with Matches.index as before
        idx = torch.where(m.index >= 0, sel[m.index.clamp(min=0).long()]
                          .to(torch.int32), torch.full_like(m.index, -1))
        out.append(m._replace(index=idx))
    return out
