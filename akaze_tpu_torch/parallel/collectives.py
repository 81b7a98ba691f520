"""Collectives over a mesh's shards: the counterparts of ``lax.psum``,
``lax.pmax``, ``lax.all_gather`` and the ``lax.ppermute`` neighbour shift
of the JAX spatial tier (``_extend_rows_of``).

A sharded value is a list with one tensor per local shard of a ``Mesh``,
in the mesh's row-major order, each on its shard's device.  ``shard``
splits a global tensor into such a list and ``replicate`` copies one to
every shard.  A collective over ``axes`` joins the shards that differ
only in those axes:

* sums run in a fixed order, one axis at a time, innermost (first-listed)
  axis first and each axis in index order, so that a run repeats bit for
  bit and a one-process mesh sums as a multi-process one does;
* gathers concatenate in block order (the first-listed axis major, as
  JAX's tiled ``all_gather`` over an axis tuple);
* where an axis spans processes, the same helpers call
  ``torch.distributed`` (``all_reduce``, ``all_gather`` and
  ``batch_isend_irecv``) on the mesh's process group: ``gloo`` for CPU
  tensors, ``nccl`` for CUDA tensors.

``traced()`` records every collective's name and per-shard operand size,
so that tests can bound what crosses the mesh.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, block_index, normalize_axes

_TRACE: Optional[list] = None


@contextlib.contextmanager
def traced():
    """Record (collective name, elements per shard operand) of every
    collective run inside the block into the yielded list."""
    global _TRACE
    outer, _TRACE = _TRACE, []
    try:
        yield _TRACE
    finally:
        _TRACE = outer


def _record(name: str, xs) -> None:
    if _TRACE is not None:
        _TRACE.append((name, max(int(x.numel()) for x in xs)))


def _key(mesh: Mesh, coord: dict, axes) -> tuple:
    """The coordinates outside ``axes``: shards with one key are joined."""
    return tuple(None if a in axes else coord[a] for a in mesh.axis_names)


def shard(x: torch.Tensor, mesh: Mesh, axes="data", dim: int = 0) -> list:
    """The local shards' blocks of a global tensor split evenly along
    ``dim`` over ``axes``, each on its shard's device."""
    axes = normalize_axes(axes)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split into {n} shards")
    blocks = x.chunk(n, dim) if n > 1 else (x,)
    return [blocks[block_index(mesh, c, axes)].to(d).contiguous()
            for c, d in zip(mesh.coords(), mesh.local_devices)]


def replicate(x: torch.Tensor, mesh: Mesh) -> list:
    """``x`` on every local shard's device (one tensor per device)."""
    return [x.to(d) for d in mesh.local_devices]


def _all_reduce(x, op, mesh: Mesh):
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op is torch.maximum
                    else dist.ReduceOp.SUM, group=mesh.group)
    return y


def _reduce(xs, mesh: Mesh, axes, op, name: str, home_only: bool):
    axes = normalize_axes(axes)
    _record(name, xs)
    coords = mesh.coords()
    names = mesh.axis_names
    parts = {tuple(c[a] for a in names): x for c, x in zip(coords, xs)}
    for a in axes:
        k = names.index(a)
        merged = {}
        for key in sorted(parts):      # index order along ``a``
            rest = key[:k] + (None,) + key[k + 1:]
            x = parts[key]
            merged[rest] = (x if rest not in merged
                            else op(merged[rest], x.to(merged[rest].device)))
        if a == mesh.process_axis and mesh.process_count > 1:
            merged = {key: _all_reduce(merged[key], op, mesh)
                      for key in sorted(merged)}
        parts = merged
    if home_only:
        return parts[_key(mesh, coords[0], axes)].to(mesh.home)
    return [parts[_key(mesh, c, axes)].to(x.device)
            for c, x in zip(coords, xs)]


def psum(xs: List[torch.Tensor], mesh: Mesh, axes="data") -> list:
    """Sum over ``axes``, replicated to every shard (``lax.psum``)."""
    return _reduce(xs, mesh, axes, torch.add, "psum", False)


def psum_home(xs: List[torch.Tensor], mesh: Mesh, axes="data"):
    """``psum``, kept once, on the mesh's first local device."""
    return _reduce(xs, mesh, axes, torch.add, "psum", True)


def pmax(xs: List[torch.Tensor], mesh: Mesh, axes="data") -> list:
    """Elementwise maximum over ``axes`` (``lax.pmax``)."""
    return _reduce(xs, mesh, axes, torch.maximum, "pmax", False)


def pmax_home(xs: List[torch.Tensor], mesh: Mesh, axes="data"):
    """``pmax``, kept once, on the mesh's first local device."""
    return _reduce(xs, mesh, axes, torch.maximum, "pmax", True)


def _process_blocks(mesh: Mesh, axes, key, process_index=None) -> list:
    """Block indices a process holds in the group ``key``, ascending."""
    return sorted(block_index(mesh, c, axes)
                  for c in mesh.coords(process_index)
                  if _key(mesh, c, axes) == key)


def all_gather(xs: List[torch.Tensor], mesh: Mesh, axes="data",
               dim: int = 0, home_only: bool = False):
    """Tiled all-gather along ``dim`` over ``axes``: every shard gets the
    blocks of its group concatenated in block order (``lax.all_gather(...,
    tiled=True)``).  ``home_only``: one result, on the first device."""
    axes = normalize_axes(axes)
    _record("all_gather", xs)
    coords = mesh.coords()
    blocks = {}
    for c, x in zip(coords, xs):
        blocks[(_key(mesh, c, axes), block_index(mesh, c, axes))] = x
    if mesh.spans_processes(axes):
        for key in sorted({k for k, _ in blocks}):
            mine = _process_blocks(mesh, axes, key)
            stack = torch.stack([blocks[(key, b)] for b in mine]).contiguous()
            got = [torch.empty_like(stack)
                   for _ in range(mesh.process_count)]
            dist.all_gather(got, stack, group=mesh.group)
            for q, st in enumerate(got):
                for b, t in zip(_process_blocks(mesh, axes, key, q), st):
                    blocks.setdefault((key, b), t)
    n = 1
    for a in axes:
        n *= mesh.shape[a]

    def joined(c, dev):
        key = _key(mesh, c, axes)
        return torch.cat([blocks[(key, b)].to(dev) for b in range(n)], dim)

    if home_only:
        return joined(coords[0], mesh.home)
    return [joined(c, x.device) for c, x in zip(coords, xs)]


def _edge_rows(x, r: int, dim: int, top: bool, edge):
    """Ghost rows at a global edge: reflect-101 of the block's own rows,
    or a constant fill."""
    h = x.shape[dim]
    if edge == "reflect":
        rows = x.narrow(dim, 1, r) if top else x.narrow(dim, h - r - 1, r)
        return rows.flip(dim)
    shape = list(x.shape)
    shape[dim] = r
    return torch.full(shape, edge, dtype=x.dtype, device=x.device)


def extend_rows(xs: List[torch.Tensor], mesh: Mesh, axis: str, r: int,
                dim: int = 0, edge="reflect") -> list:
    """Extend ``dim`` of each shard by ``r`` ghost rows on each side: the
    neighbours' genuine rows at interior seams (JAX's ``ppermute`` shift),
    and at the global top and bottom reflect-101 of the shard's own rows
    (``edge="reflect"``) or a constant (detection maps pad with the 'no
    response' value, descriptor planes with 0).  ``axis``: one mesh axis,
    the shards' blocks in index order."""
    if r == 0:
        return list(xs)
    _record("extend_rows", [x.narrow(dim, 0, r) for x in xs])
    coords = mesh.coords()
    n = mesh.shape[axis]
    where = {(_key(mesh, c, (axis,)), c[axis]): x
             for c, x in zip(coords, xs)}
    for x in xs:
        if x.shape[dim] < r + (1 if edge == "reflect" else 0):
            raise ValueError(f"{x.shape[dim]} rows cannot give {r} ghost "
                             "rows")
    remote = {}
    if mesh.spans_processes(axis):
        remote = _exchange_edges(where, mesh, axis, r, dim)
    out = []
    for c, x in zip(coords, xs):
        key, i = _key(mesh, c, (axis,)), c[axis]
        if i == 0:
            top = _edge_rows(x, r, dim, True, edge)
        else:
            src = where.get((key, i - 1))
            top = (src.narrow(dim, src.shape[dim] - r, r) if src is not None
                   else remote[(key, i - 1)])
        if i == n - 1:
            bot = _edge_rows(x, r, dim, False, edge)
        else:
            src = where.get((key, i + 1))
            bot = (src.narrow(dim, 0, r) if src is not None
                   else remote[(key, i + 1)])
        out.append(torch.cat([top.to(x.device), x, bot.to(x.device)], dim))
    return out


def _exchange_edges(where, mesh: Mesh, axis: str, r: int, dim: int):
    """Rows of the neighbouring processes' edge shards: this process's
    first shard along ``axis`` sends its first ``r`` rows down the ring
    (to process p - 1) and receives p - 1's last rows; its last shard
    sends its last rows to p + 1 and receives p + 1's first rows."""
    p, count = mesh.process_index, mesh.process_count
    local = mesh.local_shape[axis]
    lo, hi = p * local, p * local + local - 1

    def peer(q):
        return (q if mesh.group is None
                else dist.get_global_rank(mesh.group, q))

    ops, got = [], {}
    for key in sorted({k for k, _ in where}):
        first, last = where[(key, lo)], where[(key, hi)]
        if p > 0:
            buf = torch.empty_like(first.narrow(dim, 0, r)).contiguous()
            ops += [dist.P2POp(dist.isend,
                               first.narrow(dim, 0, r).contiguous(),
                               peer(p - 1), mesh.group),
                    dist.P2POp(dist.irecv, buf, peer(p - 1), mesh.group)]
            got[(key, lo - 1)] = buf
        if p < count - 1:
            buf = torch.empty_like(last.narrow(dim, 0, r)).contiguous()
            ops += [dist.P2POp(dist.isend,
                               last.narrow(dim, last.shape[dim] - r,
                                           r).contiguous(),
                               peer(p + 1), mesh.group),
                    dist.P2POp(dist.irecv, buf, peer(p + 1), mesh.group)]
            got[(key, hi + 1)] = buf
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got
