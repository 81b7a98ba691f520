"""Device meshes: named axes over the devices that hold the shards.

Port of ``akaze_tpu/parallel/mesh.py``.  The JAX package shards through
``jax.sharding.Mesh`` and ``shard_map``; here a ``Mesh`` is a grid of
``torch.device``s with axis names, and a sharded value is a list with one
tensor per shard of this process, each on its shard's device
(``parallel/collectives.py`` joins them).  Several shards may lie on one
device: ``make_mesh(4, devices=["cuda:0"] * 4)`` runs a four-shard program
on one card, and ``devices=["cpu"] * 8`` is the tests' counterpart of the
JAX tests' eight virtual CPU devices.

One axis may span processes (``parallel/distributed.py``): this process
holds a contiguous block of that axis, the ``process_index``-th of
``process_count`` equal blocks, and collectives over it go through the
axis's ``torch.distributed`` process group.  Every other axis is local.
"""

from __future__ import annotations

from itertools import product
from typing import Optional, Sequence

import numpy as np
import torch


def normalize_axes(axis) -> tuple:
    """An axis spec (one name, or a sequence of names ordered innermost
    first, such as ``("chip", "host")``) as a tuple of names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """A grid of devices with named axes.

    ``devices``: this process's block of the grid (a numpy object array
    of ``torch.device``, one axis per name).  ``process_axis``: the axis
    whose blocks lie in other processes, or None; ``group`` its process
    group (None: the default group).  Frozen and hashable, so that
    routes and plans can be cached per (plan, mesh)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_axis: Optional[str] = None, group=None):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        count, index = 1, 0
        if process_axis is not None:
            import torch.distributed as dist
            if process_axis not in axis_names:
                raise ValueError(f"process axis {process_axis!r} is not one "
                                 f"of {axis_names}")
            if not dist.is_initialized():
                raise RuntimeError("a process axis needs torch.distributed; "
                                   "call initialize_distributed() first")
            count = dist.get_world_size(group)
            index = dist.get_rank(group)
        grid.setflags(write=False)
        self.devices = grid
        self.axis_names = axis_names
        self.process_axis = process_axis
        self.group = group
        self.process_count = count
        self.process_index = index
        local = dict(zip(axis_names, grid.shape))
        self.local_shape = local
        self.shape = {a: n * (count if a == process_axis else 1)
                      for a, n in local.items()}
        self._key = (axis_names, grid.shape,
                     tuple(str(d) for d in grid.flat), process_axis,
                     count, index, id(group))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return (f"Mesh({self.shape}, devices={devs}"
                + (f", process {self.process_index}/{self.process_count} "
                   f"on {self.process_axis!r}" if self.process_axis else "")
                + ")")

    @property
    def local_devices(self) -> list:
        """The device of each local shard, in row-major (mesh) order."""
        return list(self.devices.flat)

    @property
    def home(self) -> torch.device:
        """The first local shard's device: replicated values live there."""
        return self.devices.flat[0]

    def coords(self, process_index: Optional[int] = None) -> list:
        """Global coordinates (a dict axis -> index) of each shard of a
        process (default: this one), in its local row-major order."""
        p = self.process_index if process_index is None else process_index
        out = []
        for idx in product(*(range(n) for n in self.devices.shape)):
            c = dict(zip(self.axis_names, idx))
            if self.process_axis is not None:
                c[self.process_axis] += p * self.local_shape[
                    self.process_axis]
            out.append(c)
        return out

    def spans_processes(self, axes) -> bool:
        """Whether a collective over ``axes`` crosses processes."""
        return (self.process_count > 1
                and self.process_axis in normalize_axes(axes))


def axis_size(mesh: Mesh, axis) -> int:
    """Total number of shards over one axis or an axis tuple."""
    return int(np.prod([mesh.shape[a] for a in normalize_axes(axis)]))


def block_index(mesh: Mesh, coord: dict, axes) -> int:
    """The block a shard holds of a dimension sharded over ``axes``: its
    coordinates raveled with the first-listed axis major (JAX's order for
    ``PartitionSpec((a, b))``)."""
    b = 0
    for a in normalize_axes(axes):
        b = b * mesh.shape[a] + coord[a]
    return b


def split_shape(n: int, ndim: int) -> tuple:
    """``n`` split into ``ndim`` powers of two as JAX's ``make_mesh``
    splits it (doubling each axis in turn)."""
    if ndim == 1:
        return (n,)
    shape = [1] * ndim
    i = 0
    while np.prod(shape) < n:
        shape[i % ndim] *= 2
        i += 1
    return tuple(shape)


def visible_devices() -> list:
    """Every visible CUDA device (none without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` devices: by default every
    visible CUDA device (raises when fewer than ``n_devices`` are visible,
    as JAX's does); ``devices`` lists them explicitly, repeats allowed
    (``["cuda:0"] * 4``, ``["cpu"] * 8``).

    With several axis names the count is split into powers of two as
    JAX's ``make_mesh`` splits it.  Under ``torch.distributed`` with
    more than one process, ``devices`` (default: every visible card) are
    this process's, and the first axis spans the processes: the mesh has
    ``world_size`` times as many shards."""
    import torch.distributed as dist

    devs = visible_devices() if devices is None else [torch.device(d)
                                                      for d in devices]
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    n = n_devices or len(devs) * world
    if n % world or n // world > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs) * world}")
    shape = split_shape(n, len(axis_names))
    if shape[0] % world:
        raise ValueError(f"axis {axis_names[0]!r} of {shape[0]} shards "
                         f"cannot span {world} processes")
    local = (shape[0] // world,) + shape[1:]
    grid = np.empty(int(np.prod(local)), dtype=object)
    grid[:] = devs[:grid.size]
    return Mesh(grid.reshape(local), axis_names,
                process_axis=axis_names[0] if world > 1 else None)
