"""Multi-process runtime: process bootstrap, (host, chip) meshes and
hierarchical sums.

Port of ``akaze_tpu/parallel/distributed.py``.  Every process drives its
own devices; a mesh's ``host`` axis spans the processes and its ``chip``
axis each process's local devices, so that collectives over ``chip`` stay
in the process and only the summaries of the sharded solvers (such as
distributed BA's [C, 6] camera-side sums) cross between processes.

Launch one process per host (or per group of cards) with ``torchrun``,
which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``::

    torchrun --nproc-per-node 2 my_script.py     # calls
    initialize_distributed()                     # -> True

or pass ``init_method="tcp://host:port"``, ``world_size`` and ``rank``.
Single-process use needs no call: a (1, n) host/chip mesh or a purely
local mesh runs the same programs.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from . import collectives as col
from .mesh import Mesh, visible_devices

HOST_AXIS = "host"
CHIP_AXIS = "chip"
# sum order: within a process first, then across processes
HIER_AXES = (CHIP_AXIS, HOST_AXIS)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group (idempotent).

    Arguments default from PyTorch's launcher environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Returns
    True when the process group is up, False when running single-process
    (nothing configured, or a world of one).  ``backend`` defaults to
    ``gloo`` for CPU tensors and, where a card is visible, ``nccl`` for
    CUDA tensors."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env:
            return False
        init_method = "env://"
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    if world_size <= 1:
        return False
    rank = int(env["RANK"] if rank is None else rank)
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def make_host_chip_mesh(num_hosts: Optional[int] = None,
                        chips_per_host: Optional[int] = None,
                        axis_names: Sequence[str] = HIER_AXES[::-1],
                        devices=None) -> Mesh:
    """A 2-axis (``host``, ``chip``) mesh.

    Under ``torch.distributed`` with several processes, the ``host`` axis
    is the processes (``num_hosts`` must equal the world size) and each
    process contributes ``chips_per_host`` of its ``devices`` (default:
    its visible cards).  In one process, ``devices`` are reshaped to
    (``num_hosts``, ``chips_per_host``), so the same program shapes run
    without a cluster."""
    import torch.distributed as dist

    devs = visible_devices() if devices is None else [torch.device(d)
                                                      for d in devices]
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if num_hosts is None:
        num_hosts = world
    if world > 1 and num_hosts != world:
        raise ValueError(f"{num_hosts} hosts requested in a world of "
                         f"{world} processes")
    local_hosts = 1 if world > 1 else num_hosts
    if chips_per_host is None:
        chips_per_host = len(devs) // local_hosts
    if local_hosts * chips_per_host > len(devs) or chips_per_host < 1:
        raise ValueError(f"requested {num_hosts}x{chips_per_host} devices, "
                         f"have {len(devs) * world}")
    grid = np.empty(local_hosts * chips_per_host, dtype=object)
    grid[:] = devs[:grid.size]
    return Mesh(grid.reshape(local_hosts, chips_per_host), axis_names,
                process_axis=axis_names[0] if world > 1 else None)


def hier_psum(xs, mesh: Mesh, axes: Sequence[str] = HIER_AXES) -> list:
    """Sum over a hierarchical mesh: the chip shards within each process
    first, then across the processes (``collectives.psum``'s order for an
    innermost-first axis tuple).  Works for single axes too."""
    return col.psum(xs, mesh, axes)


def mesh_axes(mesh: Mesh) -> tuple:
    """The mesh's axis names as a tuple (for axis-generic sums)."""
    return tuple(mesh.axis_names)


def process_local_batch(global_batch: int) -> int:
    """This process's share of a globally sized batch (each host feeds
    only its own pairs)."""
    import torch.distributed as dist

    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if global_batch % n:
        raise ValueError(f"{n} processes do not divide a batch of "
                         f"{global_batch}")
    return global_batch // n
