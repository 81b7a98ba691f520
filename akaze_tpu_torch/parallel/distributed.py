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
Several processes on one host each take their own cards with
``local_device_ids`` (one card each for NCCL)::

    initialize_distributed("tcp://localhost:29500", 4, rank,
                           local_device_ids=[rank])

A process may own several cards, as JAX's one process per host drives
that host's chips::

    initialize_distributed("tcp://localhost:29500", 2, rank,
                           local_device_ids=[2 * rank, 2 * rank + 1])

NCCL takes one card per rank in a communicator, so the steps that cross
processes do not run on the mesh's own group but on groups made under it
for one role each (``role_groups``): per card slot j of the mesh (its
j-th distinct local device), a group whose every rank takes part on its
j-th card, which carries the sums and gathers over the process axis of
an operand on that card ("collectives over ``host`` cross DCN once per
chip rank"); and per seam between processes p and p + 1 of the process
axis, a two-rank group that p joins on the card of its last shard along
that axis and p + 1 on the card of its first, which carries the halo
rows.  Every group carries one card per rank, on NCCL and on gloo alike.

Single-process use needs no call: a (1, n) host/chip mesh or a purely
local mesh runs the same programs.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch

from . import collectives as col
from ..programs import _card, key_cards
from .mesh import Mesh, set_local_devices, visible_devices

HOST_AXIS = "host"
CHIP_AXIS = "chip"
# sum order: within a process first, then across processes
HIER_AXES = (CHIP_AXIS, HOST_AXIS)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           local_device_ids=None) -> bool:
    """Join the process group (idempotent).

    Arguments default from PyTorch's launcher environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Returns
    True when the process group is up, False when running single-process
    (nothing configured, or a world of one).  ``backend`` defaults to
    ``gloo`` for CPU tensors and, where a card is visible, ``nccl`` for
    CUDA tensors.

    ``local_device_ids`` (JAX's argument): the CUDA indices of the cards
    this process owns.  ``visible_devices``, ``make_mesh`` and
    ``make_host_chip_mesh`` then default to them, and the first becomes
    the current card.  None keeps every visible card and the current one.
    On a group whose CUDA backend is NCCL, which takes one rank per card,
    two ranks that own one physical card (any of their
    ``local_device_ids``, or without them the current card) raise
    ``ValueError`` here on every rank, before any NCCL call: give each
    process cards of its own (``local_device_ids=[rank]``, or
    ``[2 * rank, 2 * rank + 1]`` for two each, or one
    ``CUDA_VISIBLE_DEVICES`` set each)."""
    import torch.distributed as dist

    if local_device_ids is not None:
        set_local_devices(local_device_ids)
        torch.cuda.set_device(visible_devices()[0])
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
    if collective_backend(None) == "nccl":
        _refuse_shared_cards(
            visible_devices() if local_device_ids is not None
            else [torch.device("cuda", torch.cuda.current_device())])
    return True


def collective_backend(group, device_type: str = "cuda") -> str:
    """The backend ``group`` (None: the default group) runs collectives
    of ``device_type`` tensors on, such as ``"nccl"`` or ``"gloo"``."""
    import torch.distributed as dist

    pairs = [p.split(":") for p in dist.get_backend_config(group).split(",")]
    named = {p[0]: p[1] for p in pairs if len(p) == 2}
    return named.get(device_type, pairs[0][-1])


def _card_id(device: torch.device) -> str:
    """One physical card: its host and its UUID (the same card under two
    ``CUDA_VISIBLE_DEVICES`` orders has one id)."""
    return (f"{socket.gethostname()}/"
            f"{torch.cuda.get_device_properties(device).uuid}")


def _refuse_shared_cards(owned) -> None:
    """Raise on every rank where two ranks of the NCCL group own one card
    (``owned``: this rank's cards): every rank gathers every rank's cards
    and checks them all."""
    import torch.distributed as dist

    mine = [_card_id(d) for d in owned]
    ids = [None] * dist.get_world_size()
    # over the CPU's backend: no NCCL call before the check
    cpu = (None if collective_backend(None, "cpu") == "gloo"
           else dist.new_group(backend="gloo"))
    dist.all_gather_object(ids, mine, group=cpu)
    first = {}
    for r, cards in enumerate(ids):
        for c in cards:
            if first.setdefault(c, r) != r:
                raise ValueError(
                    f"ranks {first[c]} and {r} both drive card {c}: NCCL "
                    f"takes one rank per card; give each process cards of "
                    f"its own (local_device_ids=[rank], or one "
                    f"CUDA_VISIBLE_DEVICES set each)")


_GROUPS = {}    # (parent group, this process's cards of a mesh) -> roles


def card_slot(mesh: Mesh, device) -> int:
    """The slot of ``device`` (a device of the mesh's local shards): its
    index among the mesh's distinct local devices in mesh order
    (``programs.key_cards``)."""
    return key_cards(mesh).index(_card(torch.device(device)))


def role_groups(mesh: Mesh, roles) -> dict:
    """{role: process group} for ``roles`` under the mesh's process group
    (``mesh.group``, None: the default group): ``("slot", j)``, every
    rank of the group, each on its card slot j; ``("seam", p, i, k)``,
    ranks p and p + 1 of the group, p on its card slot i and p + 1 on its
    card slot k.  A group is made on its first request, with every rank
    of the world taking part (``new_group``), then cached per parent group
    and per this process's cards of the mesh (``programs.key_cards``):
    every rank asks for the same roles in the same order (its meshes have
    the same shape and the same cards per slot), so every rank makes or
    reuses the same groups, and a group always carries the same card of
    each rank.  A second mesh of the same shape and cards gets the same
    groups."""
    import torch.distributed as dist

    parent = mesh.group
    made = _GROUPS.setdefault((parent, tuple(key_cards(mesh))), {})
    ranks = (list(range(dist.get_world_size())) if parent is None
             else dist.get_process_group_ranks(parent))
    backend = None if parent is None else dist.get_backend_config(parent)
    for role in roles:
        if role not in made:
            members = (ranks if role[0] == "slot"
                       else [ranks[role[1]], ranks[role[1] + 1]])
            made[role] = dist.new_group(members, backend=backend)
    return {role: made[role] for role in roles}


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
