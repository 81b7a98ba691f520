"""Data-parallel frame processing over a mesh.

Port of ``akaze_tpu/parallel/data_parallel.py``.  A batch of image pairs
is sharded over the mesh's ``data`` axis and every shard runs the
single-device pair program on its own pairs, on its own device: per pair
``detect_and_compute_pair`` (the K1 launches of one scale space for both
images, one K2 launch) and ``match`` (one K4 launch).  No collective is
needed; outputs stay on their shards, and ``gather_shards`` brings them
together for callers and tests.

The step is one compiled program (``_dp_step``, static ``plan``, ``mesh``
and ``fixed``, the values JAX's ``jax.jit(local_step)`` closes over): one
CUDA graph per key and process, over the process's cards of the mesh
(``programs.mesh_route``; it makes no collective, so a mesh across
processes is captured on any backend).  JAX builds a new ``jax.jit(local_step)`` on every
``make_dp_step`` call and so retraces every step; the port's keyed program
replays a repeated step instead.

``batched_detect_and_compute`` is the port's ``detect_and_compute_batch``
(one set of K1 launches and one K2 launch for B images), with the batch
stacked into one ``Features`` as the JAX package's vmap gives it.  The
JAX package's XLA-only plan for that path (``_xla_only_plan``) is a TPU
workaround and is not ported.
"""

from __future__ import annotations

import functools
from typing import Callable, List

import torch

from ..match import match
from ..pipeline import (Features, _as_images, detect_and_compute_batch,
                        detect_and_compute_pair)
from ..plan import PipelinePlan
from ..programs import jit
from . import collectives as col
from .mesh import Mesh


def stack_tuples(items: list):
    """A list of equal named tuples of tensors -> one named tuple whose
    fields are stacked along a new leading axis."""
    return type(items[0])(*(torch.stack(list(f)) for f in zip(*items)))


def batched_detect_and_compute(images, plan: PipelinePlan,
                               fixed: bool = False, device=None) -> Features:
    """Features of each image of a [B, H, W] batch, stacked ([B, ...]
    fields): one set of K1 launches and one K2 launch for the batch."""
    return stack_tuples(detect_and_compute_batch(images, plan, fixed=fixed,
                                                 device=device))


@jit(static_argnames=("plan", "mesh", "fixed"))
def _dp_step(a_shards: List[torch.Tensor], b_shards: List[torch.Tensor],
             plan: PipelinePlan, mesh: Mesh, fixed: bool):
    """Per local shard of ``mesh``, the pair program and the match of each
    of its pairs, stacked: (features_a, features_b, matches), each a list
    over the shards."""
    out = []
    for a, b in zip(a_shards, b_shards):
        per_pair = []
        for ia, ib in zip(a, b):
            fa, fb = detect_and_compute_pair(ia, ib, plan, fixed=fixed)
            m = match(fa.words, fa.valid, fb.words, fb.valid, fb.x, fb.y,
                      plan.config.max_dist)
            per_pair.append((fa, fb, m))
        out.append(tuple(stack_tuples(list(f)) for f in zip(*per_pair)))
    return tuple(list(f) for f in zip(*out))


def make_dp_step(plan: PipelinePlan, mesh: Mesh, fixed: bool = False,
                 axis: str = "data") -> Callable:
    """The per-shard program of ``dp_pipeline_step``: a function of two
    lists (one [b, H, W] batch of image pairs' first and second images
    per local shard, each on its shard's device) that returns per shard
    the stacked (features_a, features_b, matches) of its pairs; it calls
    the program ``_dp_step`` with these statics."""
    return functools.partial(_dp_step, plan=plan, mesh=mesh, fixed=fixed)


def dp_pipeline_step(images_a, images_b, plan: PipelinePlan, mesh: Mesh,
                     fixed: bool = False):
    """One data-parallel step: detect, describe and match B image pairs
    ([B, H, W] each; float in [0, 1], or raw 0..255 with ``fixed``)
    sharded over the mesh's ``data`` axis, each shard running the
    single-device pair program on its pairs.  Returns (features_a,
    features_b, matches): each a list with one stacked result per local
    shard, on the shard's device (``gather_shards`` joins them)."""
    a = _as_images(images_a, "cpu" if not isinstance(images_a, torch.Tensor)
                   else images_a.device, fixed)
    b = _as_images(images_b, a.device, fixed)
    return make_dp_step(plan, mesh, fixed)(col.shard(a, mesh, "data"),
                                           col.shard(b, mesh, "data"))


def dp_pipeline_step_multihost(local_a, local_b, plan: PipelinePlan,
                               mesh: Mesh, fixed: bool = False):
    """The data-parallel step where each process passes only its OWN share
    of the global batch (``distributed.process_local_batch`` sizes it):
    this process's shards split it in mesh order.  A one-process mesh
    degenerates to ``dp_pipeline_step``."""
    a = _as_images(local_a, "cpu" if not isinstance(local_a, torch.Tensor)
                   else local_a.device, fixed)
    b = _as_images(local_b, a.device, fixed)
    n = len(mesh.local_devices)
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} local pairs do not split over "
                         f"{n} local shards")
    return make_dp_step(plan, mesh, fixed)(
        [x.to(d) for x, d in zip(a.chunk(n), mesh.local_devices)],
        [x.to(d) for x, d in zip(b.chunk(n), mesh.local_devices)])


def gather_shards(shards: list, device="cpu"):
    """Per-shard results (tensors, or named tuples of tensors) of this
    process concatenated along their leading axis in mesh order, on
    ``device``."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([s.to(device) for s in shards])
    return type(first)(*(torch.cat([f.to(device) for f in fs])
                         for fs in zip(*shards)))
