"""Compiled programs: one captured CUDA graph per static signature.

The port's counterpart of ``jax.jit``.  ``jit(static_argnames=...,
static_argnums=...)`` wraps a function into a ``Program``.  The static
arguments mean what they mean to JAX: their values (hashable) are part of
the cache key and reach the function as they are.  Every other argument
is traced: a pytree (``torch.utils._pytree``: tuples, NamedTuples such as
``Features``, ``PoseGraph`` and ``BAProblem``, lists, dicts) whose leaves
are tensors, Python numbers or None.  The key is the static values, the
tree's structure and, per leaf, a tensor's (shape, dtype, device), a
number's type, or None.  A new key captures a new graph, as JAX retraces.

On the card, the first call of a key

  1. copies the arguments into static input buffers owned by the program
     (a number becomes a 0-d tensor, filled on every call, so that a
     traced scalar such as a damping factor is an input of the graph and
     never a constant baked into it);
  2. runs the function eagerly on a side stream (the warm-up): this builds
     the kernel library, the constant tables cached per device, the cuBLAS
     workspace of that stream and the kernels' shared-memory attributes,
     none of which can happen under capture;
  3. captures the function on the same stream into a graph, and returns
     the warm-up's outputs.

Every later call copies its arguments into the buffers, replays the graph
on the caller's current stream and returns clones of the graph's outputs,
made on that stream after the replay: no later replay overwrites what a
call returned.

Every graph of a device allocates from one memory pool, shared by all the
keys of all the programs.  A graph's buffers (its outputs included) may
then overlap another graph's, so one replay may overwrite what an earlier
replay of another key left in them; that is safe because a call clones
its outputs straight after its replay, on the same stream, and the input
buffers come from the ordinary allocator.  It asks one thing of callers:
replays of one device run in stream order, never on two streams at once.
Memory grows with the largest program, not with the number of keys.  A capture that fails raises ``ProgramError`` naming the
program and its key; nothing falls back to eager execution.

No Python runs during a replay, so the kernels' launch counters
(``sublevel.launches``, ``octave.launches``, ``describe.launches``,
``hamming_top2.launches``) would not move.  The change of each counter
during the capture (whose launches never ran) is taken back and added to
the counter on every replay instead: the counters count the card's
launches, warm-up and replays alike.

Meshes.  A static value may be a ``parallel.Mesh`` (hashable, as JAX's
static ``mesh``); traced arguments may then be per-shard lists of
tensors or of named tuples.  Such a key is decided once, from the key
alone and before any capture is tried (``mesh_route``): it is captured
when the mesh's local shards and the traced tensors all lie on one CUDA
device and every collective of the program that crosses processes (the
program's ``collective_axes``, of its static values, that span a process
axis: ``Mesh.spans_processes``) runs on NCCL, the group's backend for
CUDA tensors.  Each rank then captures one graph holding its kernels and
the NCCL collectives and point-to-point ops; the eager warm-up before
the capture brings up every communicator, and the ranks must call their
programs in one order (as they must call collectives).  A program
without collectives, such as the data-parallel step, passes whatever the
mesh.  A key whose shards all lie on the CPU takes the CPU path below.
Every other key runs the function as it is, on every call: collectives
across processes on gloo (a host-side backend that no graph can hold),
and a mesh over several cards in one process (``torch.cuda.graph`` takes
its stream and memory pool from one device, and such a graph would have
to span four).  ``stats()`` lists those keys with ``eager=True`` and
their calls, and a captured key whose collectives cross processes with
``nccl=True``.  A key the rule captures and whose capture fails raises
``ProgramError`` as any other; nothing is retried eagerly.  A key
without a mesh whose tensors lie on several devices raises.

On the CPU nothing is captured: a call whose tensors lie on the CPU (or
that has no tensor) runs the function on its arguments.  ``eager()`` is
the counterpart of ``jax.disable_jit()``: inside it every program runs
its function on its arguments, on the card too.  Captured or not, the
function sees every traced number as a 0-d tensor on the call's device
(of ``torch.as_tensor``'s dtype for it, as the input buffers are), so
that eager and captured calls run the same ops: CUDA divides by a
Python number as a multiply by its reciprocal, by a tensor as a
division; and on the card it sees every traced tensor contiguous, as
the input buffers hold it (a matmul rounds otherwise on a transposed
operand, such as the rotations ``se3_inverse`` returns, so an eager call
on the caller's strides would differ from the graph, and a mesh over
four cards, which runs eagerly, from one card's captured mesh).
``clear()`` drops every graph (the counterpart of
``jax.clear_caches()``).  The cache lives in each ``Program``, at module
level, so every caller of one program shares its graphs (``Akaze``
instances with equal plans share one pair program).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time
from typing import List

import torch
from torch.utils import _pytree as pytree

_PROGRAMS: List["Program"] = []
_EAGER = 0          # depth of eager() contexts
_STREAMS = {}       # device -> the side stream of warm-ups and captures
_POOLS = {}         # device -> the memory pool every graph there shares


class ProgramError(RuntimeError):
    """A program's capture failed."""


@contextlib.contextmanager
def eager():
    """Run every program's function as it is, without capture or replay."""
    global _EAGER
    _EAGER += 1
    try:
        yield
    finally:
        _EAGER -= 1


def clear() -> None:
    """Drop every captured graph and the devices' memory pools."""
    for p in _PROGRAMS:
        p.entries.clear()
        p.eager_keys.clear()
    _POOLS.clear()


def programs() -> List["Program"]:
    """Every program of the package."""
    return list(_PROGRAMS)


def stats() -> list:
    """Per key: the program, the key's static values and tensor shapes,
    ``eager`` (True for a key the mesh rule runs eagerly), ``nccl`` (True
    for a key whose collectives cross processes on NCCL), its calls and
    replays, the bytes its capture added to the device's pool and its
    warm-up and capture seconds (0 for an eager key)."""
    captured = [dict(program=p.name, key=describe_key(k), eager=False,
                     nccl=p.crosses_on_nccl(k[0]), calls=e.replays + 1,
                     replays=e.replays, pool_bytes=e.pool_bytes,
                     warmup_s=e.warmup_s, capture_s=e.capture_s)
                for p in _PROGRAMS for k, e in p.entries.items()]
    return captured + [dict(program=p.name, key=describe_key(k), eager=True,
                            nccl=p.crosses_on_nccl(k[0]), calls=n,
                            replays=0, pool_bytes=0, warmup_s=0.0,
                            capture_s=0.0)
                       for p in _PROGRAMS for k, n in p.eager_keys.items()]


def describe_key(key) -> str:
    """A key in a line: static values (a mesh by its repr, another object
    than a number, a string or a tuple by its type and hash) and the
    traced leaves' shapes and types."""
    statics, _, leaves = key
    shapes = [f"{tuple(x[1])}:{str(x[2]).replace('torch.', '')}"
              if x and x[0] == "tensor" else repr(x) for x in leaves]
    return (", ".join(f"{k}={v!r}" if isinstance(v, (int, float, str, tuple))
                      or _is_mesh(v)
                      else f"{k}={type(v).__name__}#{hash(v) & 0xffff:04x}"
                      for k, v in statics)
            + ("; " if statics else "") + " ".join(shapes))


def _is_mesh(v) -> bool:
    from .parallel.mesh import Mesh
    return isinstance(v, Mesh)


def _card(device: torch.device) -> torch.device:
    """``device`` with the current card's index where a CUDA device names
    none (``"cuda"``), as a tensor sent there reports it."""
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)


def crossing_backend(mesh, collective_axes):
    """The backend (``"nccl"``, ``"gloo"``) of the collectives over
    ``collective_axes`` that cross processes (the mesh group's backend for
    CUDA tensors), or None when none crosses."""
    if collective_axes is None or not mesh.spans_processes(collective_axes):
        return None
    from .parallel.distributed import collective_backend
    return collective_backend(mesh.group)


def mesh_route(mesh, devices, collective_axes) -> str:
    """How a key whose static values hold ``mesh`` runs, decided from the
    key alone: ``"capture"`` when the mesh's local shards and the traced
    tensors' ``devices`` all lie on one CUDA device and each collective
    that crosses processes runs on NCCL (``collective_axes``: the axes of
    the program's collectives, None for a program without any); ``"cpu"``
    when they all lie on the CPU; else ``"eager"``."""
    devs = {_card(torch.device(d))
            for d in list(mesh.local_devices) + list(devices)}
    if all(d.type == "cpu" for d in devs):
        return "cpu"
    one_card = len(devs) == 1 and next(iter(devs)).type == "cuda"
    ok = crossing_backend(mesh, collective_axes) in (None, "nccl")
    return "capture" if one_card and ok else "eager"


def _launch_counters():
    """The kernels' wrappers, whose ``launches`` programs keep counting."""
    from .ops.describe import describe
    from .ops.hamming import hamming_top2
    from .ops.sublevel import octave, sublevel
    return (sublevel, octave, describe, hamming_top2)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if x is None:
        return None
    if isinstance(x, (bool, int, float)):
        return ("scalar", type(x).__name__)
    raise TypeError(f"a traced argument leaf must be a tensor, a number or "
                    f"None, got {type(x).__name__}; pass it as static")


def _program_device(name: str, leaves):
    """The device of the call's tensors (the CPU where it has none)."""
    devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"{name}: arguments on several devices "
                         f"{sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cpu")


def _side_stream(device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _pool(device):
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _POOLS[device]


def _scalar(x, device):
    """Leaf ``x`` with a number made a 0-d tensor on ``device``."""
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=torch.as_tensor(x).dtype,
                          device=device)
    return x


def _eager_input(x, device):
    """Leaf ``x`` as a call that is not captured hands it to the function:
    as ``_buffer`` fills the input buffers on the card (a number as a 0-d
    tensor, a tensor contiguous), and a tensor as it is on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.contiguous() if device.type == "cuda" else x
    return _scalar(x, device)


def _buffer(x, device):
    """A static input buffer for leaf ``x``, filled with it."""
    if isinstance(x, torch.Tensor):
        return x.clone(memory_format=torch.contiguous_format)
    return _scalar(x, device)


def _fresh(leaves):
    return [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]


class _Entry:
    """One captured graph: its input buffers, outputs and measurements."""

    def __init__(self, graph, inputs, outputs, out_spec, deltas,
                 pool_bytes, warmup_s, capture_s):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.out_spec = out_spec
        self.deltas = deltas            # (counted wrapper, launches) pairs
        self.pool_bytes = pool_bytes
        self.warmup_s = warmup_s
        self.capture_s = capture_s
        self.replays = 0

    def run(self, leaves):
        for buf, x in zip(self.inputs, leaves):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            elif buf is not None:
                buf.fill_(x)
        self.graph.replay()
        for fn, n in self.deltas:
            fn.launches += n
        self.replays += 1
        return pytree.tree_unflatten(_fresh(self.outputs), self.out_spec)


class Program:
    """A function compiled per static signature (see the module's
    docstring).  ``captures`` and ``replays`` count this program's
    captures and replays; ``entries`` maps each key to its graph."""

    def __init__(self, fn, static_argnames=(), static_argnums=(),
                 collective_axes=None):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.collective_axes = collective_axes
        self.name = f"{fn.__module__}.{fn.__qualname__}"
        self.static_argnames = tuple(static_argnames)
        self.static_argnums = tuple(static_argnums)
        self.signature = inspect.signature(fn)
        params = list(self.signature.parameters)
        self.static = (frozenset(self.static_argnames)
                       | {params[i] for i in self.static_argnums})
        unknown = self.static - set(params)
        if unknown:
            raise ValueError(f"{self.name} has no argument {sorted(unknown)}")
        self.entries = {}
        self.eager_keys = {}            # key -> calls, for mesh_route "eager"
        self.captures = 0
        self.replays = 0
        _PROGRAMS.append(self)

    def key(self, *args, **kwargs):
        """The cache key of a call, and its traced leaves.  Returns
        (key, leaves, statics, spec)."""
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        statics = tuple((k, v) for k, v in bound.arguments.items()
                        if k in self.static)
        traced = {k: v for k, v in bound.arguments.items()
                  if k not in self.static}
        leaves, spec = pytree.tree_flatten(traced)
        key = (statics, spec, tuple(_leaf_key(x) for x in leaves))
        return key, leaves, statics, spec

    def route(self, *args, **kwargs) -> str:
        """How this call runs, from its key alone: ``"capture"`` (a graph
        per key on the card), ``"cpu"`` or, for a mesh the rule refuses,
        ``"eager"`` (see the module's docstring)."""
        key, leaves, statics, _ = self.key(*args, **kwargs)
        return self._route(statics, leaves)[0]

    def _axes(self, statics):
        """(the key's mesh or None, its collectives' axes or None)."""
        mesh = next((v for _, v in statics if _is_mesh(v)), None)
        return mesh, (None if mesh is None or self.collective_axes is None
                      else self.collective_axes(dict(statics)))

    def crosses_on_nccl(self, statics) -> bool:
        """Whether a key's collectives cross processes on NCCL."""
        mesh, axes = self._axes(statics)
        return mesh is not None and crossing_backend(mesh, axes) == "nccl"

    def _route(self, statics, leaves):
        """(route, the call's device)."""
        mesh, axes = self._axes(statics)
        if mesh is None:
            device = _program_device(self.name, leaves)
            return ("capture" if device.type == "cuda" else "cpu"), device
        devices = [x.device for x in leaves if isinstance(x, torch.Tensor)]
        return (mesh_route(mesh, devices, axes),
                _card(devices[0] if devices else mesh.home))

    def __call__(self, *args, **kwargs):
        key, leaves, statics, spec = self.key(*args, **kwargs)
        route, device = self._route(statics, leaves)
        if route == "eager":
            self.eager_keys[key] = self.eager_keys.get(key, 0) + 1
        if _EAGER or route != "capture":
            return self._call(statics, spec,
                              [_eager_input(x, device) for x in leaves])
        entry = self.entries.get(key)
        if entry is None:
            return self._capture(key, leaves, statics, spec, device)
        self.replays += 1
        return entry.run(leaves)

    def _call(self, statics, spec, inputs):
        return self.fn(**dict(statics), **pytree.tree_unflatten(inputs, spec))

    def _capture(self, key, leaves, statics, spec, device):
        caller = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(caller)
        t0 = time.perf_counter()
        with torch.cuda.device(device), torch.cuda.stream(side):
            inputs = [_buffer(x, device) for x in leaves]
            warm, warm_spec = pytree.tree_flatten(
                self._call(statics, spec, inputs))
        t1 = time.perf_counter()
        counters = _launch_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    graph, pool=_pool(device), stream=side,
                    capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(device)
                outputs, out_spec = pytree.tree_flatten(
                    self._call(statics, spec, inputs))
        except RuntimeError as e:
            # the failed capture leaves its pool marked as being captured
            # into, so later captures of the device take a new pool
            _POOLS.pop(device, None)
            raise ProgramError(f"{self.name}: capture of "
                               f"[{describe_key(key)}] failed: {e}") from e
        finally:
            deltas = [(fn, fn.launches - n)
                      for fn, n in zip(counters, before)]
            for fn, n in zip(counters, before):
                fn.launches = n
        pool = torch.cuda.memory_reserved(device) - reserved
        self.entries[key] = _Entry(graph, inputs, outputs, out_spec,
                                   [(fn, n) for fn, n in deltas if n],
                                   pool, t1 - t0, time.perf_counter() - t1)
        self.captures += 1
        caller.wait_stream(side)
        for x in warm:
            if isinstance(x, torch.Tensor):
                x.record_stream(caller)
        return pytree.tree_unflatten(_fresh(warm), warm_spec)


def jit(fn=None, *, static_argnames=(), static_argnums=(),
        collective_axes=None):
    """``Program(fn, ...)``, usable as ``@jit(static_argnames=(...))``,
    as ``jax.jit`` under ``functools.partial``.  ``collective_axes``: for
    a program over a mesh that makes collectives, a function of its static
    values (a dict) giving their axes (see ``mesh_route``)."""
    if fn is None:
        return functools.partial(jit, static_argnames=static_argnames,
                                 static_argnums=static_argnums,
                                 collective_axes=collective_axes)
    return Program(fn, static_argnames, static_argnums, collective_axes)
