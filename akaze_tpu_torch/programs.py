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
alone and before any capture is tried (``mesh_route``).  It is captured
when the mesh's local shards and the traced tensors all lie on CUDA
cards of the mesh and every collective of the program that crosses
processes (the program's ``collective_axes``, of its static values,
that span a process axis: ``Mesh.spans_processes``) runs on NCCL, the
group's backend for CUDA tensors; a program without collectives, such
as the data-parallel step, and a mesh of this process alone pass that
test whatever the mesh.  Each process then captures one graph per key,
as JAX's jit makes one program per process over its devices:

* it spans the key's cards (``key_cards``: the mesh's home first, then
  its other cards in mesh order): the warm-up and the capture run with
  every card's side stream current, the capture begins on the home
  card's and forks each other card's in by an event, and joins them
  back before it ends; each card allocates into its own pool, and the
  cross-card copies of the collectives are stream-ordered peer copies
  inside the graph;
* it holds the NCCL collectives and point-to-point ops of the key's
  cross-process steps, each on its card's stream, each communicator
  carrying one card of each rank (``parallel.collectives`` routes a
  step to the group of its operand's card role); the eager warm-up
  before the capture makes every such group and brings up every
  communicator (neither can happen under capture), and the ranks must
  call their programs in one order (as they must call collectives), so
  that each communicator sees one sequence of ops on every rank.

A key whose shards all lie on the CPU takes the CPU path below.  Every
other key runs the function as it is, on every call: collectives across
processes on gloo (a host-side backend that no graph can hold), and keys
that mix the CPU and a card or reach a card outside the mesh.
``stats()`` lists those keys with ``eager=True`` and their calls, a
captured key whose collectives cross processes with ``nccl=True``, and
every mesh key's ``cards``.  A key the rule captures and whose capture
fails raises ``ProgramError`` as any other; nothing is retried eagerly.
A key without a mesh whose tensors lie on several devices raises.

A replay of a key over several cards copies the inputs on each card's
current stream, makes the home card's current stream wait on every
other card's before the replay, and every other card's wait on the home
card's after it, before the outputs are cloned on their own cards: the
graph's work on a card is ordered with the work its callers queue on
that card's current stream, as a one-card replay is.  Each card's pool
is the one its own graphs share, so the rule above becomes: replays
touching one card run in that card's stream order.

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
on the caller's strides would differ from the graph).
``clear()`` drops every graph (the counterpart of
``jax.clear_caches()``).  The cache lives in each ``Program``, at module
level, so every caller of one program shares its graphs (``Akaze``
instances with equal plans share one pair program).

With ``tracing`` on, the first call of a key is a ``program.capture``
span (warm-up and capture, opened outside the capture itself), and every
later call a ``program.replay`` span holding ``program.inputs`` (the
buffer copies), ``program.graph`` (the replay and the cross-card waits)
and ``program.outputs`` (the clones).  No span opens inside a captured
function, where no Python runs on a replay.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time
from typing import List

import torch
from torch.utils import _pytree as pytree

from . import tracing

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
        for e in p.entries.values():
            e.release()
        p.entries.clear()
        p.eager_keys.clear()
    _POOLS.clear()


def programs() -> List["Program"]:
    """Every program of the package."""
    return list(_PROGRAMS)


def stats() -> list:
    """Per key: the program, the key's static values and tensor shapes,
    ``eager`` (True for a key the mesh rule runs eagerly), ``nccl`` (True
    for a key whose collectives cross processes on NCCL), ``cards`` (the
    devices of a mesh key, home first: ``key_cards``; of another key its
    device), its calls and replays, the bytes its capture added to the
    pools (``pool_bytes``, and per card ``card_pool_bytes``) and its
    warm-up and capture seconds (0 for an eager key)."""
    captured = [_row(p, k, eager=False, calls=e.replays + 1,
                     replays=e.replays, card_pool_bytes=e.pool_bytes,
                     warmup_s=e.warmup_s, capture_s=e.capture_s)
                for p in _PROGRAMS for k, e in p.entries.items()]
    return captured + [_row(p, k, eager=True, calls=n, replays=0,
                            card_pool_bytes=None, warmup_s=0.0,
                            capture_s=0.0)
                       for p in _PROGRAMS for k, n in p.eager_keys.items()]


def _row(program, key, card_pool_bytes, **fields) -> dict:
    """A ``stats()`` row of ``program``'s ``key``."""
    cards = [str(c) for c in _cards_of_key(key)]
    per = card_pool_bytes or [0] * len(cards)
    return dict(program=program.name, key=describe_key(key),
                nccl=program.crosses_on_nccl(key[0]), cards=cards,
                pool_bytes=sum(per), card_pool_bytes=list(per), **fields)


def _cards_of_key(key) -> list:
    """The devices of a key: a mesh key's ``key_cards``, else the device
    of its tensors (the CPU where it has none)."""
    statics, _, leaves = key
    devices = [x[3] for x in leaves if x and x[0] == "tensor"]
    mesh = next((v for _, v in statics if _is_mesh(v)), None)
    if mesh is not None:
        return key_cards(mesh, devices)
    return [_card(devices[0])] if devices else [torch.device("cpu")]


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


def key_cards(mesh, devices=()) -> list:
    """The devices of a mesh key, each once: the mesh's local shards'
    devices in mesh order (its home first), then those of the traced
    tensors (``devices``) that lie outside them.  A capture over several
    cards begins on the first."""
    out = []
    for d in list(mesh.local_devices) + list(devices):
        d = _card(torch.device(d))
        if d not in out:
            out.append(d)
    return out


def mesh_route(mesh, devices, collective_axes) -> str:
    """How a key whose static values hold ``mesh`` runs, decided from the
    key alone (``devices``: the traced tensors' devices;
    ``collective_axes``: the axes of the program's collectives, None for
    a program without any).  ``"cpu"`` when the shards and tensors all
    lie on the CPU; ``"capture"`` when they all lie on CUDA cards of the
    mesh, one or several, and each collective that crosses processes
    runs on NCCL; else ``"eager"`` (see the module's docstring)."""
    cards = key_cards(mesh, devices)
    if all(d.type == "cpu" for d in cards):
        return "cpu"
    if (any(d.type != "cuda" for d in cards)
            or len(cards) > len(key_cards(mesh))):
        return "eager"
    ok = crossing_backend(mesh, collective_axes) in (None, "nccl")
    return "capture" if ok else "eager"


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


@contextlib.contextmanager
def _streams(cards, sides):
    """Each card's side stream current on it, the first card current."""
    with contextlib.ExitStack() as stack:
        for s in sides[::-1]:
            stack.enter_context(torch.cuda.stream(s))
        stack.enter_context(torch.cuda.device(cards[0]))
        yield


def _wait(stream, others) -> None:
    """``stream`` waits on the work queued so far on each of ``others``."""
    for s in others:
        ev = torch.cuda.Event()
        ev.record(s)
        stream.wait_event(ev)


@contextlib.contextmanager
def _allocating_to(card, pool, held):
    """This thread's allocations on ``card`` go to ``pool`` inside the
    block.  The use of the pool this takes (which keeps its memory for
    the graph) is kept after the block and appended to ``held``, for the
    graph's entry to release when it is dropped."""
    torch._C._cuda_beginAllocateCurrentThreadToPool(card.index, pool)
    held.append((card, pool))
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(card.index, pool)


def _release(held) -> None:
    """Give back the pool uses ``_allocating_to`` took."""
    while held:
        card, pool = held.pop()
        torch._C._cuda_releasePool(card.index, pool)


@contextlib.contextmanager
def _capturing(graph, cards, sides, pools, held):
    """A capture into ``graph`` that begins on the first card's side
    stream, forks every other card's side stream in by an event (each
    card allocating into its own pool, its side stream current: the
    pools' uses go to ``held``) and joins them back before the capture
    ends."""
    origin, others = sides[0], sides[1:]
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.cuda.device(cards[0]))
        stack.enter_context(torch.cuda.graph(
            graph, pool=pools[0], stream=origin,
            capture_error_mode="thread_local"))
        for c, s, p in zip(cards[1:], others, pools[1:]):
            stack.enter_context(torch.cuda.stream(s))
            stack.enter_context(_allocating_to(c, p, held))
        stack.enter_context(torch.cuda.device(cards[0]))
        for s in others:
            _wait(s, [origin])
        try:
            yield
        except BaseException:
            # join what can be joined before the capture ends on the
            # body's error
            with contextlib.suppress(RuntimeError):
                _wait(origin, others)
            raise
        _wait(origin, others)


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
    """One captured graph: its cards (home first), input buffers, outputs,
    the uses it holds of the other cards' pools, and measurements
    (``pool_bytes``: per card)."""

    def __init__(self, graph, cards, held, inputs, outputs, out_spec,
                 deltas, pool_bytes, warmup_s, capture_s):
        self.graph = graph
        self.cards = cards
        self.held = held        # released when the entry is dropped
        self.inputs = inputs
        self.outputs = outputs
        self.out_spec = out_spec
        self.deltas = deltas            # (counted wrapper, launches) pairs
        self.pool_bytes = pool_bytes
        self.warmup_s = warmup_s
        self.capture_s = capture_s
        self.replays = 0

    def release(self) -> None:
        """Give back the other cards' pools (the graph gives back its own
        card's when it is destroyed)."""
        _release(self.held)

    def run(self, leaves):
        with tracing.span("program.inputs"):
            for buf, x in zip(self.inputs, leaves):
                if isinstance(x, torch.Tensor):
                    buf.copy_(x)
                elif buf is not None:
                    buf.fill_(x)
        with tracing.span("program.graph"):
            home = torch.cuda.current_stream(self.cards[0])
            others = [torch.cuda.current_stream(c) for c in self.cards[1:]]
            _wait(home, others)
            self.graph.replay()
            for s in others:
                _wait(s, [home])
        for fn, n in self.deltas:
            fn.launches += n
        self.replays += 1
        with tracing.span("program.outputs"):
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
        """(route, the device of the call's numbers, its cards)."""
        mesh, axes = self._axes(statics)
        if mesh is None:
            device = _program_device(self.name, leaves)
            return ("capture" if device.type == "cuda" else "cpu"), device, \
                [device]
        devices = [x.device for x in leaves if isinstance(x, torch.Tensor)]
        return (mesh_route(mesh, devices, axes),
                _card(devices[0] if devices else mesh.home),
                key_cards(mesh, devices))

    def __call__(self, *args, **kwargs):
        key, leaves, statics, spec = self.key(*args, **kwargs)
        route, device, cards = self._route(statics, leaves)
        if route == "eager":
            self.eager_keys[key] = self.eager_keys.get(key, 0) + 1
        if _EAGER or route != "capture":
            return self._call(statics, spec,
                              [_eager_input(x, device) for x in leaves])
        entry = self.entries.get(key)
        if entry is None:
            with tracing.span("program.capture"):
                return self._capture(key, leaves, statics, spec, device,
                                     cards)
        self.replays += 1
        with tracing.span("program.replay"):
            return entry.run(leaves)

    def _call(self, statics, spec, inputs):
        return self.fn(**dict(statics), **pytree.tree_unflatten(inputs, spec))

    def _capture(self, key, leaves, statics, spec, device, cards):
        callers = [torch.cuda.current_stream(c) for c in cards]
        sides = [_side_stream(c) for c in cards]
        for side, caller in zip(sides, callers):
            side.wait_stream(caller)
        t0 = time.perf_counter()
        with _streams(cards, sides):
            inputs = [_buffer(x, device) for x in leaves]
            warm, warm_spec = pytree.tree_flatten(
                self._call(statics, spec, inputs))
        t1 = time.perf_counter()
        counters = _launch_counters()
        before = [fn.launches for fn in counters]
        pools = [_pool(c) for c in cards]
        held = []
        graph = torch.cuda.CUDAGraph()
        try:
            with _capturing(graph, cards, sides, pools, held):
                reserved = [torch.cuda.memory_reserved(c) for c in cards]
                outputs, out_spec = pytree.tree_flatten(
                    self._call(statics, spec, inputs))
        except RuntimeError as e:
            # the failed capture leaves its pools marked as being captured
            # into, so later captures of those cards take new pools
            _release(held)
            for c in cards:
                _POOLS.pop(c, None)
            raise ProgramError(f"{self.name}: capture of "
                               f"[{describe_key(key)}] failed: {e}") from e
        finally:
            deltas = [(fn, fn.launches - n)
                      for fn, n in zip(counters, before)]
            for fn, n in zip(counters, before):
                fn.launches = n
        pool = [torch.cuda.memory_reserved(c) - r
                for c, r in zip(cards, reserved)]
        self.entries[key] = _Entry(graph, cards, held, inputs, outputs,
                                   out_spec,
                                   [(fn, n) for fn, n in deltas if n],
                                   pool, t1 - t0, time.perf_counter() - t1)
        self.captures += 1
        for side, caller in zip(sides, callers):
            caller.wait_stream(side)
        for x in warm:
            if isinstance(x, torch.Tensor):
                x.record_stream(torch.cuda.current_stream(x.device))
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
