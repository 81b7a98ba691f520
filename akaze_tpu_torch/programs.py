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

On the CPU nothing is captured: a call whose tensors lie on the CPU (or
that has no tensor) runs the function on its arguments.  ``eager()`` is
the counterpart of ``jax.disable_jit()``: inside it every program runs
its function on its arguments, on the card too.  Captured or not, the
function sees every traced number as a 0-d tensor on the call's device
(of ``torch.as_tensor``'s dtype for it, as the input buffers are), so
that eager and captured calls run the same ops: CUDA divides by a
Python number as a multiply by its reciprocal, by a tensor as a
division.  ``clear()`` drops every graph (the counterpart of
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
    _POOLS.clear()


def programs() -> List["Program"]:
    """Every program of the package."""
    return list(_PROGRAMS)


def stats() -> list:
    """Per captured key: the program, the key's tensor shapes, its replays,
    the bytes its capture added to the device's pool and its warm-up and
    capture seconds."""
    return [dict(program=p.name, key=describe_key(k), replays=e.replays,
                 pool_bytes=e.pool_bytes, warmup_s=e.warmup_s,
                 capture_s=e.capture_s)
            for p in _PROGRAMS for k, e in p.entries.items()]


def describe_key(key) -> str:
    """A key in a line: static values (an object other than a number or a
    string by its type and hash) and the traced leaves' shapes and types."""
    statics, _, leaves = key
    shapes = [f"{tuple(x[1])}:{str(x[2]).replace('torch.', '')}"
              if x and x[0] == "tensor" else repr(x) for x in leaves]
    return (", ".join(f"{k}={v!r}" if isinstance(v, (int, float, str))
                      else f"{k}={type(v).__name__}#{hash(v) & 0xffff:04x}"
                      for k, v in statics)
            + ("; " if statics else "") + " ".join(shapes))


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

    def __init__(self, fn, static_argnames=(), static_argnums=()):
        functools.update_wrapper(self, fn)
        self.fn = fn
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

    def __call__(self, *args, **kwargs):
        key, leaves, statics, spec = self.key(*args, **kwargs)
        device = _program_device(self.name, leaves)
        if _EAGER or device.type != "cuda":
            return self._call(statics, spec,
                              [_scalar(x, device) for x in leaves])
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


def jit(fn=None, *, static_argnames=(), static_argnums=()):
    """``Program(fn, ...)``, usable as ``@jit(static_argnames=(...))``,
    as ``jax.jit`` under ``functools.partial``."""
    if fn is None:
        return functools.partial(jit, static_argnames=static_argnames,
                                 static_argnums=static_argnums)
    return Program(fn, static_argnames, static_argnums)
