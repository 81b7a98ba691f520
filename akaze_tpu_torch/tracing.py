"""Spans and counters from inside the program, on the host clock.

Off by default: ``span`` and ``request`` then make one check and hand
back a shared null context, and ``count`` makes one check; nothing is
created, no clock is read.  ``enable()`` turns the tracer on, ``disable()``
off, ``reset()`` empties what it holds.

A span records its name, its parent span and a request id between two
``perf_counter_ns`` readings.  Spans opened under one root share the
root's request id: a root is a call of ``Akaze.detect_and_compute``,
``detect_and_compute_pair`` or ``match``, or of ``SlamSystem.process``
(each opens ``request()``), or the outermost span of a call outside any
request; a caller opens ``request()`` itself to group several calls
under one id.  Per name the tracer keeps the count, the total and the
self time (the total less what its child spans cover), and counters as
totals: memory stays flat however long it runs.

``enable(labelled=True)`` keeps, besides, every span with its ids
(``spans()``) and opens each as a ``torch.profiler.record_function``
named ``akaze_tpu_torch.<name>``, so that it lies on the clock of the
device events in a profiler's trace and names the host section around
an idle gap of the device.

``summary()`` is the one reader: the aggregates, the counters, and the
program counters the port keeps anyway (``Program.captures``,
``Program.replays``, the calls of ``eager_keys``, each kernel wrapper's
``launches``) as their change from ``reset()`` to ``disable()`` (or to
now while on).  ``programs.clear()`` in between empties ``eager_keys``,
which ``eager_calls`` then reads short.

Spans go in host code only: never inside a function that
``programs.jit`` captures, where no Python runs on a replay.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import nullcontext
from time import perf_counter_ns

import torch

PREFIX = "akaze_tpu_torch."     # of the profiler labels

_NULL = nullcontext()
_on = False
_labelled = False
_lock = threading.Lock()
_ids = itertools.count(1)       # span ids and request ids
_aggregates = {}                # name -> [count, total ns, self ns]
_counters = {}                  # name -> total
_raw = []                       # (id, parent, request, name, start, end)
_base = {}                      # program counters at reset()
_end = None                     # program counters at disable(), None while on


class _Thread(threading.local):
    """Per thread: the open spans, innermost last, and the open request's
    id."""

    def __init__(self):
        self.stack = []
        self.request = None


_thread = _Thread()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start", "child_ns",
                 "label")

    def __init__(self, name):
        self.name = name
        self.child_ns = 0
        self.label = None

    def __enter__(self):
        stack = _thread.stack
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.request = (top.request if top is not None
                        else _thread.request or next(_ids))
        if _labelled:
            self.label = torch.profiler.record_function(PREFIX + self.name)
            self.label.__enter__()
        stack.append(self)
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        stack = _thread.stack
        stack.pop()
        ns = end - self.start
        if stack:
            stack[-1].child_ns += ns
        if self.label is not None:
            self.label.__exit__(*exc)
        if not _on:                 # turned off while the span was open
            return False
        with _lock:
            agg = _aggregates.get(self.name)
            if agg is None:
                agg = _aggregates[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += ns
            agg[2] += ns - self.child_ns
            if self.label is not None:
                _raw.append((self.id, self.parent, self.request, self.name,
                             self.start, end))
        return False


class _Request:
    __slots__ = ()

    def __enter__(self):
        _thread.request = next(_ids)

    def __exit__(self, *exc):
        _thread.request = None
        return False


def span(name: str):
    """A context that records one span of ``name`` while the tracer is on
    (the shared null context while it is off)."""
    if not _on:
        return _NULL
    return _Span(name)


def request():
    """A context under which every span shares one request id; inside an
    open request or span it joins that one."""
    if not _on:
        return _NULL
    if _thread.request is not None or _thread.stack:
        return _NULL
    return _Request()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enable(labelled: bool = False) -> None:
    """Turn the tracer on; ``labelled``: keep every span and open each as
    a profiler label too."""
    global _on, _labelled, _end
    _on, _labelled, _end = True, bool(labelled), None


def disable() -> None:
    """Turn the tracer off; what it holds stays until ``reset()``."""
    global _on, _labelled, _end
    if _on:
        _end = _program_counters()
    _on = _labelled = False


def reset() -> None:
    """Forget every span and counter; the program counters count from
    here."""
    global _base, _end
    with _lock:
        _aggregates.clear()
        _counters.clear()
        _raw.clear()
        _base = _program_counters()
        _end = None if _on else _base


def enabled() -> bool:
    """Whether the tracer is on."""
    return _on


def spans() -> list:
    """Every span recorded while labelled: (id, parent id or None, request
    id, name, start ns, end ns) on ``perf_counter_ns``'s clock."""
    with _lock:
        return list(_raw)


def summary() -> dict:
    """``{"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
    {name: total}}``: the spans and counters since ``reset()``, the
    program counters' change among the counters (``captures``,
    ``replays``, ``eager_calls``, ``<kernel>.launches``)."""
    end = _program_counters() if _end is None else _end
    with _lock:
        out = {"spans": {k: {"count": a[0], "total_ns": a[1],
                             "self_ns": a[2]}
                         for k, a in _aggregates.items()},
               "counters": dict(_counters)}
    for k, v in end.items():
        out["counters"][k] = v - _base.get(k, 0)
    return out


def _program_counters() -> dict:
    from . import programs
    progs = programs.programs()
    out = {"captures": sum(p.captures for p in progs),
           "replays": sum(p.replays for p in progs),
           "eager_calls": sum(sum(p.eager_keys.values()) for p in progs)}
    for fn in programs._launch_counters():
        out[f"{fn.__name__}.launches"] = fn.launches
    return out
