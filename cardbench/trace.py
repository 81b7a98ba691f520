"""Spans and the device trace: what the per-layer metrics read.

``Spans`` brackets calls into the program's layers from the benchmark's
own code: CUDA events around a call (its time on the card's clock, host
work before the launches included), and, while the profiler runs, a
``record_function`` label, so that an idle gap of the device can be put
down to what the host was doing.  ``profiled`` runs a stretch of work
under ``torch.profiler`` and reduces it to a ``Trace``: each card's device
events, their union (busy), the idle gaps and the labels around them.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

LABEL = "cardbench."        # prefix of the benchmark's host labels


class Spans:
    """Named spans, timed when ``timed``: between CUDA events on a card,
    by the host clock on the CPU.  ``labelled`` turns the profiler labels
    on."""

    def __init__(self, timed: bool, card: bool = True):
        self.timed = timed
        self.card = card
        self.labelled = False
        self._events = {}

    @contextlib.contextmanager
    def span(self, name: str, timed: bool = True):
        import torch
        label = (torch.profiler.record_function(LABEL + name)
                 if self.labelled else contextlib.nullcontext())
        with label:
            if not (self.timed and timed):
                yield
                return
            start = self._now()
            yield
            self._events.setdefault(name, []).append((start, self._now()))

    def _now(self):
        import torch
        if not self.card:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def clear(self) -> None:
        self._events = {}

    def ms(self, name: str) -> list:
        """Every span of ``name`` in ms (synchronises on its events)."""
        out = []
        for start, end in self._events.get(name, ()):
            if isinstance(start, float):
                out.append((end - start) * 1e3)
            else:
                end.synchronize()
                out.append(start.elapsed_time(end))
        return out


@dataclass
class Trace:
    """What one traced stretch left: per card its device events (name,
    start ns, end ns), the host labels (name, start ns, end ns), the
    stretch's wall seconds, and the spans and facts that the run adds."""
    window_s: float
    device: dict = field(default_factory=dict)
    labels: list = field(default_factory=list)
    spans: object = None
    facts: dict = field(default_factory=dict)

    def busy_s(self, card=None) -> float:
        """Seconds covered by the device events of ``card``, or the mean
        over the cards the run uses."""
        cards = [card] if card is not None else self.facts.get(
            "cards", sorted(self.device))
        if not cards:
            return 0.0
        return sum(union_ns([(a, b) for _, a, b in self.device.get(c, ())])
                   for c in cards) / len(cards) / 1e9

    def kernel_s(self, *needles) -> float:
        """Device seconds of the events whose name holds one of
        ``needles``, summed over the cards."""
        return sum(b - a for evs in self.device.values()
                   for name, a, b in evs
                   if any(n in name for n in needles)) / 1e9


def union_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    total, last = 0, None
    for a, b in sorted(spans):
        if last is None or a > last:
            total += b - a
            last = b
        elif b > last:
            total += b - last
            last = b
    return total


def profiled(run, cards, spans: Spans) -> Trace:
    """Run ``run()`` under the profiler, every card synchronised before
    and after; reduce it to a ``Trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for c in cards:
            if torch.device(c).type == "cuda":
                torch.cuda.synchronize(c)

    sync()
    # the profiler slows each launch: spans measure the window, not this
    spans.labelled, timed, spans.timed = True, spans.timed, False
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall = time.perf_counter() - t0
    finally:
        spans.labelled, spans.timed = False, timed
    cuda = torch.autograd.DeviceType.CUDA
    trace = Trace(window_s=wall, spans=spans)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # the profiler mirrors host labels onto the device's timeline;
            # those are no device work
            if name.startswith(LABEL) or name.startswith("ProfilerStep"):
                continue
            trace.device.setdefault(e.device_index(), []).append(
                (name, e.start_ns(), e.end_ns()))
        elif name.startswith(LABEL):
            trace.labels.append((name[len(LABEL):], e.start_ns(),
                                 e.end_ns()))
    for evs in trace.device.values():
        evs.sort(key=lambda e: e[1])
    trace.facts["cards"] = [torch.device(c).index or 0 for c in cards]
    return trace


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed over
    the cards), and the longest idle gaps of the cards, each named by the
    innermost host label around its middle."""
    ops = {}
    for evs in trace.device.values():
        for name, a, b in evs:
            short = name.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0][:96]
            ops[short] = ops.get(short, 0.0) + (b - a) / 1e9
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for card, evs in trace.device.items():
        last = None
        for _, a, b in evs:
            if last is not None and a > last:
                gaps.append((a - last, last, a, card))
            last = b if last is None else max(last, b)
    gaps.sort(reverse=True)
    idle = []
    for ns, a, b, card in gaps[:top]:
        mid = (a + b) // 2
        around = [(e - s, n) for n, s, e in trace.labels if s <= mid <= e]
        what = min(around)[1] if around else "outside the benchmark's spans"
        idle.append([f"cuda:{card} {what}", ns / 1e9])
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": idle}
