#!/usr/bin/env python3
"""One run of a benchmark cell with the program's own tracer on.

    python3 tools/trace_cell.py --workload NAME --seed N --seconds S
                                [--tracer 0|1] [--out FILE]

Runs the cell as ``python3 -m cardbench ... --trace 1`` does (set-up,
warm-up, the window, the profiled stretch, the check), with two of
``cardbench/trace.py``'s pieces in their place for the run:

* ``ProgramSpans``: where the harness clears its spans after the
  warm-up, ``akaze_tpu_torch.tracing`` is turned on and reset, so that
  its aggregates cover the window and the stretch;
* ``profiled``: the stretch runs with the tracer labelled and turns it
  off at its end; the ``akaze_tpu_torch.`` labels are kept beside the
  harness's own, and their mirrors on the device's timeline dropped as
  the harness drops its own.  ``breakdown`` then names each idle gap of
  the device by the program's innermost section around it.  Each pass of
  Python's garbage collector in the stretch is a label too
  (``python.gc.gen<N>``), so that a gap it causes is named by it.

``--tracer 0`` runs the harness's own pieces, the tracer off throughout:
the same run for the tracer's cost, in turns.  Prints one JSON line: the
cell's end-to-end figures of the window, its per-layer metrics, the
program's (``PROGRAM_METRICS``), the breakdown, ``correct``, the
tracer's summary (the window and the stretch), each section's count and
mean over the stretch alone (``stretch``: under the profiler), and
whether anything was recorded after the stretch.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cardbench import run as cardbench_run   # noqa: E402


def _mean(summary, name, unit_ns):
    a = summary["spans"].get(name)
    return a["total_ns"] / a["count"] / unit_ns if a and a["count"] else None


def _per_frame(summary):
    frames = summary["spans"].get("slam.frame", {}).get("count", 0)
    return (summary["counters"].get("host_syncs", 0) / frames
            if frames else None)


def _launches_per_call(counter, span):
    """A reader of ``counter``'s launches over ``span``'s count: 1.0 on the
    card for a one-launch solve or match, 0.0 on the CPU, which runs the
    plain twin; None without a call."""
    def read(summary):
        calls = summary["spans"].get(span, {}).get("count", 0)
        return (summary["counters"].get(counter, 0) / calls
                if calls else None)
    return read


def _exchange_per_pair(summary):
    """Bytes between shards per pair of images through the spatial tier."""
    counters = summary["counters"]
    images = counters.get("spatial.images", 0)
    return (2 * counters.get("spatial.exchange_bytes", 0) / images
            if images else None)


GC = "python.gc."          # labels of the collector's passes

PAIRS = ("pair.vo.960x1280", "sfm.exhaustive.960x1280")
AERIAL = ("pair.aerial.3648x5472.4cards",)
SLAM = ("slam.tum.480x640",)
# name: (unit, the cells whose path records it, its reading of a summary)
PROGRAM_METRICS = {
    "pipeline.upload_ms": ("ms", PAIRS[:1] + AERIAL,
                           lambda s: _mean(s, "akaze.upload", 1e6)),
    "programs.replay_host_us": ("us", PAIRS + AERIAL,
                                lambda s: _mean(s, "program.replay", 1e3)),
    "spatial.exchange_bytes_per_pair": ("bytes", AERIAL, _exchange_per_pair),
    "vo.two_view_ms": ("ms", SLAM, lambda s: _mean(s, "vo.two_view", 1e6)),
    "slam.local_ba_ms": ("ms", SLAM,
                         lambda s: _mean(s, "slam.local_ba", 1e6)),
    "slam.host_syncs_per_frame": ("syncs", SLAM, _per_frame),
    "slam.program_captures": ("captures", SLAM,
                              lambda s: s["counters"].get("captures", 0)),
    "slam.pgo_launches_per_call": ("launches", SLAM, _launches_per_call(
        "pgo_solve.launches", "slam.pgo")),
    "match.host_us": ("us", PAIRS[1:],
                      lambda s: _mean(s, "akaze.match", 1e3)),
    "match.launches_per_call": ("launches", PAIRS[1:], _launches_per_call(
        "hamming_match.launches", "akaze.match")),
}


def program_spans(base):
    """The harness's ``Spans`` class with the tracer turned on and reset
    where the harness clears its spans, when ``timed``."""
    from akaze_tpu_torch import tracing

    class ProgramSpans(base):
        def clear(self):
            super().clear()
            if self.timed:
                tracing.enable()
                tracing.reset()
    return ProgramSpans


def profiled(run, cards, spans):
    """``cardbench.trace.profiled`` with the tracer labelled over the
    stretch: the program's labels kept in ``Trace.labels``, their device
    mirrors dropped; the tracer off at the end, its summary in
    ``Trace.facts["program"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from akaze_tpu_torch import tracing
    from cardbench.trace import LABEL, Trace

    def sync():
        for c in cards:
            if torch.device(c).type == "cuda":
                torch.cuda.synchronize(c)

    open_pass = []

    def collecting(phase, info):
        if phase == "start":
            open_pass.append(torch.profiler.record_function(
                f"{GC}gen{info['generation']}"))
            open_pass[-1].__enter__()
        elif open_pass:
            open_pass.pop().__exit__(None, None, None)

    sync()
    spans.labelled, timed, spans.timed = True, spans.timed, False
    tracing.enable(labelled=True)
    gc.callbacks.append(collecting)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(collecting)
        tracing.disable()
        spans.labelled, spans.timed = False, timed
    cuda = torch.autograd.DeviceType.CUDA
    trace = Trace(window_s=wall, spans=spans)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith((LABEL, tracing.PREFIX, GC, "ProfilerStep")):
                continue
            trace.device.setdefault(e.device_index(), []).append(
                (name, e.start_ns(), e.end_ns()))
        elif name.startswith(LABEL):
            trace.labels.append((name[len(LABEL):], e.start_ns(),
                                 e.end_ns()))
        elif name.startswith((tracing.PREFIX, GC)):
            trace.labels.append((name, e.start_ns(), e.end_ns()))
    for evs in trace.device.values():
        evs.sort(key=lambda e: e[1])
    trace.facts["cards"] = [torch.device(c).index or 0 for c in cards]
    trace.facts["program"] = tracing.summary()
    stretch = {}
    for _, _, _, name, a, b in tracing.spans():
        n, ns = stretch.get(name, (0, 0))
        stretch[name] = (n + 1, ns + b - a)
    trace.facts["stretch"] = {k: {"count": n, "mean_us": ns / n / 1e3}
                              for k, (n, ns) in sorted(stretch.items())}
    return trace


@contextlib.contextmanager
def _patched(tracer: bool):
    from cardbench import trace
    saved = trace.Spans, trace.profiled
    if tracer:
        trace.Spans, trace.profiled = program_spans(saved[0]), profiled
    try:
        yield
    finally:
        trace.Spans, trace.profiled = saved


def run(spec, cell, seed, seconds, tracer=True, start=START, **small):
    """One traced run of ``cell``; ``small``: ``devices``, ``config``,
    ``traffic`` as ``cardbench.run.run_cell`` takes them.  Returns the
    JSON line's fields."""
    from akaze_tpu_torch import tracing
    tracing.disable()
    tracing.reset()
    try:
        with _patched(tracer):
            out = cardbench_run.run_cell(spec, cell, seed, seconds, True,
                                         start=start, **small)
    finally:
        tracing.disable()
    res, t = out["result"], out["trace"]
    summary = t.facts.get("program")
    metrics = dict(res["metrics"])
    if summary is not None:
        for name, (unit, cells, read) in PROGRAM_METRICS.items():
            if cell["name"] in cells:
                metrics[name] = {"value": read(summary), "unit": unit}
    return {"workload": cell["name"], "seed": seed, "tracer": bool(tracer),
            "correct": res["correct"], "e2e": out["e2e"],
            "metrics": metrics, "breakdown": res["breakdown"],
            "device": res["device"], "summary": summary,
            "stretch": t.facts.get("stretch"),
            "recorded_after_stretch": (summary is not None
                                       and tracing.summary() != summary),
            "device_labels": sorted({n for evs in t.device.values()
                                     for n, _, _ in evs
                                     if n.startswith(tracing.PREFIX)})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/trace_cell.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", help="append the JSON line to this file too")
    args = p.parse_args(argv)

    from cardbench.spec import Spec
    spec = Spec()
    cell = spec.cell(args.workload)
    cardbench_run.environment(spec.root)
    import torch
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s)",
              file=sys.stderr)
        return 2
    line = json.dumps(run(spec, cell, args.seed, args.seconds,
                          bool(args.tracer)))
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
