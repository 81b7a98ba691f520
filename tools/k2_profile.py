#!/usr/bin/env python3
"""Device and host time of kernel K2 (orientation + MLDB cell sums) on a GPU.

    python3 tools/k2_profile.py [--tree DIR] [--label NAME] [--reps N]
                                [--out FILE]

Imports ``akaze_tpu_torch`` from ``--tree`` (default: this checkout), so
that two trees can be measured in turns by one command, one process each
(e.g. a ``git archive`` of the parent commit unpacked under ``_archive/``,
then this tree, then this tree, then the parent).  The inputs are the
same for every tree: ``chip_smoke.py``'s synthetic 960x1280 pair of this
checkout, ``max_pts=10000``.

For the float flavour (bf16 planes of the float pair) and the exact fixed
flavour (f32 planes of the pair quantised to raw 0..255), on the main
path's own slots and plane stacks (``detect_batch`` + ``slot_params``, as
``chip_smoke.py``'s K2 phase builds them):

* K2 against its plain version: max angle error, flipped descriptor bits,
  max cell-sum difference;
* the 32-byte sectors the live slots' taps touch, over the launch and
  per slot (the sector traffic, beside the 2 bytes per tap of the bound);
* device time of one K2 launch from ``torch.profiler`` (CUPTI kernel
  durations), median over ``--reps`` launches, on four slot sets: the
  main path's (N = 20,000, live ones first in each image's half), its
  live slots alone, the same N with every slot dead, and the main path's
  slots all reading the first live slot's window (every tap a cache hit:
  the kernel without its memory traffic);
* host time of one wrapper call (20 calls, no synchronisation) and the
  event-bracketed time of one call (host + device);
* from one profiled pair iteration (``detect_and_compute_pair``), the
  describe stage's device time split into padded-pyramid staging
  (``build_padded_pyramid``: the zero fill and the plane copies),
  ``slot_params``, K2 (``describe``), ``finish_descriptors`` and the rest
  of ``orient_describe_multi``, each with its kernel count.

Per-phase times of the kernel come from timing-only copies of a tree (a
phase cut out), measured by this script with ``--tree``.

Prints a summary, and writes everything as JSON to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

HOST_CALLS = 20
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """``chip_smoke.py`` of this checkout (for its pair and constants)."""
    spec = importlib.util.spec_from_file_location(
        "k2_profile_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_kernels(prof, torch):
    """Durations in ms of the K2 kernels of a trace, in order."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.start_ns(), e.duration_ns() / 1e6)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and "describe_kernel" in e.name()]
    return [d for _, d in sorted(out)]


def device_ms(torch, fn, reps):
    """Median device time of the K2 kernel of one ``fn()`` call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # the trace may drop events; take it again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = k2_kernels(prof, torch)
        if len(times) == reps:
            return statistics.median(times), times
    raise SystemExit(f"expected {reps} K2 kernels in the trace, found "
                     f"{len(times)}")


def host_us(torch, fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def event_ms(torch, fn, reps=10):
    fn()
    times = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def compare(torch, np, got, want, live):
    """(max angle error in rad, max flipped bits, max cell-sum difference)
    between two ``describe`` results on the live slots."""
    from akaze_tpu_torch.descriptor import finish_descriptors, words_to_numpy
    d = (got[0] - want[0]).abs()
    d = torch.minimum(d, 2 * math.pi - d)
    flips = np.unpackbits(
        (words_to_numpy(finish_descriptors(got[1]))
         ^ words_to_numpy(finish_descriptors(want[1]))).view(np.uint8),
        axis=1).sum(1)[live.cpu().numpy()]
    return (float(d.max()), int(flips.max()),
            float((got[1] - want[1]).abs().max()))


def slots(torch, smoke, images, plan, fixed):
    """The main path's K2 inputs: (iparams, fparams, planes, tables)."""
    from akaze_tpu_torch.descriptor import slot_params
    from akaze_tpu_torch.ops.describe import describe_tables
    from akaze_tpu_torch.pipeline import detect_batch
    kps, pp = detect_batch(images, plan, fixed=fixed)
    nplanes = pp.L.shape[0] // 2
    params = [slot_params(k, pp, plan, plane_base=i * nplanes,
                          nplanes=nplanes) for i, k in enumerate(kps)]
    ip = torch.cat([p[0] for p in params])
    fp = torch.cat([p[1] for p in params])
    tables = describe_tables(plan.config.descriptor_pattern_size, ip.device)
    return ip, fp, (pp.L, pp.lx, pp.ly), tables


def footprint(torch, ip, fp, planes, tables, angle):
    """(sectors, per-slot sectors): the 32-byte sectors that the live slots'
    taps touch, counted once over the launch and once per slot, at the
    angles ``angle`` (the plain version's tap positions)."""
    live = ip[:, 6] > 0
    ip, fp, angle = ip[live].long(), fp[live], angle[live]
    _, hp, wp = planes[0].shape
    esize = planes[0].element_size()
    p, y0, x0, oy, ox, isc = (ip[:, i] for i in range(6))
    base = ((p * hp + y0) * wp + x0)[:, None]
    t = torch.nonzero(tables.orient_w > 0)[:, 0]
    r = oy[:, None] + isc[:, None] * (t // 11 - 5)
    c = ox[:, None] + isc[:, None] * (t % 11 - 5)
    co, si = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    sc = isc.float()[:, None]
    xs = (fp[:, 1:] + sc * (tables.kof * co - tables.lof * si)
          + 0.5).long()
    ys = (fp[:, :1] + sc * (tables.kof * si + tables.lof * co)
          + 0.5).long()
    keys = []
    plane_words = planes[0].numel() * esize // 32 + 1
    for rows, cols, kinds in ((r, c, (1, 2)), (ys, xs, (0, 1, 2))):
        inside = (rows >= 0) & (rows < 128) & (cols >= 0) & (cols < 128)
        sector = (base + rows * wp + cols) * esize // 32
        slot = torch.arange(sector.shape[0], device=sector.device)[:, None]
        for kind in kinds:
            key = (slot * 3 + kind) * plane_words + sector
            keys.append(key[inside])
    keys = torch.cat(keys)
    per_slot = int(torch.unique(keys).numel())
    shared = int(torch.unique(keys % (3 * plane_words)).numel())
    return shared, per_slot


def measure_k2(torch, np, smoke, det, pair, fixed, reps):
    from akaze_tpu_torch.ops.describe import describe, describe_plain
    dev = det.device
    plan = det.plan_for(smoke.H, smoke.W)
    images = torch.stack([torch.as_tensor(x, device=dev) for x in pair])
    if fixed:
        images = images.int()
    ip, fp, planes, tables = slots(torch, smoke, images, plan, fixed)
    live = ip[:, 6] > 0
    got = describe(ip, fp, planes, tables, fixed)
    want = describe_plain(ip, fp, planes, tables, fixed)
    torch.cuda.synchronize()
    angle_err, flips, acc_err = compare(torch, np, got, want, live)
    ip_live, fp_live = ip[live].contiguous(), fp[live].contiguous()
    ip_dead = ip.clone()
    ip_dead[:, 6] = 0
    ip_one = ip.clone()   # every slot reads the first live slot's window
    ip_one[:, :3] = ip[live][0, :3]
    shared, per_slot = footprint(torch, ip, fp, planes, tables, want[0])
    out = {"slots": ip.shape[0], "live": int(live.sum()),
           "max_angle_err": angle_err, "flipped_bits": flips,
           "max_cell_sum_err": acc_err, "sectors": shared,
           "sectors_per_slot_sum": per_slot,
           "sector_ms": shared * 32 / 3.35e12 * 1e3}
    for name, (i, f) in (("main", (ip, fp)), ("live_only", (ip_live, fp_live)),
                         ("all_dead", (ip_dead, fp)),
                         ("one_window", (ip_one, fp))):
        ms, times = device_ms(torch, lambda: describe(i, f, planes, tables,
                                                      fixed), reps)
        out[f"device_ms_{name}"] = ms
        out[f"device_ms_{name}_all"] = times
    fn = lambda: describe(ip, fp, planes, tables, fixed)  # noqa: E731
    out["host_us"] = host_us(torch, fn)
    out["event_ms"] = event_ms(torch, fn)
    return out


STAGES = ("build_padded_pyramid", "orient_describe_multi", "slot_params",
          "describe", "finish_descriptors")


def stage_split(torch, smoke, det, pair):
    """Device ms and kernel count of each describe-stage piece over one
    profiled pair iteration."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from akaze_tpu_torch import descriptor, pipeline
    from akaze_tpu_torch.ops import describe as k2mod

    owners = {"build_padded_pyramid": pipeline,
              "orient_describe_multi": pipeline, "slot_params": descriptor,
              "describe": k2mod, "finish_descriptors": descriptor}
    originals = {n: getattr(m, n) for n, m in owners.items()}

    def annotated(name, fn):
        def call(*args, **kw):
            with record_function(f"k2stage::{name}"):
                return fn(*args, **kw)
        call.__dict__.update(fn.__dict__)   # a wrapper's launch counter
        return call

    a, b = (torch.as_tensor(x, device=det.device) for x in pair)
    for n, m in owners.items():
        setattr(m, n, annotated(n, originals[n]))
    try:
        for _ in range(2):
            det.match(*det.detect_and_compute_pair(a, b))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            det.match(*det.detect_and_compute_pair(a, b))
            torch.cuda.synchronize()
    finally:
        for n, m in owners.items():
            setattr(m, n, originals[n])

    # each device operation belongs to the annotated ranges whose host
    # interval holds the runtime call that launched it (same correlation id)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.end_ns(), e.name().split("::", 1)[1])
              for e in events if e.device_type() == cpu
              and e.name().startswith("k2stage::")]
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == cpu and e.correlation_id()
                and e.name().startswith(("cuda", "cu"))}
    dev = [e for e in events if e.device_type() == cuda
           and not e.name().startswith("k2stage::")]
    out = {n: {"device_ms": 0.0, "kernels": 0} for n in STAGES}
    unattributed = 0
    for e in dev:
        t = launched.get(e.correlation_id(),
                         launched.get(e.linked_correlation_id()))
        if t is None:
            unattributed += 1
            continue
        for start, end, name in ranges:
            if start <= t <= end:
                out[name]["device_ms"] += e.duration_ns() / 1e6
                out[name]["kernels"] += 1
    out["pair_device_ms"] = sum(e.duration_ns() for e in dev) / 1e6
    out["pair_kernels"] = len(dev)
    out["unattributed"] = unattributed
    out["k2_by_name_ms"] = sum(e.duration_ns() for e in dev
                               if "describe_kernel" in e.name()) / 1e6
    inner = sum(out[n]["device_ms"] for n in ("slot_params", "describe",
                                             "finish_descriptors"))
    out["orient_describe_other_ms"] = (
        out["orient_describe_multi"]["device_ms"] - inner)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="directory holding the akaze_tpu_torch to measure")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="JSON file for the full result")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import akaze_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {pkg.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from akaze_tpu_torch import Akaze, AkazeConfig, _build
    smoke = smoke_module()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    info = _build.build()
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    result = {"label": args.label, "tree": tree, "card": card,
              "build_s": info["seconds"],
              "build_log": [ln.strip() for ln in info["log"].splitlines()
                            if "Compiling entry" in ln or "registers" in ln
                            or "spill" in ln]}
    (a, b), (a8, b8), desc, _ = smoke.load_pair(None)
    result["pair"] = desc
    cells = (("float", Akaze(AkazeConfig(max_pts=smoke.MAX_PTS), device=dev),
              (a, b), False),
             ("fixed_exact", Akaze(AkazeConfig(max_pts=smoke.MAX_PTS,
                                               fixed_exact_sampling=True),
                                   fixed=True, device=dev), (a8, b8), True))
    for name, det, pair, fixed in cells:
        r = measure_k2(torch, np, smoke, det, pair, fixed, args.reps)
        result[name] = r
        print(f"[{args.label}] {name}: {r['live']} live of {r['slots']} "
              f"slots; vs plain: angle {r['max_angle_err']:.3g} rad, "
              f"{r['flipped_bits']} flipped bits, cell sums "
              f"{r['max_cell_sum_err']:.3g}; taps touch {r['sectors']} "
              f"sectors ({r['sectors'] * 32 / 1e6:.1f} MB, "
              f"{r['sector_ms'] * 1e3:.1f} us at 3.35 TB/s), "
              f"{r['sectors_per_slot_sum']} counted per slot")
        print(f"[{args.label}] {name}: K2 device {r['device_ms_main']:.4f} "
              f"ms (live only {r['device_ms_live_only']:.4f}, all dead "
              f"{r['device_ms_all_dead']:.4f}, one window "
              f"{r['device_ms_one_window']:.4f}); host {r['host_us']:.1f} us "
              f"per call; event-bracketed {r['event_ms']:.4f} ms")
        s = r["stages"] = stage_split(torch, smoke, det, pair)
        parts = ", ".join(f"{n} {s[n]['device_ms']:.4f} ms "
                          f"({s[n]['kernels']} kernels)" for n in STAGES)
        print(f"[{args.label}] {name}: pair iteration {s['pair_kernels']} "
              f"kernels, {s['pair_device_ms']:.3f} ms device; describe "
              f"stage: {parts}; rest of orient_describe_multi "
              f"{s['orient_describe_other_ms']:.4f} ms; K2 by kernel name "
              f"{s['k2_by_name_ms']:.4f} ms; {s['unattributed']} device "
              f"operations without a launch record")
    for ln in result["build_log"]:
        print(f"[{args.label}] build: {ln}")
    print(f"[{args.label}] card: {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
