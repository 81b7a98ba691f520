#!/usr/bin/env python3
"""Per-launch device and host time of kernel K1 (the scale space) on a GPU.

    python3 tools/k1_profile.py [--tree DIR] [--label NAME] [--reps N]
                                [--cluster N] [--max-pixels N] [--out FILE]

Imports ``akaze_tpu_torch`` from ``--tree`` (default: this checkout), so
that two trees can be measured in turns by one command, one process each
(e.g. a ``git archive`` of the parent commit unpacked under ``_archive/``,
then this tree, then this tree, then the parent).

For the float and the 16.16 fixed flavour, B = 2, 960x1280, the default
configuration (4 octaves x 4 sublevels):

* records every K1 wrapper call that ``build_scale_space`` makes (the
  names ``sublevel`` and ``octave`` in ``scale_space``'s namespace,
  whichever the tree has);
* device time of each call's K1 kernels from ``torch.profiler`` (CUPTI
  kernel durations), median over ``--reps``, grouped by octave;
* host time of each wrapper call: ``time.perf_counter`` over 20 calls with
  no synchronisation, divided by 20;
* device time of one whole ``build_scale_space`` by kernel class: K1, the
  ``torch.stack`` copies (PyTorch's ``Cat`` kernels), everything else;
* the event-bracketed time of one ``build_scale_space`` (host + device);
* the host time of the pieces of a wrapper call (stream, allocation).

``--cluster`` and ``--max-pixels`` override the resident kernel's cluster
size and routing threshold, to time the other choice of an octave.

Prints a summary, and writes everything as JSON to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

H, W = 960, 1280
HOST_CALLS = 20


def texture(rng, h, w):
    """Seeded float32 texture in [0, 1]: box-smoothed noise at two scales."""
    import numpy as np
    img = np.zeros((h, w))
    for cell, amp in ((4, 0.5), (16, 0.5)):
        c = rng.standard_normal((h // cell + 2, w // cell + 2))
        img += amp * np.kron(c, np.ones((cell, cell)))[:h, :w]
    img += 0.1 * rng.standard_normal((h, w))
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def device_kernels(prof, torch):
    """(name, start_ns, duration_ns) of every device kernel, in order."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and not e.name().startswith("Mem")]
    return sorted(out, key=lambda k: k[1])


def is_k1(name: str) -> bool:
    return any(k in name for k in ("sublevel", "octave", "tiled_kernel"))


def measure(torch, pkg, fixed: bool, reps: int):
    import numpy as np
    from akaze_tpu_torch import AkazeConfig, scale_space
    from akaze_tpu_torch import build_plan
    from akaze_tpu_torch.ops import sublevel as k1mod
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    imgs = np.stack([texture(rng, H, W) for _ in range(2)])
    if fixed:
        x = torch.from_numpy((imgs * 255).astype(np.uint8).astype(np.int32))
    else:
        x = torch.from_numpy(imgs)
    x = x.to(dev)
    plan = build_plan(H, W, AkazeConfig(max_pts=10000))
    shapes = {(o.height, o.width): o.octave for o in plan.octaves}

    def launches():
        return sum(getattr(f, "launches", 0) for f in vars(k1mod).values()
                   if callable(f) and isinstance(getattr(f, "launches", None),
                                                 int))

    names = [n for n in ("sublevel", "octave") if hasattr(scale_space, n)]
    calls = []
    originals = {n: getattr(scale_space, n) for n in names}

    def recorder(fn):
        def rec(*args, **kw):
            calls.append((fn, args, kw))
            return fn(*args, **kw)
        return rec

    for n in names:
        setattr(scale_space, n, recorder(originals[n]))
    try:
        scale_space.build_scale_space(x, plan)
    finally:
        for n, f in originals.items():
            setattr(scale_space, n, f)
    torch.cuda.synchronize()

    # warm-up, then launches per call and per scale space
    for _ in range(3):
        scale_space.build_scale_space(x, plan)
    torch.cuda.synchronize()
    per_call_launches = []
    for fn, args, kw in calls:
        before = launches()
        fn(*args, **kw)
        per_call_launches.append(launches() - before)
    torch.cuda.synchronize()

    # host time of each wrapper call, no synchronisation inside the loop
    host_us = []
    for fn, args, kw in calls:
        fn(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn(*args, **kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host_us.append((t1 - t0) / HOST_CALLS * 1e6)

    # device time of each call's K1 kernels
    per_call_dev = [[] for _ in calls]
    n_per_rep = sum(per_call_launches)
    for attempt in range(3):   # the trace may drop events; take it again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn, args, kw in calls:
                    fn(*args, **kw)
                torch.cuda.synchronize()
        k1 = [k for k in device_kernels(prof, torch) if is_k1(k[0])]
        if len(k1) == reps * n_per_rep:
            break
    else:
        raise SystemExit(f"expected {reps * n_per_rep} K1 kernels in the "
                         f"trace, found {len(k1)}")
    kernel_names = sorted({k[0] for k in k1})
    for r in range(reps):
        pos = r * n_per_rep
        for i, n in enumerate(per_call_launches):
            per_call_dev[i].append(sum(k[2] for k in k1[pos:pos + n]) / 1e6)
            pos += n

    rows = []
    for (fn, args, kw), n, hu, dv in zip(calls, per_call_launches, host_us,
                                         per_call_dev):
        hw = tuple(args[0].shape[-2:])
        rows.append({"octave": shapes[hw], "shape": list(hw),
                     "wrapper": fn.__name__, "launches": n,
                     "host_us": hu, "device_ms": statistics.median(dv)})

    # the whole scale space by kernel class
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            scale_space.build_scale_space(x, plan)
        torch.cuda.synchronize()
    classes = {"k1": 0.0, "stack": 0.0, "other": 0.0}
    for name, _, dur in device_kernels(prof, torch):
        key = "k1" if is_k1(name) else ("stack" if "Cat" in name
                                        else "other")
        classes[key] += dur / 1e6 / reps

    # event-bracketed scale space (host + device)
    times = []
    for _ in range(10):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        scale_space.build_scale_space(x, plan)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))

    per_octave = {}
    for r in rows:
        o = per_octave.setdefault(r["octave"], {"launches": 0,
                                                "device_ms": 0.0,
                                                "host_us": 0.0})
        o["launches"] += r["launches"]
        o["device_ms"] += r["device_ms"]
        o["host_us"] += r["host_us"]
    total_launches = sum(r["launches"] for r in rows)
    return {
        "flavour": "fixed" if fixed else "float",
        "kernel_names": kernel_names,
        "calls": rows,
        "per_octave": per_octave,
        "k1_launches": total_launches,
        "k1_device_ms": sum(r["device_ms"] for r in rows),
        "host_us_per_launch": sum(r["host_us"] for r in rows)
        / max(total_launches, 1),
        "scale_space_device_ms": classes,
        "scale_space_event_ms": statistics.median(times),
    }


def host_breakdown(torch):
    """Host time of the pieces of one K1 wrapper call, in us."""
    dev = torch.device("cuda", 0)
    x = torch.zeros((2, 240, 320), device=dev)

    def t(fn, n=2000):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    out = {"current_stream": t(lambda: torch.cuda.current_stream()
                               .cuda_stream),
           "current_device": t(torch.cuda.current_device),
           "empty_4x2x4x240x320": t(lambda: torch.empty(
               (4, 2, 4, 240, 320), device=dev)),
           "unbind": t(lambda: x.unbind(0)),
           "data_ptr": t(x.data_ptr),
           "tensor_device": t(lambda: x.device)}
    torch.cuda.synchronize()
    return out


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=here,
                    help="directory holding the akaze_tpu_torch to measure")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cluster", type=int, default=0,
                    help="CTAs per image of the resident kernel (default: "
                         "the tree's own)")
    ap.add_argument("--max-pixels", type=int, default=0,
                    help="largest plane of the resident kernel (default: "
                         "the tree's own); moves the routing threshold")
    ap.add_argument("--out", help="JSON file for the full result")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import akaze_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {pkg.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from akaze_tpu_torch import _build
    from akaze_tpu_torch.ops import sublevel as k1mod
    if args.cluster:
        k1mod.RESIDENT_CLUSTER = args.cluster
    if args.max_pixels:
        k1mod.RESIDENT_MAX_PIXELS = args.max_pixels
    info = _build.build()
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    result = {"label": args.label, "tree": tree, "card": card,
              "build_s": info["seconds"],
              "build_log": [ln.strip() for ln in info["log"].splitlines()
                            if "registers" in ln or "Function properties"
                            in ln or "spill" in ln]}
    result["host_breakdown_us"] = host_breakdown(torch)
    print(f"[{args.label}] host pieces (us): "
          f"{json.dumps(result['host_breakdown_us'])}")
    for fixed in (False, True):
        r = measure(torch, pkg, fixed, args.reps)
        result[r["flavour"]] = r
        print(f"[{args.label}] {r['flavour']}: K1 {r['k1_launches']} "
              f"launches, {r['k1_device_ms']:.4f} ms device per pair, "
              f"host {r['host_us_per_launch']:.1f} us per launch; scale "
              f"space device ms {json.dumps(r['scale_space_device_ms'])}, "
              f"event-bracketed {r['scale_space_event_ms']:.3f} ms")
        for o, v in sorted(r["per_octave"].items()):
            print(f"[{args.label}]   octave {o}: {v['launches']} launches, "
                  f"{v['device_ms']:.4f} ms device, {v['host_us']:.1f} us "
                  f"host")
    print(f"[{args.label}] card: {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
