#!/usr/bin/env python3
"""Device and host time of kernel K4 (Hamming top-2) on a GPU.

    python3 tools/k4_profile.py [--tree DIR] [--label NAME] [--reps N]
                                [--out FILE]

Imports ``akaze_tpu_torch`` from ``--tree`` (default: this checkout), so
that two trees can be measured in turns by one command, one process each
(e.g. a ``git archive`` of the parent commit unpacked under ``_archive/``,
then this tree, then this tree, then the parent).  The inputs are the same
for every tree, made by this checkout's ``chip_smoke.py``:

* the main path's own descriptors: the float pair path
  (``detect_and_compute_pair``, ``max_pts=10000``) on ``chip_smoke.py``'s
  seeded synthetic 960x1280 pair, queries image A's words and train image
  B's, at their live counts (``last_live``);
* the same with the capacities cut to the live extents (the launch
  overhead of the capacity-sized grid, beside the work);
* the 10000 x 10000 stress input of ``chip_smoke.phase_k4``.

For each: whether K4 equals its plain version (all three outputs and the
``Matches`` they give; reported, not enforced, so that timing-only copies
of a tree with a phase cut out can be measured too); K4's device time per
launch from ``torch.profiler`` (CUPTI kernel durations, median of
``--reps`` launches); host time of one
wrapper call (20 calls, no synchronisation); event-bracketed time of one
call (host + device, median); and, as a yardstick only, the device time of
``torch._int_mm`` on the same +-1 int8 operands (live rows, 512 lanes)
followed by ``torch.topk(k=2)`` of the masked dot products.  Nothing in
the package calls ``_int_mm``.

Also the pair iteration of each pair path (float, fixed exact, fixed
approximate): detect + describe + match on card tensors, median of
``--reps`` after 3 warm-ups, CUDA events (host + device).

Prints a summary, and writes everything as JSON to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HOST_CALLS = 20
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """``chip_smoke.py`` of this checkout (for its pair and inputs)."""
    spec = importlib.util.spec_from_file_location(
        "k4_profile_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_times(torch, fn, reps, needle):
    """Per call of ``fn``: the durations in ms of the device kernels whose
    name holds ``needle``, one per call; or, when ``needle`` is None, the
    summed duration of every kernel of a call and {name: ms per call}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):   # the trace may drop events; take it again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        events = sorted((e.start_ns(), e.duration_ns() / 1e6, e.name())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == cuda
                        and (needle is None or needle in e.name()))
        if needle is None or len(events) == reps:
            break
    else:
        raise SystemExit(f"expected {reps} {needle} kernels in the trace, "
                         f"found {len(events)}")
    if needle is not None:
        return [d for _, d, _ in events], sorted({n for _, _, n in events})
    by_name = {}
    for _, d, n in events:
        by_name[n] = by_name.get(n, 0.0) + d / reps
    return [sum(by_name.values())], by_name


def host_us(torch, fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def event_ms(torch, fn, reps, warmup=1):
    for _ in range(warmup):
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


def plus_minus_one(torch, words):
    """[N, 16] int32 words -> [N, 512] int8, +1 for a 0 bit, -1 for a 1."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return (1 - 2 * bits).reshape(words.shape[0], 512).to(torch.int8)


def yardstick(torch, w1, w2, v2, n1, n2, reps):
    """Device ms of ``torch._int_mm`` (cuBLAS) on the +-1 operands of the
    live extents, plus ``topk(k=2)`` of the masked dots."""
    a = plus_minus_one(torch, w1[:max(n1, 17)])
    n2p = max(-(-n2 // 8) * 8, 8)
    b = plus_minus_one(torch, torch.nn.functional.pad(
        w2[:n2], (0, 0, 0, n2p - n2))).t().contiguous()
    live = torch.nn.functional.pad(v2[:n2], (0, n2p - n2))
    neg = torch.tensor(-(1 << 30), dtype=torch.int32, device=w1.device)

    def fn():
        dot = torch._int_mm(a, b)
        return torch.topk(torch.where(live, dot, neg), 2, dim=1)

    times, by_name = device_times(torch, fn, reps, None)
    return times[0], by_name


def measure(torch, np, smoke, name, w1, w2, v1, v2, x2, y2, reps):
    from akaze_tpu_torch.match import matches_from_top2
    from akaze_tpu_torch.ops.hamming import (hamming_top2,
                                             hamming_top2_plain, last_live)
    c1, c2 = last_live(v1), last_live(v2)
    got = hamming_top2(w1, w2, v2, c1, c2)
    want = hamming_top2_plain(w1, w2, v2, c1, c2)
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    same = all(bool(torch.equal(a, b)) for a, b in zip(
        matches_from_top2(*got, v1, x2, y2),
        matches_from_top2(*want, v1, x2, y2)))
    fn = lambda: hamming_top2(w1, w2, v2, c1, c2)  # noqa: E731
    times, names = device_times(torch, fn, reps, "hamming_kernel")
    n1, n2 = int(c1), int(c2)
    ys_ms, ys_kernels = yardstick(torch, w1, w2, v2, n1, n2, reps)
    top = max(ys_kernels, key=ys_kernels.get)
    return {"extents": [n1, n2], "shape": [w1.shape[0], w2.shape[0]],
            "equal": equal, "matches_equal": same,
            "device_ms": statistics.median(times), "device_ms_all": times,
            "kernel": names, "host_us": host_us(torch, fn),
            "event_ms": event_ms(torch, fn, reps),
            "yardstick_int_mm_topk_ms": ys_ms, "yardstick_kernels": ys_kernels,
            "yardstick_top_kernel": [top[:80], ys_kernels[top]]}


def pair_ms(torch, det, a, b, reps):
    at = torch.as_tensor(a, device=det.device)
    bt = torch.as_tensor(b, device=det.device)
    return event_ms(torch, lambda: det.match(*det.detect_and_compute_pair(
        at, bt)), reps, warmup=3)


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
                            if "hamming" in ln or "registers" in ln
                            or "spill" in ln or "smem" in ln]}
    (a, b), (a8, b8), desc, _ = smoke.load_pair(None)
    result["pair"] = desc
    det = Akaze(AkazeConfig(max_pts=smoke.MAX_PTS), device=dev)
    fa, fb = det.detect_and_compute_pair(a, b)
    n1, n2 = int(fa.count), int(fb.count)
    cases = {"main": (fa.words, fb.words, fa.valid, fb.valid, fb.x, fb.y),
             "main_trimmed": (fa.words[:n1], fb.words[:n2], fa.valid[:n1],
                              fb.valid[:n2], fb.x[:n2], fb.y[:n2]),
             "stress": smoke.k4_stress_inputs(torch, dev)}
    for name, (w1, w2, v1, v2, x2, y2) in cases.items():
        r = result[name] = measure(torch, np, smoke, name, w1, w2, v1, v2,
                                   x2, y2, args.reps)
        print(f"[{args.label}] K4 {name}: {r['extents'][0]} x "
              f"{r['extents'][1]} live of {r['shape'][0]} x "
              f"{r['shape'][1]}; equal to the plain version {r['equal']}, "
              f"Matches equal {r['matches_equal']}; device "
              f"{r['device_ms']:.4f} ms (median of {args.reps}, min "
              f"{min(r['device_ms_all']):.4f}, max "
              f"{max(r['device_ms_all']):.4f}); host {r['host_us']:.1f} us "
              f"per call; event-bracketed {r['event_ms']:.4f} ms; yardstick "
              f"_int_mm + topk {r['yardstick_int_mm_topk_ms']:.4f} ms "
              f"(largest "
              f"kernel {r['yardstick_top_kernel'][1]:.4f} ms: "
              f"{r['yardstick_top_kernel'][0][:50]})")
    paths = (("float", det, (a, b)),
             ("fixed_exact", Akaze(AkazeConfig(max_pts=smoke.MAX_PTS,
                                               fixed_exact_sampling=True),
                                   fixed=True, device=dev), (a8, b8)),
             ("fixed_approximate", Akaze(AkazeConfig(max_pts=smoke.MAX_PTS),
                                         fixed=True, device=dev), (a8, b8)))
    result["pair_ms"] = {}
    for name, d, pr in paths:
        ms = result["pair_ms"][name] = pair_ms(torch, d, *pr, args.reps)
        print(f"[{args.label}] pair iteration {name}: median {ms:.3f} ms of "
              f"{args.reps}")
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
