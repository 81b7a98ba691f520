#!/usr/bin/env python3
"""Graph nodes, device and host time of the two-view programs on a GPU.

    python3 tools/two_view_profile.py [--tree DIR] [--label NAME]
                                      [--reps N] [--out FILE]

Imports ``akaze_tpu_torch`` from ``--tree`` (default: this checkout), so
that two trees can be measured in turns by one command, one process each
(as ``tools/k4_profile.py``).  The inputs are the same for every tree,
made by this checkout's ``chip_smoke.py``: the first two frames of the
SLAM cell's route (480x640, ``AkazeConfig(max_pts=4000)``, TUM's
intrinsics), their features on the card, and the VO's RANSAC settings
(threshold 2e-5, 512 hypotheses, ``make_key(0)``).

For that pair:

* ``_two_view`` eager (``programs.eager()``) and captured, in turns,
  between CUDA events (host + device), and whether the two are equal bit
  for bit;
* one captured ``_two_view`` under ``set_sync_debug_mode("error")``;
* the nodes and device ms of one replay of ``_putative``, ``_solve`` and
  ``_ransac_homography`` (on the pair's putative pixel points, 512 sets
  of 4 from a seeded generator, threshold 9 px);
* ``geometry.linalg.smallest_eigenvector`` on the 512 8-point normal
  matrices ``_solve`` gives it: the device ms and kernels of one eager
  call, and its accuracy against numpy's float64 ``eigh``: the excess of
  the Rayleigh quotient over the smallest eigenvalue, relative to the
  largest eigenvalue (largest and median over the batch).

Prints a summary, and writes everything as JSON to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """``chip_smoke.py`` of this checkout (for its route and helpers)."""
    spec = importlib.util.spec_from_file_location(
        "two_view_profile_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same(torch, a, b):
    from torch.utils import _pytree as pytree
    x, y = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(x) == len(y) and all(
        u.dtype == v.dtype and u.shape == v.shape and bool(torch.equal(u, v))
        for u, v in zip(x, y))


def eigen_inputs(epipolar, solve):
    """The batched matrices ``_solve`` hands ``smallest_eigenvector`` in
    one eager call (the first call: the 512 hypotheses)."""
    from akaze_tpu_torch import programs
    real, seen = epipolar.smallest_eigenvector, []

    def rec(M):
        seen.append(M.clone())
        return real(M)

    epipolar.smallest_eigenvector = rec
    try:
        with programs.eager():
            solve()
    finally:
        epipolar.smallest_eigenvector = real
    return next(M for M in seen if M.dim() == 3)


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
    from akaze_tpu_torch import Akaze, AkazeConfig, _build, programs
    from akaze_tpu_torch.geometry import epipolar
    from akaze_tpu_torch.geometry.homography import _ransac_homography
    from akaze_tpu_torch.geometry.linalg import smallest_eigenvector
    from akaze_tpu_torch.geometry.ransac import (draw_minimal_sets, make_key,
                                                 sets_from_key)
    from akaze_tpu_torch.slam import odometry
    smoke = smoke_module()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    frames, _ = smoke.slam_route()
    det = Akaze(AkazeConfig(max_pts=4000), device=dev)
    f1, f2 = (det.detect_and_compute(f) for f in frames[:2])
    intr = tuple(smoke.TUM_INTR[k] for k in ("fx", "fy", "cx", "cy"))
    key = make_key(0)

    def two_view():
        return odometry._two_view(key, f1, f2, *intr, 2e-5, num_hyps=512)

    with programs.eager():
        want = two_view()
    got = two_view()                                # the captures
    result = {"label": args.label, "tree": tree, "card": card,
              "captured_equals_eager": same(torch, two_view(), want)
              and same(torch, got, want)}
    eager, captured = smoke.in_turns(torch, two_view, args.reps)
    result["two_view_eager_ms"] = float(np.median(eager))
    result["two_view_captured_ms"] = float(np.median(captured))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        two_view()
        result["sync_free"] = True
    except RuntimeError as e:
        result["sync_free"] = f"{e}"[:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    m, x1, x2, put = odometry._putative(f1.words, f1.valid, f1.x, f1.y,
                                        f2.words, f2.valid, f2.x, f2.y,
                                        *intr)
    sets = sets_from_key(key, put, 512).to(torch.int64)
    px1 = torch.stack([f1.x, f1.y], -1)
    px2 = torch.stack([m.match_x, m.match_y], -1)
    hsets = draw_minimal_sets(torch.Generator(dev).manual_seed(0), put, 512,
                              4).to(torch.int64)
    calls = {"_putative": (odometry._putative, (
                 f1.words, f1.valid, f1.x, f1.y, f2.words, f2.valid, f2.x,
                 f2.y, *intr), {}),
             "_solve": (odometry._solve, (x1, x2, put, sets, 2e-5),
                        {"num_hyps": 512}),
             "_ransac_homography": (_ransac_homography, (
                 px1, px2, put, hsets, 9.0), {"num_hyps": 512})}
    result["nodes"] = {}
    for name, (prog, a, kw) in calls.items():
        prog(*a, **kw)
        n, ms = smoke.graph_nodes(torch, prog, *a, **kw)
        result["nodes"][name] = {"nodes": n, "device_ms": ms}

    M = eigen_inputs(epipolar, lambda: odometry._solve(
        x1, x2, put, sets, 2e-5, num_hyps=512))
    prof = smoke.device_kernels(torch, lambda: smallest_eigenvector(M))
    v = smallest_eigenvector(M).double().cpu().numpy()
    Mn = M.double().cpu().numpy()
    w = np.linalg.eigh(Mn)[0]
    excess = (np.einsum("bi,bij,bj->b", v, Mn, v) - w[:, 0]) / w[:, -1]
    result["eigenvector"] = {
        "batch": list(M.shape), "dtype": str(M.dtype),
        "device_ms": sum(x[0] for x in prof.values()),
        "kernels": sum(x[1] for x in prof.values()),
        "rq_excess_max": float(excess.max()),
        "rq_excess_median": float(np.median(excess))}

    e = result["eigenvector"]
    print(f"[{args.label}] _two_view on the route's first pair: eager "
          f"{smoke.spread(eager)}, captured {smoke.spread(captured)} (in "
          f"turns); captured = eager bit for bit "
          f"{result['captured_equals_eager']}; sync-free "
          f"{result['sync_free']}")
    print(f"[{args.label}] graph nodes (device ms of one replay): "
          + ", ".join(f"{k} {r['nodes']:.0f} ({r['device_ms']:.3f} ms)"
                      for k, r in result["nodes"].items()))
    print(f"[{args.label}] smallest_eigenvector on {e['batch']} "
          f"{e['dtype']}: {e['kernels']:.0f} kernels, {e['device_ms']:.4f} "
          f"ms device; Rayleigh-quotient excess over numpy's smallest "
          f"eigenvalue / largest eigenvalue: max {e['rq_excess_max']:.3g}, "
          f"median {e['rq_excess_median']:.3g}")
    print(f"[{args.label}] card: {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
