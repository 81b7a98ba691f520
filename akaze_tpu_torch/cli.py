"""Demo / benchmark CLI: the reference's main.cpp as a module entry point.

Port of ``akaze_tpu/cli.py``.  Replicates the demo lifecycle
(main.cpp:17-341): load a grayscale pair, detect and describe both images,
brute-force match, print counts and stage timings, and write keypoint and
match renderings.  It runs on the card (``--device cuda``, the default,
which raises without one); ``--device cpu`` runs every kernel's plain
version.

Usage:
    python -m akaze_tpu_torch.cli --left PATH --right PATH [--fixed]
                                  [--iters N] [--out-dir DIR] [--max-pts N]
                                  [--no-draw] [--json] [--device DEV]
                                  [--spatial N]

``--spatial N`` row-shards each image over an N-shard mesh (the spatial
tier, for images larger than one device's memory; ``Akaze(mesh=...)``).
With ``--device cuda`` the shards are the first N visible cards, and it
raises when fewer are visible, as the JAX CLI does; a device with an index
(``cuda:0``) or ``cpu`` holds all N shards.

``--left`` and ``--right`` are required: the package ships no image pair
(the reference's stereo pair, main.cpp:139-143, is not part of this
repository).  A missing file raises.

Timing (the reference averages 100 repeats, main.cpp:199-216): after a first
pair iteration and match, whose wall time (``compile_s``) covers the
programs' warm-up and capture on the card (one CUDA graph per static
signature, ``programs.py``; as the JAX CLI's covers compilation) and the
kernels' build when the checkout has no library yet, ``detect_pair_ms`` is
the median over ``--iters`` calls of ``detect_and_compute_pair`` and
``match_ms`` the median over 10 x ``--iters`` calls of ``Akaze.match``
with ``config.max_dist``, each between CUDA events on the card (host
launch work included), with ``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

def _median_ms(fn, reps: int, device) -> float:
    """Median over ``reps`` calls of ``fn``'s time: CUDA events on the
    card, the host clock on the CPU."""
    import torch

    times = []
    for _ in range(reps):
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def spatial_mesh(n: int, device: str):
    """The ``--spatial`` mesh: the first ``n`` visible cards for a
    ``cuda`` device without an index (raises when fewer are visible), else
    ``n`` shards on the one device named."""
    import torch
    from .parallel import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(n)
    return make_mesh(n, devices=[dev] * n)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="AKAZE demo/benchmark on the PyTorch + CUDA port")
    ap.add_argument("--left", required=True,
                    help="left grayscale image (PGM, or a format PIL "
                         "reads)")
    ap.add_argument("--right", required=True,
                    help="right grayscale image (PGM, or a format PIL "
                         "reads)")
    ap.add_argument("--fixed", action="store_true",
                    help="16.16 fixed-point pipeline (fastakaze)")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed pair iterations, and 10x as many match "
                         "calls (reference uses 100)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--max-pts", type=int, default=10000)
    ap.add_argument("--no-draw", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line instead of text; compile_s "
                         "is the first pair iteration's wall time: the "
                         "programs' warm-up and CUDA-graph capture, and the "
                         "kernel build when there is none yet")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card, which raises "
                         "without one; 'cpu' runs the plain versions)")
    ap.add_argument("--spatial", type=int, default=0, metavar="N",
                    help="row-shard each image over an N-shard mesh "
                         "(images larger than one device's memory): the "
                         "first N cards for --device cuda (raises when "
                         "fewer are visible), else N shards on the one "
                         "device named")
    args = ap.parse_args(argv)

    import torch
    from . import Akaze, AkazeConfig
    from .io import load_gray

    left = load_gray(args.left)
    right = load_gray(args.right)
    if not args.fixed:
        left_in = left.astype(np.float32) / 255.0
        right_in = right.astype(np.float32) / 255.0
    else:
        left_in, right_in = left, right

    cfg = AkazeConfig(max_pts=args.max_pts)
    mesh = (spatial_mesh(args.spatial, args.device) if args.spatial > 1
            else None)
    det = Akaze(cfg, fixed=args.fixed, mesh=mesh,
                device=None if mesh else args.device)
    if mesh is not None:
        try:
            det.sharded(*left.shape)
        except ValueError as e:
            ap.error(f"--spatial {args.spatial}: {e}")
    dev = det.device
    dtype = torch.int32 if args.fixed else torch.float32
    la = torch.as_tensor(left_in, device=dev).to(dtype)
    ra = torch.as_tensor(right_in, device=dev).to(dtype)

    # first pair iteration: builds the kernels if needed, and gives the
    # features to match and draw
    t0 = time.perf_counter()
    fa, fb = det.detect_and_compute_pair(la, ra)
    m = det.match(fa, fb)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0

    iters = max(args.iters, 1)
    detect_ms = _median_ms(lambda: det.detect_and_compute_pair(la, ra),
                           iters, dev)
    match_ms = _median_ms(lambda: det.match(fa, fb, det.config.max_dist),
                          10 * iters, dev)

    na, nb = int(fa.count), int(fb.count)
    acc = m.index[:na].cpu().numpy() >= 0
    n_match = int(acc.sum())
    overflow = bool(fa.overflow) or bool(fb.overflow)

    if args.json:
        print(json.dumps({
            "left_pts": na, "right_pts": nb, "matches": n_match,
            "detect_pair_ms": round(detect_ms, 3),
            "match_ms": round(match_ms, 3),
            "compile_s": round(compile_s, 1),
            "overflow": overflow,
            "fixed": args.fixed, "backend": dev.type}))
    else:
        mode = "fastakaze (16.16 int)" if args.fixed else "akaze (float32)"
        print(f"[{mode}] backend={dev.type}"
              + (f" spatial={args.spatial}" if mesh else ""))
        print(f"Number of features: {na} / {nb}")
        print(f"Matched features:   {n_match}")
        print(f"Detect+describe (both images, median of {iters}): "
              f"{detect_ms:.2f} ms")
        print(f"Match: {match_ms:.2f} ms   (first pair, capture and build "
              f"included: {compile_s:.1f} s)")
        if overflow:
            print("warning: keypoint capacity overflow: some NMS "
                  "survivors were dropped (raise max_pts)")

    if not args.no_draw:
        from .viz import draw_keypoints, draw_matches, write_png
        os.makedirs(args.out_dir, exist_ok=True)
        tag = "fastakaze" if args.fixed else "akaze"
        x, y, size = (v[:na].cpu().numpy() for v in (fa.x, fa.y, fa.size))
        write_png(os.path.join(args.out_dir, f"{tag}_keypoints.png"),
                  draw_keypoints(left, x, y, size))
        mm = draw_matches(left, right, x, y, m.match_x[:na].cpu().numpy(),
                          m.match_y[:na].cpu().numpy(), acc,
                          horizontal=left.shape[1] <= left.shape[0])
        write_png(os.path.join(args.out_dir, f"{tag}_matches.png"), mm)
        if not args.json:
            print(f"Wrote {tag}_keypoints.png / {tag}_matches.png "
                  f"to {args.out_dir}")


if __name__ == "__main__":
    main()
