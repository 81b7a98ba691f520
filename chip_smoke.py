#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``akaze_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--stock-dir DIR]

Phases, each of which fails the run (non-zero exit, no result line) on
any disagreement:

  1. the card's name and power limit, torch / CUDA / nvcc versions;
  2. build the three CUDA kernels from ``akaze_tpu_torch/csrc`` (nvcc);
  3. K1 (fused sublevel) against its plain version for all 16 sublevels of
     the 960x1280 plan, B = 2: L/Lx/Ly within 1e-5 of each plane's max,
     det on the interior;
  4. K2 (orientation + descriptor) against its plain version on the
     keypoints and pyramid of the 960x1280 pair: angles within 1e-3 rad,
     flipped descriptor bits (must be 0);
  5. K4 (Hamming top-2) against its plain version, 10000 x 10000 seeded
     words with ~20% invalid rows and planted ties: ``Matches`` equal;
  6. the main path, ``Akaze.detect_and_compute_pair`` + ``Akaze.match`` at
     960x1280, max_pts=10000, with the launch counters reset before and
     read after (K1 16, K2 1, K4 1); on the synthetic pair the known shift
     must be recovered with an inlier fraction > 0.85; a small pair must
     agree with the CPU plain pipeline;
  7. timings with CUDA events: the pair iteration (median of 20 after
     warm-up), its stages, and each kernel against its plain version.

The pair is the stock pair (``left.pgm``/``right.pgm`` under
``--stock-dir``) when given, else a seeded
synthetic 960x1280 texture A and its crop B shifted by (dy, dx) = (7, 13).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H, W = 960, 1280
MAX_PTS = 10000
SHIFT = (7, 13)
SEED = 0
TOL = 1e-5
REPS = 20           # timed pair iterations; the median is the metric


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def synthetic_texture(h: int, w: int, seed: int) -> np.ndarray:
    """Non-repetitive float32 texture in [0, 1]: Gaussian blobs at several
    scales with random signs, plus noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float64)
    area = h * w / (960 * 1280)
    for sigma, count in ((2.0, 5000), (3.5, 3000), (6.0, 1200),
                         (10.0, 400), (16.0, 120)):
        n = max(1, int(count * area))
        ys = rng.uniform(0, h, n)
        xs = rng.uniform(0, w, n)
        amps = rng.uniform(0.2, 0.6, n) * rng.choice((-1.0, 1.0), n)
        r = int(3 * sigma) + 1
        off = np.arange(-r, r + 1)
        for cy, cx, a in zip(ys, xs, amps):
            iy, ix = int(cy), int(cx)
            y0, y1 = max(iy - r, 0), min(iy + r + 1, h)
            x0, x1 = max(ix - r, 0), min(ix + r + 1, w)
            if y0 >= y1 or x0 >= x1:
                continue
            gy = np.exp(-((off + iy - cy) ** 2) / (2 * sigma * sigma))
            gx = np.exp(-((off + ix - cx) ** 2) / (2 * sigma * sigma))
            img[y0:y1, x0:x1] += a * np.outer(
                gy[y0 - iy + r:y1 - iy + r], gx[x0 - ix + r:x1 - ix + r])
    img = 0.5 + 0.5 * img / max(np.abs(img).max(), 1e-9)
    img += 0.02 * rng.standard_normal((h, w))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def load_pair(stock_dir):
    """(image_a, image_b, description, known shift or None)."""
    if stock_dir:
        from akaze_tpu_torch.io import load_pgm
        left = os.path.join(stock_dir, "left.pgm")
        right = os.path.join(stock_dir, "right.pgm")
        if os.path.exists(left) and os.path.exists(right):
            a = load_pgm(left).astype(np.float32) / 255.0
            b = load_pgm(right).astype(np.float32) / 255.0
            check(a.shape == (H, W) and b.shape == (H, W),
                  f"stock pair must be {H}x{W}, got {a.shape}, {b.shape}")
            return a, b, f"stock pair from {stock_dir}", None
        print(f"no stock pair under {stock_dir}; using the synthetic pair")
    dy, dx = SHIFT
    tex = synthetic_texture(H + dy, W + dx, SEED)
    return (tex[:H, :W].copy(), tex[dy:, dx:].copy(),
            f"synthetic seed {SEED}, B = A shifted by (dy, dx) = {SHIFT}",
            SHIFT)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median over ``reps`` of one call's time between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(torch, got, want, margin: int = 0):
    if margin:
        got = got[..., margin:-margin, margin:-margin]
        want = want[..., margin:-margin, margin:-margin]
    scale = max(float(want.abs().max()), 1e-6)
    diff = float((got - want).abs().max())
    return diff / scale, diff


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    from akaze_tpu_torch import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    return card


def phase_build():
    from akaze_tpu_torch import _build
    info = _build.build()
    _build.library()
    print(f"[build] {info['seconds']:.2f} s (cached={info['cached']}) "
          f"-> {os.path.relpath(info['path'])}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())


def record_sublevels(images, plan):
    """Every K1 call that the scale space of ``images`` makes, in pipeline
    order, with its arguments: the main path's own K1 inputs."""
    from akaze_tpu_torch import scale_space

    kernel = scale_space.sublevel
    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    scale_space.sublevel = recording
    try:
        scale_space.build_scale_space(images, plan)
    finally:
        scale_space.sublevel = kernel
    names = [f"o{oi}s{sp.scale}" for oi, octave in enumerate(plan.octaves)
             for sp in octave.scales]
    check(len(calls) == len(names),
          f"{len(names) - len(calls)} sublevels did not take K1")
    return [(name, args, kw) for name, (args, kw) in zip(names, calls)]


def phase_k1(torch, images, plan):
    from akaze_tpu_torch.ops.sublevel import sublevel, sublevel_plain

    calls = record_sublevels(images, plan)
    worst_rel, worst_abs, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
    for name, args, kw in calls:
        got = sublevel(*args, **kw)
        want = sublevel_plain(*args, **kw)
        torch.cuda.synchronize()
        step = args[3]
        for pname, g, w in zip(("L", "det", "lx", "ly"), got, want):
            rel, ab = rel_err(torch, g, w, 2 * step + 2 if pname == "det"
                              else 0)
            check(rel <= TOL, f"K1 {name} {pname}: rel err {rel:.3g}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, ab)
        ms += cuda_ms(torch, lambda: sublevel(*args, **kw))
        plain_ms += cuda_ms(torch, lambda: sublevel_plain(*args, **kw))
    print(f"[K1] {len(calls)} sublevels x B=2 agree: max rel err "
          f"{worst_rel:.3g} (abs {worst_abs:.3g}); per pair {ms:.3f} ms "
          f"vs plain {plain_ms:.3f} ms")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms)


def phase_k2(torch, images, plan):
    from akaze_tpu_torch.descriptor import (finish_descriptors, slot_params,
                                            words_to_numpy)
    from akaze_tpu_torch.ops.describe import (describe, describe_plain,
                                              describe_tables)
    from akaze_tpu_torch.pipeline import detect_batch

    kps, pp = detect_batch(images, plan)
    nplanes = pp.L.shape[0] // 2
    params = [slot_params(k, pp, plan, plane_base=i * nplanes,
                          nplanes=nplanes) for i, k in enumerate(kps)]
    ip = torch.cat([p[0] for p in params])
    fp = torch.cat([p[1] for p in params])
    planes = (pp.L, pp.lx, pp.ly)
    tables = describe_tables(plan.config.descriptor_pattern_size, ip.device)
    a1, c1 = describe(ip, fp, planes, tables)
    a2, c2 = describe_plain(ip, fp, planes, tables)
    torch.cuda.synchronize()
    d = (a1 - a2).abs()
    d = torch.minimum(d, 2 * math.pi - d)
    live = ip[:, 6] > 0
    flips = np.unpackbits(
        (words_to_numpy(finish_descriptors(c1))
         ^ words_to_numpy(finish_descriptors(c2))).view(np.uint8),
        axis=1).sum(1)[live.cpu().numpy()]
    n_live = int(live.sum())
    angle_err = float(d.max())
    acc_err = float((c1 - c2).abs().max())
    print(f"[K2] {n_live} live slots of {ip.shape[0]}: max angle err "
          f"{angle_err:.3g} rad, max cell-sum err {acc_err:.3g}, flipped "
          f"bits max {int(flips.max()) if n_live else 0} mean "
          f"{float(flips.mean()) if n_live else 0.0:.4f}")
    check(n_live > 100, f"too few keypoints for K2: {n_live}")
    check(angle_err < 1e-3, f"K2 angle err {angle_err}")
    check(int(flips.max()) == 0, f"K2 flipped bits: max {flips.max()}")
    ms = cuda_ms(torch, lambda: describe(ip, fp, planes, tables))
    plain_ms = cuda_ms(torch, lambda: describe_plain(ip, fp, planes, tables))
    print(f"[K2] {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    return dict(max_abs_err=max(angle_err, acc_err), ms=ms,
                plain_ms=plain_ms)


def phase_k4(torch, dev):
    from akaze_tpu_torch.descriptor import pack_bits
    from akaze_tpu_torch.match import matches_from_top2
    from akaze_tpu_torch.ops.hamming import (hamming_top2,
                                             hamming_top2_plain, last_live)

    rng = np.random.default_rng(SEED + 4)
    n = MAX_PTS
    b1 = rng.integers(0, 2, (n, 486)).astype(bool)
    b2 = rng.integers(0, 2, (n, 486)).astype(bool)
    near = rng.permutation(n)[: n // 2]
    b2[near] = b1[near] ^ (rng.random((near.size, 486)) < 0.05)
    b2[near[::9] + 1 - (near[::9] == n - 1) * 2] = b2[near[::9]]  # ties
    w1 = pack_bits(torch.from_numpy(b1)).to(dev)
    w2 = pack_bits(torch.from_numpy(b2)).to(dev)
    v1 = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    v2 = torch.from_numpy(rng.random(n) > 0.2).to(dev)
    x2 = torch.from_numpy(rng.uniform(0, W, n).astype(np.float32)).to(dev)
    y2 = torch.from_numpy(rng.uniform(0, H, n).astype(np.float32)).to(dev)
    c1, c2 = last_live(v1), last_live(v2)
    got = hamming_top2(w1, w2, v2, c1, c2)
    want = hamming_top2_plain(w1, w2, v2, c1, c2)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    m1 = matches_from_top2(*got, v1, x2, y2)
    m2 = matches_from_top2(*want, v1, x2, y2)
    same = all(torch.equal(a, b) for a, b in zip(m1, m2))
    ties = int(((want[0] == want[1]) & (want[2] >= 0)).sum())
    print(f"[K4] {n} x {n}, {int((~v2).sum())} invalid train rows, {ties} "
          f"tied minima: top-2 max abs err {err}, Matches equal {same}, "
          f"{int((m1.index >= 0).sum())} accepted")
    check(err == 0 and same, "K4 disagrees with its plain version")
    check(ties > 0, "no planted ties reached the matcher")
    ms = cuda_ms(torch, lambda: hamming_top2(w1, w2, v2, c1, c2))
    plain_ms = cuda_ms(torch, lambda: hamming_top2_plain(w1, w2, v2, c1,
                                                         c2), reps=3)
    print(f"[K4] {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def counters():
    from akaze_tpu_torch.ops.describe import describe
    from akaze_tpu_torch.ops.hamming import hamming_top2
    from akaze_tpu_torch.ops.sublevel import sublevel
    return {"sublevel": sublevel, "describe": describe,
            "hamming": hamming_top2}


def phase_main(torch, det, a, b, shift):
    n_sub = sum(len(o.scales) for o in det.plan_for(H, W).octaves)
    for fn in counters().values():
        fn.launches = 0
    fa, fb = det.detect_and_compute_pair(a, b)
    m = det.match(fa, fb)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"[main] launches {launches}")
    check(launches == {"sublevel": n_sub, "describe": 1, "hamming": 1},
          f"main path launches {launches}")

    for f in (fa, fb):
        check(f.x.shape == (MAX_PTS,) and f.words.shape == (MAX_PTS, 16),
              "feature shapes")
        for name in ("x", "y", "size", "response", "angle"):
            check(bool(torch.isfinite(getattr(f, name)).all()),
                  f"non-finite {name}")
    n = int(fa.count)
    acc = (m.index[:n] >= 0).cpu().numpy()
    dx = (m.match_x[:n] - fa.x[:n]).cpu().numpy()[acc]
    dy = (m.match_y[:n] - fa.y[:n]).cpu().numpy()[acc]
    print(f"[main] counts {n}, {int(fb.count)}; overflow "
          f"{bool(fa.overflow)}, {bool(fb.overflow)}; accepted "
          f"{int(acc.sum())}")
    check(n > 500 and int(fb.count) > 500, "too few keypoints")
    if shift is None:
        print(f"[main] median (dx, dy) = ({np.median(dx)}, {np.median(dy)})")
        check(acc.sum() > 100, "too few accepted matches")
        return launches
    inl = (np.abs(dx + shift[1]) < 1.5) & (np.abs(dy + shift[0]) < 1.5)
    print(f"[main] median (dx, dy) = ({np.median(dx)}, {np.median(dy)}); "
          f"inlier fraction {inl.mean():.4f}")
    check(acc.sum() > 100, "too few accepted matches")
    check(np.median(dx) == -shift[1] and np.median(dy) == -shift[0],
          "known shift not recovered")
    check(inl.mean() > 0.85, f"inlier fraction {inl.mean():.4f}")
    return launches


def phase_small_reference(torch, dev):
    """The card's pipeline against the CPU plain pipeline on a small pair."""
    from akaze_tpu_torch import Akaze, AkazeConfig
    from akaze_tpu_torch.descriptor import words_to_numpy

    tex = synthetic_texture(240 + SHIFT[0], 320 + SHIFT[1], SEED + 1)
    a = tex[:240, :320].copy()
    b = tex[SHIFT[0]:, SHIFT[1]:].copy()
    cfg = AkazeConfig(max_pts=2000, noctaves=2)
    outs = {}
    for d in ("cpu", dev):
        det = Akaze(cfg, device=d)
        fa, fb = det.detect_and_compute_pair(a, b)
        outs[str(d)] = (fa, fb, det.match(fa, fb))
    (ca, cb, cm), (ga, gb, gm) = outs["cpu"], outs[str(dev)]
    for c, g in ((ca, ga), (cb, gb)):
        n = int(c.count)
        check(int(g.count) == n and n > 20, "small pair: counts differ")
        check(bool(torch.equal(c.layer, g.layer.cpu())), "small pair: layer")
        xy = max(float((c.x - g.x.cpu()).abs().max()),
                 float((c.y - g.y.cpu()).abs().max()))
        check(xy < 1e-4, f"small pair: x/y differ by {xy}")
        flips = np.unpackbits((words_to_numpy(c.words)[:n]
                               ^ words_to_numpy(g.words)[:n]).view(np.uint8),
                              axis=1).sum()
        check(flips == 0, f"small pair: {flips} flipped bits")
    check(bool(torch.equal(cm.index, gm.index.cpu())),
          "small pair: matches differ")
    print(f"[check] 240x320 pair on the card equals the CPU plain pipeline "
          f"({int(ca.count)}, {int(cb.count)} keypoints, "
          f"{int((cm.index >= 0).sum())} matches)")


def phase_timing(torch, det, a, b):
    from akaze_tpu_torch.descriptor import orient_describe_multi
    from akaze_tpu_torch.match import match
    from akaze_tpu_torch.pipeline import detect_batch

    at = torch.as_tensor(a, device=det.device)
    bt = torch.as_tensor(b, device=det.device)

    def pair_iteration():
        fa, fb = det.detect_and_compute_pair(at, bt)
        return det.match(fa, fb)

    pair_ms = cuda_ms(torch, pair_iteration, reps=REPS, warmup=3)
    plan = det.plan_for(H, W)
    images = torch.stack([at, bt])
    stages = {"detect (scale space + extrema + refine)": [],
              "describe (pyramid + K2 + bits)": [], "match (K4)": []}
    for _ in range(REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        kps, pp = detect_batch(images, plan)
        ev[1].record()
        out = orient_describe_multi(kps, pp, plan)
        ev[2].record()
        match(out[0][1], kps[0].valid, out[1][1], kps[1].valid, kps[1].x,
              kps[1].y, plan.config.max_dist)
        ev[3].record()
        ev[3].synchronize()
        for k, (s, e) in zip(stages, zip(ev[:-1], ev[1:])):
            stages[k].append(s.elapsed_time(e))
    print(f"[time] pair iteration (detect + describe + match, 960x1280, "
          f"max_pts={MAX_PTS}): median {pair_ms:.3f} ms of {REPS}")
    for k, v in stages.items():
        print(f"[time]   {k}: median {float(np.median(v)):.3f} ms")
    return pair_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stock-dir",
                    help="directory holding left.pgm and right.pgm")
    args = ap.parse_args()

    # the port is the checkout's own, beside this script, never an installed
    # copy: its kernels must build from these sources
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "akaze_tpu_torch")):
        fail("akaze_tpu_torch/ is not beside chip_smoke.py; run it from a "
             "checkout of the repository")
    sys.path.insert(0, here)
    import torch
    import akaze_tpu_torch  # noqa: F401
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = phase_device(torch)
    phase_build()
    a, b, desc, shift = load_pair(args.stock_dir)
    print(f"[pair] {desc}")

    from akaze_tpu_torch import Akaze, AkazeConfig
    det = Akaze(AkazeConfig(max_pts=MAX_PTS), device=dev)
    plan = det.plan_for(H, W)
    check(sum(len(o.scales) for o in plan.octaves) == 16,
          "the 960x1280 plan must have 16 sublevels")
    images = torch.stack([torch.as_tensor(x, device=dev) for x in (a, b)])
    k1 = phase_k1(torch, images, plan)
    k2 = phase_k2(torch, images, plan)
    k4 = phase_k4(torch, dev)
    launches = phase_main(torch, det, a, b, shift)
    phase_small_reference(torch, dev)
    pair_ms = phase_timing(torch, det, a, b)
    print(f"[time] card: {card}; pair iteration {pair_ms:.3f} ms")

    rows = [
        ("sublevel_kernel", "akaze_tpu_torch/csrc/sublevel.cu",
         "akaze_tpu/ops/pallas_sublevel.py:423", launches["sublevel"], k1),
        ("describe_kernel", "akaze_tpu_torch/csrc/describe.cu",
         "akaze_tpu/ops/pallas_describe.py:1107", launches["describe"], k2),
        ("hamming_kernel", "akaze_tpu_torch/csrc/hamming.cu",
         "akaze_tpu/ops/pallas_match.py:103", launches["hamming"], k4),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]} for name, src, rep, n, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
