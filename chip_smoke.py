#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``akaze_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--stock-dir DIR]

Phases, each of which fails the run (non-zero exit, no result line) on
any disagreement:

  1. the card's name and power limit, torch / CUDA / nvcc versions;
  2. build the CUDA kernels from ``akaze_tpu_torch/csrc`` (one nvcc per
     source, all started together);
  3. K1 against its plain version on every octave of the 960x1280 plan,
     B = 2, through the scale space's own calls: the tiled kernel on
     octaves 0-2 and the octave-resident kernel on octave 3; on all 16
     sublevels L/Lx/Ly/det within 1e-5 of each plane's max, det on the
     whole plane for resident octaves and on the interior for tiled ones;
  4. K2 (orientation + descriptor) against its plain version on the
     keypoints and pyramid of the 960x1280 pair: angles within 1e-3 rad,
     flipped descriptor bits (must be 0); the float flavour on bf16 planes
     and, for ``bf16_sampling=False``, on f32 planes;
  5. K4 (Hamming top-2 on the tensor cores) against its plain version,
     10000 x 10000 seeded words with ~20% invalid rows and planted ties (a
     stress shape the main path never has): all three outputs equal,
     ``Matches`` equal;
  6. the main path, ``Akaze.detect_and_compute_pair`` + ``Akaze.match`` at
     960x1280, max_pts=10000, with the launch counters reset before and
     read after (K1 13 = 12 tiled + 1 resident, K2 1, K4 1); on the
     synthetic pair the known shift must be recovered with an inlier
     fraction > 0.85; K4 held against its plain version at the pair's own
     live counts; a warm pair iteration under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); a small
     pair must agree with the CPU plain pipeline; the same main path with
     ``bf16_sampling=False`` (K2 on f32 planes); one image with
     ``describe=False`` (K1 13 launches at B = 1, no K2, no K4);
  7. timings: each kernel's device time per launch and per pair from
     ``torch.profiler`` kernel durations over main-path pair iterations,
     the wrappers' host time per call (20 calls, no synchronisation), the
     event-bracketed call time (host + device) and the plain versions';
     the pair iteration (median of 20 after warm-up) and its stages;
  8. the 16.16 fixed-point path (``Akaze(..., fixed=True)``) on the pair
     quantised to raw 0..255: K1's fixed flavours against their plain
     version on all 16 sublevels, bit-exact (det on the whole plane for
     resident octaves); K2's exact fixed flavour on the fixed pair's
     keypoints, 0 flipped bits; the main path for both descriptor flavours
     (exact, ``fixed_exact_sampling=True``, and approximate, the default),
     each with its launch counters reset before and read after, the shift
     recovered; a small pair of each flavour against the CPU plain
     pipeline; no host sync in a warm pair iteration; and the same
     timings;
  9. the SLAM path, the TUM RGB-D configuration (``SlamSystem`` with the
     VO defaults and ``local_ba_every=2``, intrinsics fx = fy = 525,
     cx = 319.5, cy = 239.5) over a seeded out-and-back route of 480x640
     ``synthetic_sequence`` frames: K1 at B = 1 against its plain version
     on every octave of the 480x640 plan, and K2's single-image launch
     (which serves K3) on one frame's slots (angles within 1e-3 rad, 0
     flipped bits); the route with the launch counters reset before and
     read after (K1, K2 and K4 on every tracked frame), each frame timed
     between CUDA events; every pose finite, a loop edge accepted, PGO
     run, local BA finite; the host profile by section, device kernels per
     tracked frame (profiler), the keyframe ATE against the true offsets
     (printed, not gated); the route again, bit for bit equal, with host
     syncs per frame counted under ``set_sync_debug_mode("warn")``; K4 at
     the route's live counts; and the small sequences of
     tests/test_torch_slam.py on the card against the CPU with the CPU
     run's minimal sets replayed.

The pair is the stock pair (``left.pgm``/``right.pgm`` under
``--stock-dir``) when given, else a seeded
synthetic 960x1280 texture A and its crop B shifted by (dy, dx) = (7, 13).

The line before the last is ``{"kernels": [...]}``: per kernel its
launches on the main path, device time per pair (``ms``; per frame for the
SLAM path's rows, ``*_slam`` and ``describe_kernel_single``) and per launch
(``device_ms``), host time per wrapper call (``host_us``), event-bracketed
time (``event_ms``, host + device), the plain version's time, and the
bound computed from this run's inputs.  The last line is
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
HOST_CALLS = 20     # wrapper calls per host-time measurement
PROFILE_REPS = 3    # profiled main-path pair iterations
# NVIDIA H100 SXM published peaks: device memory,
# float32 outside the tensor cores (also taken for K1's int32 flavour),
# int8 tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12
# K2 taps per live slot: 109 live orientation taps of Lx and Ly, 441 MLDB
# taps of L, Lx and Ly (csrc/describe.cu)
K2_TAPS = 109 * 2 + 441 * 3


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
    """(float pair in [0, 1], raw 0..255 uint8 pair for the fixed path,
    description, known shift or None)."""
    if stock_dir:
        from akaze_tpu_torch.io import load_pgm
        left = os.path.join(stock_dir, "left.pgm")
        right = os.path.join(stock_dir, "right.pgm")
        if os.path.exists(left) and os.path.exists(right):
            raw = (load_pgm(left), load_pgm(right))
            check(all(r.shape == (H, W) for r in raw),
                  f"stock pair must be {H}x{W}")
            return (tuple(r.astype(np.float32) / 255.0 for r in raw), raw,
                    f"stock pair from {stock_dir}", None)
        print(f"no stock pair under {stock_dir}; using the synthetic pair")
    dy, dx = SHIFT
    tex = synthetic_texture(H + dy, W + dx, SEED)
    pair = (tex[:H, :W].copy(), tex[dy:, dx:].copy())
    return (pair, tuple(quantise(x) for x in pair),
            f"synthetic seed {SEED}, B = A shifted by (dy, dx) = {SHIFT}",
            SHIFT)


def quantise(x: np.ndarray) -> np.ndarray:
    """A texture in [0, 1] as raw 0..255, the fixed path's input."""
    return (x * 255).astype(np.uint8)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median over ``reps`` of one call's time between CUDA events: host
    work before the launches included (host + device)."""
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


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host time of one call: ``calls`` calls with no synchronisation."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_kernels(torch, fn, reps: int = PROFILE_REPS) -> dict:
    """{kernel name: (device ms, launches)} per call of ``fn``, from
    ``torch.profiler`` (CUPTI) kernel durations over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        ns, n = out.get(e.name(), (0, 0))
        out[e.name()] = (ns + e.duration_ns(), n + 1)
    return {k: (ns / reps / 1e6, n / reps) for k, (ns, n) in out.items()}


def profiled(torch, fn, needles, reps: int = PROFILE_REPS) -> dict:
    """``device_kernels`` of ``fn``, taken again (up to 3 times) while a
    kernel named by one of ``needles`` is missing: the trace can drop
    events."""
    for _ in range(3):
        prof = device_kernels(torch, fn, reps)
        missing = [n for n in needles if not any(n in k for k in prof)]
        if not missing:
            return prof
    fail(f"no {missing} kernel in 3 profiler traces")


def kernel_time(profile: dict, needle: str):
    """(device ms, launches) per call of the kernels whose name holds
    ``needle``; fails when the trace has none."""
    hits = [v for k, v in profile.items() if needle in k]
    check(bool(hits), f"no {needle} kernel in the profiler trace")
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def bound(nbytes: float, ops: float, op_rate: float = F32_OPS_PER_S):
    """(least ms, what binds): bytes over the memory rate or operations
    over the peak rate, the larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


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
        if any(k in line for k in ("Function properties", "registers",
                                   "spill")):
            print("[build]", line.strip())


def record_octaves(images, plan):
    """Every K1 call that the scale space of ``images`` makes, in pipeline
    order, with its arguments: the main path's own K1 inputs."""
    from akaze_tpu_torch import scale_space

    kernel = scale_space.octave
    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    scale_space.octave = recording
    try:
        scale_space.build_scale_space(images, plan)
    finally:
        scale_space.octave = kernel
    check(len(calls) == len(plan.octaves),
          f"{len(plan.octaves) - len(calls)} octaves did not take K1")
    return calls


def k1_work(oct_plan, batch: int, given_smooth: bool, resident: bool):
    """(bytes, operations) K1 must move and do for one octave: each launch
    reads its input once and writes each of its planes once (a tiled
    launch is one sublevel, a resident one the octave), and every stencil
    operation of the plain version is counted once per pixel."""
    px = batch * oct_plan.height * oct_plan.width
    S = len(oct_plan.scales)
    planes = (1 + given_smooth + 4 * S) if resident else (5 * S + given_smooth)
    ops = 0
    for s, sp in enumerate(oct_plan.scales):
        if not (s == 0 and given_smooth):
            r = 4 if (s == 0 and oct_plan.octave == 0) else 2
            ops += 2 * (1 + 3 * r)                       # Gaussian, 2 passes
        if sp.taus:
            ops += 20 + 17 * len(sp.taus)                # flow, FED steps
        ops += 14 + 24                                   # Lx, Ly; det
    return 4 * px * planes, ops * px


def phase_k1(torch, images, plan, tag="K1"):
    """K1 against its plain version on every octave of the pair's scale
    space.  int32 images take the fixed flavours, held bit-exact.  Returns
    per kernel (tiled, resident) its errors, event-bracketed and plain
    times, host time per launch and bound."""
    from akaze_tpu_torch.ops import sublevel as k1

    fixed = images.dtype == torch.int32
    tol = 0.0 if fixed else TOL
    calls = record_octaves(images, plan)
    res = {kind: dict(octaves=[], max_abs_err=0.0, max_rel=0.0, event_ms=0.0,
                      plain_ms=0.0, event_ms1=0.0, plain_ms1=0.0, host=0.0,
                      launches=0, bytes=0, ops=0)
           for kind in ("tiled", "resident")}
    for oi, ((args, kw), op) in enumerate(zip(calls, plan.octaves)):
        check(kw["fixed"] == fixed, f"{tag} octave {oi}: flavour")
        resident = k1.routes_resident(op, kw.get("base"))
        r = res["resident" if resident else "tiled"]
        r["octaves"].append(oi)
        got = k1.octave(*args, **kw)
        want = k1.octave_plain(*args, **kw)
        torch.cuda.synchronize()
        for s, sp in enumerate(op.scales):
            for pname, g, w in zip(("L", "det", "lx", "ly"), got, want):
                check(g.dtype == w.dtype == images.dtype,
                      f"{tag} o{oi}s{s} type")
                margin = (2 * sp.sigma_size + 2
                          if pname == "det" and not resident else 0)
                rel, ab = rel_err(torch, g[:, s].double(), w[:, s].double(),
                                  margin)
                check(rel <= tol, f"{tag} o{oi}s{s} {pname}: rel err "
                      f"{rel:.3g} ({'resident' if resident else 'tiled'})")
                r["max_rel"] = max(r["max_rel"], rel)
                r["max_abs_err"] = max(r["max_abs_err"], ab)
        r["event_ms"] += cuda_ms(torch, lambda: k1.octave(*args, **kw))
        r["plain_ms"] += cuda_ms(torch, lambda: k1.octave_plain(*args, **kw))
        before = k1.launches()
        k1.octave(*args, **kw)
        n = k1.launches() - before
        check(n == (1 if resident else len(op.scales)),
              f"{tag} octave {oi}: {n} launches")
        r["launches"] += n
        r["host"] += host_us(torch, lambda: k1.octave(*args, **kw))
        nb, no = k1_work(op, images.shape[0], kw.get("smooth") is not None,
                         resident)
        r["bytes"] += nb
        r["ops"] += no
        # B = 1, the single-image form (fused_sublevel of the JAX package)
        args1 = tuple(a[:1] if isinstance(a, torch.Tensor) else a
                      for a in args)
        kw1 = {k: v[:1] if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        r["event_ms1"] += cuda_ms(torch, lambda: k1.octave(*args1, **kw1))
        r["plain_ms1"] += cuda_ms(torch,
                                  lambda: k1.octave_plain(*args1, **kw1))
    for kind, r in res.items():
        r["host_us"] = r["host"] / max(r["launches"], 1)
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])
        print(f"[{tag} {kind}] octaves {r['octaves']}, {r['launches']} "
              f"launches, every sublevel agrees: max rel err "
              f"{r['max_rel']:.3g} (abs {r['max_abs_err']:.3g}), det on the "
              f"{'whole plane' if kind == 'resident' else 'interior'}; "
              f"event-bracketed (host + device) {r['event_ms']:.3f} ms per "
              f"pair vs plain {r['plain_ms']:.3f} ms; B=1 per image "
              f"{r['event_ms1']:.3f} ms vs plain {r['plain_ms1']:.3f} ms; "
              f"host {r['host_us']:.1f} us per launch; bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}: "
              f"{r['bytes'] / 1e6:.1f} MB, {r['ops'] / 1e9:.3f} Gop)")
    return res


def phase_k2(torch, images, plan, fixed=False, tag="K2"):
    """K2 against its plain version on the keypoints and pyramid of
    ``images`` (the pair, or one image: the single-image launch that serves
    K3), on the planes ``plan`` gives; ``fixed``: the fixed path's exact
    flavour (``plan`` must select it)."""
    from akaze_tpu_torch.descriptor import (finish_descriptors, plane_dtype,
                                            slot_params, words_to_numpy)
    from akaze_tpu_torch.ops.describe import (describe, describe_plain,
                                              describe_tables)
    from akaze_tpu_torch.pipeline import detect_batch

    check(not fixed or plan.config.fixed_descriptor_exact,
          f"{tag}: the configuration selects another flavour")
    kps, pp = detect_batch(images, plan, fixed=fixed)
    check(pp.L.dtype == plane_dtype(plan, fixed), f"{tag}: plane type")
    nplanes = pp.L.shape[0] // len(kps)
    params = [slot_params(k, pp, plan, plane_base=i * nplanes,
                          nplanes=nplanes) for i, k in enumerate(kps)]
    ip = torch.cat([p[0] for p in params])
    fp = torch.cat([p[1] for p in params])
    planes = (pp.L, pp.lx, pp.ly)
    tables = describe_tables(plan.config.descriptor_pattern_size, ip.device)
    a1, c1 = describe(ip, fp, planes, tables, fixed)
    a2, c2 = describe_plain(ip, fp, planes, tables, fixed)
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
    print(f"[{tag}] {pp.L.dtype} planes, {n_live} live slots of "
          f"{ip.shape[0]}: max angle err "
          f"{angle_err:.3g} rad, max cell-sum err {acc_err:.3g}, flipped "
          f"bits max {int(flips.max()) if n_live else 0} mean "
          f"{float(flips.mean()) if n_live else 0.0:.4f}")
    check(n_live > 100, f"too few keypoints for {tag}: {n_live}")
    check(angle_err < 1e-3, f"{tag} angle err {angle_err}")
    check(int(flips.max()) == 0, f"{tag} flipped bits: max {flips.max()}")
    event = cuda_ms(torch, lambda: describe(ip, fp, planes, tables, fixed))
    plain_ms = cuda_ms(torch, lambda: describe_plain(ip, fp, planes, tables,
                                                     fixed))
    host = host_us(torch, lambda: describe(ip, fp, planes, tables, fixed))
    nbytes = (n_live * K2_TAPS * pp.L.element_size()
              + ip.numel() * 4 + fp.numel() * 4 + a1.numel() * 4
              + c1.numel() * 4)
    bms, by = bound(nbytes, 0)
    print(f"[{tag}] event-bracketed (host + device) {event:.3f} ms vs plain "
          f"{plain_ms:.3f} ms; host {host:.1f} us per call; bound "
          f"{bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.2f} MB)")
    return dict(max_abs_err=max(angle_err, acc_err), event_ms=event,
                plain_ms=plain_ms, host_us=host, bound_ms=bms, bound_by=by)


def k4_case(torch, tag, w1, w2, v1, v2, x2, y2, plain_reps=3):
    """K4 against its plain version on one input: ``Matches`` equal; its
    times, host time and bound (the +-1 int8 tensor-core form of the TPU
    kernel: 2 x 486 operations per live pair)."""
    from akaze_tpu_torch.match import matches_from_top2
    from akaze_tpu_torch.ops.hamming import (hamming_top2,
                                             hamming_top2_plain, last_live)

    c1, c2 = last_live(v1), last_live(v2)
    got = hamming_top2(w1, w2, v2, c1, c2)
    want = hamming_top2_plain(w1, w2, v2, c1, c2)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    m1 = matches_from_top2(*got, v1, x2, y2)
    m2 = matches_from_top2(*want, v1, x2, y2)
    same = all(torch.equal(a, b) for a, b in zip(m1, m2))
    ties = int(((want[0] == want[1]) & (want[2] >= 0)).sum())
    n1, n2 = int(c1), int(c2)
    print(f"[{tag}] {n1} x {n2} live extents of {w1.shape[0]} x "
          f"{w2.shape[0]}, {int((~v2).sum())} invalid train rows, {ties} "
          f"tied minima: top-2 max abs err {err}, Matches equal {same}, "
          f"{int((m1.index >= 0).sum())} accepted")
    check(err == 0 and same, f"{tag}: K4 disagrees with its plain version")
    fn = lambda: hamming_top2(w1, w2, v2, c1, c2)  # noqa: E731
    event = cuda_ms(torch, fn)
    plain_ms = cuda_ms(torch, lambda: hamming_top2_plain(w1, w2, v2, c1, c2),
                       reps=plain_reps)
    host = host_us(torch, fn)
    dev_ms, _ = kernel_time(profiled(torch, fn, ("hamming_kernel",)),
                            "hamming_kernel")
    nbytes = (n1 + n2) * 64 + n2 + 3 * 4 * w1.shape[0]
    bms, by = bound(nbytes, 2 * 486 * n1 * n2, INT8_TC_OPS_PER_S)
    print(f"[{tag}] device {dev_ms:.4f} ms (profiler); event-bracketed "
          f"(host + device) {event:.3f} ms vs plain {plain_ms:.3f} ms; host "
          f"{host:.1f} us per call; bound {bms * 1e3:.2f} us ({by}; popcount "
          f"form {n1 * n2 * 16 / (132 * 16 * 1.98e9) * 1e6:.1f} us)")
    return dict(max_abs_err=err, ties=ties, device_ms=dev_ms, event_ms=event,
                plain_ms=plain_ms, host_us=host, bound_ms=bms, bound_by=by)


def k4_stress_inputs(torch, dev):
    """(w1, w2, v1, v2, x2, y2) of the 10000 x 10000 stress shape: seeded
    words, near copies, planted ties, ~10% / ~20% invalid rows."""
    from akaze_tpu_torch.descriptor import pack_bits

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
    return w1, w2, v1, v2, x2, y2


def phase_k4(torch, dev):
    """The 10000 x 10000 stress shape with planted ties."""
    r = k4_case(torch, "K4 stress", *k4_stress_inputs(torch, dev))
    check(r["ties"] > 0, "no planted ties reached the matcher")
    return r


def counters():
    from akaze_tpu_torch.ops.describe import describe
    from akaze_tpu_torch.ops.hamming import hamming_top2
    from akaze_tpu_torch.ops.sublevel import octave, sublevel
    return {"tiled": sublevel, "resident": octave, "describe": describe,
            "hamming": hamming_top2}


# K1 launches of the 960x1280 plan: octaves 0-2 tiled (4 + 4 + 4), octave 3
# resident (1)
MAIN_LAUNCHES = {"tiled": 12, "resident": 1, "describe": 1, "hamming": 1}


def phase_main(torch, det, a, b, shift, tag="main"):
    from akaze_tpu_torch.ops.sublevel import octave_launches
    plan = det.plan_for(H, W)
    check(sum(octave_launches(o) for o in plan.octaves)
          == MAIN_LAUNCHES["tiled"] + MAIN_LAUNCHES["resident"],
          "the plan's K1 launches")
    for fn in counters().values():
        fn.launches = 0
    fa, fb = det.detect_and_compute_pair(a, b)
    m = det.match(fa, fb)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"[{tag}] launches {launches} (K1 "
          f"{launches['tiled'] + launches['resident']})")
    check(launches == MAIN_LAUNCHES, f"main path launches {launches}")

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
    print(f"[{tag}] counts {n}, {int(fb.count)}; overflow "
          f"{bool(fa.overflow)}, {bool(fb.overflow)}; accepted "
          f"{int(acc.sum())}")
    check(n > 500 and int(fb.count) > 500, "too few keypoints")
    k4 = k4_case(torch, f"K4 {tag}", fa.words, fb.words, fa.valid, fb.valid,
                 fb.x, fb.y)
    if shift is None:
        print(f"[{tag}] median (dx, dy) = ({np.median(dx)}, "
              f"{np.median(dy)})")
        check(acc.sum() > 100, "too few accepted matches")
        return launches, k4, fa
    inl = (np.abs(dx + shift[1]) < 1.5) & (np.abs(dy + shift[0]) < 1.5)
    print(f"[{tag}] median (dx, dy) = ({np.median(dx)}, {np.median(dy)}); "
          f"inlier fraction {inl.mean():.4f}")
    check(acc.sum() > 100, "too few accepted matches")
    check(np.median(dx) == -shift[1] and np.median(dy) == -shift[0],
          "known shift not recovered")
    check(inl.mean() > 0.85, f"inlier fraction {inl.mean():.4f}")
    return launches, k4, fa


def phase_profile(torch, det, a, b, tag="profile"):
    """Device time of each kernel over main-path pair iterations."""
    at = torch.as_tensor(a, device=det.device)
    bt = torch.as_tensor(b, device=det.device)

    def pair_iteration():
        fa, fb = det.detect_and_compute_pair(at, bt)
        return det.match(fa, fb)

    prof = profiled(torch, pair_iteration, ("tiled_kernel", "octave_kernel",
                                            "describe_kernel",
                                            "hamming_kernel"))
    total = sum(v[0] for v in prof.values())
    print(f"[{tag}] {sum(v[1] for v in prof.values()):.0f} device kernels, "
          f"{total:.3f} ms device time per pair")
    return prof


def phase_no_sync(torch, det, a, b, tag="no sync"):
    """A warm pair iteration on card tensors under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that makes the
    host wait for the card raises."""
    at = torch.as_tensor(a, device=det.device)
    bt = torch.as_tensor(b, device=det.device)
    want = det.match(*det.detect_and_compute_pair(at, bt))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = det.match(*det.detect_and_compute_pair(at, bt))
    except RuntimeError as e:
        fail(f"{tag}: a warm pair iteration synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(torch.equal(got.index, want.index)), f"{tag}: results moved")
    print(f"[{tag}] a warm pair iteration ran under sync debug mode "
          f"'error': no host synchronisation")


def phase_describe_false(torch, det, a, fa, tag="describe=False"):
    """One image with ``describe=False``: K1 only (13 launches at B = 1),
    the pair's keypoints of that image, angle 0, zero words; and K1's
    device time per image (the JAX package's ``fused_sublevel``, B = 1)."""
    at = torch.as_tensor(a, device=det.device)
    for fn in counters().values():
        fn.launches = 0
    f = det.detect_and_compute(at, describe=False)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    check(launches == dict(MAIN_LAUNCHES, describe=0, hamming=0),
          f"{tag}: launches {launches}")
    n = int(fa.count)
    check(int(f.count) == n and bool(torch.equal(f.x, fa.x))
          and bool(torch.equal(f.layer, fa.layer)),
          f"{tag}: keypoints differ from the pair's")
    check(not bool(f.angle.any()) and not bool(f.words.any()),
          f"{tag}: angle or words not zero")
    needle = "<int>" if det.fixed else "<float>"
    prof = profiled(torch, lambda: det.detect_and_compute(at, describe=False),
                    ("tiled_kernel" + needle, "octave_kernel" + needle))
    tiled, nt = kernel_time(prof, "tiled_kernel" + needle)
    resident, nr = kernel_time(prof, "octave_kernel" + needle)
    check(not any("describe_kernel" in k or "hamming_kernel" in k
                  for k in prof), f"{tag}: K2 or K4 in the trace")
    print(f"[{tag}] launches {launches}; {n} keypoints equal to the pair's; "
          f"K1 B=1 device {tiled:.4f} + {resident:.4f} ms per image "
          f"({nt:.0f} + {nr:.0f} launches)")
    return tiled, resident


def phase_small_reference(torch, dev, fixed=False, exact=False,
                          tag="check"):
    """The card's pipeline against the CPU plain pipeline on a small pair
    (``fixed``: the fixed path on the pair quantised to raw 0..255, with the
    ``exact`` or the approximate descriptor)."""
    from akaze_tpu_torch import Akaze, AkazeConfig
    from akaze_tpu_torch.descriptor import words_to_numpy

    tex = synthetic_texture(240 + SHIFT[0], 320 + SHIFT[1], SEED + 1)
    a = tex[:240, :320].copy()
    b = tex[SHIFT[0]:, SHIFT[1]:].copy()
    if fixed:
        a, b = quantise(a), quantise(b)
    cfg = AkazeConfig(max_pts=2000, noctaves=2, fixed_exact_sampling=exact)
    outs = {}
    for d in ("cpu", dev):
        det = Akaze(cfg, fixed=fixed, device=d)
        fa, fb = det.detect_and_compute_pair(a, b)
        outs[str(d)] = (fa, fb, det.match(fa, fb))
    (ca, cb, cm), (ga, gb, gm) = outs["cpu"], outs[str(dev)]
    for c, g in ((ca, ga), (cb, gb)):
        n = int(c.count)
        check(int(g.count) == n and n > 20, "small pair: counts differ")
        check(bool(torch.equal(c.layer, g.layer.cpu())), "small pair: layer")
        xy = max(float((c.x - g.x.cpu()).abs().max()),
                 float((c.y - g.y.cpu()).abs().max()))
        # the fixed path's det planes are integers, equal on both sides
        check(xy == 0 if fixed else xy < 1e-4,
              f"small pair: x/y differ by {xy}")
        flips = np.unpackbits((words_to_numpy(c.words)[:n]
                               ^ words_to_numpy(g.words)[:n]).view(np.uint8),
                              axis=1).sum()
        check(flips == 0, f"small pair: {flips} flipped bits")
    check(bool(torch.equal(cm.index, gm.index.cpu())),
          "small pair: matches differ")
    print(f"[{tag}] 240x320 pair on the card equals the CPU plain pipeline "
          f"({int(ca.count)}, {int(cb.count)} keypoints, "
          f"{int((cm.index >= 0).sum())} matches)")


def phase_timing(torch, det, a, b, tag="time"):
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
        kps, pp = detect_batch(images, plan, fixed=det.fixed)
        ev[1].record()
        out = orient_describe_multi(kps, pp, plan, det.fixed)
        ev[2].record()
        match(out[0][1], kps[0].valid, out[1][1], kps[1].valid, kps[1].x,
              kps[1].y, plan.config.max_dist)
        ev[3].record()
        ev[3].synchronize()
        for k, (s, e) in zip(stages, zip(ev[:-1], ev[1:])):
            stages[k].append(s.elapsed_time(e))
    print(f"[{tag}] pair iteration (detect + describe + match, 960x1280, "
          f"max_pts={MAX_PTS}): median {pair_ms:.3f} ms of {REPS}")
    for k, v in stages.items():
        print(f"[{tag}]   {k}: median {float(np.median(v)):.3f} ms")
    return pair_ms


# --------------------------------------------------------------------------
# the SLAM path (the TUM RGB-D configuration of BASELINE.json)
# --------------------------------------------------------------------------

SLAM_H, SLAM_W = 480, 640
# TUM RGB-D's documented default calibration (fx, fy, cx, cy)
TUM_INTR = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5)
SLAM_OUT = 30            # outbound frames of the route
SLAM_STEP = 64           # px between outbound frames
# blob density of tests/test_vo_sequence.py (90 blobs on its 200 x 336
# world), applied to this route's world
BLOB_DENSITY = 90 / (200 * 336)
SLAM_MIN_KF_OUT = 6      # min_loop_gap + 1 of the default SlamConfig
SLAM_PROFILE_FRAMES = 3  # tracked frames in one profiler window
# the small sequences of tests/test_torch_slam.py (160x224)
SMALL_IMG_INTR = dict(fx=200.0, fy=200.0, cx=112.0, cy=80.0)
SMALL_SLAM = dict(optimize_every=4, min_loop_gap=2, loop_min_matches=25,
                  loop_min_inliers=8, loop_candidates=2, max_loops_per_kf=1,
                  local_ba_every=3, local_ba_window=3, local_ba_points=64)
SMALL_VO = dict(min_inliers=6, keyframe_inlier_ratio=1.05)
SMALL_AKAZE = dict(max_pts=512, noctaves=2, dthreshold=5e-5)
# card against CPU on the 3-D sequence, the card tests' tolerances: on the
# same minimal sets the card's essential matrix moves by up to ~0.06 from
# the CPU's (float32 8-point normal matrix, cuSOLVER against LAPACK)
CARD_CPU_TRAJ_TOL = 5e-2     # of the map's extent
CARD_CPU_WEIGHT_TOL = 0.3


def slam_route():
    """480x640 frames of ``synthetic_sequence`` along an out-and-back route:
    ``SLAM_OUT`` frames out, ``SLAM_STEP`` px apart, then back a quarter
    step off the outbound positions (no frame repeats an outbound one).
    Returns (float frames in [0, 1], true pixel offsets [N, 2])."""
    from akaze_tpu_torch.io import synthetic_sequence
    q = SLAM_STEP // 4
    n = 4 * (SLAM_OUT - 1) + 1
    world = (SLAM_H + 40) * (SLAM_W + 2 * int(q * n + 20))
    frames, offsets = synthetic_sequence(
        np.random.default_rng(SEED + 7), n_frames=n, size=(SLAM_H, SLAM_W),
        shift_per_frame=(0.0, float(q)), n_blobs=int(BLOB_DENSITY * world))
    order = list(range(0, n, 4)) + list(range(n - 2, 0, -4))
    return ([frames[k].astype(np.float32) / 255.0 for k in order],
            offsets[order])


def instrument(system):
    """Record each PGO and local-BA call of ``system`` with its result."""
    log = []
    for name in ("optimize", "local_bundle_adjust"):
        fn = getattr(system, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            log.append((_name, out))
            return out
        setattr(system, name, wrapped)
    return log


def tum_system(dev):
    """The SLAM configuration of the TUM RGB-D cell: VO defaults
    (AkazeConfig(max_pts=4000), RANSAC threshold 2e-5, 512 hypotheses) and
    SlamConfig defaults except local_ba_every=2."""
    from akaze_tpu_torch import AkazeConfig
    from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
    return SlamSystem(Intrinsics(**TUM_INTR), AkazeConfig(max_pts=4000),
                      SlamConfig(local_ba_every=2), device=dev)


def loop_edges(system):
    return [e for e in system.edges if e[0] - e[1] > 1]


def phase_slam(torch, dev, frames, offsets, per_frame_k1):
    """The SLAM main path at full size: ``SlamSystem.process`` frame by
    frame with the launch counters reset before and read after (and per
    frame), each frame's time between CUDA events, the host profile by
    section.  Fails unless every pose is finite, a loop edge was accepted,
    PGO ran and local BA gave a finite cost, and K1, K2 and K4 launched on
    every tracked frame."""
    from collections import defaultdict
    from akaze_tpu_torch.io import ate_rmse

    warm = tum_system(dev)                 # cuSOLVER/cuBLAS set-up, kernels
    for f in frames[:3]:
        warm.process(f)
    torch.cuda.synchronize()

    s = tum_system(dev)
    log = instrument(s)
    s.prof = s.vo.prof = defaultdict(float)
    for fn in counters().values():
        fn.launches = 0
    rows = []
    for k, f in enumerate(frames):
        before = {n: fn.launches for n, fn in counters().items()}
        n_kf = len(s.vo.keyframes)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        s.process(f)
        end.record()
        end.synchronize()
        delta = {n: fn.launches - before[n] for n, fn in counters().items()}
        rows.append((start.elapsed_time(end), len(s.vo.keyframes) > n_kf,
                     delta))
    launches = {n: fn.launches for n, fn in counters().items()}
    print(f"[slam] {len(frames)} frames of {SLAM_H}x{SLAM_W}, "
          f"{len(s.vo.keyframes)} keyframes, launches {launches}")

    kf_out = sum(kf.index < SLAM_OUT for kf in s.vo.keyframes)
    loops = loop_edges(s)
    pgo = [c for n, c in log if n == "optimize"]
    ba = [c for n, c in log if n == "local_bundle_adjust"]
    tracked = [ms for k, (ms, kf, _) in enumerate(rows) if k and not kf]
    kframes = [ms for k, (ms, kf, _) in enumerate(rows) if k and kf]
    idx = [kf.index for kf in s.vo.keyframes]
    gt = np.stack([offsets[idx, 1], offsets[idx, 0], np.zeros(len(idx))], 1)
    ate = ate_rmse(s.keyframe_trajectory(), gt)
    res = dict(
        system=s, launches=launches, loops=[e[:2] for e in loops],
        pgo=pgo, ba=ba, tracked_ms=float(np.median(tracked)),
        keyframe_ms=float(np.median(kframes)), n_tracked=len(tracked),
        n_keyframe_frames=len(kframes), ate_px_units=ate,
        prof={k: v / len(frames) * 1e3 for k, v in sorted(s.prof.items())},
        total_s=sum(r[0] for r in rows) / 1e3)
    print(f"[slam] keyframes on the way out {kf_out}; loop edges "
          f"{res['loops']}; PGO costs {[round(c, 6) for c in pgo]}; local "
          f"BA costs {[None if c is None else round(c, 6) for c in ba]}")
    print(f"[slam] median frame time (CUDA events): tracked frames "
          f"{res['tracked_ms']:.3f} ms ({len(tracked)} frames), keyframe "
          f"frames {res['keyframe_ms']:.3f} ms ({len(kframes)} frames); "
          f"whole route {res['total_s']:.3f} s")
    print("[slam] host profile, ms per frame by section (vo.fetch absorbs "
          "device time): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                       res["prof"].items()))
    print(f"[slam] keyframe ATE after similarity alignment to the true "
          f"offsets (pixels; a plane under translation, not gated): "
          f"{ate:.4f}")
    # the checks, after the statistics are printed
    for k, (_, _, d) in enumerate(rows):
        check(d["tiled"] == per_frame_k1["tiled"]
              and d["resident"] == per_frame_k1["resident"]
              and d["describe"] == 1, f"slam frame {k}: launches {d}")
        check(k == 0 or d["hamming"] >= 1, f"slam frame {k}: no K4")
    for R, t in s.vo.poses:
        check(np.isfinite(R).all() and np.isfinite(t).all(),
              "slam: a non-finite pose")
    for kf in s.vo.keyframes:
        check(np.isfinite(kf.R).all() and np.isfinite(kf.t).all(),
              "slam: a non-finite keyframe pose")
    check(kf_out >= SLAM_MIN_KF_OUT,
          f"slam: {kf_out} keyframes on the way out")
    check(bool(loops), "slam: no loop edge accepted")
    check(bool(pgo) and all(np.isfinite(c) for c in pgo),
          f"slam: PGO costs {pgo}")
    check(any(c is not None for c in ba)
          and all(np.isfinite(c) for c in ba if c is not None),
          f"slam: local BA costs {ba}")
    check(bool(tracked) and bool(kframes), "slam: no tracked-only frame")
    return res


def phase_slam_profile(torch, dev, frames):
    """Device kernels per tracked frame, from ``torch.profiler`` over the
    frames after the first keyframe (a new system each attempt; the trace
    can drop events)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    needles = ("tiled_kernel<float>", "octave_kernel<float>",
               "describe_kernel<__nv_bfloat16", "hamming_kernel")
    for _ in range(3):
        s = tum_system(dev)
        s.process(frames[0])
        torch.cuda.synchronize()
        window = frames[1:1 + SLAM_PROFILE_FRAMES]
        n_kf = len(s.vo.keyframes)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for f in window:
                s.process(f)
            torch.cuda.synchronize()
        out = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            ns, n = out.get(e.name(), (0, 0))
            out[e.name()] = (ns + e.duration_ns(), n + 1)
        per = {k: (ns / len(window) / 1e6, n / len(window))
               for k, (ns, n) in out.items()}
        if all(any(nd in k for k in per) for nd in needles):
            break
    else:
        fail("slam profile: a kernel of the path is missing from 3 traces")
    kernels = sum(v[1] for v in per.values())
    dev_ms = sum(v[0] for v in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[slam profile] frames 1-{len(window)} "
          f"({len(s.vo.keyframes) - n_kf} of them keyframes): "
          f"{kernels:.0f} device kernels and {dev_ms:.3f} ms device time "
          f"per frame; largest: " + "; ".join(
              f"{k[:48]} {v[0]:.4f} ms x{v[1]:.0f}" for k, v in top))
    return per


def phase_slam_repeat(torch, dev, frames, first):
    """The full-size run again: keyframe trajectory and edges bit for bit
    equal to the first run; host syncs per frame counted under
    ``torch.cuda.set_sync_debug_mode("warn")`` (not gated)."""
    import warnings
    s = tum_system(dev)
    syncs = []
    for f in frames:
        n_kf = len(s.vo.keyframes)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                s.process(f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n = sum("synchroniz" in str(w.message) for w in caught)
        syncs.append((n, len(s.vo.keyframes) > n_kf))
    a, b = first.keyframe_trajectory(), s.keyframe_trajectory()
    check(a.shape == b.shape and np.array_equal(a, b),
          "slam: two card runs differ")
    check([e[:2] for e in first.edges] == [e[:2] for e in s.edges]
          and all(np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])
                  for x, y in zip(first.edges, s.edges)),
          "slam: two card runs' edges differ")
    tracked = [n for k, (n, kf) in enumerate(syncs) if k and not kf]
    keyf = [n for k, (n, kf) in enumerate(syncs) if k and kf]
    res = dict(tracked=float(np.median(tracked)),
               keyframe=float(np.median(keyf)))
    print(f"[slam repeat] a second full-size run: keyframe trajectory and "
          f"edges bit for bit equal; host syncs per frame (sync debug "
          f"'warn'): tracked median {res['tracked']:.0f} "
          f"(min {min(tracked)}, max {max(tracked)}), keyframe frames "
          f"median {res['keyframe']:.0f} (max {max(keyf)})")
    return res


def small_system(dev, intr, sampler):
    from akaze_tpu_torch import AkazeConfig
    from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
    s = SlamSystem(Intrinsics(**intr), AkazeConfig(**SMALL_AKAZE),
                   SlamConfig(**SMALL_SLAM), device=dev, **SMALL_VO)
    s.vo.sampler = sampler
    return s


def phase_slam_card_cpu(torch, dev):
    """The small sequences of tests/test_torch_slam.py on the card against
    the port's CPU run, with the CPU run's minimal sets replayed: on
    ``synthetic_sequence`` (a plane: degenerate two-view geometry, so
    trajectories are not compared) keyframes and edges equal; on
    ``projected_sequence`` (a 3-D scene) also edge weights and keyframe
    trajectories within the card tests' tolerances."""
    from akaze_tpu_torch.geometry.ransac import SetRecorder
    from akaze_tpu_torch.io import synthetic_sequence
    from akaze_tpu_torch.io.dataset import projected_sequence
    from akaze_tpu_torch.pipeline import features_from_numpy

    frames, _ = synthetic_sequence(np.random.default_rng(3), n_frames=9,
                                   size=(160, 224),
                                   shift_per_frame=(0.0, 10.0), n_blobs=300)
    images = [frames[k].astype(np.float32) / 255.0 for k in (0, 4, 8, 7, 3)]
    scene, _ = projected_sequence(np.random.default_rng(5))
    feeds = {d: [features_from_numpy(f, d) for f in scene]
             for d in ("cpu", str(dev))}
    intr3d = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    out = {}
    for name, seq, intr in (("images", images, SMALL_IMG_INTR),
                            ("3-D scene", range(len(scene)), intr3d)):
        rec = SetRecorder()
        runs = []
        for d, sampler in (("cpu", rec), (str(dev), None)):
            sm = small_system(d, intr, sampler or rec.replay())
            if name != "images":
                sm.vo.akaze.detect_and_compute = feeds[d].__getitem__
            for f in seq:
                sm.process(f)
            runs.append(sm)
        c, g = runs
        check([k.index for k in c.vo.keyframes]
              == [k.index for k in g.vo.keyframes],
              f"card = CPU ({name}): keyframes differ")
        check([e[:2] for e in c.edges] == [e[:2] for e in g.edges],
              f"card = CPU ({name}): edges differ")
        check(bool(loop_edges(c)), f"card = CPU ({name}): no loop edge")
        tc, tg = c.keyframe_trajectory(), g.keyframe_trajectory()
        check(np.isfinite(tg).all(), f"card = CPU ({name}): non-finite")
        traj = float(np.abs(tc - tg).max() / max(np.abs(tc).max(), 1e-9))
        wdiff = float(np.abs(np.asarray([e[4] for e in c.edges])
                             - np.asarray([e[4] for e in g.edges])).max())
        if name != "images":
            check(traj <= CARD_CPU_TRAJ_TOL and wdiff <= CARD_CPU_WEIGHT_TOL,
                  f"card = CPU ({name}): trajectory {traj:.3g} of the "
                  f"extent, edge weights {wdiff:.3g}")
        out[name] = (traj, wdiff)
        print(f"[slam card = CPU] {name}: {len(c.vo.keyframes)} keyframes "
              f"and edges {[e[:2] for e in c.edges]} equal; keyframe "
              f"trajectories differ by {traj:.3g} of the extent, edge "
              f"weights by {wdiff:.3g}"
              + (" (not compared: degenerate)" if name == "images" else ""))
    return out


def k3_row_inputs(torch, dev, frame):
    """The single-image path's plan and one frame on the card."""
    from akaze_tpu_torch import Akaze, AkazeConfig
    det = Akaze(AkazeConfig(max_pts=4000), device=dev)
    return det, det.plan_for(SLAM_H, SLAM_W), torch.as_tensor(
        frame, device=dev)[None]


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
    (a, b), (a8, b8), desc, shift = load_pair(args.stock_dir)
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
    launches, k4_main, fa = phase_main(torch, det, a, b, shift)
    phase_no_sync(torch, det, a, b)
    k1_b1 = phase_describe_false(torch, det, a, fa)
    phase_small_reference(torch, dev)
    prof = phase_profile(torch, det, a, b)
    pair_ms = phase_timing(torch, det, a, b)
    print(f"[time] card: {card}; pair iteration {pair_ms:.3f} ms")

    # the float path on f32 planes (bf16_sampling=False)
    f32 = Akaze(AkazeConfig(max_pts=MAX_PTS, bf16_sampling=False),
                device=dev)
    k2_f32 = phase_k2(torch, images, f32.plan_for(H, W), tag="K2 f32")
    launches_f32, _, _ = phase_main(torch, f32, a, b, shift,
                                    tag="main float f32")
    phase_no_sync(torch, f32, a, b, tag="no sync float f32")
    prof_f32 = phase_profile(torch, f32, a, b, tag="profile float f32")

    # the 16.16 fixed-point path, both descriptor flavours
    exact = Akaze(AkazeConfig(max_pts=MAX_PTS, fixed_exact_sampling=True),
                  fixed=True, device=dev)
    approx = Akaze(AkazeConfig(max_pts=MAX_PTS), fixed=True, device=dev)
    plan_fx = exact.plan_for(H, W)
    images_fx = torch.stack([torch.as_tensor(x, device=dev).int()
                             for x in (a8, b8)])
    k1_fx = phase_k1(torch, images_fx, plan_fx, tag="K1 fixed")
    k2_fx = phase_k2(torch, images_fx, plan_fx, fixed=True, tag="K2 fixed")
    launches_fx, _, _ = phase_main(torch, exact, a8, b8, shift,
                                   tag="main fixed exact")
    launches_ap, _, _ = phase_main(torch, approx, a8, b8, shift,
                                   tag="main fixed approximate")
    phase_no_sync(torch, exact, a8, b8, tag="no sync fixed exact")
    phase_no_sync(torch, approx, a8, b8, tag="no sync fixed approximate")
    phase_small_reference(torch, dev, fixed=True, exact=True,
                          tag="check fixed exact")
    phase_small_reference(torch, dev, fixed=True,
                          tag="check fixed approximate")
    prof_fx = phase_profile(torch, exact, a8, b8, tag="profile fixed exact")
    fx_ms = phase_timing(torch, exact, a8, b8, tag="time fixed exact")
    ap_ms = phase_timing(torch, approx, a8, b8, tag="time fixed approximate")
    print(f"[time] card: {card}; fixed pair iteration {fx_ms:.3f} ms "
          f"(exact), {ap_ms:.3f} ms (approximate)")

    # the SLAM path: the TUM RGB-D configuration at 480x640
    t0 = time.perf_counter()
    frames, offsets = slam_route()
    print(f"[slam] route of {len(frames)} frames ({SLAM_OUT} out, "
          f"{len(frames) - SLAM_OUT} back) rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    det1, plan1, img1 = k3_row_inputs(torch, dev, frames[0])
    for fn in counters().values():
        fn.launches = 0
    det1.detect_and_compute(img1[0])
    per_frame_k1 = {k: counters()[k].launches for k in ("tiled", "resident")}
    check(per_frame_k1["tiled"] > 0 and per_frame_k1["resident"] > 0,
          f"480x640 plan: K1 launches {per_frame_k1}")
    k1_slam = phase_k1(torch, img1, plan1, tag="K1 slam")
    k3 = phase_k2(torch, img1, plan1, tag="K3 (K2 single image)")
    slam = phase_slam(torch, dev, frames, offsets, per_frame_k1)
    prof_slam = phase_slam_profile(torch, dev, frames)
    phase_slam_repeat(torch, dev, frames, slam["system"])
    fa = det1.detect_and_compute(frames[0])
    fb = det1.detect_and_compute(frames[1])
    k4_slam = k4_case(torch, "K4 slam", fa.words, fb.words, fa.valid,
                      fb.valid, fb.x, fb.y)
    phase_slam_card_cpu(torch, dev)
    print(f"[slam] card: {card}; median frame {slam['tracked_ms']:.3f} ms "
          f"tracked, {slam['keyframe_ms']:.3f} ms with a new keyframe")

    k1_rep = "akaze_tpu/ops/pallas_sublevel.py:423"
    k2_rep = ("akaze_tpu/ops/pallas_describe.py:1107, "
              "akaze_tpu/ops/pallas_describe.py:579")
    k1_src = "akaze_tpu_torch/csrc/sublevel.cu"
    k2_src = "akaze_tpu_torch/csrc/describe.cu"
    rows = []
    for name, needle, p, r, n in (
            ("tiled_kernel", "tiled_kernel<float>", prof, k1["tiled"],
             launches["tiled"]),
            ("octave_kernel", "octave_kernel<float>", prof, k1["resident"],
             launches["resident"]),
            ("tiled_kernel_fixed", "tiled_kernel<int>", prof_fx,
             k1_fx["tiled"], launches_fx["tiled"]),
            ("octave_kernel_fixed", "octave_kernel<int>", prof_fx,
             k1_fx["resident"], launches_fx["resident"])):
        ms, nl = kernel_time(p, needle)
        check(nl == n, f"{name}: {nl} launches in the trace, {n} counted")
        rows.append((name, k1_src, k1_rep, n, ms, r, r["event_ms"]))
    for name, needle, p, r, n in (
            ("describe_kernel", "describe_kernel<__nv_bfloat16", prof, k2,
             launches["describe"]),
            ("describe_kernel_f32", "describe_kernel<float, false", prof_f32,
             k2_f32, launches_f32["describe"]),
            ("describe_kernel_fixed", "describe_kernel<float, true", prof_fx,
             k2_fx, launches_fx["describe"])):
        ms, _ = kernel_time(p, needle)
        rows.append((name, k2_src, k2_rep, n, ms, r, r["event_ms"]))
    ms, _ = kernel_time(prof, "hamming_kernel")
    k4_src = "akaze_tpu_torch/csrc/hamming.cu"
    k4_rep = "akaze_tpu/ops/pallas_match.py:103"
    rows.append(("hamming_kernel", k4_src, k4_rep, launches["hamming"],
                 ms, k4_main, k4_main["event_ms"]))
    rows = [r + (r[4] / max(r[3], 1),) for r in rows]
    # the SLAM path's rows: ms is device time per frame of the route's
    # tracked frames (profiler), launches count the whole route
    for name, needle, src, rep, r in (
            ("tiled_kernel_slam", "tiled_kernel<float>", k1_src,
             "akaze_tpu/ops/pallas_sublevel.py:346", k1_slam["tiled"]),
            ("octave_kernel_slam", "octave_kernel<float>", k1_src,
             "akaze_tpu/ops/pallas_sublevel.py:346", k1_slam["resident"]),
            ("describe_kernel_single", "describe_kernel<__nv_bfloat16",
             k2_src, "akaze_tpu/ops/pallas_describe.py:579", k3),
            ("hamming_kernel_slam", "hamming_kernel", k4_src, k4_rep,
             k4_slam)):
        ms, per_frame = kernel_time(prof_slam, needle)
        counter = {"tiled_kernel_slam": "tiled",
                   "octave_kernel_slam": "resident",
                   "describe_kernel_single": "describe",
                   "hamming_kernel_slam": "hamming"}[name]
        rows.append((name, src, rep, slam["launches"][counter], ms, r,
                     r["event_ms"], ms / max(per_frame, 1e-9)))
    kernels = []
    for name, src, rep, n, ms, r, event, per_launch in rows:
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": n, "max_abs_err": r["max_abs_err"], "ms": ms,
               "device_ms": per_launch, "host_us": r["host_us"],
               "event_ms": event, "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": None}
        if name in ("tiled_kernel", "octave_kernel"):
            row["b1_device_ms_per_image"] = k1_b1[name == "octave_kernel"]
        if name == "hamming_kernel":
            row["stress_10000x10000"] = {
                k: k4[k] for k in ("device_ms", "event_ms", "plain_ms",
                                   "host_us", "bound_ms")}
        kernels.append(row)
        print(f"[kernels] {name}: {n} launches, device {ms:.4f} ms per "
              f"{'frame' if name.endswith(('_slam', '_single')) else 'pair'}"
              f" ({per_launch:.4f} per launch), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), host "
              f"{r['host_us']:.1f} us per call/launch, event-bracketed "
              f"{event:.3f} ms, plain {r['plain_ms']:.3f} ms")
    print(f"[kernels] card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
