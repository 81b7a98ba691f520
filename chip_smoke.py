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
     timings.

The pair is the stock pair (``left.pgm``/``right.pgm`` under
``--stock-dir``) when given, else a seeded
synthetic 960x1280 texture A and its crop B shifted by (dy, dx) = (7, 13).

The line before the last is ``{"kernels": [...]}``: per kernel its
launches on the main path, device time per pair (``ms``) and per launch
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
    """K2 against its plain version on the pair's keypoints and pyramid, on
    the planes ``plan`` gives; ``fixed``: the fixed path's exact flavour
    (``plan`` must select it)."""
    from akaze_tpu_torch.descriptor import (finish_descriptors, plane_dtype,
                                            slot_params, words_to_numpy)
    from akaze_tpu_torch.ops.describe import (describe, describe_plain,
                                              describe_tables)
    from akaze_tpu_torch.pipeline import detect_batch

    check(not fixed or plan.config.fixed_descriptor_exact,
          f"{tag}: the configuration selects another flavour")
    kps, pp = detect_batch(images, plan, fixed=fixed)
    check(pp.L.dtype == plane_dtype(plan, fixed), f"{tag}: plane type")
    nplanes = pp.L.shape[0] // 2
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
    rows.append(("hamming_kernel", "akaze_tpu_torch/csrc/hamming.cu",
                 "akaze_tpu/ops/pallas_match.py:103", launches["hamming"],
                 ms, k4_main, k4_main["event_ms"]))
    kernels = []
    for name, src, rep, n, ms, r, event in rows:
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": n, "max_abs_err": r["max_abs_err"], "ms": ms,
               "device_ms": ms / max(n, 1), "host_us": r["host_us"],
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
        print(f"[kernels] {name}: {n} launches, device {ms:.4f} ms per pair "
              f"({ms / max(n, 1):.4f} per launch), bound "
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
