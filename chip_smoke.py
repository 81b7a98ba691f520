#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``akaze_tpu_torch``) on NVIDIA GPUs.

    python3 chip_smoke.py [--stock-dir DIR]             # one card
    python3 chip_smoke.py --cards 4 [--stock-dir DIR]   # four cards

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
  3b. detection's extrema and NMS kernel (``ops/detect.py``) against its
     plain twin on the card, on the 960x1280 pair's own det stacks
     (float and fixed) and the 480x640 SLAM frame's: response, layer and
     survivor mask equal bit for bit; its device time, byte bound, plain
     time and host time per call;
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
  10. the single-device tools: the demo CLI as a user runs it (``python
     -m akaze_tpu_torch.cli --json --iters 20`` in a subprocess, float and
     ``--fixed``, on the pair written as PGM files: exit 0, counts equal to
     the main path's on the same pair, > 500 matches, backend cuda, both
     drawings written; then its path in this process with the launch
     counters read); ``ransac_homography`` on the main pair's matches (the
     known shift within 0.5 px, inliers > 0.85; its program held bit for
     bit against the eager call, no host sync, its graph's nodes, timed
     eager and captured), on 2,000 points with outliers and the CPU run's
     sets, and
     ``pnp_dlt``, card against CPU; ``debug_planes`` of one 960x1280 image
     on the card (13 K1 launches) against the CPU; the native host
     runtime built with g++ (a fallback fails) and ``FrameSequence(...,
     prefetch=True)`` giving the SLAM route's frames byte for byte, with
     the loader's frames per second beside the synchronous decode's;
  11. the multi-device tier (``akaze_tpu_torch.parallel``) with several
     shards on this one card (the programs and their exactness, not a
     speed-up), each run under a guard that fails if a kernel's plain
     version runs: the spatial tier (``Akaze(mesh=...)``) on the 960x1280
     pair at 2 and 4 shards in all four flavours and on a 1920x2560 pair
     at 4 and 8 shards (float and exact fixed), against the card's
     unsharded path (the scale space gathered: fixed bit-exact, float
     within 1e-5 of each plane's max; features: counts and layers equal,
     x/y within 5e-5 px, 0 flipped bits; matches equal; the shift
     recovered), with K1/K2 launches per shard as ``spatial_route``
     predicts and K1 and K2 held against their plain versions on the
     shards' own halo-extended inputs; ``sharded_match`` at 10000 x 10000
     over 4 shards (equal to unsharded K4, K4 per shard = plain);
     ``dp_pipeline_step`` on 8 pairs over 4 shards (equal to the per-pair
     path); sharded PGO and landmark-sharded BA at the SLAM cell's sizes
     (against the single-device solvers, two runs bit for bit equal, no
     landmark-sized collective); ``SlamSystem(mesh=4 shards)`` on the TUM
     route (K1, K2 per shard on every frame; keyframes and edges equal to
     the single-device run's); the CLI with ``--spatial 4 --device
     cuda:0`` in this process; ``dryrun_multichip(4)``.

  12. the compiled programs (``akaze_tpu_torch/programs.py``: one CUDA
     graph per static signature, the JAX package's ``jax.jit`` sites), in
     ``[program ...]`` phases beside the paths above: ``torch.profiler``
     sees a replay's kernels with the eager launch counts (the kernel rows
     profile replays; the run fails otherwise); per pair flavour the
     pair and match programs held against the eager card path (each of 3
     replays equal bit for bit, ``captures`` fixed, ``replays`` one more
     per call, the launch counters moved as the eager call moves them, no
     plain version run), outputs of a call unchanged by the next call on
     other inputs, no host sync in a replayed iteration, the pair
     iteration eager and captured in turns (medians of 20 between CUDA
     events) and each one's device busy time against its wall (idle
     share); the single-image program at 960x1280 (``describe=True`` and
     ``False``) and 480x640, the match program at 10000 x 10000; the
     loop-candidate program on every candidate stack of the SLAM route,
     PGO and local BA at the SLAM cell's buckets at two values of their
     traced damping, each without a sync and timed per call in turns; the
     SLAM route eagerly and with programs: keyframes and edges equal bit
     for bit, no new capture on a repeated route, frame, PGO and BA times
     side by side, host syncs per tracked and keyframe frame; each key's
     warm-up and capture seconds and the MiB its capture added to the
     device's shared graph pool, and that pool's size after the route; the
     two-view programs (``_putative`` and ``_solve``, the draw eager
     between them) on every tracked and loop pair of the eager route, each
     equal bit for bit to its eager call, K4 equal to its plain version on
     every pair, no host sync inside or between the programs, each graph's
     nodes, and a tracked pair's two-view eager and captured in turns;
     ``[program mesh ...]``: the multi-device programs on meshes whose
     shards share this card (the spatial program on a 960x1280 image over
     2 and 4 shards and a 1920x2560 image over 8, the dp step, sharded
     PGO, observation- and landmark-sharded BA) each held against the
     eager card path as above, without a sync, timed eager and captured
     in turns with each form's idle share; ``SlamSystem(mesh=4)`` on the
     TUM route eagerly and with programs (keyframes and edges bit for bit,
     no new key) and the CLI's ``--spatial 4`` eagerly and with programs
     (no new key); each key's capture seconds and pool MiB, and the shared
     pool after the mesh phases.  Every phase above that calls ``Akaze``,
     ``SlamSystem``, the dp step or the solvers drives the programs; the
     ``[mesh ...]`` phases hold each program's output against an eager
     call whose kernel inputs they record (no Python runs in a replay).

``--cards 4`` runs only the multi-device tier on four cards (and fails,
never skips, with fewer): the card names and power limits, how the cards
are joined (``nvidia-smi topo -m`` or NVLink's link states, peer access,
a card-to-card copy rate); the kernels' build; then with one process over
cuda:0..3 (``make_mesh(4)``; by ``programs.mesh_route``'s rule each key is
one captured graph over the four cards) every mesh path, eager
(``programs.eager()``) and captured, held bit for bit against the same
mesh with its four shards on cuda:0: the spatial tier on the
960x1280 pair in all four flavours (the float flavour is the main path:
launch counters reset before and read after, K1/K2 launches per card as
``spatial_route`` predicts) and on a 1920x2560 pair, ``sharded_match`` at
10000 x 10000, the dp step of 8 pairs (2 per card), sharded PGO and
observation- and landmark-sharded BA at the SLAM cell's sizes,
``SlamSystem(mesh=make_mesh(4))`` on the TUM route, the CLI with
``--spatial 4 --device cuda``, ``dryrun_multichip(4)``; K1, K2 and K4
against their plain versions on each card's own launches (recorded on an
eager call); replays equal to the eager call, no host sync in a replay,
no new key on a repeat, each key captured over the four cards with the
MiB it added to each card's pool; each path's times eager and captured in
turns with each card's idle share; the peak device memory per card of one
image unsharded against row-sharded over four cards, eager and captured
(1920x2560 and the largest size up to 3840x5120 the spatial tier takes);
then four processes
of one card each (this script with ``--worker``,
``initialize_distributed(..., local_device_ids=[rank])``, NCCL): the
spatial program, ``sharded_match``, ``dp_pipeline_step_multihost``,
sharded PGO and both BAs, each equal on every rank bit for bit to the
one-process mesh of the same shape, every key across processes captured
with its NCCL calls (replays = eager, no host sync, no new key on a
repeat), eager and captured times in turns with the idle share per rank;
last JAX's (host, chip) runtime shape, two processes of two cards each
(this script with ``--procs-worker``, ``local_device_ids`` [0, 1] and
[2, 3], NCCL) over ``make_mesh(4)`` and ``make_host_chip_mesh(2, 2)``: the
same paths (the dp step with 4 of the 8 pairs per process) and JAX's
runtime collectives (``hier_psum``, ``psum`` and ``all_gather`` over
``"host"``, one program), each equal on both ranks bit for bit to the
one-process mesh of the same shape over cuda:0..3, every key one graph
over the process's two cards holding both cards' NCCL calls (replays =
eager, no host sync, no new key on a repeat), the spatial pair's
launches per card with the counters set to 0 before and read after, K1,
K2 and K4 against their plain versions on each card's own launches, eager
and captured in turns with each card's idle share beside the one-process
and four-rank walls.  Its kernels line holds the four-card rows
(``*_cards4``: per card per pair of the spatial main path;
``*_cards4_dp``: per card per dp step; both profiled from replays;
``hamming_kernel_cards4_sharded_match``: per card per call, eager as
``sharded_match`` is no program; ``*_procs2x2``: per card per pair of the
spatial path of the two processes, from replays).

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
The sharded paths' rows (``*_spatial4``, ``*_spatial4_fixed``: per pair
over 4 shards; ``hamming_kernel_sharded_match``: per 10000 x 10000 call;
``*_dp``: per step of 8 pairs) carry the keys every row must have.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
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

def cuda_times(torch, fn, reps: int = 5, warmup: int = 1) -> list:
    """``reps`` times of one call between CUDA events: host work before
    the launches included (host + device)."""
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
    return times


def cuda_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median of ``cuda_times``."""
    return float(np.median(cuda_times(torch, fn, reps, warmup)))


def spread(times) -> str:
    """'median (min..max) ms of n' for a list of times."""
    return (f"{np.median(times):.3f} ({min(times):.3f}..{max(times):.3f}) "
            f"ms, {len(times)} calls")


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


def profiled(torch, fn, needles, reps: int = PROFILE_REPS,
             grow: int = 10) -> dict:
    """``device_kernels`` of ``fn``, taken again (up to 3 times, each over
    ``grow`` times the calls of the one before) while a kernel named by one
    of ``needles`` is missing: the trace can drop events, a trace of a few
    short calls most often."""
    for attempt in range(3):
        prof = device_kernels(torch, fn, reps * grow ** attempt)
        missing = [n for n in needles if not any(n in k for k in prof)]
        if not missing:
            return prof
    fail(f"no {missing} kernel in 3 profiler traces; the last held "
         f"{len(prof)} kernel names: {sorted(prof)[:6]}")


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


def phase_detect(torch, images, plan, tag="detect"):
    """The extrema and NMS kernel against its plain twin on the det stacks
    of ``images``'s scale space (K1's own outputs): response, layer and
    survivor mask equal bit for bit.  Returns its device time (profiler),
    event-bracketed, plain and host times, and its byte bound: each det
    stack read once, the three maps written once."""
    from akaze_tpu_torch.ops.detect import extrema_nms, extrema_nms_plain
    from akaze_tpu_torch.scale_space import build_scale_space

    octs, _ = build_scale_space(images, plan)
    before = extrema_nms.launches
    got = extrema_nms(octs, plan)
    want = extrema_nms_plain(octs, plan)
    torch.cuda.synchronize()
    check(extrema_nms.launches == before + 1, f"{tag}: not one launch")
    for g, w, name in zip(got, want, ("resp", "layer", "mask")):
        check(g.dtype == w.dtype and g.shape == w.shape, f"{tag}: {name} "
              f"is {g.dtype} {tuple(g.shape)}, plain {w.dtype} "
              f"{tuple(w.shape)}")
        diff = int((g != w).sum())
        check(diff == 0, f"{tag}: {name} differs from the plain twin at "
              f"{diff} pixels")
    survivors = int(want[2].sum())
    check(survivors > 100, f"{tag}: {survivors} NMS survivors")
    fn = lambda: extrema_nms(octs, plan)  # noqa: E731
    for _ in range(3):      # the trace can drop events of short kernels
        dev_ms, n = kernel_time(profiled(torch, fn, ("extrema_nms_kernel",)),
                                "extrema_nms_kernel")
        if n == 1:
            break
    check(n == 1, f"{tag}: {n} kernel launches a call in the trace")
    event = cuda_ms(torch, fn)
    plain_ms = cuda_ms(torch, lambda: extrema_nms_plain(octs, plan))
    host = host_us(torch, fn)
    nbytes = (sum(o.det.numel() * o.det.element_size() for o in octs)
              + sum(t.numel() * t.element_size() for t in got))
    bms, by = bound(nbytes, 0)
    print(f"[{tag}] {images.dtype} B={images.shape[0]} "
          f"{plan.height}x{plan.width}, {len(plan.octaves)} octaves: resp, "
          f"layer and mask equal to the plain twin ({survivors} survivors, "
          f"{int((want[1] >= 0).sum())} layered pixels); device "
          f"{dev_ms:.4f} ms (profiler); event-bracketed (host + device) "
          f"{event:.3f} ms vs plain {plain_ms:.3f} ms; host {host:.1f} us "
          f"per call; bound {bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} "
          f"MB)")
    return dict(max_abs_err=0.0, device_ms=dev_ms, event_ms=event,
                plain_ms=plain_ms, host_us=host, bound_ms=bms, bound_by=by)


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


def k4_library_ms(torch, w1, w2, v2, n1, n2):
    """CUDA-event ms of the library form of K4's function on the live
    extents: one ``torch._int_mm`` (cuBLAS int8) of the +-1 bit lanes and
    ``topk(k=2)`` of the masked dot products.  A yardstick: the port never
    calls it."""
    def plus_minus_one(words):
        shifts = torch.arange(32, device=words.device, dtype=torch.int32)
        bits = (words[:, :, None] >> shifts) & 1
        return (1 - 2 * bits).reshape(words.shape[0], 512).to(torch.int8)

    a = plus_minus_one(w1[:max(n1, 17)])
    n2p = max(-(-n2 // 8) * 8, 8)
    pad = torch.nn.functional.pad
    b = plus_minus_one(pad(w2[:n2], (0, 0, 0, n2p - n2))).t().contiguous()
    live = pad(v2[:n2], (0, n2p - n2))
    neg = torch.full((), -(1 << 30), dtype=torch.int32, device=w1.device)
    return cuda_ms(torch, lambda: torch.topk(
        torch.where(live, torch._int_mm(a, b), neg), 2, dim=1), reps=9)


def k4_case(torch, tag, w1, w2, v1, v2, x2, y2, plain_reps=3):
    """K4 against its plain version on one input: the one-launch match
    (``hamming_match``, the main path's) equal to the plain chain
    (``hamming_match_plain``) bit for bit, and the raw top-2 entry
    (``hamming_top2``) to ``hamming_top2_plain``.  The one-launch match's
    times, host time, bound (the +-1 int8 tensor-core form of the TPU
    kernel: 2 x 486 operations per live pair) and the library yardstick
    (``k4_library_ms``) are the row's; the top-2 entry's times go under
    ``top2``."""
    from akaze_tpu_torch.ops.hamming import (hamming_match,
                                             hamming_match_plain,
                                             hamming_top2,
                                             hamming_top2_plain, last_live)

    c1, c2 = last_live(v1), last_live(v2)
    got = hamming_top2(w1, w2, v2, c1, c2)
    want = hamming_top2_plain(w1, w2, v2, c1, c2)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    fn = lambda: hamming_match(w1, v1, w2, v2, x2, y2)  # noqa: E731
    plain = lambda: hamming_match_plain(w1, v1, w2, v2, x2, y2)  # noqa: E731
    m1, m2 = fn(), plain()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(m1, m2))
    ties = int(((want[0] == want[1]) & (want[2] >= 0)).sum())
    n1, n2 = int(c1), int(c2)
    print(f"[{tag}] {n1} x {n2} live extents of {w1.shape[0]} x "
          f"{w2.shape[0]}, {int((~v2).sum())} invalid train rows, {ties} "
          f"tied minima: top-2 max abs err {err}, one-launch match = plain "
          f"chain bit for bit: {same}, {int((m1[0] >= 0).sum())} accepted")
    check(err == 0 and same, f"{tag}: K4 disagrees with its plain version")
    prof = profiled(torch, fn, ("hamming_kernel",))
    check(len(prof) == 1, f"{tag}: the one-launch match ran {sorted(prof)}")
    dev_ms, _ = kernel_time(prof, "hamming_kernel")
    event = cuda_ms(torch, fn)
    plain_ms = cuda_ms(torch, plain, reps=plain_reps)
    host = host_us(torch, fn)
    tfn = lambda: hamming_top2(w1, w2, v2, c1, c2)  # noqa: E731
    top2 = dict(
        event_ms=cuda_ms(torch, tfn), host_us=host_us(torch, tfn),
        device_ms=kernel_time(profiled(torch, tfn, ("hamming_kernel",)),
                              "hamming_kernel")[0])
    # words and validity of the live rows read once, the four fields written
    nbytes = (n1 + n2) * 65 + 4 * 4 * w1.shape[0]
    bms, by = bound(nbytes, 2 * 486 * n1 * n2, INT8_TC_OPS_PER_S)
    library = k4_library_ms(torch, w1, w2, v2, n1, n2)
    print(f"[{tag}] one-launch match: device {dev_ms:.4f} ms (profiler); "
          f"event-bracketed (host + device) {event:.3f} ms vs plain chain "
          f"{plain_ms:.3f} ms; host {host:.1f} us per call; bound "
          f"{bms * 1e3:.2f} us ({by}; popcount form "
          f"{n1 * n2 * 16 / (132 * 16 * 1.98e9) * 1e6:.1f} us); library "
          f"(_int_mm + topk) {library:.4f} ms")
    print(f"[{tag}] top-2 entry: device {top2['device_ms']:.4f} ms "
          f"(profiler), event-bracketed {top2['event_ms']:.3f} ms, host "
          f"{top2['host_us']:.1f} us per call")
    return dict(max_abs_err=err, ties=ties, device_ms=dev_ms, event_ms=event,
                plain_ms=plain_ms, host_us=host, bound_ms=bms, bound_by=by,
                library_ms=library, top2=top2)


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
    from akaze_tpu_torch.ops.detect import extrema_nms
    from akaze_tpu_torch.ops.hamming import hamming_match
    from akaze_tpu_torch.ops.pgo import pgo_solve
    from akaze_tpu_torch.ops.sublevel import octave, sublevel
    return {"tiled": sublevel, "resident": octave, "extrema": extrema_nms,
            "describe": describe, "hamming": hamming_match, "pgo": pgo_solve}


# K1 launches of the 960x1280 plan: octaves 0-2 tiled (4 + 4 + 4), octave 3
# resident (1); one extrema and NMS launch for the batch; no PGO
MAIN_LAUNCHES = {"tiled": 12, "resident": 1, "extrema": 1, "describe": 1,
                 "hamming": 1, "pgo": 0}


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
        return launches, k4, fa, fb, m
    inl = (np.abs(dx + shift[1]) < 1.5) & (np.abs(dy + shift[0]) < 1.5)
    print(f"[{tag}] median (dx, dy) = ({np.median(dx)}, {np.median(dy)}); "
          f"inlier fraction {inl.mean():.4f}")
    check(acc.sum() > 100, "too few accepted matches")
    check(np.median(dx) == -shift[1] and np.median(dy) == -shift[0],
          "known shift not recovered")
    check(inl.mean() > 0.85, f"inlier fraction {inl.mean():.4f}")
    return launches, k4, fa, fb, m


def phase_profile(torch, det, a, b, tag="profile"):
    """Device time of each kernel over main-path pair iterations."""
    at = torch.as_tensor(a, device=det.device)
    bt = torch.as_tensor(b, device=det.device)

    def pair_iteration():
        fa, fb = det.detect_and_compute_pair(at, bt)
        return det.match(fa, fb)

    prof = profiled(torch, pair_iteration, ("tiled_kernel", "octave_kernel",
                                            "extrema_nms_kernel",
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
    """One image with ``describe=False``: K1 (13 launches at B = 1) and the
    extrema and NMS kernel only, the pair's keypoints of that image, angle
    0, zero words; and K1's device time per image (the JAX package's
    ``fused_sublevel``, B = 1)."""
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


def tum_system(dev, mesh=None):
    """The SLAM configuration of the TUM RGB-D cell: VO defaults
    (AkazeConfig(max_pts=4000), RANSAC threshold 2e-5, 512 hypotheses) and
    SlamConfig defaults except local_ba_every=2; on ``mesh`` when given."""
    from akaze_tpu_torch import AkazeConfig
    from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
    place = dict(device=dev) if mesh is None else dict(mesh=mesh)
    return SlamSystem(Intrinsics(**TUM_INTR), AkazeConfig(max_pts=4000),
                      SlamConfig(local_ba_every=2), **place)


def loop_edges(system):
    return [e for e in system.edges if e[0] - e[1] > 1]


def phase_slam(torch, dev, frames, offsets, per_frame_k1):
    """The SLAM main path at full size: ``SlamSystem.process`` frame by
    frame with the launch counters reset before and read after (and per
    frame), each frame's time between CUDA events, the host profile by
    section.  Fails unless every pose is finite, a loop edge was accepted,
    PGO ran and local BA gave a finite cost, K1, the extrema and NMS
    kernel, K2 and K4 launched on every tracked frame, and PGO's kernel
    once a solve and never elsewhere.  Returns, among its results, the
    route's pose graphs as ``optimize_pose_graph`` received them."""
    from akaze_tpu_torch import tracing
    from akaze_tpu_torch.io import ate_rmse
    from akaze_tpu_torch.slam import system as slam_system

    warm = tum_system(dev)                 # cuSOLVER/cuBLAS set-up, kernels
    for f in frames[:3]:
        warm.process(f)
    torch.cuda.synchronize()

    s = tum_system(dev)
    log = instrument(s)
    for fn in counters().values():
        fn.launches = 0
    tracing.enable()
    tracing.reset()
    rows = []
    with recording(slam_system, "optimize_pose_graph") as graphs:
        for k, f in enumerate(frames):
            before = {n: fn.launches for n, fn in counters().items()}
            n_kf, solves = len(s.vo.keyframes), len(graphs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            s.process(f)
            end.record()
            end.synchronize()
            delta = {n: fn.launches - before[n]
                     for n, fn in counters().items()}
            rows.append((start.elapsed_time(end),
                         len(s.vo.keyframes) > n_kf, delta,
                         len(graphs) - solves))
    tracing.disable()
    sections = tracing.summary()["spans"]
    launches = {n: fn.launches for n, fn in counters().items()}
    print(f"[slam] {len(frames)} frames of {SLAM_H}x{SLAM_W}, "
          f"{len(s.vo.keyframes)} keyframes, launches {launches}")

    kf_out = sum(kf.index < SLAM_OUT for kf in s.vo.keyframes)
    loops = loop_edges(s)
    pgo = [c for n, c in log if n == "optimize"]
    ba = [c for n, c in log if n == "local_bundle_adjust"]
    tracked = [ms for k, (ms, kf, _, _) in enumerate(rows) if k and not kf]
    kframes = [ms for k, (ms, kf, _, _) in enumerate(rows) if k and kf]
    idx = [kf.index for kf in s.vo.keyframes]
    gt = np.stack([offsets[idx, 1], offsets[idx, 0], np.zeros(len(idx))], 1)
    ate = ate_rmse(s.keyframe_trajectory(), gt)
    res = dict(
        system=s, launches=launches, loops=[e[:2] for e in loops],
        graphs=graphs,
        pgo=pgo, ba=ba, tracked_ms=float(np.median(tracked)),
        keyframe_ms=float(np.median(kframes)), n_tracked=len(tracked),
        n_keyframe_frames=len(kframes), ate_px_units=ate,
        prof={k: v["total_ns"] / len(frames) / 1e6
              for k, v in sorted(sections.items())},
        total_s=sum(r[0] for r in rows) / 1e3)
    print(f"[slam] keyframes on the way out {kf_out}; loop edges "
          f"{res['loops']}; PGO costs {[round(c, 6) for c in pgo]}; local "
          f"BA costs {[None if c is None else round(c, 6) for c in ba]}")
    print(f"[slam] median frame time (CUDA events): tracked frames "
          f"{res['tracked_ms']:.3f} ms ({len(tracked)} frames), keyframe "
          f"frames {res['keyframe_ms']:.3f} ms ({len(kframes)} frames); "
          f"whole route {res['total_s']:.3f} s")
    print("[slam] host profile (tracing spans, children included), ms per "
          "frame by section (vo.fetch absorbs device time): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res["prof"].items()))
    print(f"[slam] keyframe ATE after similarity alignment to the true "
          f"offsets (pixels; a plane under translation, not gated): "
          f"{ate:.4f}")
    # the checks, after the statistics are printed
    for k, (_, _, d, solves) in enumerate(rows):
        check(d["tiled"] == per_frame_k1["tiled"]
              and d["resident"] == per_frame_k1["resident"]
              and d["extrema"] == 1 and d["describe"] == 1
              and d["pgo"] == solves, f"slam frame {k}: launches {d}, "
              f"{solves} PGO solves")
        check(k == 0 or d["hamming"] >= 1, f"slam frame {k}: no K4")
    check(len(graphs) == len([c for c in pgo if c is not None]),
          f"slam: {len(graphs)} PGO solves, optimize costs {pgo}")
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


def pgo_stress_graph(torch, dev, n=256, e=1024):
    """A pose graph of ``n`` poses and ``e`` edges (the capacity of a long
    TUM sequence's keyframes and loops): a drifted walk, its odometry chain
    and loops between random pairs, one in eight of them an outlier."""
    from akaze_tpu_torch.geometry import se3_compose, se3_exp, se3_inverse
    from akaze_tpu_torch.slam.posegraph import PoseGraph
    rng = np.random.default_rng(SEED + 43)
    step = torch.from_numpy(rng.standard_normal((n - 1, 6)).astype(
        np.float32) * np.float32([0.5] * 3 + [0.15] * 3))

    def walk(steps):
        R, t = [torch.eye(3)], [torch.zeros(3)]
        for x in steps:
            dR, dt = se3_exp(x[None])
            Rn, tn = se3_compose(R[-1], t[-1], dR[0], dt[0])
            R.append(Rn)
            t.append(tn)
        return torch.stack(R), torch.stack(t)

    R_true, t_true = walk(step)
    ei, ej = list(range(n - 1)), list(range(1, n))
    while len(ei) < e:
        a, b = sorted(rng.integers(0, n, 2).tolist())
        if b - a > 1:
            ei.append(a)
            ej.append(b)
    Rij, tij = se3_compose(*se3_inverse(R_true[ei], t_true[ei]),
                           R_true[ej], t_true[ej])
    noise = rng.standard_normal((e, 6)).astype(np.float32) * 0.01
    noise[n::8] *= 50.0
    Rij, tij = se3_compose(Rij, tij, *se3_exp(torch.from_numpy(noise)))
    R0, t0 = walk(step + torch.from_numpy(rng.standard_normal(
        (n - 1, 6)).astype(np.float32) * 0.03))
    g = PoseGraph(torch.tensor(ei, dtype=torch.int32),
                  torch.tensor(ej, dtype=torch.int32), Rij, tij,
                  torch.ones(e))
    return (R0.to(dev), t0.to(dev), PoseGraph(*(a.to(dev) for a in g)),
            torch.arange(n, device=dev) == 0)


def phase_pgo(torch, dev, graphs):
    """PGO's kernel (``ops/pgo.py``) against its plain twin on the card:
    on the SLAM route's graphs as ``optimize_pose_graph`` received them
    and on a 256-pose, 1024-edge graph, under the route's loss; poses and
    cost equal bit for bit, two launches equal, one launch a call.  Times
    the kernel (profiler device time, event-bracketed, host time per call)
    and the plain chain (event-bracketed, its device time and kernels per
    call).  Returns {"route": ..., "256x1024": ...}, the route's row from
    its last graph (the largest)."""
    from akaze_tpu_torch.ops.pgo import pgo_solve, pgo_solve_plain
    from akaze_tpu_torch.slam import SlamConfig
    cfg = SlamConfig()
    cases = []
    for a, kw in graphs:
        R, t, g = a
        cases.append((R, t, g, kw["fixed_mask"], kw.get("iters", 10)))
    check(bool(cases), "pgo: the route recorded no graph")
    cases.append((*pgo_stress_graph(torch, dev), 10))
    out = {}
    for k, (R, t, g, fixed, iters) in enumerate(cases):
        n, e = R.shape[0], g.weight.shape[0]
        damping = torch.full((), 1e-6, device=dev)
        args = (R, t, g, fixed, iters, 50, damping, cfg.robust,
                cfg.robust_delta)
        before = pgo_solve.launches
        got = pgo_solve(*args)
        again = pgo_solve(*args)
        want = pgo_solve_plain(*args)
        torch.cuda.synchronize()
        check(pgo_solve.launches == before + 2, f"pgo {n}x{e}: launches "
              f"{pgo_solve.launches - before} for two calls")
        for x, y, z, name in zip(got, again, want, ("R", "t", "cost")):
            check(torch.equal(x, y), f"pgo {n}x{e}: {name} differs between "
                  "two launches")
            check(torch.equal(x, z), f"pgo {n}x{e}: {name} differs from the "
                  f"plain twin at {int((x != z).sum())} entries")
        fn = lambda: pgo_solve(*args)  # noqa: E731
        plain = lambda: pgo_solve_plain(*args)  # noqa: E731
        # the launches are the counter's (above); the trace can drop a
        # kernel's events, so its time is taken per traced launch
        dev_ms, nl = kernel_time(profiled(torch, fn, ("pgo_solve_kernel",)),
                                 "pgo_solve_kernel")
        dev_ms /= nl
        plain_kernels = device_kernels(torch, plain, reps=1)
        plain_dev = sum(v[0] for v in plain_kernels.values())
        plain_n = sum(v[1] for v in plain_kernels.values())
        event = cuda_ms(torch, fn)
        plain_ms = cuda_ms(torch, plain, reps=3)
        host = host_us(torch, fn)
        nbytes = sum(x.numel() * x.element_size()
                     for x in (R, t, *g, fixed, *got))
        bms, by = bound(nbytes, 0)
        name = "256x1024" if k == len(cases) - 1 else "route"
        print(f"[pgo] {n} poses x {e} edges ({int((g.weight > 0).sum())} "
              f"active), {cfg.robust}: R, t and cost equal to the plain "
              f"twin bit for bit, and between two launches; cost "
              f"{float(got[2]):.6g}; kernel device {dev_ms:.4f} ms "
              f"(profiler), event-bracketed {event:.3f} ms, host {host:.1f} "
              f"us per call; plain chain {plain_ms:.3f} ms eager "
              f"({plain_n:.0f} kernels, {plain_dev:.3f} ms of device time "
              f"a call); bytes bound {bms * 1e3:.3f} us")
        out[name] = dict(max_abs_err=0.0, device_ms=dev_ms, event_ms=event,
                         plain_ms=plain_ms, plain_kernels=plain_n,
                         plain_device_ms=plain_dev, host_us=host,
                         bound_ms=bms, bound_by=f"latency ({by} {bms:.4f})")
    return out


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


def route_syncs(torch, dev, frames):
    """The TUM route on a new system with its host syncs counted per frame
    under ``torch.cuda.set_sync_debug_mode("warn")``: (system, tracked
    frames' counts, keyframe frames' counts), the first frame left out."""
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
    return (s, [n for k, (n, kf) in enumerate(syncs) if k and not kf],
            [n for k, (n, kf) in enumerate(syncs) if k and kf])


def phase_slam_repeat(torch, dev, frames, first):
    """The full-size run again: keyframe trajectory and edges bit for bit
    equal to the first run; host syncs per frame counted (``route_syncs``,
    not gated).  Returns the counts: (tracked frames', keyframe frames')."""
    s, tracked, keyf = route_syncs(torch, dev, frames)
    a, b = first.keyframe_trajectory(), s.keyframe_trajectory()
    check(a.shape == b.shape and np.array_equal(a, b),
          "slam: two card runs differ")
    check([e[:2] for e in first.edges] == [e[:2] for e in s.edges]
          and all(np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])
                  for x, y in zip(first.edges, s.edges)),
          "slam: two card runs' edges differ")
    print(f"[slam repeat] a second full-size run: keyframe trajectory and "
          f"edges bit for bit equal; host syncs per frame (sync debug "
          f"'warn'): tracked median {np.median(tracked):.0f} "
          f"(min {min(tracked)}, max {max(tracked)}), keyframe frames "
          f"median {np.median(keyf):.0f} (max {max(keyf)})")
    return tracked, keyf


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


# --------------------------------------------------------------------------
# the single-device tools: the demo CLI, homography and PnP, debug planes,
# the native host runtime
# --------------------------------------------------------------------------

CLI_ITERS = 20           # the CLI's --iters: pair iterations timed
HOMOGRAPHY_N = 2000      # points of the outlier case, a third outliers


def pair_counts(fa, fb, m):
    """(left keypoints, right keypoints, accepted matches), as the CLI
    counts them."""
    n = int(fa.count)
    return n, int(fb.count), int((m.index[:n] >= 0).sum())


def main_path_counts(torch, det, a, b, tag):
    """``pair_counts`` of the main path on (a, b), with the launch counters
    reset before and read after (those of ``phase_main``)."""
    for fn in counters().values():
        fn.launches = 0
    fa, fb = det.detect_and_compute_pair(a, b)
    m = det.match(fa, fb)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    check(launches == MAIN_LAUNCHES, f"[{tag}] launches {launches}")
    counts = pair_counts(fa, fb, m)
    print(f"[{tag}] launches {launches}; counts {counts}")
    return counts


def phase_cli(torch, card, raw_pair, expected):
    """The demo CLI at full size as a user runs it: ``python -m
    akaze_tpu_torch.cli --json --iters 20`` in a subprocess on the pair
    written as PGM files, float and ``--fixed``.  ``expected``: per flavour
    (False, True) the counts ``phase_main`` gave on the same pair.  Fails
    on a non-zero exit and unless the counts are equal, matches > 500, the
    backend is cuda and both drawings exist.  Then the CLI's path in this
    process (``--iters 1``) with the launch counters read: K1, the
    extrema and NMS kernel and K2 on both pair iterations, K4 on the first
    match and the 10 timed ones."""
    import contextlib
    import io
    from akaze_tpu_torch import cli
    from akaze_tpu_torch.io import save_pgm
    here = os.path.dirname(os.path.abspath(__file__))
    want_launches = {"tiled": 2 * MAIN_LAUNCHES["tiled"],
                     "resident": 2 * MAIN_LAUNCHES["resident"],
                     "extrema": 2, "describe": 2, "hamming": 11, "pgo": 0}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lp = os.path.join(tmp, "left.pgm")
        rp = os.path.join(tmp, "right.pgm")
        save_pgm(lp, raw_pair[0])
        save_pgm(rp, raw_pair[1])
        for fixed in (False, True):
            tag = "fastakaze" if fixed else "akaze"
            argv = (["--left", lp, "--right", rp, "--json", "--out-dir", tmp]
                    + (["--fixed"] if fixed else []))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "akaze_tpu_torch.cli", *argv,
                 "--iters", str(CLI_ITERS)], cwd=here, capture_output=True,
                text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"[cli {tag}] exit {proc.returncode}:\n"
                  f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            counts = (rec["left_pts"], rec["right_pts"], rec["matches"])
            print(f"[cli {tag}] python -m akaze_tpu_torch.cli "
                  f"{' '.join(argv)} --iters {CLI_ITERS}: {json.dumps(rec)}")
            print(f"[cli {tag}] card: {card}; detect_pair_ms "
                  f"{rec['detect_pair_ms']} (median of {CLI_ITERS} pair "
                  f"iterations, CUDA events), match_ms {rec['match_ms']} "
                  f"(median of {10 * CLI_ITERS} calls), compile_s "
                  f"{rec['compile_s']} (first pair; the kernel library was "
                  f"built earlier in this run), process wall {wall:.1f} s")
            check(counts == expected[fixed],
                  f"[cli {tag}] counts {counts}, phase_main gave "
                  f"{expected[fixed]} on the same pair")
            check(rec["matches"] > 500, f"[cli {tag}] {rec['matches']} "
                  f"matches")
            check(rec["backend"] == "cuda" and rec["fixed"] is fixed,
                  f"[cli {tag}] backend {rec['backend']}")
            for kind in ("keypoints", "matches"):
                png = os.path.join(tmp, f"{tag}_{kind}.png")
                check(os.path.exists(png), f"[cli {tag}] no {png}")
            for fn in counters().values():
                fn.launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv + ["--iters", "1", "--no-draw"])
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters().items()}
            print(f"[cli {tag}] launches of the CLI's path with --iters 1 "
                  f"(2 pair iterations, 11 matches): {launches}")
            check(launches == want_launches,
                  f"[cli {tag}] launches {launches}")
            out[tag] = rec
    return out


def phase_homography(torch, dev, card, fa, m, shift):
    """``ransac_homography`` (512 hypotheses, 9 px^2) on the main pair's
    accepted matches: the known shift as a homography within 0.5 px at the
    image corners, inlier fraction > 0.85; its program
    (``_ransac_homography``) held against ``programs.eager()`` bit for
    bit, no host sync in the draw or the replay, its graph's nodes, and
    its time eager and captured in turns.  The outlier case at
    ``HOMOGRAPHY_N`` points on the card with the CPU run's sets, and
    ``pnp_dlt``, against the CPU."""
    from akaze_tpu_torch.geometry.homography import (_ransac_homography,
                                                     pnp_dlt,
                                                     ransac_homography)
    from akaze_tpu_torch.geometry.ransac import draw_minimal_sets
    from akaze_tpu_torch.testing import (HOMOGRAPHY_CARD_TOL,
                                         homography_distance,
                                         homography_outlier_case)

    x1 = torch.stack([fa.x, fa.y], 1)
    x2 = torch.stack([m.match_x, m.match_y], 1)
    valid = m.index >= 0

    def call():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ransac_homography(gen, x1, x2, valid, 9.0, 512)

    res, _ = hold_program(torch, _ransac_homography, call, "homography")
    no_sync(torch, call, "homography")
    sets = draw_minimal_sets(torch.Generator(device=dev).manual_seed(SEED),
                             valid, 512, 4)
    nodes, node_ms = graph_nodes(torch, _ransac_homography, x1, x2, valid,
                                 sets, 9.0, num_hyps=512, refit_iters=2)
    eager, captured = in_turns(torch, call, 7)
    key_line(_ransac_homography, "homography")
    Hm = (res.H / res.H[2, 2]).double().cpu()
    corners = torch.tensor([[0.0, 0.0], [W - 1, 0.0], [0.0, H - 1],
                            [W - 1, H - 1]], dtype=torch.float64)
    hc = torch.cat([corners, torch.ones(4, 1, dtype=torch.float64)],
                   1) @ Hm.T
    n_valid = int(valid.sum())
    frac = int(res.num_inliers) / max(n_valid, 1)
    drift = None
    if shift is not None:
        moved = corners - torch.tensor([shift[1], shift[0]],
                                       dtype=torch.float64)
        drift = float((hc[:, :2] / hc[:, 2:] - moved).abs().max())
    print(f"[homography] {n_valid} accepted matches of the main pair: "
          f"{int(res.num_inliers)} inliers ({frac:.4f}); H / H22 = "
          f"{np.round(Hm.numpy(), 5).tolist()}; corners off the known "
          f"shift by {drift} px")
    print(f"[homography] card: {card}; ransac_homography (512 hypotheses): "
          f"captured = eager bit for bit; no host sync (draw and replay); "
          f"graph {nodes:.0f} device nodes, {node_ms:.3f} ms device; eager "
          f"{spread(eager)}, captured {spread(captured)} (in turns, CUDA "
          f"events)")
    check(frac > 0.85, f"[homography] inlier fraction {frac:.4f}")
    check(drift is None or drift < 0.5,
          f"[homography] corners off the known shift by {drift} px")

    p1, p2, out = homography_outlier_case(np.random.default_rng(SEED + 11),
                                          HOMOGRAPHY_N, HOMOGRAPHY_N // 3)
    p1, p2 = torch.from_numpy(p1), torch.from_numpy(p2)
    ok = torch.ones(HOMOGRAPHY_N, dtype=torch.bool)
    sets = draw_minimal_sets(torch.Generator().manual_seed(SEED), ok, 512, 4)
    cpu = ransac_homography(None, p1, p2, ok, 4.0, sets=sets)
    gpu = ransac_homography(None, p1.to(dev), p2.to(dev), ok.to(dev), 4.0,
                            sets=sets.to(dev))
    dh = homography_distance(gpu.H.cpu(), cpu.H)
    flips = int((gpu.inliers.cpu() != cpu.inliers).sum())
    print(f"[homography] outlier case, {HOMOGRAPHY_N} points ("
          f"{len(out)} planted outliers) with the CPU run's sets: card H "
          f"differs by {dh:.3g} (normalised, up to sign), inlier masks by "
          f"{flips} rows; {int(gpu.num_inliers)} inliers, "
          f"{int(gpu.inliers.cpu()[out].sum())} planted outliers accepted")
    check(dh <= HOMOGRAPHY_CARD_TOL, f"[homography] card H off by {dh}")
    check(flips <= HOMOGRAPHY_N // 100, f"[homography] {flips} rows differ")
    check(int(gpu.inliers.cpu()[out].sum()) < HOMOGRAPHY_N // 100,
          "[homography] planted outliers accepted")

    rng = np.random.default_rng(SEED + 12)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (30, 3)).astype(np.float32)
    a = 0.2
    R = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    Xc = X @ R.T + np.asarray([0.3, -0.2, 0.5], np.float32)
    u = torch.from_numpy((Xc[:, :2] / Xc[:, 2:3]).astype(np.float32))
    X = torch.from_numpy(X)
    rc, tc = pnp_dlt(X, u)
    rg, tg = pnp_dlt(X.to(dev), u.to(dev))
    dr = float((rg.cpu() - rc).abs().max())
    dt = float((tg.cpu() - tc).abs().max())
    print(f"[homography] pnp_dlt card against CPU: R by {dr:.3g}, t by "
          f"{dt:.3g}; R off the true rotation by "
          f"{float(np.abs(rg.cpu().numpy() - R).max()):.3g}")
    check(dr < 1e-3 and dt < 1e-2, "[homography] pnp_dlt card != CPU")


def phase_debug(torch, dev, card, image, plan):
    """``debug_planes`` of one image on the card (K1, the launches of
    ``describe=False``, counters reset before and read after) against the
    CPU: planes within K1's tolerance (det on the interior, as for the
    tiled kernel), the layer and size maps and the NMS mask equal."""
    from akaze_tpu_torch.debug import debug_planes
    from akaze_tpu_torch.detect import build_extrema_maps, nms
    from akaze_tpu_torch.pipeline import _as_images
    from akaze_tpu_torch.scale_space import build_scale_space
    for fn in counters().values():
        fn.launches = 0
    got = debug_planes(image, plan, device=dev)
    launches = {k: fn.launches for k, fn in counters().items()}
    check(launches == dict(MAIN_LAUNCHES, extrema=0, describe=0, hamming=0),
          f"[debug] launches {launches}")
    t0 = time.perf_counter()
    want = debug_planes(image, plan, device="cpu")
    cpu_s = time.perf_counter() - t0
    times = cuda_times(torch, lambda: debug_planes(image, plan, device=dev),
                       reps=5)
    x = _as_images(image, dev, False)

    def planes_on_card():
        octaves, _ = build_scale_space(x, plan)
        nms(*build_extrema_maps(octaves, plan), plan)

    dev_times = cuda_times(torch, planes_on_card, reps=5)
    check(list(got) == list(want), "[debug] keys differ")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        check(g.dtype == w.dtype and g.shape == w.shape, f"[debug] {k}")
        if k in ("layer_map", "size_map", "nms_mask"):
            check(np.array_equal(g, w), f"[debug] {k}: "
                  f"{int((g != w).sum())} pixels differ")
            continue
        if k.startswith("det"):
            oi, si = map(int, k[3:].split("_"))
            mg = 2 * plan.octaves[oi].scales[si].sigma_size + 2
            g, w = g[mg:-mg, mg:-mg], w[mg:-mg, mg:-mg]
        scale = max(float(np.abs(w[w > -1e5]).max()), 1e-6)
        rel = float(np.abs(g.astype(np.float64) - w).max()) / scale
        worst = max(worst, rel)
        check(rel <= TOL, f"[debug] {k}: rel err {rel:.3g}")
    print(f"[debug] {len(got)} planes of a {H}x{W} image, launches "
          f"{launches}: card = CPU (max rel err {worst:.3g}; maps and "
          f"{int(got['nms_mask'].sum())} NMS survivors equal); card: {card};"
          f" CPU {cpu_s:.2f} s")
    mib = sum(v.nbytes for v in got.values()) / 2 ** 20
    print(f"[debug] between CUDA events: debug_planes {spread(times)}; of "
          f"which the planes on the card, no copies, {spread(dev_times)}; "
          f"the rest copies {mib:.1f} MiB to the host")


def phase_native(card, frames):
    """The native host runtime: its library must build (g++), and
    ``FrameSequence(dir, prefetch=True)`` yields the SLAM route's frames,
    written as PGM files, byte for byte and in order; the loader's frames
    per second beside the synchronous decode's."""
    from akaze_tpu_torch import native
    from akaze_tpu_torch.io import FrameSequence, load_pgm, save_pgm
    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    check(lib is not None, "[native] the native library did not build "
          "(g++): FrameSequence would decode in Python")
    raw = [np.rint(f * 255).astype(np.uint8) for f in frames]
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{k:06d}.pgm") for k in range(len(raw))]
        for p, r in zip(paths, raw):
            save_pgm(p, r)
        got = list(FrameSequence(tmp, prefetch=True))
        check(len(got) == len(raw)
              and all(g.dtype == np.uint8 and np.array_equal(g, r)
                      for g, r in zip(got, raw)),
              "[native] prefetched frames differ from those written")
        loader_s, sync_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            loader = native.FrameLoader(paths)
            n = sum(1 for _ in loader)
            loader.close()
            loader_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for p in paths:
                load_pgm(p)
            sync_s.append(time.perf_counter() - t0)
        check(n == len(paths), f"[native] loader gave {n} frames")
    h, w = raw[0].shape
    print(f"[native] library {os.path.relpath(native.library_path())} "
          f"({build_s:.2f} s to build and load); FrameSequence(prefetch="
          f"True) gave the {len(raw)} frames of {h}x{w} byte for byte, in "
          f"order; frames per second (host: {card}): native loader "
          f"{len(paths) / np.median(loader_s):.0f}, synchronous decode "
          f"{len(paths) / np.median(sync_s):.0f} (median of 3 passes)")


# --------------------------------------------------------------------------
# the multi-device tier (akaze_tpu_torch.parallel) with several shards on
# this one card: the programs and their exactness, not a speed-up
# --------------------------------------------------------------------------

MESH_XY_TOL = 5e-5        # px: the spatial tier's bound for float FMA noise
BIG_H, BIG_W = 1920, 2560
DP_PAIRS = 8
# sharded against single-device PGO: R within JAX's bound
# (tests/test_parallel.py), t within 1e-3 of the trajectory's extent, the
# cost within 1e-3 relative: each sums in its own order
PGO_TOL = 1e-3


@contextlib.contextmanager
def no_plain_versions():
    """Fail the run if any kernel's plain version runs inside: a sharded
    path on card tensors must launch the kernels."""
    from akaze_tpu_torch.ops import describe as k2
    from akaze_tpu_torch.ops import detect as kd
    from akaze_tpu_torch.ops import hamming as k4
    from akaze_tpu_torch.ops import pgo
    from akaze_tpu_torch.ops import sublevel as k1
    saved = [(m, n, getattr(m, n)) for m, n in (
        (k1, "sublevel_plain"), (k1, "octave_plain"),
        (kd, "extrema_nms_plain"), (k2, "describe_plain"),
        (k4, "hamming_top2_plain"), (k4, "hamming_match_plain"),
        (pgo, "pgo_solve_plain"))]

    def guard(name):
        def refuse(*a, **kw):
            fail(f"{name} ran on the card inside a sharded path")
        return refuse

    for m, n, _ in saved:
        setattr(m, n, guard(n))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def recording(module, name):
    """Record (args, kwargs) of every call of ``module.name``."""
    real = getattr(module, name)
    calls = []

    def rec(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def cpu_mesh_of(n, dev):
    from akaze_tpu_torch.parallel import make_mesh
    return make_mesh(n, devices=[dev] * n)


def sublevel_work(px: int, taus, radius: int, given_smooth: bool):
    """(bytes, operations) of one tiled sublevel on ``px`` pixels, counted
    as ``k1_work`` counts them."""
    ops = (0 if given_smooth else 2 * (1 + 3 * radius))
    ops += (20 + 17 * len(taus)) if taus else 0
    ops += 14 + 24
    return 4 * px * (5 + given_smooth), ops * px


def check_k1_calls(torch, tiled, resident, fixed, tag):
    """K1 against its plain version on the calls a sharded path made (the
    tiled kernel on halo-extended blocks, the resident kernel on gathered
    octaves): planes within 1e-5 of their max (fixed: bit-exact), det on
    the interior of tiled blocks.  Returns errors, the plain versions'
    time (each call once, between CUDA events) and the bound of the
    work."""
    from akaze_tpu_torch.ops import sublevel as k1
    tol = 0.0 if fixed else TOL
    out = dict(max_abs_err=0.0, max_rel=0.0, plain_ms=0.0, bytes=0, ops=0,
               res_abs_err=0.0, res_plain_ms=0.0, res_bytes=0, res_ops=0)
    for a, kw in tiled:
        got = k1.sublevel(*a, **kw)
        t = cuda_times(torch, lambda: k1.sublevel_plain(*a, **kw), reps=1,
                       warmup=0)[0]
        want = k1.sublevel_plain(*a, **kw)
        for name, g, w in zip(("L", "det", "lx", "ly"), got, want):
            margin = 2 * a[3] + 2 if name == "det" else 0
            rel, ab = rel_err(torch, g.double(), w.double(), margin)
            check(rel <= tol, f"[{tag}] tiled {name} on a "
                  f"{tuple(a[0].shape)} block: rel err {rel:.3g}")
            out["max_rel"] = max(out["max_rel"], rel)
            out["max_abs_err"] = max(out["max_abs_err"], ab)
        out["plain_ms"] += t
        nb, no = sublevel_work(a[0].numel(), a[2], kw["smooth_radius"],
                               kw.get("smooth") is not None)
        out["bytes"] += nb
        out["ops"] += no
    for a, kw in resident:
        # a gathered octave runs where the unsharded rule puts it: on the
        # resident kernel (det held on the whole plane), or on the tiled
        # one (det on the interior, its work counted with the tiled rows)
        op = a[2]
        res = k1.routes_resident(op, kw.get("base"))
        got = k1.octave(*a, **kw)
        t = cuda_times(torch, lambda: k1.octave_plain(*a, **kw), reps=1,
                       warmup=0)[0]
        want = k1.octave_plain(*a, **kw)
        for s_i, sp in enumerate(op.scales):
            for name, g, w in zip(("L", "det", "lx", "ly"), got, want):
                margin = 2 * sp.sigma_size + 2 if (name == "det"
                                                   and not res) else 0
                rel, ab = rel_err(torch, g[:, s_i].double(),
                                  w[:, s_i].double(), margin)
                check(rel <= tol, f"[{tag}] gathered octave "
                      f"({'resident' if res else 'tiled'}) {name}: rel err "
                      f"{rel:.3g}")
                key = "res_abs_err" if res else "max_abs_err"
                out[key] = max(out[key], ab)
        nb, no = k1_work(op, a[0].shape[0], kw.get("smooth") is not None,
                         res)
        pre = "res_" if res else ""
        out[pre + "plain_ms"] += t
        out[pre + "bytes"] += nb
        out[pre + "ops"] += no
    return out


def check_k2_calls(torch, calls, tag):
    """K2 against its plain version on the launches a sharded path made
    (each shard's halo-extended plane stack): angles within 1e-3 rad, 0
    flipped bits."""
    from akaze_tpu_torch.descriptor import finish_descriptors, words_to_numpy
    from akaze_tpu_torch.ops.describe import describe, describe_plain
    out = dict(max_abs_err=0.0, plain_ms=0.0, bytes=0, live=0)
    for a, _ in calls:
        ip, fp, planes, tables, fixed, _f32 = a
        a1, c1 = describe(ip, fp, planes, tables, fixed)
        t = cuda_times(torch, lambda: describe_plain(ip, fp, planes, tables,
                                                     fixed),
                       reps=1, warmup=0)[0]
        a2, c2 = describe_plain(ip, fp, planes, tables, fixed)
        d = (a1 - a2).abs()
        d = torch.minimum(d, 2 * math.pi - d)
        live = (ip[:, 6] > 0).cpu().numpy()
        flips = np.unpackbits(
            (words_to_numpy(finish_descriptors(c1))
             ^ words_to_numpy(finish_descriptors(c2))).view(np.uint8),
            axis=1).sum(1)[live]
        check(float(d.max()) < 1e-3 and (not live.any()
                                         or int(flips.max()) == 0),
              f"[{tag}] K2 on a shard: angle {float(d.max())}, flips")
        out["max_abs_err"] = max(out["max_abs_err"], float(d.max()),
                                 float((c1 - c2).abs().max()))
        out["plain_ms"] += t
        n_live = int(live.sum())
        out["live"] += n_live
        out["bytes"] += (n_live * K2_TAPS * planes[0].element_size()
                         + ip.numel() * 4 + fp.numel() * 4 + a1.numel() * 4
                         + c1.numel() * 4)
    return out


def k4_top2_args(args):
    """The top-2 arguments (w1, w2, v2, count1, count2) of a recorded
    one-launch match's arguments (w1, v1, w2, v2, x2, y2, max_dist)."""
    from akaze_tpu_torch.ops.hamming import last_live
    w1, v1, w2, v2 = args[:4]
    return w1, w2, v2, last_live(v1), last_live(v2)


def k4_call_library_ms(torch, call):
    """``k4_library_ms`` on a recorded one-launch match's inputs."""
    w1, w2, v2, c1, c2 = k4_top2_args(call[0])
    return k4_library_ms(torch, w1, w2, v2, int(c1), int(c2))


def check_k4_calls(torch, calls, tag):
    """K4 against its plain version on the launches a sharded path made
    (each shard's queries against its train set): all four fields of
    ``Matches`` bit for bit.  Returns the error, the plain versions' time
    (each call once, between CUDA events) and the bound of the work."""
    from akaze_tpu_torch.ops import hamming as k4mod
    err, plain_ms, nbytes, ops = 0, 0.0, 0, 0
    for a, _ in calls:
        g = k4mod.hamming_match(*a)
        t = cuda_times(torch, lambda: k4mod.hamming_match_plain(*a), reps=1,
                       warmup=0)[0]
        p = k4mod.hamming_match_plain(*a)
        err = max(err, max(float((x - y).abs().max()) for x, y in zip(g, p)))
        check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                  for x, y in zip(g, p)), f"[{tag}] K4 on a shard differs")
        plain_ms += t
        n1, n2 = (int(c) for c in k4_top2_args(a)[3:])
        nbytes += (n1 + n2) * 65 + 4 * 4 * a[0].shape[0]
        ops += 2 * 486 * n1 * n2
    check(err == 0, f"[{tag}] K4 on a shard disagrees: {err}")
    bms, by = bound(nbytes, ops, INT8_TC_OPS_PER_S)
    return dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by)


def compare_features(torch, got, want, tag, exact_xy: bool):
    """Sharded features against the unsharded path's: counts, layers and
    validity equal, x/y within ``MESH_XY_TOL`` (fixed: exact), angles
    within 1e-3 rad, 0 flipped bits.  Returns the largest x/y and angle
    differences."""
    from akaze_tpu_torch.descriptor import words_to_numpy
    n = int(want.count)
    check(int(got.count) == n and bool(torch.equal(got.valid, want.valid))
          and bool(got.overflow) == bool(want.overflow),
          f"[{tag}] counts {int(got.count)} against {n}")
    check(bool(torch.equal(got.layer[:n], want.layer[:n])),
          f"[{tag}] layers differ")
    dxy = max(float((getattr(got, f)[:n] - getattr(want, f)[:n]).abs()
                    .max()) for f in ("x", "y")) if n else 0.0
    check(dxy == 0.0 if exact_xy else dxy <= MESH_XY_TOL,
          f"[{tag}] x/y differ by {dxy}")
    d = (got.angle[:n] - want.angle[:n]).abs()
    da = float(torch.minimum(d, 2 * math.pi - d).max()) if n else 0.0
    flips = int(np.unpackbits((words_to_numpy(got.words[:n])
                               ^ words_to_numpy(want.words[:n]))
                              .view(np.uint8)).sum())
    check(da < 1e-3 and flips == 0,
          f"[{tag}] angles differ by {da}, {flips} flipped bits")
    return dxy, da


def shift_recovered(torch, fa, m, shift, tag):
    n = int(fa.count)
    acc = (m.index[:n] >= 0).cpu().numpy()
    dx = (m.match_x[:n] - fa.x[:n]).cpu().numpy()[acc]
    dy = (m.match_y[:n] - fa.y[:n]).cpu().numpy()[acc]
    inl = (np.abs(dx + shift[1]) < 1.5) & (np.abs(dy + shift[0]) < 1.5)
    check(acc.sum() > 100 and np.median(dx) == -shift[1]
          and np.median(dy) == -shift[0] and inl.mean() > 0.85,
          f"[{tag}] known shift not recovered (median {np.median(dx)}, "
          f"{np.median(dy)}; inliers {inl.mean():.4f})")
    return inl.mean()


def mesh_flavours():
    from akaze_tpu_torch import AkazeConfig
    return {"float": (False, AkazeConfig(max_pts=MAX_PTS)),
            "float f32": (False, AkazeConfig(max_pts=MAX_PTS,
                                             bf16_sampling=False)),
            "fixed exact": (True, AkazeConfig(max_pts=MAX_PTS,
                                              fixed_exact_sampling=True)),
            "fixed approximate": (True, AkazeConfig(max_pts=MAX_PTS))}


def phase_mesh_spatial(torch, dev, card, pairs, shards, flavours, size,
                       shift, rows_for=None):
    """The spatial tier on one pair of ``size`` for each shard count and
    flavour: ``Akaze(mesh=...)`` (each image row-sharded), held against
    the card's unsharded path; the scale space gathered against the
    unsharded one (fixed bit-exact, float within 1e-5 of each plane's
    max); K1/K2 launches per shard equal to the route's prediction, K1 and
    K2 against their plain versions on the shards' own inputs; the known
    shift recovered.  ``rows_for``: (n, flavour) whose kernels are
    profiled for the kernels line."""
    from akaze_tpu_torch import Akaze, programs
    from akaze_tpu_torch.parallel import (spatial, spatial_launches,
                                          spatial_route,
                                          spatial_scale_space)
    from akaze_tpu_torch.ops import describe as k2mod
    from akaze_tpu_torch.scale_space import build_scale_space
    h, w = size
    out = {"times": {}, "rows": {}}
    for name, (fixed, cfg) in flavours.items():
        a, b = pairs[fixed]
        ref = Akaze(cfg, fixed=fixed, device=dev)
        plan = ref.plan_for(h, w)
        ra, rb = ref.detect_and_compute_pair(a, b)
        rm = ref.match(ra, rb)
        at = torch.as_tensor(a, device=dev)
        out["times"][(name, 1)] = cuda_times(
            torch, lambda: ref.detect_and_compute(at), reps=5)
        ref_octs = None
        for n in shards:
            tag = f"mesh spatial {h}x{w} {name} n={n}"
            mesh = cpu_mesh_of(n, dev)
            det = Akaze(cfg, fixed=fixed, mesh=mesh)
            if name in ("float", "fixed exact"):
                if ref_octs is None:
                    ref_octs, _ = build_scale_space(
                        at.int() if fixed else at, plan)
                octs, _ = spatial_scale_space(at, plan, mesh, fixed=fixed)
                worst = 0.0
                for oi, ro in enumerate(ref_octs):
                    for k in range(4):
                        g = torch.cat([o[oi][k] for o in octs], 1)
                        rel, _ = rel_err(torch, g.double(), ro[k].double())
                        worst = max(worst, rel)
                        check(rel == 0.0 if fixed else rel <= TOL,
                              f"[{tag}] scale space octave {oi} plane {k}: "
                              f"rel err {rel:.3g}")
                print(f"[{tag}] scale space equal to the unsharded one: "
                      f"max rel err {worst:.3g} over every plane")
            # the shards' kernel calls, recorded on an eager run (no
            # Python runs in a replay); then the program (captured on its
            # first image, replayed on the second) held against it
            for fn in counters().values():
                fn.launches = 0
            with programs.eager(), no_plain_versions(), \
                    recording(spatial, "sublevel") as tiled, \
                    recording(spatial, "octave") as resident, \
                    recording(k2mod, "_launch") as k2calls:
                eager = det.detect_and_compute_pair(a, b)
                torch.cuda.synchronize()
            eager_n = launch_counts()
            for fn in counters().values():
                fn.launches = 0
            with no_plain_versions():
                fa, fb = det.detect_and_compute_pair(a, b)
                m = det.match(fa, fb)
                torch.cuda.synchronize()
            launches = launch_counts()
            per = spatial_launches(plan, n)
            want = {"tiled": 2 * n * per["tiled"],
                    "resident": 2 * n * per["resident"], "extrema": 0,
                    "describe": 2 * n, "hamming": 1, "pgo": 0}
            check(launches == want, f"[{tag}] launches {launches}, the "
                  f"route {spatial_route(plan, n)} predicts {want}")
            check(eager_n == want | {"hamming": 0}, f"[{tag}] the eager "
                  f"call launched {eager_n}")
            equal_outputs(torch, (fa, fb), eager, tag)
            check(det.spatial_fallbacks == 0, f"[{tag}] fell back")
            dxy = max(compare_features(torch, fa, ra, tag, fixed)[0],
                      compare_features(torch, fb, rb, tag, fixed)[0])
            check(bool(torch.equal(m.index, rm.index)),
                  f"[{tag}] matches differ from the unsharded path's")
            inl = (shift_recovered(torch, fa, m, shift, tag)
                   if shift is not None else float("nan"))
            k1c = check_k1_calls(torch, tiled, resident, fixed, tag)
            k2c = check_k2_calls(torch, k2calls, tag)
            out["times"][(name, n)] = cuda_times(
                torch, lambda: det.detect_and_compute(at), reps=5)
            print(f"[{tag}] launches {launches} = the route's "
                  f"{spatial_route(plan, n)}; the program's replay equal to "
                  f"the eager call bit for bit; features equal to the "
                  f"unsharded path's (x/y within {dxy:.3g} px, 0 flipped "
                  f"bits), matches equal, shift recovered (inliers "
                  f"{inl:.4f}); K1 on {len(tiled)} halo-extended blocks "
                  f"and {len(resident)} gathered octaves = plain (rel "
                  f"{k1c['max_rel']:.3g}), K2 on {len(k2calls)} shard "
                  f"stacks = plain; spatial per image "
                  f"{spread(out['times'][(name, n)])} (unsharded "
                  f"{spread(out['times'][(name, 1)])}); card: {card}")
            if rows_for and (n, name) in rows_for:
                needle = "<int>" if fixed else "<float>"
                k2n = ("describe_kernel<float, true" if name == "fixed exact"
                       else "describe_kernel<float, false"
                       if name == "float f32"
                       else "describe_kernel<__nv_bfloat16")
                # a route may run no octave on the resident kernel
                # (1920x2560: octave 3 is tiled, or gathered onto it)
                res = launches["resident"] > 0
                with no_plain_versions():
                    prof = profiled(torch, lambda: det.match(
                        *det.detect_and_compute_pair(a, b)),
                        ("tiled_kernel" + needle, k2n, "hamming_kernel")
                        + (("octave_kernel" + needle,) if res else ()))
                out["rows"][(n, name)] = dict(
                    launches=launches, k1=k1c, k2=k2c,
                    tiled=kernel_time(prof, "tiled_kernel" + needle),
                    resident=(kernel_time(prof, "octave_kernel" + needle)
                              if res else None),
                    describe=kernel_time(prof, k2n))
    return out


def big_pairs():
    """The 1920x2560 pair (B = A shifted by SHIFT) and its raw 0..255
    form."""
    dy, dx = SHIFT
    tex = synthetic_texture(BIG_H + dy, BIG_W + dx, SEED + 21)
    pair = (tex[:BIG_H, :BIG_W].copy(), tex[dy:, dx:].copy())
    return {False: pair, True: tuple(quantise(x) for x in pair)}


def phase_mesh_match(torch, dev, card):
    """``sharded_match`` at 10000 x 10000 (the K4 stress inputs) over 4
    shards: queries sharded, the train set gathered and compacted, K4 per
    shard; ``Matches`` equal to unsharded K4's; K4 against its plain
    version on each shard's inputs."""
    from akaze_tpu_torch.match import match
    from akaze_tpu_torch.ops import hamming as k4mod
    from akaze_tpu_torch.parallel import gather_shards, sharded_match
    w1, w2, v1, v2, x2, y2 = k4_stress_inputs(torch, dev)
    mesh = cpu_mesh_of(4, dev)
    want = match(w1, v1, w2, v2, x2, y2, 96)
    for fn in counters().values():
        fn.launches = 0
    with no_plain_versions(), recording(k4mod, "_launch_match") as calls:
        got = gather_shards(sharded_match(w1, v1, w2, v2, x2, y2, mesh, 96),
                            dev)
        torch.cuda.synchronize()
    launches = counters()["hamming"].launches
    check(launches == 4, f"[mesh match] {launches} K4 launches")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    check(same, "[mesh match] sharded Matches differ from unsharded K4's")
    k4c = check_k4_calls(torch, calls, "mesh match")
    err, plain_ms = k4c["max_abs_err"], k4c["plain_ms"]
    fn = lambda: sharded_match(w1, v1, w2, v2, x2, y2, mesh, 96)  # noqa
    times = cuda_times(torch, fn, reps=5)
    ms, nl = kernel_time(profiled(torch, fn, ("hamming_kernel",)),
                         "hamming_kernel")
    bms, by = k4c["bound_ms"], k4c["bound_by"]
    library = k4_library_ms(torch, w1, w2, v2, w1.shape[0], w2.shape[0])
    print(f"[mesh match] 10000 x 10000 over 4 shards on one card: Matches "
          f"equal to unsharded K4's ({int((got.index >= 0).sum())} "
          f"accepted); 4 K4 launches ({nl:.0f} in the trace), each = plain; "
          f"device {ms:.4f} ms per call; call {spread(times)}; bound "
          f"{bms * 1e3:.2f} us ({by}); library (_int_mm + topk) "
          f"{library:.4f} ms; card: {card}")
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                call_ms=float(np.median(times)), library_ms=library)


def phase_mesh_dp(torch, dev, card):
    """``dp_pipeline_step``: 8 pairs at 960x1280 over 4 shards, each
    shard running the pair program on its 2 pairs; every output equal to
    the per-pair path's; K1 13, K2 1, K4 1 launches per pair; K1, K2 and
    K4 against their plain versions on the step's own launches, with
    bounds from those inputs."""
    from akaze_tpu_torch import Akaze, AkazeConfig, programs, scale_space
    from akaze_tpu_torch.ops import describe as k2mod
    from akaze_tpu_torch.ops import hamming as k4mod
    from akaze_tpu_torch.parallel import dp_pipeline_step, gather_shards
    dy, dx = SHIFT
    tex = synthetic_texture(H + dy + DP_PAIRS, W + dx + DP_PAIRS, SEED + 31)
    a = np.stack([tex[i:i + H, i:i + W] for i in range(DP_PAIRS)])
    b = np.stack([tex[i + dy:i + dy + H, i + dx:i + dx + W]
                  for i in range(DP_PAIRS)])
    det = Akaze(AkazeConfig(max_pts=MAX_PTS), device=dev)
    plan = det.plan_for(H, W)
    mesh = cpu_mesh_of(4, dev)
    at, bt = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    # the kernels' inputs, recorded on an eager step; then the program
    with programs.eager(), no_plain_versions(), \
            recording(scale_space, "octave") as octaves, \
            recording(k2mod, "_launch") as k2calls, \
            recording(k4mod, "_launch_match") as k4calls:
        eager = dp_pipeline_step(at, bt, plan, mesh)
        torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    with no_plain_versions():
        out = dp_pipeline_step(at, bt, plan, mesh)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {k: DP_PAIRS * v for k, v in MAIN_LAUNCHES.items()}
    check(launches == want, f"[mesh dp] launches {launches}")
    equal_outputs(torch, out, eager, "mesh dp")
    k1c = check_k1_calls(torch, [], octaves, False, "mesh dp")
    k2c = check_k2_calls(torch, k2calls, "mesh dp")
    k4c = check_k4_calls(torch, k4calls, "mesh dp")
    # the library yardstick on the step's own K4 inputs, summed per step
    k4c["library_ms"] = sum(k4_call_library_ms(torch, c) for c in k4calls)
    check(len(out[0]) == 4 and all(f.x.shape[0] == DP_PAIRS // 4
                                   for f in out[0]), "[mesh dp] shards")
    fa, fb, m = (gather_shards(x, dev) for x in out)
    for i in range(DP_PAIRS):
        ra, rb = det.detect_and_compute_pair(at[i], bt[i])
        rm = det.match(ra, rb, plan.config.max_dist)
        for got, ref in ((fa, ra), (fb, rb), (m, rm)):
            for f, v in ref._asdict().items():
                check(bool(torch.equal(getattr(got, f)[i], v)),
                      f"[mesh dp] pair {i} {f} differs from the per-pair "
                      f"path")
    fn = lambda: dp_pipeline_step(at, bt, plan, mesh)  # noqa: E731
    times = cuda_times(torch, fn, reps=3)
    prof = profiled(torch, fn, ("tiled_kernel<float>", "octave_kernel<float>",
                                "describe_kernel<__nv_bfloat16",
                                "hamming_kernel"), reps=1)
    print(f"[mesh dp] {DP_PAIRS} pairs of {H}x{W} over 4 shards on one "
          f"card: launches {launches}; the program equal to the eager step "
          f"bit for bit; every output equal to the per-pair "
          f"path's; K1 on {len(octaves)} octaves, K2 on {len(k2calls)} and "
          f"K4 on {len(k4calls)} launches = plain; step {spread(times)} "
          f"({float(np.median(times)) / DP_PAIRS:.3f} ms per pair); K4's "
          f"library yardstick (_int_mm + topk on the step's {len(k4calls)} "
          f"inputs) {k4c['library_ms']:.4f} ms per step; card: {card}")
    return dict(launches=launches, prof=prof, step_ms=float(np.median(times)),
                k1=k1c, k2=k2c, k4=k4c)


def slam_cell_problems(torch, dev):
    """A pose graph and a local BA problem at the SLAM cell's sizes: 16
    keyframes with 32 edge slots (a drifted chain plus loops, one an
    outlier) and a 5-camera window with 512 landmarks."""
    from akaze_tpu_torch.geometry import se3_compose, se3_exp, se3_inverse
    from akaze_tpu_torch.slam.ba import BAProblem
    from akaze_tpu_torch.slam.posegraph import PoseGraph
    rng = np.random.default_rng(SEED + 41)
    n = 16
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = np.arange(n) * 0.5
    xi[:, 4] = np.sin(np.arange(n) * 0.4) * 0.3
    Rt, tt = se3_exp(torch.from_numpy(xi))
    ei = list(range(n - 1)) + [0, 3, 5, 8, 2, 11, 1]
    ej = list(range(1, n)) + [15, 12, 14, 13, 9, 15, 6]
    Ri, ti = se3_inverse(Rt[ei], tt[ei])
    Rij, tij = se3_compose(Ri, ti, Rt[ej], tt[ej])
    tij[-1] += torch.tensor([2.0, 0.0, 0.0])
    e = len(ei)
    cap = 32
    g = PoseGraph(
        i=torch.tensor(ei + [0] * (cap - e), dtype=torch.int32),
        j=torch.tensor(ej + [0] * (cap - e), dtype=torch.int32),
        R_ij=torch.cat([Rij, torch.eye(3).expand(cap - e, 3, 3)]),
        t_ij=torch.cat([tij, torch.zeros(cap - e, 3)]),
        weight=torch.cat([torch.ones(e), torch.zeros(cap - e)]))
    noise = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32)
                             * 0.05)
    noise[0] = 0
    R0, t0 = se3_compose(Rt, tt, *se3_exp(noise))
    graph = (R0.to(dev), t0.to(dev), PoseGraph(*(f.to(dev) for f in g)))

    n_cams, n_pts = 5, 512
    X = rng.uniform([-3, -2, 6], [3, 2, 12], (n_pts, 3)).astype(np.float32)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0] = np.arange(n_cams) * 0.3
    Rc, tc = se3_inverse(*se3_exp(torch.from_numpy(xi)))
    Xc = torch.einsum("cij,pj->cpi", Rc, torch.from_numpy(X)) + tc[:, None]
    uv = Xc[..., :2] / Xc[..., 2:3]
    keep = (rng.random((n_cams, n_pts)) < 0.8).reshape(-1)
    cam = torch.arange(n_cams).repeat_interleave(n_pts)[keep]
    pt = torch.arange(n_pts).repeat(n_cams)[keep]
    m = int(keep.sum())
    mcap = 1 << (m - 1).bit_length()
    prob = BAProblem(
        torch.cat([cam, torch.zeros(mcap - m, dtype=torch.int64)]).int(),
        torch.cat([pt, torch.zeros(mcap - m, dtype=torch.int64)]).int(),
        torch.cat([uv.reshape(-1, 2)[keep], torch.zeros(mcap - m, 2)]),
        torch.cat([torch.ones(m), torch.zeros(mcap - m)]))
    X0 = torch.from_numpy(X + rng.standard_normal(X.shape).astype(
        np.float32) * 0.04)
    return graph, (Rc, tc, X0, prob)


def phase_mesh_solvers(torch, dev, card):
    """Sharded PGO (edges, 4 shards, the SLAM cell's robust loss) and
    landmark-sharded local BA (4 shards) at the SLAM cell's sizes, against
    the single-device solvers on the card; two sharded runs bit for bit
    equal; times per call."""
    from akaze_tpu_torch.parallel import (gather_points,
                                          landmark_sharded_bundle_adjust,
                                          partition_landmarks,
                                          sharded_optimize_pose_graph)
    from akaze_tpu_torch.parallel.collectives import all_gather, traced
    from akaze_tpu_torch.slam import SlamConfig
    from akaze_tpu_torch.slam.ba import bundle_adjust
    from akaze_tpu_torch.slam.posegraph import optimize_pose_graph
    from akaze_tpu_torch.parallel import scatter_points
    cfg = SlamConfig()
    mesh = cpu_mesh_of(4, dev)
    (R0, t0, g), (Rc, tc, X0, prob) = slam_cell_problems(torch, dev)
    kw = dict(iters=10, robust=cfg.robust, robust_delta=cfg.robust_delta)
    single = optimize_pose_graph(R0, t0, g, **kw)
    runs = [sharded_optimize_pose_graph(R0, t0, g, mesh, **kw)
            for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "[mesh pgo] two sharded runs differ")
    dR = float((runs[0][0] - single[0]).abs().max())
    dt = float((runs[0][1] - single[1]).abs().max()
               / single[1].abs().max())
    c1, c0 = float(runs[0][2]), float(single[2])
    check(dR <= PGO_TOL and dt <= PGO_TOL
          and abs(c1 - c0) <= 1e-3 * abs(c0) + 1e-9,
          f"[mesh pgo] sharded against single-device: R {dR}, t {dt}, "
          f"cost {c1} / {c0}")
    pgo_t = cuda_times(torch, lambda: sharded_optimize_pose_graph(
        R0, t0, g, mesh, **kw), reps=3)
    pgo_1 = cuda_times(torch, lambda: optimize_pose_graph(R0, t0, g, **kw),
                       reps=3)

    n_cams, n_pts = Rc.shape[0], X0.shape[0]
    mcap = prob.cam.shape[0]
    part = partition_landmarks(prob, n_pts, 4,
                               min_pts_per_shard=-(-n_pts // 4),
                               min_obs_per_shard=-(-mcap // 4))
    Xg = gather_points(part, X0)
    args = (Rc.to(dev), tc.to(dev))
    with traced() as log:
        lb = [landmark_sharded_bundle_adjust(*args, Xg, part, mesh, iters=6)
              for _ in range(2)]
    check(all(torch.equal(x, y) for x, y in zip(lb[0][:2], lb[1][:2]))
          and all(torch.equal(x, y) for x, y in zip(lb[0][2], lb[1][2])),
          "[mesh ba] two sharded runs differ")
    check(max(k for _, k in log) <= n_cams * 36,
          "[mesh ba] a landmark-sized collective")
    ref = bundle_adjust(*args, X0.to(dev), type(prob)(*(f.to(dev)
                                                         for f in prob)),
                        n_cams=n_cams, n_pts=n_pts, iters=6)
    X1 = scatter_points(part, all_gather(lb[0][2], mesh, "data",
                                         home_only=True))
    cb, cr = float(lb[0][3]), float(ref[3])
    dX = np.abs(X1 - ref[2].cpu().numpy())
    okX = bool((dX <= 1e-3 + 1e-2 * np.abs(ref[2].cpu().numpy())).all())
    dRb = float((lb[0][0] - ref[0]).abs().max())
    check(abs(cb - cr) <= 1e-3 * abs(cr) + 1e-7 and okX and dRb <= 1e-4,
          f"[mesh ba] sharded against single-device: cost {cb} / {cr}, "
          f"X {dX.max()}, R {dRb}")
    ba_t = cuda_times(torch, lambda: landmark_sharded_bundle_adjust(
        *args, Xg, part, mesh, iters=6), reps=3)
    ba_1 = cuda_times(torch, lambda: bundle_adjust(
        *args, X0.to(dev), type(prob)(*(f.to(dev) for f in prob)),
        n_cams=n_cams, n_pts=n_pts, iters=6), reps=3)
    print(f"[mesh pgo] 16 poses, 32 edge slots over 4 shards ({cfg.robust} "
          f"loss): two runs bit for bit equal; against single-device PGO "
          f"R {dR:.3g}, t {dt:.3g} of the extent, cost {c1:.6g} / {c0:.6g}; per call "
          f"sharded {spread(pgo_t)}, single {spread(pgo_1)}; card: {card}")
    print(f"[mesh ba] 5 cameras, 512 landmarks, {mcap} observation slots "
          f"over 4 landmark blocks: two runs bit for bit equal; largest "
          f"collective {max(k for _, k in log)} elements ([C, 6, 6] = "
          f"{n_cams * 36}); against single-device BA cost {cb:.6g} / "
          f"{cr:.6g}, X {dX.max():.3g}, R {dRb:.3g}; per call sharded "
          f"{spread(ba_t)}, single {spread(ba_1)}; card: {card}")
    return dict(pgo_ms=float(np.median(pgo_t)), ba_ms=float(np.median(ba_t)))


def phase_mesh_slam(torch, dev, card, frames, single):
    """``SlamSystem(mesh=4 shards)`` on the TUM RGB-D route: detection
    row-sharded (K1, K2 per shard on every frame, K4 on tracked frames),
    sharded PGO and landmark-sharded local BA; keyframes and edges equal
    to the single-device card run's (``single``); poses compared as P7-2
    allows (printed: a plane under translation)."""
    from akaze_tpu_torch import AkazeConfig, programs
    from akaze_tpu_torch.parallel import spatial_launches
    from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
    mesh = cpu_mesh_of(4, dev)
    s = tum_system(dev, mesh)
    log = instrument(s)
    plan = s.vo.akaze.plan_for(SLAM_H, SLAM_W)
    per = spatial_launches(plan, 4)
    ms = []
    known = {(r["program"], r["key"]) for r in programs.stats()}
    for fn in counters().values():
        fn.launches = 0
    with no_plain_versions():
        for k, f in enumerate(frames):
            before = {n: fn.launches for n, fn in counters().items()}
            t = cuda_times(torch, lambda: s.process(f), reps=1, warmup=0)[0]
            d = {n: fn.launches - before[n] for n, fn in counters().items()}
            check(d["tiled"] == 4 * per["tiled"]
                  and d["resident"] == 4 * per["resident"]
                  and d["extrema"] == 0 and d["describe"] == 4
                  and d["pgo"] == 0 and (k == 0 or d["hamming"] >= 1),
                  f"[mesh slam] frame {k}: launches {d}")
            ms.append(t)
    launches = {n: fn.launches for n, fn in counters().items()}
    check(s.vo.akaze.mesh is mesh and s.vo.akaze.spatial_fallbacks == 0,
          "[mesh slam] detection did not run sharded")
    check([k.index for k in s.vo.keyframes]
          == [k.index for k in single.vo.keyframes],
          "[mesh slam] keyframes differ from the single-device run's")
    check([e[:2] for e in s.edges] == [e[:2] for e in single.edges],
          "[mesh slam] edges differ from the single-device run's")
    for kf in s.vo.keyframes:
        check(np.isfinite(kf.R).all() and np.isfinite(kf.t).all(),
              "[mesh slam] a non-finite keyframe pose")
    check(bool([c for n, c in log if n == "optimize"])
          and any(c is not None for n, c in log
                  if n == "local_bundle_adjust"),
          "[mesh slam] no PGO or no local BA")
    # the keys the route captured: PGO's edge buckets, and BA's landmark
    # blocks, which partition_landmarks may size above the bucket
    for r in programs.stats():
        if (r["program"], r["key"]) not in known and "Mesh(" in r["key"]:
            print(f"[mesh slam] the route captured "
                  f"{r['program'].rsplit('.', 1)[1]} [{r['key'][:400]}]: "
                  f"{r['calls']} calls, pool +{r['pool_bytes'] / 2**20:.1f} "
                  f"MiB")
    a, b = s.keyframe_trajectory(), single.keyframe_trajectory()
    diff = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))
    print(f"[mesh slam] {len(frames)} frames over 4 shards: launches "
          f"{launches} (per frame K1 {4 * per['tiled']} tiled + "
          f"{4 * per['resident']} resident, K2 4); {len(s.vo.keyframes)} "
          f"keyframes and edges {[e[:2] for e in s.edges][-3:]}... equal to "
          f"the single-device run's; keyframe trajectories differ by "
          f"{diff:.3g} of the extent (P7-2: not gated); median frame "
          f"{np.median(ms):.3f} ms, route {sum(ms) / 1e3:.3f} s; card: "
          f"{card}")
    # the kernels line's rows: K1 and K2 against their plain versions on
    # one tracked frame's shard calls of a new system, device time per
    # frame over the frames after it
    from akaze_tpu_torch.ops import describe as k2mod
    from akaze_tpu_torch.parallel import spatial
    first = s
    s = SlamSystem(Intrinsics(**TUM_INTR), AkazeConfig(max_pts=4000),
                   SlamConfig(local_ba_every=2), mesh=mesh)
    s.process(frames[0])
    with programs.eager(), no_plain_versions(), \
            recording(spatial, "sublevel") as tiled, \
            recording(spatial, "octave") as resident, \
            recording(k2mod, "_launch") as k2calls:
        s.process(frames[1])
        torch.cuda.synchronize()
    k1c = check_k1_calls(torch, tiled, resident, False, "mesh slam")
    k2c = check_k2_calls(torch, k2calls, "mesh slam")
    rest = iter(frames[2:])
    with no_plain_versions():
        prof = profiled(torch, lambda: s.process(next(rest)),
                        ("tiled_kernel<float>", "octave_kernel<float>",
                         "describe_kernel<__nv_bfloat16"), grow=1)
    rows = dict(launches=launches, k1=k1c, k2=k2c,
                tiled=kernel_time(prof, "tiled_kernel<float>"),
                resident=kernel_time(prof, "octave_kernel<float>"),
                describe=kernel_time(prof, "describe_kernel<__nv_bfloat16"))
    busy_ms = sum(v[0] for v in prof.values())
    print(f"[mesh slam] K1 on {len(tiled)} blocks and {len(resident)} "
          f"gathered octaves and K2 on {len(k2calls)} shard stacks of one "
          f"frame = plain; device per frame: K1 tiled "
          f"{rows['tiled'][0]:.4f} ms in {rows['tiled'][1]:.0f}, resident "
          f"{rows['resident'][0]:.4f} in {rows['resident'][1]:.0f}, K2 "
          f"{rows['describe'][0]:.4f} in {rows['describe'][1]:.0f}; every "
          f"device event {busy_ms:.3f} ms in "
          f"{sum(v[1] for v in prof.values()):.0f} per frame (frames 3-5, "
          f"programs replayed)")
    return dict(launches=launches, frame_ms=float(np.median(ms)), rows=rows,
                system=first)


def phase_mesh_cli(torch, dev, card, raw_pair, expected):
    """The CLI's spatial lifecycle in this process: ``--spatial 4 --device
    cuda:0 --json --iters 1``, counts equal to the main path's on the same
    PGM pair, launch counters read (2 pair iterations of 2 row-sharded
    images, 11 matches)."""
    import contextlib as cl
    import io
    from akaze_tpu_torch import cli
    from akaze_tpu_torch.io import save_pgm
    from akaze_tpu_torch.parallel import spatial_launches
    from akaze_tpu_torch import build_plan, AkazeConfig
    per = spatial_launches(build_plan(H, W, AkazeConfig(max_pts=MAX_PTS)), 4)
    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "l.pgm"), os.path.join(tmp, "r.pgm")
        save_pgm(lp, raw_pair[0])
        save_pgm(rp, raw_pair[1])
        for fn in counters().values():
            fn.launches = 0
        buf = io.StringIO()
        with cl.redirect_stdout(buf), no_plain_versions():
            cli.main(["--left", lp, "--right", rp, "--json", "--iters", "1",
                      "--no-draw", "--spatial", "4", "--device", str(dev)])
        torch.cuda.synchronize()
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"tiled": 16 * per["tiled"], "resident": 16 * per["resident"],
            "extrema": 0, "describe": 16, "hamming": 11, "pgo": 0}
    counts = (rec["left_pts"], rec["right_pts"], rec["matches"])
    check(counts == expected,
          f"[mesh cli] {rec}; the main path gave {expected}")
    check(launches == want, f"[mesh cli] launches {launches}")
    print(f"[mesh cli] --spatial 4 --device {dev}: {json.dumps(rec)}; "
          f"launches {launches}; counts equal to the main path's; card: "
          f"{card}")
    return rec


def phase_mesh_dryrun(torch, dev):
    from akaze_tpu_torch.parallel import dryrun_multichip
    with no_plain_versions():
        out = dryrun_multichip(4, devices=[dev] * 4)
    check(all(np.isfinite(out[k]) for k in ("ba_cost", "pgo_cost",
                                            "hostchip_lm_ba_cost"))
          and out["spatial_count"] > 0 and out["matched"] > 0,
          f"[mesh dryrun] {out}")
    print(f"[mesh dryrun] dryrun_multichip(4) on one card: {out}")
    return out


def mesh_rows(spatials, match, dp, slam, k1_rep, k1_b1_rep, k2_rep,
              k4_rep):
    """The sharded paths' rows of the kernels line; ``spatials``: (name
    suffix, ``phase_mesh_spatial`` result) per image size.  K1 runs at
    B = 1 on every spatial shard (``k1_b1_rep``) and at B = 2 per pair in
    the dp step (``k1_rep``)."""
    srcs = {"k1": "akaze_tpu_torch/csrc/sublevel.cu",
            "k2": "akaze_tpu_torch/csrc/describe.cu",
            "k4": "akaze_tpu_torch/csrc/hamming.cu"}
    rows = []
    spatial_rows = sorted((n, name, size, r) for size, sp in spatials
                          for (n, name), r in sp["rows"].items())
    spatial_rows += [(None, "float", "_mesh_slam", slam)]
    for n, name, size, r in spatial_rows:
        sfx = (f"_spatial{n}" if n else "") + size + (
            "_fixed" if "fixed" in name else "")
        k1, k2 = r["k1"], r["k2"]
        for kind, key, err, plain, nb, no in (
                ("tiled_kernel", "tiled", k1["max_abs_err"], k1["plain_ms"],
                 k1["bytes"], k1["ops"]),
                ("octave_kernel", "resident", k1["res_abs_err"],
                 k1["res_plain_ms"], k1["res_bytes"], k1["res_ops"])):
            if r[key] is None:
                continue
            bms, by = bound(nb, no)
            rows.append(dict(name=kind + sfx, source=srcs["k1"],
                             replaces=k1_b1_rep,
                             launches=r["launches"][key],
                             max_abs_err=err, ms=r[key][0],
                             plain_ms=plain, bound_ms=bms, bound_by=by))
        bms, by = bound(k2["bytes"], 0)
        rows.append(dict(name="describe_kernel" + sfx, source=srcs["k2"],
                         replaces=k2_rep, launches=r["launches"]["describe"],
                         max_abs_err=k2["max_abs_err"], ms=r["describe"][0],
                         plain_ms=k2["plain_ms"], bound_ms=bms, bound_by=by))
    rows.append(dict(name="hamming_kernel_sharded_match", source=srcs["k4"],
                     replaces=k4_rep, launches=match["launches"],
                     max_abs_err=match["max_abs_err"], ms=match["ms"],
                     plain_ms=match["plain_ms"], bound_ms=match["bound_ms"],
                     bound_by=match["bound_by"],
                     library_ms=match["library_ms"]))
    # the dp step: every number from its own launches
    k1, k2, k4 = dp["k1"], dp["k2"], dp["k4"]
    for name, needle, key, src, rep, err, plain, nb, no in (
            ("tiled_kernel_dp", "tiled_kernel<float>", "tiled", "k1",
             k1_rep, k1["max_abs_err"], k1["plain_ms"], k1["bytes"],
             k1["ops"]),
            ("octave_kernel_dp", "octave_kernel<float>", "resident", "k1",
             k1_rep, k1["res_abs_err"], k1["res_plain_ms"],
             k1["res_bytes"], k1["res_ops"]),
            ("describe_kernel_dp", "describe_kernel<__nv_bfloat16",
             "describe", "k2", k2_rep, k2["max_abs_err"], k2["plain_ms"],
             k2["bytes"], 0)):
        bms, by = bound(nb, no)
        rows.append(dict(name=name, source=srcs[src], replaces=rep,
                         launches=dp["launches"][key], max_abs_err=err,
                         ms=kernel_time(dp["prof"], needle)[0],
                         plain_ms=plain, bound_ms=bms, bound_by=by))
    rows.append(dict(name="hamming_kernel_dp", source=srcs["k4"],
                     replaces=k4_rep, launches=dp["launches"]["hamming"],
                     max_abs_err=k4["max_abs_err"],
                     ms=kernel_time(dp["prof"], "hamming_kernel")[0],
                     plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
                     bound_by=k4["bound_by"], library_ms=k4["library_ms"]))
    return rows


# --------------------------------------------------------------------------
# the compiled programs (akaze_tpu_torch/programs.py): one CUDA graph per
# static signature, held against the eager card path
# --------------------------------------------------------------------------

PRINTED_KEYS = set()    # (program, key) lines key_line printed


def launch_counts():
    return {k: fn.launches for k, fn in counters().items()}


def equal_outputs(torch, got, want, tag):
    """Fail unless two outputs of one program are equal bit for bit."""
    from torch.utils import _pytree as pytree
    g, gs = pytree.tree_flatten(got)
    w, ws = pytree.tree_flatten(want)
    check(gs == ws, f"[{tag}] output structures differ")
    for i, (x, y) in enumerate(zip(g, w)):
        same = (x.dtype == y.dtype and x.shape == y.shape
                and bool(torch.equal(x, y)))
        check(same, f"[{tag}] output {i} differs from the eager run's")


def hold_program(torch, program, fn, tag, calls=3):
    """``fn`` (one call of ``program`` on the card) against the same call
    run eagerly (``programs.eager()``): after a first call (a capture, or
    a replay of a key captured before), each of ``calls`` replays equals
    the eager output bit for bit, leaves ``captures`` as it was, adds one
    to ``replays`` and moves the launch counters as the eager call moved
    them; no kernel's plain version runs.  Returns (eager output, its
    launches)."""
    from akaze_tpu_torch import programs
    with no_plain_versions():
        with programs.eager():
            before = launch_counts()
            want = fn()
            torch.cuda.synchronize()
            eager_n = {k: v - before[k] for k, v in launch_counts().items()}
        fn()
        torch.cuda.synchronize()
        captures = program.captures
        for _ in range(calls):
            replays = program.replays
            before = launch_counts()
            got = fn()
            torch.cuda.synchronize()
            n = {k: v - before[k] for k, v in launch_counts().items()}
            check(program.captures == captures
                  and program.replays == replays + 1,
                  f"[{tag}] captures {program.captures} (was {captures}), "
                  f"replays {program.replays} (was {replays})")
            check(n == eager_n, f"[{tag}] a replay counted launches {n}, "
                  f"the eager call {eager_n}")
            equal_outputs(torch, got, want, tag)
    return want, eager_n


def no_sync(torch, fn, tag):
    """``fn`` (warm) under ``set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        fail(f"[{tag}] a replay synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def fresh_outputs(torch, first, second, tag):
    """``first()`` then ``second()``, one program on other inputs: the
    first call's outputs stay as they were."""
    from torch.utils import _pytree as pytree
    out = pytree.tree_leaves(first())
    keep = [x.clone() for x in out]
    other = pytree.tree_leaves(second())
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(out, keep)),
          f"[{tag}] a later call overwrote an earlier call's outputs")
    check(not all(torch.equal(x, y) for x, y in zip(out, other)),
          f"[{tag}] other inputs gave the same outputs")


def in_turns(torch, fn, reps):
    """Times of ``fn`` between CUDA events, eager (``programs.eager()``)
    and captured in turns: (eager times, captured times)."""
    from akaze_tpu_torch import programs
    eager, captured = [], []
    for _ in range(reps):
        with programs.eager():
            eager += cuda_times(torch, fn, reps=1, warmup=0)
        captured += cuda_times(torch, fn, reps=1, warmup=0)
    return eager, captured


def busy(torch, fn, eager: bool, reps: int = PROFILE_REPS):
    """(device ms, device events) per call of ``fn``: the profiler's
    device events summed (one stream: they never overlap)."""
    from akaze_tpu_torch import programs
    with programs.eager() if eager else contextlib.nullcontext():
        prof = device_kernels(torch, fn, reps)
    return sum(v[0] for v in prof.values()), sum(v[1] for v in prof.values())


def graph_nodes(torch, program, *args, **kwargs):
    """(device events, device ms) of one replay of ``program``'s graph for
    these arguments, from the profiler: its kernel, copy and memset
    nodes."""
    graph = program.entries[program.key(*args, **kwargs)[0]].graph
    prof = device_kernels(torch, graph.replay)
    return sum(v[1] for v in prof.values()), sum(v[0] for v in prof.values())


def key_line(program, tag):
    """Capture seconds and the MiB added to the shared graph pool by each
    key of ``program`` not printed before."""
    from akaze_tpu_torch import programs
    rows = [s for s in programs.stats() if s["program"] == program.name
            and (s["program"], s["key"]) not in PRINTED_KEYS]
    for s in rows:
        PRINTED_KEYS.add((s["program"], s["key"]))
        print(f"[{tag}] key {s['key'][:90]}: warm-up {s['warmup_s']:.3f} s, "
              f"capture {s['capture_s']:.3f} s, pool +"
              f"{s['pool_bytes'] / 2**20:.1f} MiB, {s['replays']} replays")
    return rows


def phase_program_profiler(torch, det, a, b):
    """``torch.profiler`` sees a replayed graph's kernels under their
    names, with the eager iteration's launch counts (the kernel rows and
    the captured busy time profile replays): fails otherwise."""
    from akaze_tpu_torch import programs
    at = torch.as_tensor(a, device=det.device)
    bt = torch.as_tensor(b, device=det.device)

    def pair_iteration():
        return det.match(*det.detect_and_compute_pair(at, bt))

    needles = ("tiled_kernel", "octave_kernel", "extrema_nms_kernel",
               "describe_kernel", "hamming_kernel")

    def launches(prof):
        return {n: sum(v[1] for k, v in prof.items() if n in k)
                for n in needles}

    with programs.eager():
        want = device_kernels(torch, pair_iteration)
    for _ in range(3):      # the trace can drop events
        got = device_kernels(torch, pair_iteration)
        if launches(got) == launches(want) and all(launches(got).values()):
            break
    else:
        fail(f"[program profiler] a replayed pair iteration's kernels "
             f"{launches(got)} against the eager iteration's "
             f"{launches(want)}: a kernel of the path is missing from the "
             f"trace or counted otherwise")
    print(f"[program profiler] a replayed pair iteration: "
          f"{sum(v[1] for v in got.values()):.0f} device events, "
          f"{sum(v[0] for v in got.values()):.3f} ms (eager "
          f"{sum(v[1] for v in want.values()):.0f}, "
          f"{sum(v[0] for v in want.values()):.3f} ms); the kernels appear "
          f"under their names with the eager launch counts")


def phase_program_pair(torch, det, a, b, tag):
    """Program 1 (the pair) of one flavour at 960x1280 and the match after
    it: the pair held against the eager card path, the match one launch
    and no program; fresh outputs, times eager and captured in turns,
    device busy against wall."""
    from akaze_tpu_torch import pipeline, programs
    at = torch.as_tensor(a, device=det.device)
    bt = torch.as_tensor(b, device=det.device)
    (fa, fb), n = hold_program(
        torch, pipeline._jit_detect_and_compute_pair,
        lambda: det.detect_and_compute_pair(at, bt), f"{tag} pair")
    check(n == MAIN_LAUNCHES | {"hamming": 0}, f"[{tag}] launches {n}")
    keys, before = len(programs.stats()), launch_counts()
    det.match(fa, fb)
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in launch_counts().items()}
    check(len(programs.stats()) == keys and n == dict.fromkeys(n, 0) | {
        "hamming": 1}, f"[{tag} match] launches {n}, a program key added: "
        f"{len(programs.stats()) != keys}")
    fresh_outputs(torch, lambda: det.detect_and_compute_pair(at, bt),
                  lambda: det.detect_and_compute_pair(bt, at), tag)

    def pair_iteration():
        return det.match(*det.detect_and_compute_pair(at, bt))

    no_sync(torch, pair_iteration, tag)
    eager, captured = in_turns(torch, pair_iteration, REPS)
    out = dict(eager_ms=float(np.median(eager)),
               captured_ms=float(np.median(captured)))
    for kind in ("eager", "captured"):
        ms, events = busy(torch, pair_iteration, kind == "eager")
        out[f"{kind}_busy_ms"] = ms
        out[f"{kind}_events"] = events
        out[f"{kind}_idle"] = 1.0 - ms / out[f"{kind}_ms"]
    out["keys"] = key_line(pipeline._jit_detect_and_compute_pair, tag)
    print(f"[{tag}] captured = eager bit for bit (the pair, 3 replays; "
          f"the match one launch, no program); fresh outputs; no sync; pair "
          f"iteration eager {spread(eager)}, captured {spread(captured)} "
          f"(in turns); device eager {out['eager_busy_ms']:.3f} ms busy in "
          f"{out['eager_events']:.0f} events, idle {out['eager_idle']:.3f}; "
          f"captured {out['captured_busy_ms']:.3f} ms busy, idle "
          f"{out['captured_idle']:.3f}")
    return out


def phase_program_single(torch, det, image, tag):
    """Program 2 (one image): ``describe=True`` and ``False`` held against
    the eager card path; no sync; times eager and captured in turns."""
    from akaze_tpu_torch import pipeline
    x = torch.as_tensor(image, device=det.device)
    out = {}
    for describe in (True, False):
        t = f"{tag} describe={describe}"
        f, n = hold_program(torch, pipeline._jit_detect_and_compute,
                            lambda: det.detect_and_compute(x, describe), t)
        check(n["tiled"] > 0 and n["describe"] == int(describe)
              and n["hamming"] == 0, f"[{t}] launches {n}")
        no_sync(torch, lambda: det.detect_and_compute(x, describe), t)
        eager, captured = in_turns(
            torch, lambda: det.detect_and_compute(x, describe), REPS // 2)
        out[describe] = dict(eager_ms=float(np.median(eager)),
                             captured_ms=float(np.median(captured)))
        print(f"[{t}] {int(f.count)} keypoints; captured = eager bit for "
              f"bit (launches {n}); no sync; eager {spread(eager)}, "
              f"captured {spread(captured)} (in turns)")
    out["keys"] = key_line(pipeline._jit_detect_and_compute, tag)
    return out


def phase_program_candidates(torch, system):
    """Program 4 on the SLAM route's loop-candidate stacks: every
    keyframe's candidates as ``SlamSystem`` screens them."""
    from akaze_tpu_torch.slam.system import _batched_match_counts
    cfg, index = system.cfg, system.index
    stacks = 0
    for q in range(len(index)):
        cand = index.candidates(q, cfg.min_loop_gap, cfg.loop_candidates)
        if not len(cand):
            continue
        f = index._feats[q]
        words = torch.stack([index._feats[int(c)].words for c in cand])
        valid = torch.stack([index._feats[int(c)].valid for c in cand])

        def call():
            return _batched_match_counts(f.words, f.valid, words, valid, 96)

        counts, n = hold_program(torch, _batched_match_counts, call,
                                 f"program candidates kf {q}", calls=1)
        check(n["hamming"] == len(cand), f"[program candidates] {n}")
        stacks += 1
    check(stacks > 0, "[program candidates] the route screened no keyframe")
    no_sync(torch, call, "program candidates")
    eager, captured = in_turns(torch, call, REPS)
    print(f"[program candidates] {stacks} candidate stacks of the route "
          f"(last: {len(cand)} keyframes, counts {counts.tolist()}): "
          f"captured = eager bit for bit; no sync; last stack eager "
          f"{spread(eager)}, captured {spread(captured)}")
    return dict(eager_ms=float(np.median(eager)),
                captured_ms=float(np.median(captured)),
                keys=key_line(_batched_match_counts, "program candidates"))


def phase_program_solvers(torch, dev):
    """Programs 5 and 6 (PGO, local BA) at the SLAM cell's buckets, as
    ``SlamSystem`` calls them: held against the eager card path at two
    values of the traced damping (``damping``, ``lam0``), no sync, times
    per call eager and captured in turns."""
    from akaze_tpu_torch.slam import SlamConfig
    from akaze_tpu_torch.slam.ba import bundle_adjust
    from akaze_tpu_torch.slam.posegraph import optimize_pose_graph
    cfg = SlamConfig()
    (R0, t0, g), (Rc, tc, X0, prob) = slam_cell_problems(torch, dev)
    fixed = torch.arange(R0.shape[0], device=dev) == 0
    kw = dict(iters=10, fixed_mask=fixed, robust=cfg.robust,
              robust_delta=cfg.robust_delta)
    out = {}
    for damping in (1e-6, 1e-2):
        hold_program(torch, optimize_pose_graph,
                     lambda: optimize_pose_graph(R0, t0, g, damping=damping,
                                                 **kw),
                     f"program pgo damping={damping}", calls=2)
    pgo = lambda: optimize_pose_graph(R0, t0, g, **kw)  # noqa: E731
    no_sync(torch, pgo, "program pgo")
    out["pgo"] = in_turns(torch, pgo, 5)
    args = (Rc.to(dev), tc.to(dev), X0.to(dev),
            type(prob)(*(f.to(dev) for f in prob)))
    n = dict(n_cams=Rc.shape[0], n_pts=X0.shape[0], iters=6,
             fixed_cam_mask=torch.arange(Rc.shape[0], device=dev) == 0)
    for lam0 in (1e-3, 1e-1):
        hold_program(torch, bundle_adjust,
                     lambda: bundle_adjust(*args, lam0=lam0, **n),
                     f"program ba lam0={lam0}", calls=2)
    ba = lambda: bundle_adjust(*args, **n)  # noqa: E731
    no_sync(torch, ba, "program ba")
    out["ba"] = in_turns(torch, ba, 5)
    for name, prog in (("pgo", optimize_pose_graph), ("ba", bundle_adjust)):
        eager, captured = out[name]
        out[name] = dict(eager_ms=float(np.median(eager)),
                         captured_ms=float(np.median(captured)),
                         keys=key_line(prog, f"program {name}"))
        print(f"[program {name}] captured = eager bit for bit at two "
              f"damping values; no sync; per call eager {spread(eager)}, "
              f"captured {spread(captured)} (in turns)")
    return out


def timed_route(torch, dev, frames, mesh=None):
    """The TUM route on a new system (on ``mesh`` when given): (system,
    tracked frame ms, keyframe frame ms, PGO ms per call, BA ms per call):
    frames between CUDA events, PGO and BA calls by the host spans
    ``slam.pgo`` and ``slam.local_ba`` of ``tracing``."""
    from akaze_tpu_torch import tracing
    s = tum_system(dev, mesh)
    tracked, keyf = [], []
    tracing.enable()
    tracing.reset()
    for k, f in enumerate(frames):
        n_kf = len(s.vo.keyframes)
        t = cuda_times(torch, lambda: s.process(f), reps=1, warmup=0)[0]
        if k:
            (keyf if len(s.vo.keyframes) > n_kf else tracked).append(t)
    tracing.disable()
    spans = tracing.summary()["spans"]

    def per_call(name):
        a = spans.get(name)
        return a["total_ns"] / a["count"] / 1e6 if a else 0.0
    return (s, tracked, keyf, per_call("slam.pgo"),
            per_call("slam.local_ba"))


def same_map(a, b):
    """Keyframes (frame indices, poses, words) and edges equal bit for
    bit."""
    return ([k.index for k in a.vo.keyframes]
            == [k.index for k in b.vo.keyframes]
            and all(np.array_equal(x.R, y.R) and np.array_equal(x.t, y.t)
                    and bool((x.features.words == y.features.words).all())
                    for x, y in zip(a.vo.keyframes, b.vo.keyframes))
            and len(a.edges) == len(b.edges)
            and all(x[:2] == y[:2] and np.array_equal(x[2], y[2])
                    and np.array_equal(x[3], y[3]) and x[4] == y[4]
                    for x, y in zip(a.edges, b.edges)))


def phase_program_route(torch, dev, frames, first, syncs, card):
    """The SLAM route eagerly (``programs.eager()``) and with programs
    (every key captured by the first run, ``first``): keyframes and edges
    equal bit for bit to the eager run's and to the first run's; no new
    capture; frame, PGO and BA times side by side; host syncs per frame of
    an eager route beside ``syncs``, those of ``[slam repeat]``'s route
    with programs; the programs' keys and the shared graph pool after the
    route."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.slam import odometry, system
    with programs.eager(), recording(odometry, "_two_view") as tracked, \
            recording(system, "_two_view") as loops:
        eager = timed_route(torch, dev, frames)
    captures = sum(p.captures for p in programs.programs())
    captured = timed_route(torch, dev, frames)
    new = sum(p.captures for p in programs.programs()) - captures
    check(same_map(eager[0], captured[0]),
          "[program route] the captured route differs from the eager one")
    check(same_map(first, captured[0]),
          "[program route] two captured routes differ")
    check(new == 0, f"[program route] a repeated route captured {new} "
          f"new keys")
    with programs.eager():
        eager_syncs = route_syncs(torch, dev, frames)[1:]
    stats = programs.stats()
    pool = sum(s["pool_bytes"] for s in stats) / 2**20
    per = {}
    for s in stats:
        name = s["program"].rsplit(".", 1)[1]
        per[name] = per.get(name, 0) + 1
    out = dict(eager=[float(np.median(eager[1])), float(np.median(eager[2])),
                      eager[3], eager[4]],
               captured=[float(np.median(captured[1])),
                         float(np.median(captured[2])), captured[3],
                         captured[4]],
               keys=per, pool_mib=pool,
               syncs={kind: [float(np.median(c)) for c in counts]
                      for kind, counts in (("eager", eager_syncs),
                                           ("captured", syncs))},
               two_view_calls={"tracked": tracked, "loop": loops})
    print(f"[program route] {len(frames)} frames: keyframes and edges equal "
          f"bit for bit to the eager run's and the first run's; no new "
          f"capture. median tracked frame eager {out['eager'][0]:.3f} / "
          f"captured {out['captured'][0]:.3f} ms; keyframe frame "
          f"{out['eager'][1]:.3f} / {out['captured'][1]:.3f} ms; PGO per "
          f"call {out['eager'][2]:.3f} / {out['captured'][2]:.3f} ms; local "
          f"BA per call {out['eager'][3]:.3f} / {out['captured'][3]:.3f} ms "
          f"(host wall per section); card: {card}")
    print(f"[program route] host syncs per frame (sync debug 'warn', median "
          f"over the route): tracked frames eager "
          f"{out['syncs']['eager'][0]:.0f} / captured "
          f"{out['syncs']['captured'][0]:.0f} (max {max(syncs[0])}), "
          f"keyframe frames {out['syncs']['eager'][1]:.0f} / "
          f"{out['syncs']['captured'][1]:.0f} (max {max(syncs[1])})")
    print(f"[programs] after the SLAM route: {len(stats)} captured keys "
          f"{per}; the shared graph pool {pool:.1f} MiB; torch.cuda "
          f"reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB")
    return out


def phase_program_two_view(torch, calls, card):
    """The two-view programs (``_putative``: K4's match and the putative
    points; ``_solve``: RANSAC and triangulation; the draw runs eagerly
    between them) on the SLAM route's tracked pairs and loop pairs, as the
    eager route called ``_two_view`` (``calls``): each call captured
    equals it under ``programs.eager()`` bit for bit, with no new capture;
    K4 equals its plain version on every pair; no host sync inside either
    program or between them; each graph's nodes; a tracked pair's
    ``_two_view`` eager and captured in turns, and its device busy time."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.geometry.ransac import sets_from_key
    from akaze_tpu_torch.match import matches_from_top2
    from akaze_tpu_torch.ops.hamming import (hamming_top2,
                                             hamming_top2_plain, last_live)
    from akaze_tpu_torch.slam import odometry
    progs = (odometry._putative, odometry._solve)
    captures = [p.captures for p in progs]
    for kind, recorded in calls.items():
        check(bool(recorded), f"[program two_view] no {kind} pair recorded")
        for a, kw in recorded:
            with programs.eager():
                want = odometry._two_view(*a, **kw)
            got = odometry._two_view(*a, **kw)
            equal_outputs(torch, got, want, f"program two_view {kind}")
            f1, f2 = a[1], a[2]
            c1, c2 = last_live(f1.valid), last_live(f2.valid)
            top = hamming_top2(f1.words, f2.words, f2.valid, c1, c2)
            plain = hamming_top2_plain(f1.words, f2.words, f2.valid, c1, c2)
            same = (all(torch.equal(x, y) for x, y in zip(top, plain))
                    and all(torch.equal(x, y) for x, y in zip(
                        matches_from_top2(*top, f1.valid, f2.x, f2.y),
                        want[0])))
            check(same, f"[program two_view] {kind} pair: K4 differs from "
                  f"its plain version")
        no_sync(torch, lambda: odometry._two_view(*a, **kw),
                f"program two_view {kind}")
    new = [p.captures - n for p, n in zip(progs, captures)]
    check(new == [0, 0], f"[program two_view] new captures {new}")
    (key, f1, f2, fx, fy, cx, cy, thr), kw = calls["tracked"][0]
    m, x1, x2, put = odometry._putative(f1.words, f1.valid, f1.x, f1.y,
                                        f2.words, f2.valid, f2.x, f2.y,
                                        fx, fy, cx, cy)
    sets = sets_from_key(key, put, 512)
    nodes = {"_putative": graph_nodes(
                 torch, odometry._putative, f1.words, f1.valid, f1.x, f1.y,
                 f2.words, f2.valid, f2.x, f2.y, fx, fy, cx, cy),
             "_solve": graph_nodes(torch, odometry._solve, x1, x2, put, sets,
                                   thr, num_hyps=512)}

    def call():
        return odometry._two_view(*calls["tracked"][0][0],
                                  **calls["tracked"][0][1])

    eager, captured = in_turns(torch, call, REPS)
    out = dict(eager_ms=float(np.median(eager)),
               captured_ms=float(np.median(captured)), nodes=nodes,
               keys=key_line(odometry._putative, "program two_view")
               + key_line(odometry._solve, "program two_view"))
    for kind in ("eager", "captured"):
        ms, events = busy(torch, call, kind == "eager")
        out[f"{kind}_busy_ms"] = ms
        out[f"{kind}_idle"] = 1.0 - ms / out[f"{kind}_ms"]
    print(f"[program two_view] {len(calls['tracked'])} tracked and "
          f"{len(calls['loop'])} loop pairs of the route: captured = eager "
          f"bit for bit, no new capture; K4 = plain on every pair; no host "
          f"sync inside or between the programs; graph nodes (device "
          f"events of one replay, device ms): " + ", ".join(
              f"{k} {n:.0f} in {ms:.3f} ms" for k, (n, ms) in nodes.items())
          + f"; a tracked pair's _two_view eager {spread(eager)}, captured "
          f"{spread(captured)} (in turns); device busy eager "
          f"{out['eager_busy_ms']:.3f} ms (idle {out['eager_idle']:.3f}), "
          f"captured {out['captured_busy_ms']:.3f} ms (idle "
          f"{out['captured_idle']:.3f}); card: {card}")
    return out


def turns_and_idle(torch, fn, reps, profile_reps=PROFILE_REPS):
    """``fn`` eager and captured in turns (``in_turns``) and each form's
    device busy time against its wall (idle share)."""
    eager, captured = in_turns(torch, fn, reps)
    out = dict(eager_ms=float(np.median(eager)),
               captured_ms=float(np.median(captured)),
               eager_spread=spread(eager), captured_spread=spread(captured))
    for kind in ("eager", "captured"):
        ms, events = busy(torch, fn, kind == "eager", profile_reps)
        out[f"{kind}_busy_ms"] = ms
        out[f"{kind}_events"] = events
        out[f"{kind}_idle"] = 1.0 - ms / out[f"{kind}_ms"]
    return out


def turns_line(r) -> str:
    return (f"eager {r['eager_spread']}, captured {r['captured_spread']} "
            f"(in turns); device busy eager {r['eager_busy_ms']:.3f} ms in "
            f"{r['eager_events']:.0f} events (idle {r['eager_idle']:.3f}), "
            f"captured {r['captured_busy_ms']:.3f} ms in "
            f"{r['captured_events']:.0f} (idle {r['captured_idle']:.3f})")


def phase_program_mesh(torch, dev, card, pairs, big, frames, slam_first,
                       raw_pair, expected):
    """The multi-device programs on meshes whose shards share this card,
    each held against ``programs.eager()`` (``hold_program``: replays bit
    for bit, the launch counters moved as the eager call moves them, no
    plain version run), no host sync in a replay, timed eager and
    captured in turns with the idle share of each, and each key's capture
    seconds and pool MiB: the spatial program on a 960x1280 image over 2
    and 4 shards and a 1920x2560 image over 8, the dp step (8 pairs, 4
    shards), sharded PGO, observation- and landmark-sharded BA at the SLAM
    cell's buckets; then ``SlamSystem(mesh=4)`` on the TUM route eagerly
    and with programs (keyframes and edges equal bit for bit to the eager
    run's and to ``[mesh slam]``'s, no new key) and the CLI with
    ``--spatial 4`` eagerly and again with programs (no new key, counts
    equal).  Returns the times."""
    import io
    from akaze_tpu_torch import Akaze, AkazeConfig, cli, pipeline, programs
    from akaze_tpu_torch.io import save_pgm
    from akaze_tpu_torch.parallel import (data_parallel, dp_pipeline_step,
                                          gather_points,
                                          landmark_sharded_bundle_adjust,
                                          pad_edges, pad_observations,
                                          partition_landmarks, sharded_ba,
                                          sharded_bundle_adjust,
                                          sharded_optimize_pose_graph,
                                          sharded_pgo)
    from akaze_tpu_torch.slam import SlamConfig
    out = {}
    sp = pipeline._jit_spatial_detect_and_compute
    for (h, w), img, n, reps in (((H, W), pairs[0], 2, REPS // 2),
                                 ((H, W), pairs[0], 4, REPS // 2),
                                 ((BIG_H, BIG_W), big[0], 8, 5)):
        tag = f"program mesh spatial {h}x{w} n={n}"
        det = Akaze(AkazeConfig(max_pts=MAX_PTS), mesh=cpu_mesh_of(n, dev))
        x = torch.as_tensor(img, device=dev)
        f, launches = hold_program(torch, sp,
                                   lambda: det.detect_and_compute(x), tag)
        no_sync(torch, lambda: det.detect_and_compute(x), tag)
        with no_plain_versions():
            r = turns_and_idle(torch, lambda: det.detect_and_compute(x),
                               reps)
        out[f"spatial {h}x{w} n={n}"] = r
        print(f"[{tag}] {int(f.count)} keypoints; captured = eager bit for "
              f"bit (launches {launches}); no sync; per image "
              f"{turns_line(r)}; card: {card}")

    # every spatial key of the mesh phases (four flavours at 960x1280,
    # two at 1920x2560) and this one
    out["spatial keys"] = key_line(sp, "program mesh spatial")

    # the dp step
    tag = "program mesh dp"
    dy, dx = SHIFT
    tex = synthetic_texture(H + dy + DP_PAIRS, W + dx + DP_PAIRS, SEED + 31)
    at = torch.as_tensor(np.stack([tex[i:i + H, i:i + W]
                                   for i in range(DP_PAIRS)]), device=dev)
    bt = torch.as_tensor(np.stack([tex[i + dy:i + dy + H, i + dx:i + dx + W]
                                   for i in range(DP_PAIRS)]), device=dev)
    plan = Akaze(AkazeConfig(max_pts=MAX_PTS), device=dev).plan_for(H, W)
    mesh = cpu_mesh_of(4, dev)

    def step():
        return dp_pipeline_step(at, bt, plan, mesh)

    _, launches = hold_program(torch, data_parallel._dp_step, step, tag,
                               calls=2)
    no_sync(torch, step, tag)
    with no_plain_versions():
        r = turns_and_idle(torch, step, 5, profile_reps=1)
    r["keys"] = key_line(data_parallel._dp_step, tag)
    out["dp"] = r
    print(f"[{tag}] {DP_PAIRS} pairs over 4 shards: captured = eager bit "
          f"for bit (launches {launches}); no sync; per step "
          f"{turns_line(r)}; card: {card}")

    # the solvers at the SLAM cell's buckets
    cfg = SlamConfig()
    (R0, t0, g), (Rc, tc, X0, prob) = slam_cell_problems(torch, dev)
    kw = dict(iters=10, robust=cfg.robust, robust_delta=cfg.robust_delta)
    n_cams, n_pts = Rc.shape[0], X0.shape[0]
    mcap = prob.cam.shape[0]
    part = partition_landmarks(prob, n_pts, 4,
                               min_pts_per_shard=-(-n_pts // 4),
                               min_obs_per_shard=-(-mcap // 4))
    Xg = gather_points(part, X0).to(dev)
    part = part._replace(prob=type(prob)(*(f.to(dev) for f in part.prob)))
    Rc, tc, X0 = Rc.to(dev), tc.to(dev), X0.to(dev)
    gprob = pad_observations(type(prob)(*(f.to(dev) for f in prob)), 4)
    g4 = pad_edges(g, 4)
    for name, prog, fn, reps in (
            ("pgo", sharded_pgo._run_sharded_pgo,
             lambda: sharded_optimize_pose_graph(R0, t0, g4, mesh, **kw), 3),
            ("ba", sharded_ba._run_landmark_sharded_ba,
             lambda: landmark_sharded_bundle_adjust(Rc, tc, Xg, part, mesh,
                                                    iters=6), 5),
            ("ba observations", sharded_ba._run_sharded_ba,
             lambda: sharded_bundle_adjust(Rc, tc, X0, gprob, mesh,
                                           iters=6), 3)):
        tag = f"program mesh {name}"
        _, launches = hold_program(torch, prog, fn, tag, calls=2)
        no_sync(torch, fn, tag)
        r = turns_and_idle(torch, fn, reps, profile_reps=1)
        r["keys"] = key_line(prog, tag)
        out[name] = r
        print(f"[{tag}] 4 shards at the SLAM cell's buckets: captured = "
              f"eager bit for bit; no sync; per call {turns_line(r)}; card: "
              f"{card}")

    # SlamSystem(mesh=4) on the TUM route: eagerly, then with programs
    # (every key captured by [mesh slam]'s route)
    tag = "program mesh slam"
    with programs.eager(), no_plain_versions():
        eager = timed_route(torch, dev, frames, mesh)
    captures = sum(p.captures for p in programs.programs())
    with no_plain_versions():
        captured = timed_route(torch, dev, frames, mesh)
    new = sum(p.captures for p in programs.programs()) - captures
    check(same_map(eager[0], captured[0]),
          f"[{tag}] the captured route differs from the eager one")
    check(same_map(slam_first, captured[0]),
          f"[{tag}] two captured routes differ")
    check(new == 0, f"[{tag}] a repeated route captured {new} new keys")
    mesh_keys = [s for s in programs.stats() if "Mesh(" in s["key"]]
    per = {}
    for s in mesh_keys:
        name = s["program"].rsplit(".", 1)[1]
        per[name] = per.get(name, 0) + 1
    out["slam"] = dict(
        eager=[float(np.median(eager[1])), float(np.median(eager[2])),
               eager[3], eager[4]],
        captured=[float(np.median(captured[1])),
                  float(np.median(captured[2])), captured[3], captured[4]])
    e, c = out["slam"]["eager"], out["slam"]["captured"]
    print(f"[{tag}] {len(frames)} frames over 4 shards: keyframes and edges "
          f"equal bit for bit to the eager run's and to [mesh slam]'s; no "
          f"new capture; median tracked frame eager {e[0]:.3f} / captured "
          f"{c[0]:.3f} ms; keyframe frame {e[1]:.3f} / {c[1]:.3f} ms; PGO "
          f"per call {e[2]:.3f} / {c[2]:.3f} ms; local BA per call "
          f"{e[3]:.3f} / {c[3]:.3f} ms (host wall per section); mesh keys "
          f"after the route {per}; card: {card}")

    # the CLI's --spatial 4, eagerly and again with programs
    tag = "program mesh cli"
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "l.pgm"), os.path.join(tmp, "r.pgm")
        save_pgm(lp, raw_pair[0])
        save_pgm(rp, raw_pair[1])
        argv = ["--left", lp, "--right", rp, "--json", "--iters",
                str(CLI_ITERS), "--no-draw", "--spatial", "4", "--device",
                str(dev)]
        for kind in ("eager", "captured"):
            captures = sum(p.captures for p in programs.programs())
            buf = io.StringIO()
            with (programs.eager() if kind == "eager"
                  else contextlib.nullcontext()), \
                    contextlib.redirect_stdout(buf), no_plain_versions():
                cli.main(argv)
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            counts = (rec["left_pts"], rec["right_pts"], rec["matches"])
            check(counts == expected, f"[{tag}] {kind}: {rec}; the main "
                  f"path gave {expected}")
            new = sum(p.captures for p in programs.programs()) - captures
            check(new == 0, f"[{tag}] {kind} run captured {new} new keys")
            recs[kind] = rec
    out["cli"] = {k: r["detect_pair_ms"] for k, r in recs.items()}
    stats = programs.stats()
    pool = sum(s["pool_bytes"] for s in stats) / 2**20
    mesh_pool = sum(s["pool_bytes"] for s in mesh_keys) / 2**20
    eager_keys = [s for s in stats if s["eager"]]
    check(not eager_keys, f"[programs] keys run eagerly on one card: "
          f"{eager_keys}")
    out["pool_mib"] = pool
    print(f"[{tag}] --spatial 4 --iters {CLI_ITERS}: detect_pair_ms eager "
          f"{recs['eager']['detect_pair_ms']} / captured "
          f"{recs['captured']['detect_pair_ms']}, match_ms "
          f"{recs['captured']['match_ms']}, compile_s "
          f"{recs['captured']['compile_s']}; counts equal to the main "
          f"path's; no new key; card: {card}")
    print(f"[programs] after the mesh phases: {len(stats)} keys, "
          f"{len(mesh_keys)} of them on meshes (their captures added "
          f"{mesh_pool:.1f} MiB), none run eagerly; the shared graph pool "
          f"{pool:.1f} MiB; torch.cuda reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB")
    return out


# --------------------------------------------------------------------------
# four cards (--cards 4): one process over cuda:0..3, and four processes of
# one card each joined on NCCL
# --------------------------------------------------------------------------

CARDS = 4
NCCL_TIMEOUT_S = 420     # a worker process's whole run
MEM_MAX = (3840, 5120)   # the largest image the memory phase tries


def sync_all(torch, cards):
    for c in cards:
        torch.cuda.synchronize(c)


def wall_times(torch, fn, cards, reps: int = 5, warmup: int = 1) -> list:
    """``reps`` host times (ms) of one call of ``fn``, every card
    synchronised before and after: the wall of work spread over cards."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        sync_all(torch, cards)
        t0 = time.perf_counter()
        fn()
        sync_all(torch, cards)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


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


def profile_cards(torch, fn, reps: int = PROFILE_REPS, cards=None) -> dict:
    """Per card index, per call of ``fn`` (``torch.profiler`` over ``reps``
    calls): ``kernels`` {name: (device ms, launches)}, ``busy`` the ms
    covered by the card's device events (the union of their intervals:
    NCCL's kernels run beside the compute stream), ``compute`` the same
    without NCCL's kernels, and ``nccl`` their summed ms.  ``cards``: the
    cards to synchronise (default: every visible one)."""
    from torch.profiler import ProfilerActivity, profile
    cards = range(torch.cuda.device_count()) if cards is None else cards
    fn()
    sync_all(torch, cards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync_all(torch, cards)
    cuda = torch.autograd.DeviceType.CUDA
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        per.setdefault(e.device_index(), []).append(
            (e.name(), e.start_ns(), e.end_ns(), e.duration_ns()))
    out = {}
    for c, evs in per.items():
        kern = {}
        for name, _, _, ns in evs:
            t, n = kern.get(name, (0, 0))
            kern[name] = (t + ns, n + 1)
        nccl = [e for e in evs if "nccl" in e[0].lower()]
        out[c] = dict(
            kernels={k: (t / reps / 1e6, n / reps)
                     for k, (t, n) in kern.items()},
            busy=union_ns([(a, b) for _, a, b, _ in evs]) / reps / 1e6,
            compute=union_ns([(a, b) for name, a, b, _ in evs
                              if "nccl" not in name.lower()]) / reps / 1e6,
            nccl=sum(e[3] for e in nccl) / reps / 1e6)
    return out


def idle_by_card(prof: dict, wall_ms: float, cards) -> list:
    """Per card: 1 - the time its device events cover over the wall of
    the call."""
    return [1.0 - prof.get(c.index, {}).get("busy", 0.0) / wall_ms
            for c in cards]


@contextlib.contextmanager
def launches_by_card():
    """Count each kernel's launches per card (the card of the launch's
    first tensor) for the eager calls inside: yields {card: {counter:
    launches}}."""
    from akaze_tpu_torch.ops import describe as k2mod
    from akaze_tpu_torch.ops import detect as kdmod
    from akaze_tpu_torch.ops import hamming as k4mod
    from akaze_tpu_torch.ops import sublevel as k1mod
    names = counters()
    table = {}
    saved = [(m, n, getattr(m, n)) for m, n in (
        (k1mod, "_launch_sublevel"), (k1mod, "_launch_octave"),
        (kdmod, "_launch"), (k2mod, "_launch"),
        (k4mod, "_launch_match"))]

    def counted(real):
        def launch(*a, **kw):
            before = {k: fn.launches for k, fn in names.items()}
            out = real(*a, **kw)
            first = a[0] if hasattr(a[0], "device") else a[0][0].det
            card = table.setdefault(str(first.device),
                                    dict.fromkeys(names, 0))
            for k, fn in names.items():
                card[k] += fn.launches - before[k]
            return out
        return launch

    for m, n, fn in saved:
        setattr(m, n, counted(fn))
    try:
        yield table
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def on_card(calls, c) -> list:
    """The recorded calls whose first tensor lies on card ``c``."""
    return [(a, kw) for a, kw in calls if a[0].device == c]


def per_card_checks(torch, cards, tiled, resident, k2calls, k4calls, fixed,
                    tag):
    """K1, K2 and K4 against their plain versions on each card's own
    recorded calls (with that card current, so that the plain versions'
    CUDA events bracket its work): per card the errors, plain ms, bytes
    and operations."""
    out = []
    for c in cards:
        with torch.cuda.device(c):
            r = {"k1": check_k1_calls(torch, on_card(tiled, c),
                                      on_card(resident, c), fixed,
                                      f"{tag} {c}")}
            if k2calls is not None:
                r["k2"] = check_k2_calls(torch, on_card(k2calls, c),
                                         f"{tag} {c}")
            mine = on_card(k4calls or [], c)
            r["k4"] = (check_k4_calls(torch, mine, f"{tag} {c}")
                       if mine else None)
            if mine:
                r["k4"]["library_ms"] = sum(
                    k4_call_library_ms(torch, c) for c in mine)
        out.append(r)
    return out


def phase_link(torch, cards):
    """How the cards are joined: ``nvidia-smi topo -m`` where the machine
    answers it, NVLink's state per link, peer access, and the copy rate
    from card 0 to card 1 (256 MiB, median of 5 between CUDA events)."""
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    if topo.returncode == 0 and topo.stdout.strip():
        print("[cards link] nvidia-smi topo -m:\n" + topo.stdout.rstrip())
    else:
        print(f"[cards link] nvidia-smi topo -m: exit {topo.returncode} "
              f"({(topo.stdout + topo.stderr).strip()[:200]})")
    nvl = subprocess.run(["nvidia-smi", "nvlink", "--status", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    links = [ln.strip() for ln in nvl.stdout.splitlines()
             if "Link" in ln]
    print(f"[cards link] nvidia-smi nvlink --status -i 0: exit "
          f"{nvl.returncode}, {len(links)} links"
          + (f": {links[0]} ..." if links else
             f" ({(nvl.stdout + nvl.stderr).strip()[:200]})"))
    peer = [torch.cuda.can_device_access_peer(cards[0], c)
            for c in cards[1:]]
    x = torch.empty(64 << 20, dtype=torch.float32, device=cards[0])
    y = torch.empty_like(x, device=cards[1])
    ms = cuda_ms(torch, lambda: y.copy_(x), reps=5)
    rate = x.numel() * 4 / (ms / 1e3) / 1e9
    print(f"[cards link] card 0 reaches cards 1-3 as a peer: {peer}; a 256 "
          f"MiB copy card 0 -> card 1: {ms:.3f} ms = {rate:.1f} GB/s")
    return dict(nvlink_links=len(links), peer=peer, copy_gb_s=rate)


def card_ms(prof: dict, c, needles) -> float:
    """Device ms per call on card ``c`` (a device or its index) of the
    kernels whose names hold one of ``needles``."""
    kernels = prof.get(getattr(c, "index", c), {}).get("kernels", {})
    return sum(v[0] for k, v in kernels.items()
               if any(n in k for n in needles))


def one_card_mesh(cards):
    """The four-shard mesh with every shard on the first card."""
    from akaze_tpu_torch.parallel import make_mesh
    return make_mesh(CARDS, devices=[cards[0]] * CARDS)


def expect_by_card(cards, by_card, each, tag):
    """Fail unless every card launched ``each`` (per counter named)."""
    for c in cards:
        got = by_card.get(str(c), {})
        got = {k: got.get(k, 0) for k in each}
        check(got == each, f"[{tag}] {c} launched {got}, want {each}")


def hold_cards(torch, cards, fn, tag, calls=2):
    """``fn`` (one call of a mesh path over ``cards``) against the same
    call under ``programs.eager()``: the first call (a capture, or a replay
    of a key captured before) and ``calls`` replays equal the eager output
    bit for bit and add no key; one replay runs under
    ``set_sync_debug_mode("error")``; an op on each output's card, issued
    straight after a replay, reads that replay's values; and a call's
    outputs on every card are unchanged by the next call.  No kernel's
    plain version runs.  Returns the eager output."""
    from akaze_tpu_torch import programs
    with no_plain_versions():
        with programs.eager():
            want = fn()
        first = fn()
        sync_all(torch, cards)
        captures = sum(p.captures for p in programs.programs())
        outs = []
        for i in range(calls):
            if i == 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = fn()
            except RuntimeError as e:
                fail(f"[{tag}] a replay over {len(cards)} cards "
                     f"synchronised: {e}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs.append((got, [x.clone() for x in pytree_leaves(got)]))
        sync_all(torch, cards)
    new = sum(p.captures for p in programs.programs()) - captures
    check(new == 0, f"[{tag}] a repeated call captured {new} new keys")
    equal_outputs(torch, first, want, tag)
    for got, read in outs:
        equal_outputs(torch, got, want, tag)
        equal_outputs(torch, read, pytree_leaves(want), tag + " read")
    return want


def cards_turns(torch, cards, fn, reps=5):
    """``fn`` eager (``programs.eager()``) and captured in turns, walls
    with every card synchronised, and per form each card's kernels and
    idle share (``profile_cards`` of one call against the form's median
    wall)."""
    from akaze_tpu_torch import programs
    out = dict(eager_ms=[], captured_ms=[])
    with no_plain_versions():
        for _ in range(reps):
            with programs.eager():
                out["eager_ms"] += wall_times(torch, fn, cards, 1, 0)
            out["captured_ms"] += wall_times(torch, fn, cards, 1, 0)
        for kind in ("eager", "captured"):
            with (programs.eager() if kind == "eager"
                  else contextlib.nullcontext()):
                prof = profile_cards(torch, fn, 1, cards)
            out[f"{kind}_prof"] = prof
            out[f"{kind}_idle"] = idle_by_card(
                prof, float(np.median(out[f"{kind}_ms"])), cards)
    return out


def cards_turns_line(r) -> str:
    return (f"eager {spread(r['eager_ms'])} (idle per card "
            f"{', '.join(f'{x:.3f}' for x in r['eager_idle'])}), captured "
            f"{spread(r['captured_ms'])} (idle "
            f"{', '.join(f'{x:.3f}' for x in r['captured_idle'])}), in turns")


def cards_keys(torch, cards, names, tag):
    """Fails unless the programs ``names`` (the last part of their names)
    have a key over ``cards`` and each such key is captured
    (``eager=False``); prints each key's capture seconds and the MiB it
    added to each card's pool (once per key)."""
    from akaze_tpu_torch import programs
    want = [str(c) for c in cards]
    rows = [r for r in programs.stats() if r["cards"] == want
            and r["program"].rsplit(".", 1)[1] in names]
    check(rows and all(not r["eager"] for r in rows),
          f"[{tag}] keys over {want}: {rows}")
    for r in rows:
        if (r["program"], r["key"]) in PRINTED_KEYS:
            continue
        PRINTED_KEYS.add((r["program"], r["key"]))
        print(f"[{tag} key] {r['program'].rsplit('.', 1)[1]} "
              f"[{r['key'][:80]}]: eager={r['eager']}, cards "
              f"{', '.join(r['cards'])}, warm-up {r['warmup_s']:.3f} s, "
              f"capture {r['capture_s']:.3f} s, pool + "
              f"{', '.join(f'{b / 2**20:.1f}' for b in r['card_pool_bytes'])}"
              f" MiB per card, {r['replays']} replays")


def phase_cards_spatial(torch, cards, card, pairs, flavours, size, shift,
                        profile_flavour=None):
    """The spatial tier over cuda:0..3 in one process (``Akaze(mesh=
    make_mesh(4))``; one graph over the four cards per key, by
    ``programs.mesh_route``'s rule) on one pair of ``size`` per flavour:
    the eager call (``programs.eager()``) with K1/K2 launches per card as
    ``spatial_route`` predicts and K1 and K2 against their plain versions
    on each card's own recorded inputs; the captured call and its replays
    (``hold_cards``) with the eager call's launch counts; features and
    matches of both bit for bit those of the same mesh with its four
    shards on cuda:0; the known shift recovered; the keys captured over
    the four cards with each card's pool; per image eager and captured in
    turns with each card's idle share, and one card's times beside; for
    ``profile_flavour``, each card's kernel times from replays of the
    pair."""
    from akaze_tpu_torch import Akaze, programs
    from akaze_tpu_torch.ops import describe as k2mod
    from akaze_tpu_torch.parallel import (make_mesh, spatial,
                                          spatial_launches, spatial_route)
    h, w = size
    out = {}
    for name, (fixed, cfg) in flavours.items():
        tag = f"cards spatial {h}x{w} {name}"
        a, b = (torch.as_tensor(x, device=cards[0]) for x in pairs[fixed])
        one = Akaze(cfg, fixed=fixed, mesh=one_card_mesh(cards))
        four = Akaze(cfg, fixed=fixed, mesh=make_mesh(CARDS))
        check(four.mesh.local_devices == cards,
              f"[{tag}] make_mesh(4) took {four.mesh.local_devices}")
        want = one.detect_and_compute_pair(a, b)
        wm = one.match(*want)
        plan = four.plan_for(h, w)
        per = spatial_launches(plan, CARDS)
        # the match runs once, on the mesh's first card (the one-card
        # mesh's match key)
        each = {"tiled": 2 * per["tiled"], "resident": 2 * per["resident"],
                "extrema": 0, "describe": 2, "pgo": 0}
        total = dict({k: CARDS * v for k, v in each.items()}, hamming=1)
        for fn in counters().values():
            fn.launches = 0
        with programs.eager(), no_plain_versions(), \
                launches_by_card() as by_card, \
                recording(spatial, "sublevel") as tiled, \
                recording(spatial, "octave") as resident, \
                recording(k2mod, "_launch") as k2calls:
            eager = four.detect_and_compute_pair(a, b)
            em = four.match(*eager)
            sync_all(torch, cards)
        check(launch_counts() == total,
              f"[{tag}] eager launches {launch_counts()}")
        expect_by_card(cards, by_card, each, tag)
        equal_outputs(torch, (eager, em), (want, wm), tag + " eager")
        for fn in counters().values():
            fn.launches = 0
        with no_plain_versions():
            got = four.detect_and_compute_pair(a, b)
            m = four.match(*got)
            sync_all(torch, cards)
        check(launch_counts() == total,
              f"[{tag}] captured launches {launch_counts()}")
        check(four.spatial_fallbacks == 0, f"[{tag}] fell back")
        equal_outputs(torch, (got, m), (want, wm), tag)
        hold_cards(torch, cards, lambda: four.detect_and_compute_pair(a, b),
                   tag)
        cards_keys(torch, cards, ("_jit_spatial_detect_and_compute",), tag)
        inl = (shift_recovered(torch, got[0], m, shift, tag)
               if shift is not None else float("nan"))
        checks = per_card_checks(torch, cards, tiled, resident, k2calls,
                                 None, fixed, tag)
        turns = cards_turns(torch, cards, lambda: four.detect_and_compute(a))
        t1 = wall_times(torch, lambda: one.detect_and_compute(a), cards)
        with programs.eager():
            t1e = wall_times(torch, lambda: one.detect_and_compute(a),
                             cards)
        r = dict(launches=by_card, checks=checks, turns=turns, one_ms=t1,
                 one_eager_ms=t1e)
        line = ""
        if name == profile_flavour:
            needle = "<int>" if fixed else "<float>"

            def pair():
                return four.match(*four.detect_and_compute_pair(a, b))

            pt = cards_turns(torch, cards, pair, reps=3)
            prof = pt["captured_prof"]
            r.update(prof=prof, pair_turns=pt, idle=pt["captured_idle"])
            k1n = ("tiled_kernel" + needle, "octave_kernel" + needle)
            line = ("; per pair " + cards_turns_line(pt) + ", per card "
                    "device K1 / K2 ms of a replay: " + ", ".join(
                        f"{c} {card_ms(prof, c, k1n):.4f} / "
                        f"{card_ms(prof, c, ('describe_kernel',)):.4f}"
                        for c in cards))
        out[name] = r
        print(f"[{tag}] over {', '.join(map(str, cards))} in one process: "
              f"one graph over the four cards per key; eager and captured "
              f"features and matches equal bit for bit to the same mesh on "
              f"{cards[0]} alone, replays = eager, no host sync in a replay, "
              f"no new key on a repeat; launches per card (eager) "
              f"{by_card[str(cards[0])]} on {cards[0]}, "
              f"{by_card[str(cards[1])]} on each other card = the route "
              f"{spatial_route(plan, CARDS)}, the same totals captured; K1 "
              f"and K2 = plain on every card's inputs; shift recovered "
              f"(inliers {inl:.4f}); per image four cards "
              f"{cards_turns_line(turns)}; one card {spread(t1)} "
              f"(captured), {spread(t1e)} (eager){line}; cards: {card}")
    return out


def phase_cards_match(torch, cards, card):
    """``sharded_match`` at 10000 x 10000 over cuda:0..3: ``Matches``
    equal bit for bit to the one-card four-shard mesh's, one K4 launch per
    card, K4 against its plain version on each card's inputs."""
    from akaze_tpu_torch.ops import hamming as k4mod
    from akaze_tpu_torch.parallel import (gather_shards, make_mesh,
                                          sharded_match)
    tag = "cards match"
    w1, w2, v1, v2, x2, y2 = k4_stress_inputs(torch, cards[0])
    four = make_mesh(CARDS)

    def call(mesh=four):
        return sharded_match(w1, v1, w2, v2, x2, y2, mesh, 96)

    want = gather_shards(call(one_card_mesh(cards)), cards[0])
    for fn in counters().values():
        fn.launches = 0
    with no_plain_versions(), launches_by_card() as by_card, \
            recording(k4mod, "_launch_match") as calls:
        got = gather_shards(call(), cards[0])
        sync_all(torch, cards)
    expect_by_card(cards, by_card, {"tiled": 0, "resident": 0,
                                    "extrema": 0, "describe": 0,
                                    "hamming": 1, "pgo": 0}, tag)
    equal_outputs(torch, got, want, tag)
    checks = per_card_checks(torch, cards, [], [], None, calls, False, tag)
    t4 = wall_times(torch, call, cards)
    prof = profile_cards(torch, call)
    idle = idle_by_card(prof, float(np.median(t4)), cards)
    ms = [card_ms(prof, c, ("hamming_kernel",)) for c in cards]
    print(f"[{tag}] 10000 x 10000 over {CARDS} cards: Matches equal bit for "
          f"bit to the one-card mesh's ({int((got.index >= 0).sum())} "
          f"accepted); 1 K4 launch per card, each = plain; per call "
          f"{spread(t4)}; K4 per card "
          f"{', '.join(f'{x:.4f}' for x in ms)} ms, idle share "
          f"{', '.join(f'{x:.3f}' for x in idle)}; cards: {card}")
    return dict(launches=by_card, checks=checks, ms=ms, idle=idle,
                call_ms=t4)


def dp_inputs(torch, dev):
    """The 8 pairs of the dp step at 960x1280 (each shifted by SHIFT)."""
    dy, dx = SHIFT
    tex = synthetic_texture(H + dy + DP_PAIRS, W + dx + DP_PAIRS, SEED + 31)
    a = np.stack([tex[i:i + H, i:i + W] for i in range(DP_PAIRS)])
    b = np.stack([tex[i + dy:i + dy + H, i + dx:i + dx + W]
                  for i in range(DP_PAIRS)])
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def phase_cards_dp(torch, cards, card):
    """``dp_pipeline_step``: 8 pairs of 960x1280 over cuda:0..3, two per
    card, one graph over the four cards: the eager step with K1 13, K2 1,
    K4 1 launches per pair on each card and K1, K2 and K4 against their
    plain versions on each card's launches; the captured step and its
    replays (``hold_cards``); every output of both equal bit for bit to
    the one-card four-shard mesh's; eager and captured in turns with each
    card's idle share, the kernel rows from replays."""
    from akaze_tpu_torch import Akaze, AkazeConfig, programs, scale_space
    from akaze_tpu_torch.ops import describe as k2mod
    from akaze_tpu_torch.ops import hamming as k4mod
    from akaze_tpu_torch.parallel import dp_pipeline_step, make_mesh
    tag = "cards dp"
    at, bt = dp_inputs(torch, cards[0])
    plan = Akaze(AkazeConfig(max_pts=MAX_PTS), device=cards[0]).plan_for(H, W)
    four = make_mesh(CARDS)
    want = dp_pipeline_step(at, bt, plan, one_card_mesh(cards))
    pairs = DP_PAIRS // CARDS
    for fn in counters().values():
        fn.launches = 0
    with programs.eager(), no_plain_versions(), \
            launches_by_card() as by_card, \
            recording(scale_space, "octave") as octaves, \
            recording(k2mod, "_launch") as k2calls, \
            recording(k4mod, "_launch_match") as k4calls:
        eager = dp_pipeline_step(at, bt, plan, four)
        sync_all(torch, cards)
    total = launch_counts()
    expect_by_card(cards, by_card, {k: pairs * v for k, v in
                                    MAIN_LAUNCHES.items()}, tag)
    check([f.x.device for f in eager[0]] == cards, f"[{tag}] shards")
    equal_outputs(torch, [x.to(cards[0]) for x in pytree_leaves(eager)],
                  pytree_leaves(want), tag + " eager")
    checks = per_card_checks(torch, cards, [], octaves, k2calls, k4calls,
                             False, tag)

    def step():
        return dp_pipeline_step(at, bt, plan, four)

    for fn in counters().values():
        fn.launches = 0
    with no_plain_versions():
        got = step()
        sync_all(torch, cards)
    check(launch_counts() == total, f"[{tag}] captured launches "
          f"{launch_counts()}, eager {total}")
    equal_outputs(torch, [x.to(cards[0]) for x in pytree_leaves(got)],
                  pytree_leaves(want), tag)
    hold_cards(torch, cards, step, tag)
    cards_keys(torch, cards, ("_dp_step",), tag)
    turns = cards_turns(torch, cards, step, reps=3)
    print(f"[{tag}] {DP_PAIRS} pairs of {H}x{W} over {CARDS} cards, "
          f"{pairs} per card, one graph over the four: eager and captured "
          f"outputs equal bit for bit to the one-card mesh's, replays = "
          f"eager, no host sync, no new key; launches per card "
          f"{by_card[str(cards[0])]} (eager; the same totals captured); K1, "
          f"K2 and K4 = plain on every card's launches; step "
          f"{cards_turns_line(turns)}; cards: {card}")
    return dict(launches=by_card, checks=checks, prof=turns["captured_prof"],
                idle=turns["captured_idle"], turns=turns)


def pytree_leaves(x) -> list:
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(x)


def solver_calls(torch, dev, mesh, hc):
    """The SLAM cell's sharded solvers on ``mesh`` (PGO and
    observation-sharded BA over ``data``) and ``hc`` (landmark-sharded BA
    over ("chip", "host")), their inputs on ``dev``: {name: call}."""
    from akaze_tpu_torch.parallel import (gather_points,
                                          landmark_sharded_bundle_adjust,
                                          pad_observations,
                                          partition_landmarks,
                                          sharded_bundle_adjust,
                                          sharded_optimize_pose_graph)
    from akaze_tpu_torch.slam import SlamConfig
    cfg = SlamConfig()
    (R0, t0, g), (Rc, tc, X0, prob) = slam_cell_problems(torch, dev)
    n_pts, mcap = X0.shape[0], prob.cam.shape[0]
    part = partition_landmarks(prob, n_pts, CARDS,
                               min_pts_per_shard=-(-n_pts // CARDS),
                               min_obs_per_shard=-(-mcap // CARDS))
    Xg = gather_points(part, X0).to(dev)
    part = part._replace(prob=type(prob)(*(f.to(dev) for f in part.prob)))
    Rc, tc, X0 = Rc.to(dev), tc.to(dev), X0.to(dev)
    gprob = pad_observations(type(prob)(*(f.to(dev) for f in prob)), CARDS)
    kw = dict(iters=10, robust=cfg.robust, robust_delta=cfg.robust_delta)
    return {
        "pgo": lambda: sharded_optimize_pose_graph(R0, t0, g, mesh, **kw),
        "ba observations": lambda: sharded_bundle_adjust(
            Rc, tc, X0, gprob, mesh, iters=6),
        "ba landmarks": lambda: landmark_sharded_bundle_adjust(
            Rc, tc, Xg, part, hc, iters=6, axis=("chip", "host"))}


def phase_cards_solvers(torch, cards, card):
    """Sharded PGO (16 poses, 32 edge slots, the SLAM cell's robust loss)
    and observation- and landmark-sharded BA (5 cameras, 512 points) over
    cuda:0..3, each one graph over the four cards: eager and captured
    outputs (``hold_cards``) equal bit for bit to the one-card four-shard
    mesh's; per call eager and captured in turns with each card's idle
    share, and the one card's (captured) beside."""
    from akaze_tpu_torch.parallel import make_host_chip_mesh, make_mesh
    one = one_card_mesh(cards)
    ones = solver_calls(torch, cards[0], one,
                        make_host_chip_mesh(CARDS, 1, devices=[cards[0]]
                                            * CARDS))
    fours = solver_calls(torch, cards[0], make_mesh(CARDS),
                         make_host_chip_mesh(CARDS, 1))
    names = {"pgo": "_run_sharded_pgo", "ba observations": "_run_sharded_ba",
             "ba landmarks": "_run_landmark_sharded_ba"}
    out = {}
    for name, fn in fours.items():
        tag = f"cards {name}"
        want = ones[name]()
        eager = hold_cards(torch, cards, fn, tag)
        equal_outputs(torch, [x.to(cards[0]) for x in pytree_leaves(eager)],
                      pytree_leaves(want), tag)
        cards_keys(torch, cards, (names[name],), tag)
        turns = cards_turns(torch, cards, fn, reps=3)
        t1 = wall_times(torch, ones[name], cards, reps=3)
        out[name] = dict(turns=turns, one_ms=t1)
        print(f"[{tag}] over {CARDS} cards, one graph over the four: eager "
              f"and captured outputs equal bit for bit to the one-card "
              f"mesh's, replays = eager, no host sync, no new key; per call "
              f"{cards_turns_line(turns)}; one card {spread(t1)} "
              f"(captured); cards: {card}")
    return out


def phase_cards_slam(torch, cards, card, frames):
    """``SlamSystem(mesh=make_mesh(4))`` on the TUM RGB-D route over
    cuda:0..3, eagerly (``programs.eager()``; K1 and K2 on every card on
    every frame) and with its programs (every mesh key one graph over the
    four cards), twice: keyframes (indices, poses, words) and edges of
    every run equal bit for bit to the same route on the one-card
    four-shard mesh; the second captured route captures no new key;
    frame times side by side."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.parallel import make_mesh
    tag = "cards slam"
    one = timed_route(torch, cards[0], frames, one_card_mesh(cards))
    with programs.eager(), no_plain_versions(), \
            launches_by_card() as by_card:
        eager = timed_route(torch, cards[0], frames, make_mesh(CARDS))
    with no_plain_versions():
        first = timed_route(torch, cards[0], frames, make_mesh(CARDS))
        captures = sum(p.captures for p in programs.programs())
        four = timed_route(torch, cards[0], frames, make_mesh(CARDS))
    new = sum(p.captures for p in programs.programs()) - captures
    check(new == 0, f"[{tag}] a repeated route captured {new} new keys")
    for name, run in (("eager", eager), ("first captured", first),
                      ("captured", four)):
        check(same_map(run[0], one[0]), f"[{tag}] the {name} four-card "
              f"route differs from the one-card mesh's")
    for c in cards:
        n = by_card.get(str(c), {})
        check(n.get("tiled", 0) > 0 and n.get("describe", 0) == len(frames),
              f"[{tag}] {c} launched {n}")
    cards_keys(torch, cards, ("_jit_spatial_detect_and_compute",), tag)
    e, c4, c1 = eager, four, one
    print(f"[{tag}] {len(frames)} frames over {CARDS} cards: keyframes and "
          f"edges of the eager and both captured routes equal bit for bit "
          f"to the one-card mesh's; no new key on the second captured "
          f"route; launches per card (eager) {by_card}; median tracked "
          f"frame eager {np.median(e[1]):.3f} / captured "
          f"{np.median(c4[1]):.3f} ms (one card captured "
          f"{np.median(c1[1]):.3f}), keyframe frame {np.median(e[2]):.3f} / "
          f"{np.median(c4[2]):.3f} / {np.median(c1[2]):.3f} ms, PGO per "
          f"call {e[3]:.3f} / {c4[3]:.3f} / {c1[3]:.3f} ms, local BA "
          f"{e[4]:.3f} / {c4[4]:.3f} / {c1[4]:.3f} ms; cards: {card}")
    return dict(tracked_ms=float(np.median(e[1])),
                captured_tracked_ms=float(np.median(c4[1])),
                one_tracked_ms=float(np.median(c1[1])))


def phase_cards_cli(torch, cards, card, raw_pair):
    """The CLI as a user runs it over four cards: ``--spatial 4 --device
    cuda`` (the first four cards) in this process, with its programs
    (each key one graph over the four cards), again (no new key), and
    under ``programs.eager()`` (K2 launched on every card); every run's
    counts equal to ``--spatial 4 --device cuda:0``'s."""
    import io
    from akaze_tpu_torch import cli, programs
    from akaze_tpu_torch.io import save_pgm
    tag = "cards cli"
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "l.pgm"), os.path.join(tmp, "r.pgm")
        save_pgm(lp, raw_pair[0])
        save_pgm(rp, raw_pair[1])
        for run, dev in (("captured", "cuda"), ("again", "cuda"),
                         ("eager", "cuda"), ("one card", str(cards[0]))):
            buf = io.StringIO()
            captures = sum(p.captures for p in programs.programs())
            with contextlib.redirect_stdout(buf), no_plain_versions(), \
                    (programs.eager() if run == "eager"
                     else contextlib.nullcontext()), \
                    launches_by_card() as by_card:
                cli.main(["--left", lp, "--right", rp, "--json", "--iters",
                          "2", "--no-draw", "--spatial", str(CARDS),
                          "--device", dev])
            sync_all(torch, cards)
            new = sum(p.captures for p in programs.programs()) - captures
            recs[run] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                         {k: v["describe"] for k, v in by_card.items()}, new)
    check(recs["again"][2] == 0, f"[{tag}] a second run captured "
          f"{recs['again'][2]} new keys")
    counts = {run: (r["left_pts"], r["right_pts"], r["matches"])
              for run, (r, _, _) in recs.items()}
    check(len(set(counts.values())) == 1 and counts["one card"][2] > 500,
          f"[{tag}] counts {counts}")
    n4 = recs["eager"][1]
    check(sorted(n4) == sorted(map(str, cards)) and len(set(n4.values()))
          == 1, f"[{tag}] K2 launches per card {n4}")
    cards_keys(torch, cards, ("_jit_spatial_detect_and_compute",), tag)
    four, eager, one = (recs[k][0] for k in ("again", "eager", "one card"))
    print(f"[{tag}] --spatial {CARDS} --device cuda: {json.dumps(four)}; "
          f"counts of the captured, repeated and eager runs equal to "
          f"--device {cards[0]}'s {counts['one card']}; no new key on the "
          f"repeat; K2 launches per card (eager) {n4}; detect_pair_ms "
          f"{four['detect_pair_ms']} (four cards, captured) / "
          f"{eager['detect_pair_ms']} (four cards, eager) / "
          f"{one['detect_pair_ms']} (one card, captured); cards: {card}")
    return dict(four=four, eager=eager, one=one)


def phase_cards_dryrun(torch, cards):
    """``dryrun_multichip(4)`` with its default devices (the first four
    cards) equal to the same run with four shards on cuda:0."""
    from akaze_tpu_torch.parallel import dryrun_multichip
    with no_plain_versions():
        four = dryrun_multichip(CARDS)
        one = dryrun_multichip(CARDS, devices=[cards[0]] * CARDS)
    check(four == one, f"[cards dryrun] four cards {four}, one card {one}")
    print(f"[cards dryrun] dryrun_multichip({CARDS}) over the first four "
          f"cards equal to four shards on {cards[0]}: {four}")
    return four


def phase_cards_programs(torch, cards, card):
    """After the one-process paths: every program key is captured (none
    eager), and the keys over the four cards, per program, with the MiB
    their captures added to each card's pool."""
    from akaze_tpu_torch import programs
    stats = programs.stats()
    eager = [r for r in stats if r["eager"]]
    check(not eager, f"[cards programs] keys run eagerly: {eager}")
    want = [str(c) for c in cards]
    per = {}
    for r in stats:
        if r["cards"] == want:
            name = r["program"].rsplit(".", 1)[1]
            n, pool = per.get(name, (0, [0.0] * CARDS))
            per[name] = (n + 1, [p + b / 2**20 for p, b in
                                 zip(pool, r["card_pool_bytes"])])
    check(set(per) >= {"_jit_spatial_detect_and_compute", "_dp_step",
                       "_run_sharded_pgo", "_run_sharded_ba",
                       "_run_landmark_sharded_ba"},
          f"[cards programs] programs over the four cards: {sorted(per)}")
    total = [sum(v[1][i] for v in per.values()) for i in range(CARDS)]
    print(f"[cards programs] {len(stats)} keys, none eager; over "
          f"{', '.join(want)}: " + "; ".join(
              f"{name} {n} keys, pool + "
              f"{', '.join(f'{x:.1f}' for x in pool)} MiB"
              for name, (n, pool) in sorted(per.items()))
          + f"; in all + {', '.join(f'{x:.1f}' for x in total)} MiB per "
          f"card; reserved per card "
          f"{', '.join(f'{torch.cuda.memory_reserved(c) / 2**20:.1f}' for c in cards)}"
          f" MiB; cards: {card}")
    return per


def phase_cards_memory(torch, cards, card):
    """Peak device memory per card of one image (float, max_pts=10000, the
    kernel path): unsharded on card 0 (eager) against row-sharded over the
    four cards, eager and captured, at 1920x2560 and at the largest size
    up to 3840x5120 that ``spatial_supported`` takes over four shards (2x2
    tiles of the 1920x2560 texture: the working set follows the shape, not
    the content).  Eager: per card the peak of ``max_memory_allocated``
    above what was allocated before the call.  Captured (every graph
    dropped first, so that the key's capture alone fills the pools): per
    card the MiB the key's capture added to the card's pool, and that
    plus the peak a replay allocates above the resident set (its inputs
    and cloned outputs)."""
    from akaze_tpu_torch import Akaze, AkazeConfig, programs
    from akaze_tpu_torch.parallel import make_mesh, spatial_supported
    cfg = AkazeConfig(max_pts=MAX_PTS)
    single = Akaze(cfg, device=cards[0])
    four = Akaze(cfg, mesh=make_mesh(CARDS))
    sizes = [(BIG_H, BIG_W)]
    for h in range(MEM_MAX[0], BIG_H, -64):
        w = h * 4 // 3
        ok, _ = spatial_supported(four.plan_for(h, w), CARDS, detect=True,
                                  describe=True)
        if ok:
            sizes.append((h, w))
            break
    tex = big_pairs()[False][0]
    out = {}

    def peaks(fn):
        sync_all(torch, cards)
        torch.cuda.empty_cache()
        base = [torch.cuda.memory_allocated(c) for c in cards]
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        fn()
        sync_all(torch, cards)
        return [(torch.cuda.max_memory_allocated(c) - b) / 2**20
                for c, b in zip(cards, base)]

    for h, w in sizes:
        img = torch.as_tensor(np.tile(tex, (2, 2))[:h, :w].copy()
                              if h > BIG_H else tex, device=cards[0])
        with programs.eager(), no_plain_versions():
            single.detect_and_compute(img)
            four.detect_and_compute(img)
            m1 = peaks(lambda: single.detect_and_compute(img))
            m4 = peaks(lambda: four.detect_and_compute(img))
        programs.clear()
        with no_plain_versions():
            four.detect_and_compute(img)
            pool = [b / 2**20 for b in cards_pool(torch, cards)]
            replay = peaks(lambda: four.detect_and_compute(img))
        captured = [p + r for p, r in zip(pool, replay)]
        out[f"{h}x{w}"] = dict(unsharded_mib=m1[0], sharded_mib=m4,
                               captured_pool_mib=pool,
                               captured_replay_mib=replay,
                               captured_mib=captured)
        print(f"[cards memory] {h}x{w}: peak above the resident set, "
              f"unsharded on {cards[0]} {m1[0]:.1f} MiB (eager); row-sharded "
              f"over {CARDS} cards, eager {', '.join(f'{x:.1f}' for x in m4)}"
              f" MiB (cards 0-3; card 0 also holds the gathered features); "
              f"captured: pool {', '.join(f'{x:.1f}' for x in pool)} + a "
              f"replay's {', '.join(f'{x:.1f}' for x in replay)} = "
              f"{', '.join(f'{x:.1f}' for x in captured)} MiB; cards: {card}")
    return out


def cards_pool(torch, cards) -> list:
    """Bytes the captured keys over ``cards`` added to each card's
    pool."""
    from akaze_tpu_torch import programs
    want = [str(c) for c in cards]
    rows = [r for r in programs.stats() if r["cards"] == want]
    check(len(rows) == 1 and not rows[0]["eager"],
          f"[cards memory] keys over {want}: {rows}")
    return rows[0]["card_pool_bytes"]


# the four NCCL processes: each runs ``nccl_worker`` on its own card

NCCL_PATHS = ("spatial", "match", "dp", "pgo", "ba observations",
              "ba landmarks")


def nccl_paths(torch, a, dm, hc, rank):
    """{path: call} of the four-process phase, with this rank's inputs on
    its card: the spatial program on the 960x1280 image over ``dm``,
    ``sharded_match`` at 10000 x 10000, this rank's share of the dp step's
    8 pairs (``dp_pipeline_step_multihost``), and the SLAM cell's solvers
    (``solver_calls``).  With ``rank`` None: the one-process mesh's calls
    of the same shape (the whole dp batch)."""
    from akaze_tpu_torch import Akaze, AkazeConfig
    from akaze_tpu_torch.parallel import (dp_pipeline_step,
                                          dp_pipeline_step_multihost,
                                          process_local_batch, sharded_match)
    home = dm.home
    det = Akaze(AkazeConfig(max_pts=MAX_PTS), mesh=dm)
    x = torch.as_tensor(a, device=home)
    w1, w2, v1, v2, x2, y2 = k4_stress_inputs(torch, home)
    at, bt = dp_inputs(torch, home)
    plan = det.plan_for(H, W)
    if rank is None:
        def dp():
            return dp_pipeline_step(at, bt, plan, dm)
    else:
        n = process_local_batch(DP_PAIRS)
        la, lb = at[rank * n:(rank + 1) * n], bt[rank * n:(rank + 1) * n]

        def dp():
            return dp_pipeline_step_multihost(la, lb, plan, dm)
    calls = {"spatial": lambda: det.detect_and_compute(x),
             "match": lambda: sharded_match(w1, v1, w2, v2, x2, y2, dm, 96),
             "dp": dp}
    calls.update(solver_calls(torch, home, dm, hc))
    return calls


def rank_turns(torch, fn, rank: int, reps: int = 5) -> dict:
    """``fn`` eager and captured in turns (medians between CUDA events)
    and, per form, the card's busy time (the union of its device events),
    its compute time (the same without NCCL's kernels), NCCL's summed
    kernel time, and the idle share 1 - compute / wall: NCCL's kernels run
    on a stream of their own and spin there until the other ranks arrive,
    so their time counts the ranks' skew (a profiled call of one rank can
    wait on another rank's previous call), not work of this card."""
    from akaze_tpu_torch import programs
    eager, captured = in_turns(torch, fn, reps)
    out = dict(eager_ms=float(np.median(eager)),
               captured_ms=float(np.median(captured)))
    for kind in ("eager", "captured"):
        with programs.eager() if kind == "eager" else \
                contextlib.nullcontext():
            p = profile_cards(torch, fn, 1, [rank]).get(rank, {})
        out.update({f"{kind}_{k}_ms": p.get(k, 0.0)
                    for k in ("busy", "compute", "nccl")})
        out[f"{kind}_idle"] = 1.0 - out[f"{kind}_compute_ms"] / out[
            f"{kind}_ms"]
    return out


def nccl_worker(torch, rank: int, port: int, outdir: str) -> int:
    """One of four processes, on card ``rank`` (``local_device_ids=
    [rank]``), joined on NCCL: each path of ``nccl_paths`` eagerly
    (``programs.eager()``), then as its program (captured: one graph per
    rank holding the NCCL calls) and replayed, every replay equal to the
    eager call bit for bit, no host sync in a replay, no new key on a
    repeat; eager and captured times in turns and each one's idle share.
    Writes the outputs and a JSON of the numbers to ``outdir``."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch import parallel as P
    check(P.initialize_distributed(f"tcp://localhost:{port}", CARDS, rank,
                                   local_device_ids=[rank]),
          "initialize_distributed did not join the group")
    check(torch.cuda.current_device() == rank,
          f"rank {rank}: card {torch.cuda.current_device()} is current")
    dm, hc = P.make_mesh(CARDS), P.make_host_chip_mesh(CARDS, 1)
    check(dm.local_devices == [torch.device("cuda", rank)]
          and dm.spans_processes("data") and hc.spans_processes("host"),
          f"rank {rank}: meshes {dm}, {hc}")
    (a, _), _, _, _ = load_pair(None)
    calls = nccl_paths(torch, a, dm, hc, rank)
    outs, info = {}, {"rank": rank, "card": str(dm.home)}
    for name in NCCL_PATHS:
        fn = calls[name]
        tag = f"nccl {name} rank {rank}"
        with programs.eager(), no_plain_versions():
            want = pytree_leaves(fn())
        with no_plain_versions():
            first = pytree_leaves(fn())
            torch.cuda.synchronize()
            captures = sum(p.captures for p in programs.programs())
            replays = [pytree_leaves(fn()) for _ in range(2)]
            torch.cuda.synchronize()
        check(sum(p.captures for p in programs.programs()) == captures,
              f"[{tag}] a repeated call captured a new key")
        for got in [first] + replays:
            equal_outputs(torch, got, want, tag)
        if name != "match":         # sharded_match is no program
            no_sync(torch, fn, tag)
        outs.update({f"{name}.{i}": t.cpu().numpy()
                     for i, t in enumerate(want)})
        with no_plain_versions():
            info[name] = rank_turns(torch, fn, rank)
    info["keys"] = [dict(program=s["program"].rsplit(".", 1)[1],
                         key=s["key"][:160], eager=s["eager"],
                         nccl=s["nccl"], capture_s=s["capture_s"],
                         pool_mib=s["pool_bytes"] / 2**20)
                    for s in programs.stats() if "Mesh(" in s["key"]]
    torch.cuda.synchronize()
    np.savez(os.path.join(outdir, f"out.{rank}.npz"), **outs)
    with open(os.path.join(outdir, f"info.{rank}.json"), "w") as f:
        json.dump(info, f)
    leave_together(outdir, rank, CARDS, "nccl")


def phase_nccl(torch, cards, card, a):
    """Four processes of one card each on NCCL (``nccl_worker``): every
    path's outputs equal on every rank to the one-process mesh of the same
    shape (four shards on cuda:0) bit for bit: replicated outputs equal on
    all ranks, per-shard outputs each rank's shard; every mesh key of a
    collective across processes captured with its NCCL calls.  A worker's
    failure fails the run with its exit code and the tail of its
    output."""
    from akaze_tpu_torch.parallel import make_host_chip_mesh
    one = one_card_mesh(cards)
    hc1 = make_host_chip_mesh(CARDS, 1, devices=[cards[0]] * CARDS)
    refs = {name: fn() for name, fn in nccl_paths(torch, a, one, hc1,
                                                  None).items()}
    torch.cuda.synchronize()
    wall, got, info = run_ranks("--worker", CARDS, "nccl")
    hold_ranks(refs, NCCL_PATHS, got, 1, "nccl")
    for r, inf in enumerate(info):
        keys = inf["keys"]
        crossing = [k for k in keys if k["nccl"]]
        check(crossing and all(not k["eager"] for k in keys),
              f"[nccl] rank {r}: mesh keys {keys}")
        for name in NCCL_PATHS:
            x = inf[name]
            # sharded_match is no program: both forms are its eager call
            print(f"[nccl {name}] rank {r} on {inf['card']}: eager "
                  f"{x['eager_ms']:.3f} ms, "
                  f"{'again' if name == 'match' else 'captured'} "
                  f"{x['captured_ms']:.3f} ms (in turns); device busy eager "
                  f"{x['eager_busy_ms']:.3f}"
                  f" / captured {x['captured_busy_ms']:.3f} ms (compute "
                  f"{x['eager_compute_ms']:.3f} / "
                  f"{x['captured_compute_ms']:.3f}, NCCL kernels "
                  f"{x['eager_nccl_ms']:.3f} / {x['captured_nccl_ms']:.3f}); "
                  f"idle share (no compute kernel) eager "
                  f"{x['eager_idle']:.3f}, captured {x['captured_idle']:.3f}")
        print(f"[nccl keys] rank {r}: " + "; ".join(
            f"{k['program']} nccl={k['nccl']} capture {k['capture_s']:.2f} "
            f"s, pool +{k['pool_mib']:.1f} MiB" for k in keys))
    print(f"[nccl] four processes of one card each on NCCL, in {wall:.1f} "
          f"s: every path ({', '.join(NCCL_PATHS)}) equal bit for bit on "
          f"every rank to the one-process mesh of the same shape; every "
          f"key across processes captured with its NCCL calls, replays = "
          f"eager, no host sync, no new key on a repeat; cards: {card}")
    return info


def run_ranks(flag: str, world: int, tag: str):
    """Run this script with ``flag RANK PORT DIR`` as ``world`` processes
    joined on a free port, stop them all at the first failure (a rank that
    fails leaves the others waiting in a collective) or at
    ``NCCL_TIMEOUT_S``, and fail with each failed rank's exit code and the
    tail of its output.  Returns (seconds, each rank's outputs, each
    rank's info)."""
    import socket
    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as outdir:
        logs = [open(os.path.join(outdir, f"log.{r}"), "w+")
                for r in range(world)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), flag,
             str(r), str(port), outdir], stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.perf_counter() - t0 < NCCL_TIMEOUT_S):
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tails = []
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            tails.append(f.read()[-4000:])
            f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                print(f"[{tag}] rank {r} exit {p.returncode}; its output "
                      f"ends:\n{tails[r]}", flush=True)
        check(all(p.returncode == 0 for p in procs),
              f"[{tag}] worker exit codes {[p.returncode for p in procs]}")
        wall = time.perf_counter() - t0
        got = [np.load(os.path.join(outdir, f"out.{r}.npz"))
               for r in range(world)]
        info = []
        for r in range(world):
            with open(os.path.join(outdir, f"info.{r}.json")) as f:
                info.append(json.load(f))
    return wall, got, info


def hold_ranks(refs, paths, got, per: int, tag: str):
    """Fail unless every rank's outputs of every path (``got``: each
    rank's saved leaves, ``path.i``) equal the one-process mesh's
    (``refs``) bit for bit: replicated outputs whole, per-shard outputs
    the rank's ``per`` shards."""
    for name in paths:
        for r, g in enumerate(got):
            leaves = [x.cpu().numpy()
                      for x in pytree_leaves(rank_view(refs[name], r, per))]
            keys = sorted((k for k in g.files
                           if k.rsplit(".", 1)[0] == name),
                          key=lambda k: int(k.rsplit(".", 1)[1]))
            check(len(keys) == len(leaves), f"[{tag} {name}] rank {r}: "
                  f"{len(keys)} outputs, the one-process mesh "
                  f"{len(leaves)}")
            for k, w in zip(keys, leaves):
                check(g[k].dtype == w.dtype and np.array_equal(g[k], w),
                      f"[{tag} {name}] rank {r} output {k} differs from "
                      f"the one-process mesh's")


def rank_view(out, r, per: int = 1):
    """Rank ``r``'s part of a one-process mesh output: per-shard lists
    (one entry per shard) give the rank's shard (``per`` 1) or its
    ``per`` shards; everything else (features, poses, costs: one tensor
    on the mesh's first device) is replicated."""
    if isinstance(out, list):
        return out[r] if per == 1 else out[r * per:(r + 1) * per]
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(rank_view(x, r, per) for x in out)
    return out


# two processes of two cards each (JAX's (host, chip) runtime shape): each
# runs ``procs_worker`` on its own two cards

PROCS = 2               # processes of the (host, chip) phase
PROC_CARDS = 2          # cards per process
PROCS_PATHS = NCCL_PATHS + ("collectives",)
PROCS_PROGRAMS = {"_jit_spatial_detect_and_compute", "_dp_step",
                  "_run_sharded_pgo", "_run_sharded_ba",
                  "_run_landmark_sharded_ba", "_runtime_collectives"}


def _runtime_collectives(xs, mesh):
    """JAX's runtime collectives on a (host, chip) mesh
    (``akaze_tpu/parallel/distributed.py``): ``hier_psum`` over ("chip",
    "host"), ``psum`` and a tiled ``all_gather`` over ``"host"`` alone."""
    from akaze_tpu_torch.parallel import collectives as col
    from akaze_tpu_torch.parallel import hier_psum
    return (hier_psum(xs, mesh), col.psum(xs, mesh, "host"),
            col.all_gather(xs, mesh, "host"))


@functools.cache
def runtime_program():
    """``_runtime_collectives`` as one program (the mesh static, its
    collectives over ("chip", "host")), so that it is captured."""
    from akaze_tpu_torch import programs
    return programs.jit(_runtime_collectives, static_argnames=("mesh",),
                        collective_axes=lambda statics: ("chip", "host"))


def procs_paths(torch, a, dm, hc, rank):
    """``nccl_paths`` on ``dm`` and ``hc`` (the dp step: this rank's 4 of
    the 8 pairs), and the runtime collectives (``runtime_program``) on
    seeded real-valued [384, 33] rows sharded over ("chip", "host") of
    ``hc``."""
    from akaze_tpu_torch.parallel import collectives as col
    calls = nccl_paths(torch, a, dm, hc, rank)
    rng = np.random.default_rng(SEED + 7)
    g = torch.as_tensor(rng.standard_normal((4 * 96, 33)).astype(np.float32),
                        device=hc.home)
    xs = col.shard(g, hc, ("chip", "host"))
    calls["collectives"] = lambda: runtime_program()(xs, hc)
    return calls


def procs_turns(torch, cards, fn, reps: int = 3):
    """``cards_turns`` of ``fn`` over a rank's cards: (walls in turns with
    each card's busy, compute (no NCCL kernel) and NCCL ms per form and
    its idle share 1 - compute / wall, as NCCL's kernels spin until the
    other rank arrives; the captured form's profile)."""
    r = cards_turns(torch, cards, fn, reps)
    out = dict(eager_ms=r["eager_ms"], captured_ms=r["captured_ms"])
    for kind in ("eager", "captured"):
        wall = float(np.median(r[f"{kind}_ms"]))
        prof = r[f"{kind}_prof"]
        for k in ("busy", "compute", "nccl"):
            out[f"{kind}_{k}_ms"] = [prof.get(c.index, {}).get(k, 0.0)
                                     for c in cards]
        out[f"{kind}_idle"] = [1.0 - x / wall
                               for x in out[f"{kind}_compute_ms"]]
    return out, r["captured_prof"]


def procs_worker(torch, rank: int, port: int, outdir: str) -> int:
    """One of two processes, on cards 2 * rank and 2 * rank + 1
    (``local_device_ids``), joined on NCCL, over ``make_mesh(4)`` and
    ``make_host_chip_mesh(2, 2)``: the spatial pair with the launch
    counters set to 0 before and read after (K1/K2 launches per card as
    ``spatial_route`` predicts, eager and captured), K1 and K2 against
    their plain versions on each card's launches of the eager pair, and K1,
    K2 and K4 on the eager dp step's and ``sharded_match``'s; then each
    path of ``procs_paths`` eagerly and as its program (one graph over the
    two cards per key, holding the NCCL calls of both cards'
    communicators), its first call and replays equal to the eager call bit
    for bit, no host sync in a replay, no new key on a repeat
    (``hold_cards``); every mesh key captured over the two cards, with
    ``nccl=True`` where its collectives cross the processes; eager and
    captured in turns with each card's idle share, and each card's kernel
    times from replays of the pair.  Writes the outputs and a JSON of the
    numbers to ``outdir``."""
    from akaze_tpu_torch import Akaze, AkazeConfig, programs, scale_space
    from akaze_tpu_torch import parallel as P
    from akaze_tpu_torch.ops import describe as k2mod
    from akaze_tpu_torch.ops import hamming as k4mod
    from akaze_tpu_torch.parallel import spatial, spatial_launches
    owned = [PROC_CARDS * rank + j for j in range(PROC_CARDS)]
    cards = [torch.device("cuda", i) for i in owned]
    check(P.initialize_distributed(f"tcp://localhost:{port}", PROCS, rank,
                                   local_device_ids=owned),
          "initialize_distributed did not join the group")
    check(torch.cuda.current_device() == owned[0],
          f"rank {rank}: card {torch.cuda.current_device()} is current")
    dm, hc = P.make_mesh(CARDS), P.make_host_chip_mesh(PROCS, PROC_CARDS)
    check(dm.local_devices == cards and hc.local_devices == cards
          and dm.spans_processes("data") and hc.spans_processes("host"),
          f"rank {rank}: meshes {dm}, {hc}")
    (a, b), _, _, _ = load_pair(None)
    calls = procs_paths(torch, a, dm, hc, rank)
    det = Akaze(AkazeConfig(max_pts=MAX_PTS), mesh=dm)
    x, y = (torch.as_tensor(v, device=cards[0]) for v in (a, b))
    per = spatial_launches(det.plan_for(H, W), CARDS)
    each = {"tiled": 2 * per["tiled"], "resident": 2 * per["resident"],
            "extrema": 0, "describe": 2, "hamming": 0, "pgo": 0}
    info = {"rank": rank, "cards": [str(c) for c in cards]}

    def pair():
        return det.detect_and_compute_pair(x, y)

    # the spatial pair: the counters set to 0 just before, read just after
    tag = f"procs spatial pair rank {rank}"
    for fn in counters().values():
        fn.launches = 0
    with programs.eager(), no_plain_versions(), \
            launches_by_card() as by_card, \
            recording(spatial, "sublevel") as tiled, \
            recording(spatial, "octave") as resident, \
            recording(k2mod, "_launch") as k2calls:
        pair()
        sync_all(torch, cards)
    expect_by_card(cards, by_card, each, tag)
    total = launch_counts()
    check(total == {k: PROC_CARDS * v for k, v in each.items()},
          f"[{tag}] eager launches {total}")
    checks = per_card_checks(torch, cards, tiled, resident, k2calls, None,
                             False, tag)
    for fn in counters().values():
        fn.launches = 0
    with no_plain_versions():
        pair()
        sync_all(torch, cards)
    check(launch_counts() == total,
          f"[{tag}] captured launches {launch_counts()}, eager {total}")
    hold_cards(torch, cards, pair, tag)
    pt, prof = procs_turns(torch, cards, pair)
    info["pair"] = dict(turns=pt, launches=[by_card[str(c)] for c in cards],
                        checks=checks, kernel_ms=[{
                            k: card_ms(prof, c, (n,)) for k, n in (
                                ("tiled", "tiled_kernel<float>"),
                                ("resident", "octave_kernel<float>"),
                                ("describe", "describe_kernel"))}
                            for c in cards])
    # the dp step's and sharded_match's kernels, per card
    tag = f"procs dp rank {rank}"
    with programs.eager(), no_plain_versions(), \
            launches_by_card() as dp_cards, \
            recording(scale_space, "octave") as octaves, \
            recording(k2mod, "_launch") as dk2, \
            recording(k4mod, "_launch_match") as dk4:
        calls["dp"]()
        sync_all(torch, cards)
    pairs = DP_PAIRS // CARDS
    expect_by_card(cards, dp_cards, {k: pairs * v for k, v in
                                     MAIN_LAUNCHES.items()}, tag)
    info["dp_checks"] = per_card_checks(torch, cards, [], octaves, dk2, dk4,
                                        False, tag)
    tag = f"procs match rank {rank}"
    with no_plain_versions(), launches_by_card() as m_cards, \
            recording(k4mod, "_launch_match") as mk4:
        calls["match"]()
        sync_all(torch, cards)
    expect_by_card(cards, m_cards, {"tiled": 0, "resident": 0,
                                    "extrema": 0, "describe": 0,
                                    "hamming": 1, "pgo": 0}, tag)
    info["match_checks"] = per_card_checks(torch, cards, [], [], None, mk4,
                                           False, tag)
    outs = {}
    for name in PROCS_PATHS:
        fn = calls[name]
        tag = f"procs {name} rank {rank}"
        if name == "match":             # sharded_match is no program
            with no_plain_versions():
                want = fn()
                equal_outputs(torch, fn(), want, tag)
        else:
            want = hold_cards(torch, cards, fn, tag)
        outs.update({f"{name}.{i}": t.cpu().numpy()
                     for i, t in enumerate(pytree_leaves(want))})
        info[name] = procs_turns(torch, cards, fn)[0]
    keys = [r for r in programs.stats() if "Mesh(" in r["key"]]
    names = {r["program"].rsplit(".", 1)[1] for r in keys}
    check(names == PROCS_PROGRAMS, f"rank {rank}: mesh programs {names}")
    for r in keys:
        name = r["program"].rsplit(".", 1)[1]
        check(not r["eager"] and r["cards"] == info["cards"]
              and r["nccl"] == (name != "_dp_step"),
              f"rank {rank}: mesh key {r}")
    info["keys"] = [dict(program=r["program"].rsplit(".", 1)[1],
                         key=r["key"][:160], eager=r["eager"],
                         nccl=r["nccl"], cards=r["cards"],
                         capture_s=r["capture_s"],
                         pool_mib=[b / 2**20 for b in r["card_pool_bytes"]])
                    for r in keys]
    sync_all(torch, cards)
    np.savez(os.path.join(outdir, f"out.{rank}.npz"), **outs)
    with open(os.path.join(outdir, f"info.{rank}.json"), "w") as f:
        json.dump(info, f)
    leave_together(outdir, rank, PROCS, "procs")


def leave_together(outdir: str, rank: int, world: int, tag: str):
    """Exit once every rank has written its results, with no collective
    at teardown (a barrier or destroy_process_group there can wait
    forever on communicators that captured graphs hold)."""
    open(os.path.join(outdir, f"done.{rank}"), "w").close()
    t0 = time.monotonic()
    while not all(os.path.exists(os.path.join(outdir, f"done.{r}"))
                  for r in range(world)):
        check(time.monotonic() - t0 < 120, f"rank {rank}: the other ranks "
              f"did not finish")
        time.sleep(0.05)
    print(f"[{tag} rank {rank}] done", flush=True)
    sys.stdout.flush()
    os._exit(0)


def phase_procs(torch, cards, card, a, nccl_info):
    """Two processes of two cards each on NCCL (``procs_worker``), JAX's
    (host, chip) runtime shape: every path of ``procs_paths`` equal on
    both ranks bit for bit to the one-process mesh of the same shape over
    cuda:0..3 (called eagerly here: replicated outputs equal on both
    ranks, per-shard outputs each rank's two shards); each rank's keys
    captured over its two cards with their NCCL calls; eager and captured
    walls per rank in turns with each card's idle share, printed beside
    this process's one-process-over-four-cards captured wall and the four
    NCCL ranks' captured walls (``nccl_info``).  Returns the workers'
    infos."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.parallel import make_host_chip_mesh, make_mesh
    dm = make_mesh(CARDS, devices=cards)
    hc = make_host_chip_mesh(PROCS, PROC_CARDS, devices=cards)
    calls = procs_paths(torch, a, dm, hc, None)
    with programs.eager(), no_plain_versions():
        refs = {name: fn() for name, fn in calls.items()}
    sync_all(torch, cards)
    one = {}
    with no_plain_versions():
        for name, fn in calls.items():
            one[name] = wall_times(torch, fn, cards, reps=3)
    wall, got, info = run_ranks("--procs-worker", PROCS, "procs")
    hold_ranks(refs, PROCS_PATHS, got, PROC_CARDS, "procs")
    for r, inf in enumerate(info):
        for name in PROCS_PATHS:
            x = inf[name]
            four = [i[name]["captured_ms"] for i in nccl_info
                    if name in i]
            print(f"[procs {name}] rank {r} on {', '.join(inf['cards'])}: "
                  f"eager {spread(x['eager_ms'])}, "
                  f"{'again' if name == 'match' else 'captured'} "
                  f"{spread(x['captured_ms'])} ms (in turns); idle per card "
                  f"(no compute kernel) eager "
                  f"{', '.join(f'{v:.3f}' for v in x['eager_idle'])}, "
                  f"captured "
                  f"{', '.join(f'{v:.3f}' for v in x['captured_idle'])}; "
                  f"NCCL kernels captured "
                  f"{', '.join(f'{v:.3f}' for v in x['captured_nccl_ms'])} "
                  f"ms; beside: one process over {CARDS} cards captured "
                  f"{spread(one[name])}"
                  + (f", four NCCL ranks captured "
                     f"{min(four):.3f}-{max(four):.3f} ms" if four else ""))
        print(f"[procs keys] rank {r}: " + "; ".join(
            f"{k['program']} nccl={k['nccl']} cards {', '.join(k['cards'])}"
            f" capture {k['capture_s']:.2f} s, pool + "
            f"{', '.join(f'{m:.1f}' for m in k['pool_mib'])} MiB"
            for k in inf["keys"]))
    print(f"[procs] two processes of two cards each on NCCL "
          f"(local_device_ids [0, 1] and [2, 3]), in {wall:.1f} s: every "
          f"path ({', '.join(PROCS_PATHS)}) equal bit for bit on both ranks "
          f"to the one-process mesh of the same shape over "
          f"{', '.join(map(str, cards))}; every mesh key captured as one "
          f"graph over the rank's two cards with the NCCL calls of both "
          f"cards' communicators, replays = eager, no host sync, no new key "
          f"on a repeat; K1, K2 and K4 = plain on every card; cards: {card}")
    return info


def procs_rows(info, k1_rep, k2_rep):
    """The kernels line's two-process rows (``*_procs2x2``): per card (the
    mean over the four cards, each card's numbers beside it) device ms per
    pair of the spatial path from replays, launches per card of the eager
    pair, errors, plain times and bounds from each card's own launches."""
    srcs = {"tiled": ("akaze_tpu_torch/csrc/sublevel.cu", k1_rep),
            "resident": ("akaze_tpu_torch/csrc/sublevel.cu", k1_rep),
            "describe": ("akaze_tpu_torch/csrc/describe.cu", k2_rep)}
    pairs = [i["pair"] for i in info]
    per = [(p["launches"][j], p["checks"][j], p["kernel_ms"][j],
            p["turns"]["captured_idle"][j])
           for p in pairs for j in range(PROC_CARDS)]
    rows = []
    for kind, name in (("tiled", "tiled_kernel"),
                       ("resident", "octave_kernel"),
                       ("describe", "describe_kernel")):
        if not per[0][0][kind]:
            continue
        if kind == "describe":
            errs = [c["k2"]["max_abs_err"] for _, c, _, _ in per]
            plains = [c["k2"]["plain_ms"] for _, c, _, _ in per]
            bounds = [bound(c["k2"]["bytes"], 0) for _, c, _, _ in per]
        else:
            pre = "res_" if kind == "resident" else ""
            errs = [c["k1"][pre + "abs_err" if pre else "max_abs_err"]
                    for _, c, _, _ in per]
            plains = [c["k1"][pre + "plain_ms"] for _, c, _, _ in per]
            bounds = [bound(c["k1"][pre + "bytes"], c["k1"][pre + "ops"])
                      for _, c, _, _ in per]
        ms = [k[kind] for _, _, k, _ in per]
        src, rep = srcs[kind]
        rows.append(dict(
            name=name + "_procs2x2", route="cuda", source=src, replaces=rep,
            launches=per[0][0][kind],
            launches_per_card=[n[kind] for n, _, _, _ in per],
            max_abs_err=max(errs), ms=float(np.mean(ms)), ms_per_card=ms,
            plain_ms=float(np.mean(plains)),
            bound_ms=float(np.mean([b[0] for b in bounds])),
            bound_by=bounds[0][1], library_ms=None,
            idle_per_card=[i for _, _, _, i in per]))
    return rows


def cards_rows(sp, match, dp, k1_rep, k1_b1_rep, k2_rep, k4_rep):
    """The kernels line's four-card rows: per card (the mean over the four
    cards, each card's numbers beside it) device ms per pair of the
    spatial main path (``*_cards4``), per 10000 x 10000 call
    (``hamming_kernel_cards4_sharded_match``) and per dp step of 8 pairs
    (``*_cards4_dp``); launches per card; bounds and plain times from each
    card's own launches."""
    srcs = {"k1": "akaze_tpu_torch/csrc/sublevel.cu",
            "k2": "akaze_tpu_torch/csrc/describe.cu",
            "k4": "akaze_tpu_torch/csrc/hamming.cu"}
    rows = []

    def row(name, src, rep, launches, errs, ms, plains, bounds,
            library=None, idle=None):
        b = [x[0] for x in bounds]
        rows.append(dict(
            name=name, source=srcs[src], replaces=rep,
            launches=launches, launches_per_card=launches,
            max_abs_err=max(errs), ms=float(np.mean(ms)),
            ms_per_card=ms, plain_ms=float(np.mean(plains)),
            bound_ms=float(np.mean(b)), bound_by=bounds[0][1],
            library_ms=(None if library is None
                        else float(np.mean(library))),
            idle_per_card=idle))

    for sfx, r, rep1 in (("_cards4", sp, k1_b1_rep), ("_cards4_dp", dp,
                                                      k1_rep)):
        cards = sorted(r["prof"])
        ch = r["checks"]
        n0 = r["launches"]["cuda:1"]     # a card besides the mesh's first
        for kind, key, pre, needle in (
                ("tiled_kernel", "tiled", "", "tiled_kernel<float>"),
                ("octave_kernel", "resident", "res_",
                 "octave_kernel<float>")):
            if not n0[key]:
                continue
            row(kind + sfx, "k1", rep1, n0[key],
                [c["k1"][pre + "abs_err" if pre else "max_abs_err"]
                 for c in ch],
                [card_ms(r["prof"], c, (needle,)) for c in cards],
                [c["k1"][pre + "plain_ms"] for c in ch],
                [bound(c["k1"][pre + "bytes"], c["k1"][pre + "ops"])
                 for c in ch], idle=r["idle"])
        row("describe_kernel" + sfx, "k2", k2_rep, n0["describe"],
            [c["k2"]["max_abs_err"] for c in ch],
            [card_ms(r["prof"], c, ("describe_kernel",)) for c in cards],
            [c["k2"]["plain_ms"] for c in ch],
            [bound(c["k2"]["bytes"], 0) for c in ch], idle=r["idle"])
        if n0["hamming"]:
            row("hamming_kernel" + sfx, "k4", k4_rep, n0["hamming"],
                [c["k4"]["max_abs_err"] for c in ch],
                [card_ms(r["prof"], c, ("hamming_kernel",))
                 for c in cards],
                [c["k4"]["plain_ms"] for c in ch],
                [(c["k4"]["bound_ms"], c["k4"]["bound_by"]) for c in ch],
                library=[c["k4"]["library_ms"] for c in ch],
                idle=r["idle"])
    ch = match["checks"]
    row("hamming_kernel_cards4_sharded_match", "k4", k4_rep, 1,
        [c["k4"]["max_abs_err"] for c in ch], match["ms"],
        [c["k4"]["plain_ms"] for c in ch],
        [(c["k4"]["bound_ms"], c["k4"]["bound_by"]) for c in ch],
        library=[c["k4"]["library_ms"] for c in ch], idle=match["idle"])
    return rows


def main_four(torch, args) -> int:
    """``--cards 4``: the multi-device tier on four cards, in three forms:
    one process over cuda:0..3 (every mesh path, eager and as one graph
    over the four cards per key, held bit for bit against the same mesh
    with its four shards on cuda:0), four processes of one card each on
    NCCL and two processes of two cards each on NCCL (every path equal to
    the one-process mesh, its keys captured); the memory a mesh saves per
    card.  Fails, and never skips, with fewer than four cards."""
    n = torch.cuda.device_count()
    check(n >= CARDS, f"--cards {CARDS} needs {CARDS} visible cards, "
          f"{n} visible")
    cards = [torch.device("cuda", i) for i in range(CARDS)]
    torch.cuda.set_device(cards[0])
    card = phase_device(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    names = smi.stdout.strip().splitlines()
    print(f"[cards] {len(names)} cards: " + " | ".join(names))
    card = " | ".join(names[:CARDS]) if len(set(names)) > 1 else (
        f"{CARDS} x {card}")
    link = phase_link(torch, cards)
    phase_build()
    (a, b), (a8, b8), desc, shift = load_pair(args.stock_dir)
    print(f"[pair] {desc}")
    t0 = time.perf_counter()
    flavours = mesh_flavours()
    sp = phase_cards_spatial(torch, cards, card, {False: (a, b),
                                                  True: (a8, b8)},
                             flavours, (H, W), shift,
                             profile_flavour="float")
    phase_cards_spatial(torch, cards, card, big_pairs(),
                        {"float": flavours["float"]}, (BIG_H, BIG_W), SHIFT)
    match = phase_cards_match(torch, cards, card)
    dp = phase_cards_dp(torch, cards, card)
    phase_cards_solvers(torch, cards, card)
    t1 = time.perf_counter()
    frames, _ = slam_route()
    print(f"[cards slam] route of {len(frames)} frames rendered in "
          f"{time.perf_counter() - t1:.1f} s")
    phase_cards_slam(torch, cards, card, frames)
    phase_cards_cli(torch, cards, card, (a8, b8))
    phase_cards_dryrun(torch, cards)
    phase_cards_programs(torch, cards, card)
    memory = phase_cards_memory(torch, cards, card)
    print(f"[cards] one process over {CARDS} cards: every path passed in "
          f"{time.perf_counter() - t0:.1f} s; no kernel's plain version ran "
          f"on a card inside one")
    t0 = time.perf_counter()
    nccl = phase_nccl(torch, cards, card, a)
    print(f"[nccl] passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    procs = phase_procs(torch, cards, card, a, nccl)
    print(f"[procs] passed in {time.perf_counter() - t0:.1f} s")
    k2_rep = ("akaze_tpu/ops/pallas_describe.py:1107, "
              "akaze_tpu/ops/pallas_describe.py:579")
    rows = cards_rows(sp["float"], match, dp,
                      "akaze_tpu/ops/pallas_sublevel.py:423",
                      "akaze_tpu/ops/pallas_sublevel.py:346", k2_rep,
                      "akaze_tpu/ops/pallas_match.py:103")
    rows += procs_rows(procs, "akaze_tpu/ops/pallas_sublevel.py:346",
                       k2_rep)
    kernels = [dict(row, route="cuda") for row in rows]
    for r in kernels:
        print(f"[kernels] {r['name']}: {r['launches']} launches per card, "
              f"device {r['ms']:.4f} ms per card (cards "
              f"{', '.join(f'{x:.4f}' for x in r['ms_per_card'])}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.3f} ms, max abs err {r['max_abs_err']:.3g}")
    print(f"[cards] link {json.dumps(link)}; memory {json.dumps(memory)}")
    print(f"[kernels] cards: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    ap.add_argument("--cards", type=int, default=1, choices=(1, CARDS),
                    help=f"{CARDS}: only the four-card phases (one process "
                    f"over four cards, four NCCL processes, two NCCL "
                    f"processes of two cards each); fails with fewer than "
                    f"{CARDS} cards")
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--procs-worker", nargs=3,
                    metavar=("RANK", "PORT", "DIR"), help=argparse.SUPPRESS)
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
    if args.worker:
        rank, port, outdir = args.worker
        return nccl_worker(torch, int(rank), int(port), outdir)
    if args.procs_worker:
        rank, port, outdir = args.procs_worker
        return procs_worker(torch, int(rank), int(port), outdir)
    if args.cards == CARDS:
        return main_four(torch, args)
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
    kd = phase_detect(torch, images, plan)
    k2 = phase_k2(torch, images, plan)
    k4 = phase_k4(torch, dev)
    launches, k4_main, fa_main, _, m_main = phase_main(torch, det, a, b,
                                                       shift)
    phase_program_profiler(torch, det, a, b)
    phase_no_sync(torch, det, a, b)
    k1_b1 = phase_describe_false(torch, det, a, fa_main)
    phase_small_reference(torch, dev)
    prof = phase_profile(torch, det, a, b)
    pair_ms = phase_timing(torch, det, a, b)
    print(f"[time] card: {card}; pair iteration {pair_ms:.3f} ms")
    prog = {"float": phase_program_pair(torch, det, a, b, "program float")}
    phase_program_single(torch, det, a, "program single 960x1280")

    # the float path on f32 planes (bf16_sampling=False)
    f32 = Akaze(AkazeConfig(max_pts=MAX_PTS, bf16_sampling=False),
                device=dev)
    k2_f32 = phase_k2(torch, images, f32.plan_for(H, W), tag="K2 f32")
    launches_f32, *_ = phase_main(torch, f32, a, b, shift,
                                  tag="main float f32")
    phase_no_sync(torch, f32, a, b, tag="no sync float f32")
    prof_f32 = phase_profile(torch, f32, a, b, tag="profile float f32")
    prog["float f32"] = phase_program_pair(torch, f32, a, b,
                                           "program float f32")

    # the 16.16 fixed-point path, both descriptor flavours
    exact = Akaze(AkazeConfig(max_pts=MAX_PTS, fixed_exact_sampling=True),
                  fixed=True, device=dev)
    approx = Akaze(AkazeConfig(max_pts=MAX_PTS), fixed=True, device=dev)
    plan_fx = exact.plan_for(H, W)
    images_fx = torch.stack([torch.as_tensor(x, device=dev).int()
                             for x in (a8, b8)])
    k1_fx = phase_k1(torch, images_fx, plan_fx, tag="K1 fixed")
    kd_fx = phase_detect(torch, images_fx, plan_fx, tag="detect fixed")
    k2_fx = phase_k2(torch, images_fx, plan_fx, fixed=True, tag="K2 fixed")
    launches_fx, *_ = phase_main(torch, exact, a8, b8, shift,
                                 tag="main fixed exact")
    launches_ap, _, *pair_ap = phase_main(torch, approx, a8, b8, shift,
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
    prog["fixed exact"] = phase_program_pair(torch, exact, a8, b8,
                                             "program fixed exact")
    prog["fixed approximate"] = phase_program_pair(
        torch, approx, a8, b8, "program fixed approximate")

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
    kd_slam = phase_detect(torch, img1, plan1, tag="detect slam")
    k3 = phase_k2(torch, img1, plan1, tag="K3 (K2 single image)")
    slam = phase_slam(torch, dev, frames, offsets, per_frame_k1)
    pgo = phase_pgo(torch, dev, slam["graphs"])
    prof_slam = phase_slam_profile(torch, dev, frames)
    syncs = phase_slam_repeat(torch, dev, frames, slam["system"])
    fa = det1.detect_and_compute(frames[0])
    fb = det1.detect_and_compute(frames[1])
    k4_slam = k4_case(torch, "K4 slam", fa.words, fb.words, fa.valid,
                      fb.valid, fb.x, fb.y)
    phase_slam_card_cpu(torch, dev)
    phase_program_single(torch, det1, frames[0], "program single 480x640")
    phase_program_candidates(torch, slam["system"])
    phase_program_solvers(torch, dev)
    route = phase_program_route(torch, dev, frames, slam["system"], syncs,
                                card)
    phase_program_two_view(torch, route["two_view_calls"], card)
    print(f"[slam] card: {card}; median frame {slam['tracked_ms']:.3f} ms "
          f"tracked, {slam['keyframe_ms']:.3f} ms with a new keyframe")

    # the single-device tools: the demo CLI on the pair written as PGM
    # files (the float path reads them as raw / 255, so its counts come
    # from the main path on that pair), homography and PnP, debug planes,
    # the native host runtime
    pgm = tuple(x.astype(np.float32) / 255.0 for x in (a8, b8))
    pgm_counts = main_path_counts(torch, det, *pgm, "main float pgm")
    phase_cli(torch, card, (a8, b8), {False: pgm_counts,
                                      True: pair_counts(*pair_ap)})
    phase_homography(torch, dev, card, fa_main, m_main, shift)
    phase_debug(torch, dev, card, a, plan)
    phase_native(card, frames)

    # the multi-device tier, several shards on this one card
    t0 = time.perf_counter()
    flavours = mesh_flavours()
    sp = phase_mesh_spatial(torch, dev, card, {False: (a, b), True: (a8, b8)},
                            (2, 4), flavours, (H, W), shift,
                            rows_for={(4, "float"), (4, "fixed exact")})
    big = phase_mesh_spatial(torch, dev, card, big_pairs(), (4, 8),
                             {k: flavours[k]
                              for k in ("float", "fixed exact")},
                             (BIG_H, BIG_W), SHIFT,
                             rows_for={(4, "float"), (8, "float")})
    mesh_match = phase_mesh_match(torch, dev, card)
    dp = phase_mesh_dp(torch, dev, card)
    phase_mesh_solvers(torch, dev, card)
    mesh_slam = phase_mesh_slam(torch, dev, card, frames, slam["system"])
    phase_mesh_cli(torch, dev, card, (a8, b8), pgm_counts)
    phase_mesh_dryrun(torch, dev)
    print(f"[mesh] every sharded path passed in "
          f"{time.perf_counter() - t0:.1f} s; no kernel's plain version ran "
          f"on the card inside one")
    t0 = time.perf_counter()
    phase_program_mesh(torch, dev, card, (a, b), big_pairs()[False], frames,
                       mesh_slam["system"], (a8, b8), pgm_counts)
    print(f"[program mesh] every mesh program passed in "
          f"{time.perf_counter() - t0:.1f} s")

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
    kd_src = "akaze_tpu_torch/csrc/detect.cu"
    kd_rep = "none (XLA fuses akaze_tpu/detect.py build_extrema_maps, nms)"
    for name, needle, p, r, n in (
            ("extrema_nms_kernel", "extrema_nms_kernel<float>", prof, kd,
             launches["extrema"]),
            ("extrema_nms_kernel_fixed", "extrema_nms_kernel<int>", prof_fx,
             kd_fx, launches_fx["extrema"])):
        ms, nl = kernel_time(p, needle)
        check(nl == n, f"{name}: {nl} launches in the trace, {n} counted")
        rows.append((name, kd_src, kd_rep, n, ms, r, r["event_ms"]))
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
            ("extrema_nms_kernel_slam", "extrema_nms_kernel<float>", kd_src,
             kd_rep, kd_slam),
            ("hamming_kernel_slam", "hamming_kernel", k4_src, k4_rep,
             k4_slam)):
        ms, per_frame = kernel_time(prof_slam, needle)
        counter = {"tiled_kernel_slam": "tiled",
                   "octave_kernel_slam": "resident",
                   "describe_kernel_single": "describe",
                   "extrema_nms_kernel_slam": "extrema",
                   "hamming_kernel_slam": "hamming"}[name]
        rows.append((name, src, rep, slam["launches"][counter], ms, r,
                     r["event_ms"], ms / max(per_frame, 1e-9)))
    # PGO's rows: per call, at the route's largest graph (launches: the
    # route's solves) and at 256 poses x 1024 edges
    kp_src = "akaze_tpu_torch/csrc/pgo.cu"
    kp_rep = "none (XLA compiles akaze_tpu/slam/posegraph.py's loops)"
    for name, r, n in (("pgo_solve_kernel_slam", pgo["route"],
                        slam["launches"]["pgo"]),
                       ("pgo_solve_kernel_256x1024", pgo["256x1024"], 1)):
        rows.append((name, kp_src, kp_rep, n, r["device_ms"], r,
                     r["event_ms"], r["device_ms"]))
    # the sharded paths' rows: per pair (spatial, 4 shards), per call
    # (sharded_match, 4 shards), per step of 8 pairs (dp, 4 shards)
    mesh = mesh_rows([("", sp), (f"_{BIG_H}x{BIG_W}", big)], mesh_match, dp,
                     mesh_slam["rows"], k1_rep,
                     "akaze_tpu/ops/pallas_sublevel.py:346", k2_rep, k4_rep)
    kernels = []
    for row in mesh:
        kernels.append(dict({"library_ms": None}, route="cuda", **row))
        print(f"[kernels] {row['name']}: {row['launches']} launches, device "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.3f} ms, max abs "
              f"err {row['max_abs_err']:.3g}")
    for name, src, rep, n, ms, r, event, per_launch in rows:
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": n, "max_abs_err": r["max_abs_err"], "ms": ms,
               "device_ms": per_launch, "host_us": r["host_us"],
               "event_ms": event, "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r.get("library_ms")}
        if name in ("tiled_kernel", "octave_kernel"):
            row["b1_device_ms_per_image"] = k1_b1[name == "octave_kernel"]
        if name.startswith("pgo_solve_kernel"):
            row["plain_kernels"] = r["plain_kernels"]
            row["plain_device_ms"] = r["plain_device_ms"]
        if name == "hamming_kernel":
            row["stress_10000x10000"] = {
                k: k4[k] for k in ("device_ms", "event_ms", "plain_ms",
                                   "host_us", "bound_ms")}
        kernels.append(row)
        per = ("call" if name.startswith("pgo_solve") else "frame"
               if name.endswith(("_slam", "_single")) else "pair")
        print(f"[kernels] {name}: {n} launches, device {ms:.4f} ms per "
              f"{per}"
              f" ({per_launch:.4f} per launch), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), host "
              f"{r['host_us']:.1f} us per call/launch, event-bracketed "
              f"{event:.3f} ms, plain {r['plain_ms']:.3f} ms")
    from akaze_tpu_torch import programs
    for p in programs.programs():
        if p.captures:
            print(f"[programs] {p.name}: {p.captures} captures, "
                  f"{p.replays} replays")
    for name, r in prog.items():
        print(f"[programs] pair iteration {name}: eager "
              f"{r['eager_ms']:.3f} ms, captured {r['captured_ms']:.3f} ms")
    print(f"[kernels] card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
