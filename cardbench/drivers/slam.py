"""Handheld RGB-D SLAM replayed offline: passes of a seeded route through
``SlamSystem.process``.

Parameters of the mix: the route (``out_frames`` frames out, ``step_px``
apart, and back a quarter step off) through each of ``worlds`` blob
worlds at ``blob_density`` per px, rendered on the device and handed over
as host float32 frames; each pass runs one world's route through a fresh
``SlamSystem``, in a closed loop.  A world's content sets the work of its
pass (its keyframes, loops, PGO and BA calls), so the timed worlds are
world w drawn from seed w, the same for every run, and ``--seed`` draws
the order in which the passes take them: every seed the same work, in
another order.  ``trace_steps`` frames in the traced stretch.  A step is
one frame.

The check holds whole passes against the reference's replay of the same
frames (``reference.slam.System``, which detects, matches, draws, solves
and optimises on its own): ``sample_passes`` passes of the window, and,
once the window has closed and the peak memory is read, one more pass
through the same path on a world drawn from the run's seed, so that
every seed's check sees new data.  What is compared is what the program
hands its user, read through public names only: the features of every
frame (``vo.akaze.detect_and_compute``), the pose of every frame
(``vo.poses``), the keyframes' frames, poses and landmark depths
(``vo.keyframes``) and the pose graph's edges (``edges``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import compare, gen
from ..reference.slam import system as ref_system
from . import Reservoir, akaze_fields, reference_plan, release_program
from .pairs import elapsed_ms, timer

NUMBERS = ("kp_unpaired", "response_err", "bits_flipped", "depth_unpaired",
           "depth_err", "pose_err", "structure_diff")


class Driver:
    def __init__(self, config, traffic, seed, devices, spans):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.devices, self.spans = devices, spans
        self.height, self.width = config["image"]
        self.done = 0
        self.k = 0
        self.latency = []        # (start, end, added a keyframe)
        self.recording = None    # the current pass's features, per frame

    def _system(self, timed=True):
        from akaze_tpu_torch import AkazeConfig
        from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
        system = SlamSystem(Intrinsics(**self.config["intrinsics"]),
                            AkazeConfig(**akaze_fields(self.config)),
                            SlamConfig(**self.config["slam"]),
                            device=self.devices[0],
                            **self.config.get("vo", {}))
        detect, optimize = system.vo.akaze.detect_and_compute, \
            system.optimize

        def recorded_detect(image, describe=True):
            f = detect(image, describe)
            if self.recording is not None:
                self.recording.append(kept(f))
            return f
        system.vo.akaze.detect_and_compute = recorded_detect
        if timed:
            spans = self.spans

            def timed_optimize(*args, **kwargs):
                with spans.span("pgo"):
                    return optimize(*args, **kwargs)
            system.optimize = timed_optimize
        return system

    def _route(self, world_seed):
        t = self.traffic
        frames, _ = gen.route_frames(
            self.height, self.width, t["out_frames"], t["step_px"],
            t["blob_density"], world_seed, self.devices[0])
        return [f.cpu().numpy().copy() for f in frames]

    def setup(self):
        t = self.traffic
        stated = self.config.get("frames_per_sequence")
        if stated is not None and stated != 2 * t["out_frames"] - 1:
            raise ValueError(f"the configuration states {stated} frames a "
                             f"sequence, the mix's route has "
                             f"{2 * t['out_frames'] - 1}")
        self.worlds = [self._route(w) for w in range(t["worlds"])]
        self.order = list(range(len(self.worlds)))
        self.passes = 0
        self.sample = Reservoir(0, self.seed, 3)
        for _ in range(len(self.worlds) * len(self.worlds[0])):
            self.step()                 # a warm pass of each world captures
        self.restart()

    def restart(self):
        """Back to a fresh pass's first frame, nothing counted or kept."""
        self.done = 0
        self.k = 0
        self.passes = 0
        self.latency.clear()
        self.recording = None
        self.sample = Reservoir(self.traffic["sample_passes"], self.seed, 3)
        rng = np.random.default_rng([int(self.seed) % (1 << 64), 6])
        n = len(self.worlds)
        self.order = [int(w) for _ in range(64) for w in rng.permutation(n)]

    def step(self):
        if self.k == 0:
            self.system = self._system()
            self.world = self.order[self.passes % len(self.order)]
            self.frames = self.worlds[self.world]
            self.passes += 1
            self.recording = []
        card = torch.device(self.devices[0]).type == "cuda"
        before = len(self.system.vo.keyframes)
        start = timer(card)
        with self.spans.span("frame", timed=False):
            self.system.process(self.frames[self.k])
        self.latency.append((start, timer(card),
                             len(self.system.vo.keyframes) > before))
        self.k = (self.k + 1) % len(self.frames)
        self.done += 1
        if self.k == 0 and not self.spans.labelled:
            # a whole pass of the window: a candidate for the sample
            slot = self.sample.wants()
            if slot >= 0:
                self.sample.put(slot, dict(
                    frames=self.frames,
                    **outputs(self.system, self.recording)))

    def end_to_end(self, window_s):
        ms = [elapsed_ms(s, e) for s, e, _ in self.latency]
        tracked = [m for m, (_, _, kf) in zip(ms, self.latency) if not kf]
        return {"frame_ms": window_s * 1e3 / self.done,
                "frame_p95_ms": float(np.percentile(ms, 95)),
                "frame_median_ms": float(np.median(ms)),
                "tracked_frame_ms": float(np.mean(tracked)) if tracked
                else None}

    def begin_trace(self):
        self.trace_start = len(self.latency)

    def facts(self):
        return {"tracked_frame_ms": [
            elapsed_ms(s, e) for s, e, kf in
            self.latency[:self.trace_start] if not kf]}

    def release(self):
        """The checked pass on the seed's own world (after the window and
        the peak's reading), then the program's state freed."""
        frames = self._route(self.seed)
        system = self._system(timed=False)
        self.recording = []
        for frame in frames:
            system.process(frame)
        self.kept = self.sample.items + [
            dict(frames=frames, **outputs(system, self.recording))]
        self.sample.items = []
        self.recording = None
        self.system = system = None
        release_program()

    # -- the check ------------------------------------------------------
    def check(self, lower=None):
        """Each compared number, its worst over the kept passes;
        ``lower``: the control, the reference one precision lower in the
        program's place (its planes made in it, its solvers' inputs and
        outputs rounded through it)."""
        home = self.devices[0]
        plan = reference_plan(self.config, self.height, self.width)
        readings = {k: [] for k in NUMBERS}
        for prog in self.kept:
            ref = replay(self.config, plan, prog["frames"], home, None)
            if lower is not None:
                ctl = replay(self.config, plan, prog["frames"], home, lower)
                prog = outputs(ctl, [kept(f) for f in ctl.vo.features])
            for k, v in compare_pass(prog, ref).items():
                readings[k].append(v)
        # a number with nothing to compare reads infinite: not correct
        return {k: max(v, default=float("inf")) for k, v in readings.items()}


def replay(config, plan, frames, device, lower):
    """The reference system over ``frames``, as the cell configures the
    program."""
    system = ref_system.System(
        ref_system.Intrinsics(**config["intrinsics"]), plan,
        ref_system.SlamConfig(**config["slam"]), lower=lower,
        **config.get("vo", {}))
    for frame in frames:
        system.process(torch.as_tensor(frame).to(device))
    return system


def kept(f):
    """A ``Features`` as recorded: CPU tensors cloned (on the CPU the
    program's numpy views share memory with its tensors; on the card each
    is a program's fresh output)."""
    return type(f)(*(v.clone() if isinstance(v, torch.Tensor)
                     and v.device.type == "cpu" else v for v in f))


def outputs(system, features) -> dict:
    """What a pass hands its user, copied: per-frame features and poses,
    the keyframes (frame, R, t, metric depths and their validity), and the
    pose graph's edges (i, j)."""
    vo = system.vo

    def copy(a):
        return None if a is None else np.array(a)
    return dict(features=list(features),
                poses=[(np.array(R), np.array(t)) for R, t in vo.poses],
                keyframes={int(k.index): (np.array(k.R), np.array(k.t),
                                          copy(k.z), copy(k.z_ok))
                           for k in vo.keyframes},
                edges={(int(e[0]), int(e[1])) for e in system.edges})


def angle(R1, R2) -> float:
    """The rotation between R1 and R2 in rad to first order: ||R1 - R2||
    / sqrt(2) (exactly 0 for equal rotations)."""
    d = np.asarray(R1, np.float64) - np.asarray(R2, np.float64)
    return float(np.linalg.norm(d) / 2.0 ** 0.5)


def compare_pass(prog: dict, ref) -> dict:
    """The numbers of one pass, the program's outputs against the
    reference system's after the same frames:

    * ``kp_unpaired``, ``response_err``, ``bits_flipped``: ``compare``'s,
      the worst frame (the scale space, detection, K2);
    * ``structure_diff``: keyframes and pose-graph edges on one side
      only, over the reference's (the keyframe decisions from the
      inlier counts, loop closure);
    * ``depth_unpaired``: keyframe slots with a metric depth on one side
      only, over those with one on either (matches, K4, RANSAC's
      inliers, the sign of triangulation);
    * ``depth_err``: the largest gap of a keyframe slot's metric depth,
      over the reference's median depth of that keyframe (triangulation,
      scale propagation);
    * ``pose_err``: each frame's pose as made and each keyframe's at the
      pass's end (after PGO and local BA): the larger of the rotation gap
      in rad and the translation gap over the largest translation of the
      reference's route.
    """
    out = {k: 0.0 for k in NUMBERS}
    for p, r in zip(prog["features"], ref.vo.features):
        numbers, _ = compare.compare_image(compare.live(p), compare.live(r))
        for k, v in numbers.items():
            out[k] = max(out[k], v)
    ref_out = outputs(ref, [])
    kp, kr = prog["keyframes"], ref_out["keyframes"]
    ep, er = prog["edges"], ref_out["edges"]
    out["structure_diff"] = (len(kp.keys() ^ kr.keys()) + len(ep ^ er)) / \
        max(len(kr) + len(er), 1)
    if len(prog["poses"]) != len(ref_out["poses"]):
        out["structure_diff"] = max(out["structure_diff"], 1.0)

    extent = max([float(np.linalg.norm(t)) for _, t in ref_out["poses"]]
                 + [1e-6])
    pairs = list(zip(prog["poses"], ref_out["poses"]))
    pairs += [((kp[i][0], kp[i][1]), (kr[i][0], kr[i][1]))
              for i in kp.keys() & kr.keys()]
    for (Rp, tp), (Rr, tr) in pairs:
        gap = np.linalg.norm(np.asarray(tp, np.float64)
                             - np.asarray(tr, np.float64)) / extent
        out["pose_err"] = max(out["pose_err"], angle(Rp, Rr), float(gap))

    one_side = either = 0
    for i in kp.keys() & kr.keys():
        zp, okp = kp[i][2:]
        zr, okr = kr[i][2:]
        if okp is None and okr is None:
            continue
        okp = np.zeros_like(okr) if okp is None else okp
        okr = np.zeros_like(okp) if okr is None else okr
        one_side += int((okp ^ okr).sum())
        either += int((okp | okr).sum())
        both = okp & okr
        if both.any():
            med = max(float(np.median(zr[okr])), 1e-12)
            gap = np.abs(zp[both].astype(np.float64) - zr[both]).max()
            out["depth_err"] = max(out["depth_err"], float(gap) / med)
    out["depth_unpaired"] = one_side / max(either, 1)
    return out
