"""A closed loop of image pairs: what a VO or stereo front end waits on.

Parameters of the mix: ``pool`` pairs, each two crops of one seeded
texture at a seeded integer shift of up to ``max_shift`` px per axis,
handed to the program as host float32 arrays in turn; ``sample`` pairs
of the window compared with the reference; ``trace_steps`` pairs in the
traced stretch.  A step is one request: ``detect_and_compute_pair`` of
the two host images, ``match``, and the correspondences (A's keypoints,
their matched B coordinates and the match indices) brought to the host.
Its latency runs between CUDA events from before the upload to after the
fetch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, gen
from ..reference import akaze as reference
from . import (Reservoir, program, reference_plan, release_program)


class Driver:
    def __init__(self, config, traffic, seed, devices, spans):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.devices, self.spans = devices, spans
        self.height, self.width = config["image"]
        self.done = 0
        self.latency = []          # (start, end) CUDA events per pair
        self.counts = []           # live counts of each traced pair

    # -- set-up ---------------------------------------------------------
    def setup(self):
        h, w, m = self.height, self.width, self.traffic["max_shift"]
        home = self.devices[0]
        self.pool = []
        for i, (dy, dx) in enumerate(gen.shifts(self.seed, self.traffic[
                "pool"], m)):
            world = gen.texture(h + 2 * m, w + 2 * m, self.seed, i, home)
            a = world[m:m + h, m:m + w]
            b = world[m + dy:m + dy + h, m + dx:m + dx + w]
            self.pool.append((a.cpu().numpy().copy(),
                              b.cpu().numpy().copy(), (dy, dx)))
        del world
        self.det = program(self.config, self.devices)
        for i in range(3):          # capture, then two replays
            self._request(*self.pool[i % len(self.pool)][:2])
        self.restart()

    def restart(self):
        """Back to the first request, with nothing counted or kept."""
        self.done = 0
        self.latency.clear()
        self.sample = Reservoir(self.traffic["sample"], self.seed, 1)

    # -- the loop -------------------------------------------------------
    def _request(self, a, b):
        spans = self.spans
        start = timer(self._card)
        with spans.span("detect"):
            fa, fb = self.det.detect_and_compute_pair(a, b)
        with spans.span("match"):
            m = self.det.match(fa, fb)
        with spans.span("fetch", timed=False):
            torch.stack([fa.x, fa.y, m.match_x, m.match_y]).cpu()
            m.index.cpu()
        return fa, fb, m, (start, timer(self._card))

    @property
    def _card(self):
        return torch.device(self.devices[0]).type == "cuda"

    def step(self):
        k = self.done % len(self.pool)
        a, b, _ = self.pool[k]
        fa, fb, m, events = self._request(a, b)
        self.done += 1
        self.latency.append(events)
        if self.spans.labelled:         # the traced stretch, after the window
            self.counts.append((fa.count, fb.count))
            return
        slot = self.sample.wants()
        if slot >= 0:
            self.sample.put(slot, (k, fa, fb, m))

    def end_to_end(self, window_s):
        ms = [elapsed_ms(s, e) for s, e in self.latency]
        median = float(np.median(ms))
        return {"pairs_per_s": self.done / window_s,
                "pair_p95_ms": float(np.percentile(ms, 95)),
                "pair_median_ms": median,
                "pair_median_over_baseline": median / self.config[
                    "baseline_ms"] if "baseline_ms" in self.config
                else None}

    def begin_trace(self):
        self.counts.clear()

    def facts(self):
        counts = [(int(a), int(b)) for a, b in self.counts]
        return {"pairs": len(counts), "akaze": self.config["akaze"],
                "image": (self.height, self.width), "batch": 2,
                "k2": [(a + b, 2 * self.config["akaze"]["max_pts"], 2)
                       for a, b in counts],
                "k4": [(a, b, self.config["akaze"]["max_pts"])
                       for a, b in counts]}

    # -- the check ------------------------------------------------------
    def release(self):
        self.kept = self.sample.items
        self.sample.items = []
        del self.det
        release_program()

    def check(self, lower=None):
        """Each compared number, its worst over the sample; ``lower``: a
        lower precision for the reference put in the program's place (the
        control)."""
        plan = reference_plan(self.config, self.height, self.width)
        readings, shift_ok = [], []
        home = self.devices[0]
        for k, fa, fb, m in self.kept:
            a, b, (dy, dx) = self.pool[k]
            images = torch.stack([torch.as_tensor(a), torch.as_tensor(b)]
                                 ).to(home)
            ra, rb = reference.detect_and_compute_batch(images, plan)
            rm = reference.match_features(ra, rb)
            if lower is not None:
                with reference.planes_in(lower):
                    fa, fb = reference.detect_and_compute_batch(images, plan)
                m = reference.match_features(fa, fb)
            readings.append(compare.compare_pair((fa, fb, m), (ra, rb, rm)))
            shift_ok.append(shift_inliers(fa, m, dy, dx))
        self.shift_inliers = min(shift_ok) if shift_ok else None
        return compare.worst(readings)


def timer(card: bool):
    """A CUDA event recorded now on a card, else the host clock."""
    if not card:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    return start.elapsed_time(end)


def shift_inliers(fa, m, dy, dx) -> float:
    """Share of the accepted matches within 1.5 px of the known shift."""
    n = int(fa.count)
    acc = m.index[:n] >= 0
    ex = (m.match_x[:n] - fa.x[:n] + dx).abs()
    ey = (m.match_y[:n] - fa.y[:n] + dy).abs()
    good = acc & (ex < 1.5) & (ey < 1.5)
    return float(good.sum()) / max(int(acc.sum()), 1)
