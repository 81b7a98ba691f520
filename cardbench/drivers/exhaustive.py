"""Exhaustive matching of a photo collection, as COLMAP's exhaustive
matcher does: every image detected once, then every pair matched.

Parameters of the mix: sets of ``images`` crops of one seeded texture,
the world ``world`` times an image's size per axis, so that crops
overlap; ``pool_sets`` sets drawn from the seed and the set index, taken
in turn; ``sample`` pairs of the window compared with the reference;
``trace_steps`` steps in the traced stretch.  A step is one call: the
next image's ``detect_and_compute`` from its host array (features stay on
the card, the keypoints' coordinates are fetched once per image), or,
once the set is detected, the next pair's ``match`` with the match
indices brought to the host.  ``pairs_per_s`` counts matched pairs.
"""

from __future__ import annotations

import torch

from .. import compare, gen
from ..reference import akaze as reference
from . import Reservoir, program, reference_plan, release_program


class Driver:
    def __init__(self, config, traffic, seed, devices, spans):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.devices, self.spans = devices, spans
        self.height, self.width = config["image"]
        n = traffic["images"]
        self.pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        self.done = 0              # pairs matched
        self.traced = []           # what the traced stretch ran

    def _set(self, index):
        h, w = self.height, self.width
        f = self.traffic["world"]
        big_h, big_w = int(h * f), int(w * f)
        world = gen.texture(big_h, big_w, self.seed, index, self.devices[0])
        corners = gen.crop_offsets(self.seed, index, self.traffic["images"],
                                   big_h - h, big_w - w)
        return [world[y:y + h, x:x + w].cpu().numpy().copy()
                for y, x in corners]

    def setup(self):
        self.sets = [self._set(i) for i in range(self.traffic["pool_sets"])]
        self.det = program(self.config, self.devices)
        for _ in range(3):          # capture, then two replays
            fa = self.det.detect_and_compute(self.sets[0][0])
            fb = self.det.detect_and_compute(self.sets[0][1])
            self.det.match(fa, fb).index.cpu()
        self.restart()

    def restart(self):
        """Back to the first set's first image, nothing counted or kept."""
        self.done = 0
        self.sample = Reservoir(self.traffic["sample"], self.seed, 2)
        self._begin(0)

    def _begin(self, set_index):
        self.set_index = set_index
        self.features = []
        self.next_pair = 0

    def step(self):
        images = self.sets[self.set_index % len(self.sets)]
        if len(self.features) < len(images):
            with self.spans.span("detect"):
                f = self.det.detect_and_compute(images[len(self.features)])
            with self.spans.span("keypoints", timed=False):
                torch.stack([f.x, f.y]).cpu()
            self.features.append(f)
            if self.spans.labelled:
                self.traced.append(("image", f.count))
            return
        i, j = self.pairs[self.next_pair]
        with self.spans.span("match"):
            m = self.det.match(self.features[i], self.features[j])
            m.index.cpu()
        self.done += 1
        self.next_pair += 1
        if self.spans.labelled:         # the traced stretch, after the window
            self.traced.append(("pair", self.features[i].count,
                                self.features[j].count))
        else:
            slot = self.sample.wants()
            if slot >= 0:
                self.sample.put(slot, (self.set_index % len(self.sets), i,
                                       j, self.features[i],
                                       self.features[j], m))
        if self.next_pair == len(self.pairs):
            self._begin(self.set_index + 1)

    def end_to_end(self, window_s):
        return {"pairs_per_s": self.done / window_s}

    def begin_trace(self):
        self.traced.clear()

    def facts(self):
        n = self.config["akaze"]["max_pts"]
        images = [int(c[1]) for c in self.traced if c[0] == "image"]
        pairs = [(int(c[1]), int(c[2])) for c in self.traced
                 if c[0] == "pair"]
        return {"pairs": len(pairs), "scale_spaces": len(images),
                "akaze": self.config["akaze"],
                "image": (self.height, self.width), "batch": 1,
                "k2": [(c, n, 2) for c in images],
                "k4": [(a, b, n) for a, b in pairs]}

    def release(self):
        self.kept = self.sample.items
        self.sample.items = []
        self.features = []
        del self.det
        release_program()

    def check(self, lower=None):
        """Each compared number, its worst over the sample; ``lower`` as in
        the pair driver (the control)."""
        plan = reference_plan(self.config, self.height, self.width)
        home = self.devices[0]
        readings = []
        for s, i, j, fa, fb, m in self.kept:
            refs = []
            for k in (i, j):
                image = torch.as_tensor(self.sets[s][k]).to(home)[None]
                refs.append(reference.detect_and_compute_batch(image,
                                                               plan)[0])
            ra, rb = refs
            rm = reference.match_features(ra, rb)
            if lower is not None:
                with reference.planes_in(lower):
                    fa, fb = (reference.detect_and_compute_batch(
                        torch.as_tensor(self.sets[s][k]).to(home)[None],
                        plan)[0] for k in (i, j))
                m = reference.match_features(fa, fb)
            readings.append(compare.compare_pair((fa, fb, m), (ra, rb, rm)))
        return compare.worst(readings)
