"""Each cell's path at a size a CPU test can hold: its configuration and
traffic with the sizes cut, everything else as the cell runs it."""

from __future__ import annotations

import copy
import time

from cardbench.run import run_cell
from cardbench.spec import Spec

SMALL_AKAZE = dict(max_pts=1000, noctaves=2)
# the small sequences of tests/test_torch_slam.py (160x224)
SMALL_SLAM = dict(
    image=[160, 224], frames_per_sequence=13, intrinsics=dict(fx=200.0, fy=200.0, cx=112.0, cy=80.0),
    slam=dict(optimize_every=4, min_loop_gap=2, loop_min_matches=25,
              loop_min_inliers=8, loop_candidates=2, max_loops_per_kf=1,
              local_ba_every=3, local_ba_window=3, local_ba_points=64),
    vo=dict(min_inliers=6, keyframe_inlier_ratio=1.05),
    akaze=dict(max_pts=512, noctaves=2, dthreshold=5e-5))
TRAFFIC = {
    "pairs": dict(pool=2, max_shift=8, sample=2, trace_steps=2,
                  warm_steps=1),
    "exhaustive": dict(images=4, pool_sets=2, sample=2, trace_steps=8,
                       warm_steps=2),
    "slam": dict(worlds=2, out_frames=7, step_px=32, sample_passes=1,
                 warm_steps=1),
}


def small(spec: Spec, cell: dict, shards: int = None):
    """(configuration, traffic, devices) of ``cell`` cut for the CPU;
    ``shards``: CPU shards in place of the cell's cards."""
    shards = shards or cell["chips"]
    config = copy.deepcopy(spec.config(cell))
    traffic = dict(spec.traffic(cell))
    traffic.update(TRAFFIC[traffic["driver"]])
    if traffic["driver"] == "slam":
        config.update(copy.deepcopy(SMALL_SLAM))
    else:
        # four shards need rows enough for every halo
        config["image"] = [480, 640] if shards == 4 else [240, 320]
        config["akaze"].update(SMALL_AKAZE)
    devices = ["cpu"] * shards
    return config, traffic, devices


# a window long enough for a whole pass of the small route
SECONDS = {"pairs": 2.0, "exhaustive": 2.0, "slam": 8.0}


def run_small(name: str, seed: int = 7, seconds: float = None,
              trace: bool = False, spec: Spec = None,
              shards: int = None) -> dict:
    """One run of the cell ``name`` at the small size on the CPU: the
    harness's whole path but its look for a card."""
    spec = spec or Spec()
    cell = spec.cell(name)
    config, traffic, devices = small(spec, cell, shards)
    seconds = seconds or SECONDS[traffic["driver"]]
    return run_cell(spec, cell, seed, seconds, trace, devices=devices,
                    config=config, traffic=traffic,
                    start=time.perf_counter())
