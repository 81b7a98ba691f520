"""``tools/trace_cell.py``: a small ``--trace 1`` run of each benchmark
cell on the CPU (``cardbench/tests/small.py``'s sizes; a four-card cell
on four CPU shards) with the program's tracer on reports each program
metric of the cell, keeps no program label on the device's timeline, and
records nothing once the traced stretch has ended (the release, the SLAM
check's own pass)."""

import importlib.util
import time
from pathlib import Path

import pytest
import torch

from akaze_tpu_torch import tracing
from cardbench.spec import Spec
from cardbench.tests.small import SECONDS, small

TOOL = Path(__file__).resolve().parent.parent / "tools" / "trace_cell.py"


def load_tool():
    spec = importlib.util.spec_from_file_location("trace_cell", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["pair.vo.960x1280",
                                  "sfm.exhaustive.960x1280",
                                  "slam.tum.480x640",
                                  "pair.aerial.3648x5472.4cards"])
def test_a_traced_cell_reports_the_program_metrics(name):
    torch.set_num_threads(1)
    tool = load_tool()
    spec = Spec()
    cell = spec.cell(name)
    config, traffic, devices = small(spec, cell)
    seconds = SECONDS[traffic["driver"]]
    if traffic["driver"] == "slam":
        # one world, its whole route in the traced stretch
        traffic.update(worlds=1, trace_steps=13, warm_steps=0)
        seconds = 1.0
    elif traffic["driver"] == "exhaustive":
        # the set's four detections take ~1.5 s of the 2-s window on an
        # idle host: a loaded one can end the window before any pair is
        # matched, and a check with no pair reads infinite
        seconds = 3 * seconds
    try:
        out = tool.run(spec, cell, 2 ** 33 + 5, seconds,
                       start=time.perf_counter(), devices=devices,
                       config=config, traffic=traffic)
    finally:
        tracing.disable()
        tracing.reset()
    mine = {k for k, (_, cells, _) in tool.PROGRAM_METRICS.items()
            if name in cells}
    assert mine and mine <= set(out["metrics"])
    for k in mine:
        # on the CPU nothing is captured, so no program replays
        if k != "programs.replay_host_us":
            assert out["metrics"][k]["value"] is not None, k
    assert out["correct"]
    assert out["device_labels"] == []
    assert not out["recorded_after_stretch"]
    assert not tracing.enabled()
    spans = out["summary"]["spans"]
    if traffic["driver"] == "slam":
        assert {"slam.frame", "vo.two_view", "slam.local_ba",
                "slam.pgo"} <= set(spans)
        # PGO's kernel runs on the card only: the CPU solves with the plain
        # loop, no launch in any of the calls
        assert out["metrics"]["slam.pgo_launches_per_call"] == {
            "value": 0.0, "unit": "launches"}
    else:
        assert {"akaze.upload", "akaze.detect", "akaze.match"} <= set(spans)
    if name == "sfm.exhaustive.960x1280":
        # the matcher's kernel runs on the card only: the CPU matches with
        # the plain twin, no launch in any call
        assert out["metrics"]["match.launches_per_call"] == {
            "value": 0.0, "unit": "launches"}
        assert out["metrics"]["match.host_us"]["value"] > 0
    if cell["chips"] > 1:
        # the pair's images through the spatial tier, four CPU shards
        counters = out["summary"]["counters"]
        assert counters["spatial.images"] == 2 * spans["akaze.upload"][
            "count"] == spans["akaze.spatial"]["count"]
        assert out["metrics"]["spatial.exchange_bytes_per_pair"][
            "value"] > 0
        assert "spatial.fallbacks" not in counters


def test_match_metrics_read_the_tracer_summary():
    """``match.host_us`` is the mean ``akaze.match`` span in us, and
    ``match.launches_per_call`` the one-launch matcher's launches over
    those spans; neither reads anything without a match."""
    tool = load_tool()
    host = tool.PROGRAM_METRICS["match.host_us"][2]
    per_call = tool.PROGRAM_METRICS["match.launches_per_call"][2]
    summary = {"spans": {"akaze.match": {"count": 4, "total_ns": 180_000,
                                         "self_ns": 170_000}},
               "counters": {"hamming_match.launches": 4,
                            "hamming_top2.launches": 0}}
    assert host(summary) == 45.0
    assert per_call(summary) == 1.0
    empty = {"spans": {}, "counters": {"hamming_match.launches": 3}}
    assert host(empty) is None and per_call(empty) is None
    cells = {cells for _, cells, _ in (
        tool.PROGRAM_METRICS["match.host_us"],
        tool.PROGRAM_METRICS["match.launches_per_call"])}
    assert cells == {("sfm.exhaustive.960x1280",)}
