"""``akaze_tpu_torch.tracing``: the program's spans and counters.

Off, the tracer records nothing and hands out one shared null context;
on, spans nest with parent and request ids and self times; ``Akaze`` and
a small SLAM route (``tests/test_torch_slam.py``'s sizes) record every
section of the layers they run, ``host_syncs`` counts each read of a
tensor to the host; the program counters read as their change since
``reset()``.  One card case: a captured program's replay and its three
sections.  The file imports no JAX and no conftest fixture, so that the
card case runs under ``--noconftest``.
"""

import contextlib

import numpy as np
import pytest
import torch

from akaze_tpu_torch import Akaze, AkazeConfig, programs, tracing
from akaze_tpu_torch.io.dataset import synthetic_sequence
from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
from akaze_tpu_torch.slam.odometry import to_numpy

SLAM_CFG = dict(optimize_every=4, min_loop_gap=2, loop_min_matches=25,
                loop_min_inliers=8, loop_candidates=2, max_loops_per_kf=1,
                local_ba_every=3, local_ba_window=3, local_ba_points=64)
VO_CFG = dict(min_inliers=6, keyframe_inlier_ratio=1.05)
AKAZE_CFG = dict(max_pts=512, noctaves=2, dthreshold=5e-5)
INTR = dict(fx=200.0, fy=200.0, cx=112.0, cy=80.0)

# each section of the SLAM path and the section it opens under
PARENTS = {
    "slam.frame": None, "vo.detect": "slam.frame",
    "akaze.upload": "vo.detect", "akaze.detect": "vo.detect",
    "vo.two_view": "slam.frame", "vo.fetch": "vo.two_view",
    "vo.scale": "slam.frame", "vo.keyframe": "slam.frame",
    "slam.index_add": "slam.frame", "slam.loop_closure": "slam.frame",
    "slam.pgo": "slam.frame", "pgo.pad": "slam.pgo",
    "pgo.solve": "slam.pgo", "pgo.writeback": "slam.pgo",
    "slam.local_ba": "slam.frame", "local_ba.build": "slam.local_ba",
    "local_ba.pad": "slam.local_ba", "local_ba.solve": "slam.local_ba",
    "local_ba.writeback": "slam.local_ba",
}


@pytest.fixture
def tracer():
    """The tracer off and empty before and after the test."""
    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


def blob_image(seed, h=160, w=224):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for cy, cx, s in zip(rng.uniform(10, h - 10, 40),
                         rng.uniform(10, w - 10, 40), rng.uniform(2, 6, 40)):
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return np.clip(img, 0, 1).astype(np.float32)


def route():
    """``tests/test_torch_slam.py``'s out-and-back route, 5 frames."""
    frames, _ = synthetic_sequence(np.random.default_rng(3), n_frames=9,
                                   size=(160, 224), shift_per_frame=(0.0,
                                                                     10.0),
                                   n_blobs=300)
    return [frames[k].astype(np.float32) / 255.0 for k in (0, 4, 8, 7, 3)]


def by_id():
    return {r[0]: r for r in tracing.spans()}


def test_off_records_nothing(tracer):
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")
    assert isinstance(tracing.span("a"), contextlib.nullcontext)
    assert tracing.request() is tracing.span("a")
    det = Akaze(AkazeConfig(**AKAZE_CFG), device="cpu")
    f = det.detect_and_compute(blob_image(0))
    det.match(f, f)
    to_numpy(f.x)
    tracing.count("host_syncs")
    s = tracing.summary()
    assert s["spans"] == {} and tracing.spans() == []
    assert set(s["counters"].values()) == {0}
    assert "host_syncs" not in s["counters"]


def test_spans_nest_with_parents_requests_and_self_time(tracer):
    tracing.enable(labelled=True)
    with tracing.request():
        with tracing.span("outer"):
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    sum(range(20000))
            with tracing.span("inner"):
                sum(range(10000))
            sum(range(10000))
    with tracing.span("alone"):
        pass
    tracing.disable()
    spans = by_id()
    names = {r[3]: [] for r in spans.values()}
    for r in spans.values():
        names[r[3]].append(r)
    outer, = names["outer"]
    alone, = names["alone"]
    leaf, = names["leaf"]
    assert outer[1] is None and alone[1] is None
    assert all(r[1] == outer[0] for r in names["inner"])
    assert leaf[1] == names["inner"][0][0]
    assert len({r[2] for r in spans.values() if r[3] != "alone"}) == 1
    assert alone[2] != outer[2]
    agg = tracing.summary()["spans"]
    for name, rs in names.items():
        total = sum(r[5] - r[4] for r in rs)
        children = sum(c[5] - c[4] for c in spans.values()
                       if c[1] in {r[0] for r in rs})
        assert agg[name]["count"] == len(rs)
        assert agg[name]["total_ns"] == total
        assert agg[name]["self_ns"] == total - children
    assert agg["outer"]["self_ns"] < agg["outer"]["total_ns"]


def test_akaze_records_each_call_under_one_root(tracer):
    det = Akaze(AkazeConfig(**AKAZE_CFG), device="cpu")
    a, b = blob_image(0), blob_image(1)
    tracing.enable(labelled=True)
    fa = det.detect_and_compute(a)
    det.detect_and_compute_pair(a, b)
    det.match(fa, fa)
    with tracing.request():
        det.match(fa, det.detect_and_compute(b))
    tracing.disable()
    spans = tracing.spans()
    assert [r[3] for r in spans] == [
        "akaze.upload", "akaze.detect", "akaze.upload", "akaze.detect",
        "akaze.match", "akaze.upload", "akaze.detect", "akaze.match"]
    assert all(r[1] is None for r in spans)
    requests = [r[2] for r in spans]
    assert requests[0] == requests[1] != requests[2] == requests[3]
    assert len(set(requests[:5])) == 3 and len(set(requests[5:])) == 1
    assert requests[5] not in requests[:5]
    agg = tracing.summary()["spans"]
    assert {k: v["count"] for k, v in agg.items()} == {
        "akaze.upload": 3, "akaze.detect": 3, "akaze.match": 2}


def test_slam_route_records_every_section(tracer, monkeypatch):
    frames = route()
    system = SlamSystem(Intrinsics(**INTR), AkazeConfig(**AKAZE_CFG),
                        SlamConfig(**SLAM_CFG), device="cpu", **VO_CFG)
    fetches = []
    cpu = torch.Tensor.cpu

    def counted(t, *a, **kw):
        fetches.append(1)
        return cpu(t, *a, **kw)
    tracing.enable(labelled=True)
    tracing.reset()
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    for f in frames:
        system.process(f)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    tracing.disable()
    spans = by_id()
    assert {r[3] for r in spans.values()} == set(PARENTS)
    for r in spans.values():
        parent = spans.get(r[1])
        assert (parent and parent[3]) == PARENTS[r[3]], r
    roots = [r for r in spans.values() if r[3] == "slam.frame"]
    assert len(roots) == len(frames)
    assert len({r[2] for r in spans.values()}) == len(frames)
    for r in spans.values():
        root = r
        while root[1] is not None:
            root = spans[root[1]]
        assert r[2] == root[2]
    s = tracing.summary()
    assert s["spans"]["slam.frame"]["count"] == len(frames)
    assert s["counters"]["host_syncs"] == len(fetches) > len(frames)


def test_program_counters_are_deltas_since_reset(tracer):
    from akaze_tpu_torch.ops.hamming import hamming_top2
    prog = programs.jit(lambda x: x)
    launches = hamming_top2.launches
    try:
        prog.captures, prog.replays = 3, 7
        prog.eager_keys["k"] = 2
        hamming_top2.launches += 5
        tracing.reset()
        tracing.enable()
        prog.captures += 1
        prog.replays += 4
        prog.eager_keys["k"] += 1
        hamming_top2.launches += 2
        c = tracing.summary()["counters"]
        assert (c["captures"], c["replays"], c["eager_calls"],
                c["hamming_top2.launches"]) == (1, 4, 1, 2)
        tracing.disable()
        prog.replays += 10
        hamming_top2.launches += 10
        assert tracing.summary()["counters"] == c
        tracing.reset()
        assert set(tracing.summary()["counters"].values()) == {0}
    finally:
        hamming_top2.launches = launches
        programs._PROGRAMS.remove(prog)


def _affine(x):
    return x * 2 + 1


@pytest.mark.cuda
def test_a_replay_records_its_three_sections(tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from torch.profiler import ProfilerActivity, profile
    prog = programs.jit(_affine)
    x = torch.arange(4096.0, device="cuda")
    try:
        tracing.enable(labelled=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            first = prog(x)
            second = prog(x + 1)
            torch.cuda.synchronize()
        tracing.disable()
        assert torch.equal(first, x * 2 + 1)
        assert torch.equal(second, (x + 1) * 2 + 1)
        assert prog.captures == 1 and prog.replays == 1
        spans = by_id()
        names = [r[3] for r in spans.values()]
        assert names.count("program.capture") == 1
        replay, = [r for r in spans.values() if r[3] == "program.replay"]
        assert sorted(r[3] for r in spans.values() if r[1] == replay[0]) \
            == ["program.graph", "program.inputs", "program.outputs"]
        c = tracing.summary()["counters"]
        assert (c["captures"], c["replays"]) == (1, 1)
        labels = {e.name for e in prof.events()}
        assert {"akaze_tpu_torch.program.capture",
                "akaze_tpu_torch.program.replay",
                "akaze_tpu_torch.program.graph"} <= labels
    finally:
        for e in prog.entries.values():
            e.release()
        prog.entries.clear()
        programs._PROGRAMS.remove(prog)
