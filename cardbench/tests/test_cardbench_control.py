"""The comparison that decides ``correct`` fails what it must: the control
(the reference one precision lower in the program's place) and each fault
that a cell can have, planted under a whole small run of the harness on
the CPU (everything but its look for a card)."""

from __future__ import annotations

import pytest
import torch

from cardbench.spec import Spec
from cardbench.tests.small import run_small

CELLS = [w["name"] for w in Spec().data["workloads"]]


def failed(run) -> list:
    return [k for k, v in run["result"]["check"].items()
            if not v["value"] <= v["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct_and_the_control_is_not(name):
    run = run_small(name)
    assert run["result"]["correct"], run["result"]["check"]
    limits = Spec().limits(Spec().cell(name))
    control = run["driver"].check(lower=torch.bfloat16)
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if Spec().traffic(Spec().cell(n))[
                                      "driver"] == "pairs"])
def test_half_the_batch_left_out(monkeypatch, name):
    """The pair's second image dropped: its features are the first's."""
    from akaze_tpu_torch import pipeline
    real = pipeline.Akaze.detect_and_compute_pair

    def first_twice(self, a, b):
        fa, _ = real(self, a, b)
        return fa, fa
    monkeypatch.setattr(pipeline.Akaze, "detect_and_compute_pair",
                        first_twice)
    assert not run_small(name)["result"]["correct"]


@pytest.mark.parametrize("name", [n for n in CELLS if Spec().traffic(
    Spec().cell(n))["driver"] in ("pairs", "exhaustive")])
def test_an_answer_altered_where_it_is_produced(monkeypatch, name):
    """Every accepted match sent to the train keypoint after its own."""
    from akaze_tpu_torch import pipeline
    real = pipeline.Akaze.match

    def shifted(f1, f2, max_dist=96):
        m = real(f1, f2, max_dist)
        index = torch.where(m.index >= 0, (m.index + 1) % int(f2.count),
                            m.index)
        return m._replace(index=index)
    monkeypatch.setattr(pipeline.Akaze, "match", staticmethod(shifted))
    run = run_small(name)
    assert "match_diff" in failed(run)


def pgo_unchanged(R, t, graph, **kw):
    return R.clone(), t.clone(), torch.zeros((), device=R.device)


def ba_unchanged(R, t, X, prob, **kw):
    return R.clone(), t.clone(), X.clone(), torch.zeros((), device=R.device)


@pytest.mark.parametrize("name", [n for n in CELLS if Spec().traffic(
    Spec().cell(n))["driver"] == "slam"])
@pytest.mark.parametrize("step,fault,number", [
    ("optimize_pose_graph", pgo_unchanged, "pose_err"),
    ("bundle_adjust", ba_unchanged, "pose_err")])
def test_a_step_that_returns_its_state_unchanged(monkeypatch, name, step,
                                                 fault, number):
    """PGO, or local BA, hands back the poses it was given."""
    from akaze_tpu_torch.slam import system
    monkeypatch.setattr(system, step, fault)
    assert number in failed(run_small(name))


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if Spec().traffic(Spec().cell(n))[
                                      "driver"] == "pairs"])
def test_the_exchange_between_cards_left_out(monkeypatch, name):
    """The pair path over four shards (the spatial tier, as across four
    cards), each shard's ghost rows taken from its own rows (reflected) at
    every seam, as if no neighbour had sent its rows."""
    from akaze_tpu_torch.parallel import collectives

    def no_exchange(xs, mesh, axis, r, dim=0, edge="reflect"):
        if r == 0:
            return list(xs)
        return [torch.cat([collectives._edge_rows(x, r, dim, True, edge), x,
                           collectives._edge_rows(x, r, dim, False, edge)],
                          dim) for x in xs]
    assert run_small(name, shards=4)["result"]["correct"]
    monkeypatch.setattr(collectives, "extend_rows", no_exchange)
    assert not run_small(name, shards=4)["result"]["correct"]


@pytest.mark.parametrize("name", [n for n in CELLS if Spec().traffic(
    Spec().cell(n))["driver"] == "slam"])
def test_a_landmark_altered_where_it_is_produced(monkeypatch, name):
    """Every triangulated point of the two-view solve 1% farther: the
    depths the keyframes keep, and the scale propagated from them."""
    from akaze_tpu_torch.slam import odometry
    real = odometry.triangulate

    def farther(R, t, x1, x2):
        X, z1, z2 = real(R, t, x1, x2)
        return X * 1.01, z1 * 1.01, z2 * 1.01
    monkeypatch.setattr(odometry, "triangulate", farther)
    assert "depth_err" in failed(run_small(name))
