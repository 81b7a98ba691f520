"""The frozen roofline arithmetic, counted by hand."""

from __future__ import annotations

import pytest

from cardbench import roofline as R


def test_k1_by_hand_at_a_small_shape():
    plan = R.plan_for(dict(max_pts=100, noctaves=1, max_scale=2), 100, 120)
    (o,) = plan.octaves
    px = 100 * 120
    # B = 1: the image read once, 2 sublevels x 4 planes written once
    nbytes, ops = R.k1_work(plan, 1)
    assert nbytes == 4 * px * (1 + 4 * 2)
    # sublevel 0: the base Gaussian (radius 4) and its derivatives, no
    # FED; sublevel 1: the sigma-1 Gaussian (radius 2), the flow and its
    # FED steps, the derivatives
    n = len(o.scales[1].taus)
    assert ops == px * (2 * (1 + 3 * 4) + 38 + 2 * (1 + 3 * 2) + 20
                        + 17 * n + 38)


def test_main_path_against_the_hand_counted_bounds():
    """PERF.md's hand counts at B = 2, 960x1280: K2 0.0060 ms and K4
    0.0020 ms at the main path's live counts; K1 0.078 ms tiled + 0.001
    resident, counting each tiled launch's input (the previous sublevel's
    L, a re-read): the frozen count reads each octave's input once, so it
    lies below by exactly those planes."""
    plan = R.plan_for(dict(max_pts=10000), 960, 1280)
    assert R.k2_bound_s(4025, 20000, 2) * 1e3 == pytest.approx(0.0060,
                                                               abs=5e-5)
    assert R.k4_bound_s(2017, 2008, 10000) * 1e3 == pytest.approx(0.0020,
                                                                  abs=5e-5)
    nbytes, _ = R.k1_work(plan, 2)
    reread = sum(4 * 2 * o.height * o.width * (len(o.scales) - 1)
                 for o in plan.octaves[:3])        # the three tiled octaves
    assert (nbytes + reread) / R.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        0.078 + 0.001, abs=5e-4)
    assert R.k1_bound_s(plan, 2) * 1e3 == pytest.approx(0.0672, abs=5e-4)


def test_bounds_take_the_larger_side():
    assert R.bound_s(R.HBM_BYTES_PER_S, 0, R.F32_OPS_PER_S) == 1.0
    assert R.bound_s(0, R.INT8_TC_OPS_PER_S, R.INT8_TC_OPS_PER_S) == 1.0
