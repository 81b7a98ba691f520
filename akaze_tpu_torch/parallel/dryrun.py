"""One small step of every sharded path on an n-shard mesh: the port's
counterpart of ``__graft_entry__.dryrun_multichip``."""

from __future__ import annotations

import numpy as np
import torch

from ..config import AkazeConfig
from ..geometry.se3 import se3_exp, se3_inverse
from ..plan import build_plan
from ..slam.ba import BAProblem
from ..slam.posegraph import PoseGraph
from .data_parallel import dp_pipeline_step, gather_shards
from .distributed import make_host_chip_mesh
from .mesh import make_mesh
from .sharded_ba import (gather_points, landmark_sharded_bundle_adjust,
                         pad_observations, partition_landmarks,
                         sharded_bundle_adjust)
from .sharded_match import sharded_match
from .sharded_pgo import pad_edges, sharded_optimize_pose_graph
from .spatial import spatial_detect_and_compute, spatial_supported


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run, on an ``n_devices``-shard mesh: a data-parallel step over
    ``n_devices`` image pairs, the sharded matcher on its first pair, the
    observation-sharded BA, the edge-sharded PGO, the landmark-sharded BA
    on a (2, n/2) host/chip mesh, and the spatial front end on two shards.
    ``devices``: the mesh's devices (default: the first ``n_devices``
    visible cards; raises when fewer are visible).  Returns the results'
    summary; raises where one is not finite or not shaped as expected."""
    mesh = make_mesh(n_devices, devices=devices)
    devs = mesh.local_devices
    rng = np.random.default_rng(0)
    h, w = 160, 192
    cfg = AkazeConfig(max_pts=256, noctaves=2)
    plan = build_plan(h, w, cfg)
    imgs_a = rng.uniform(0, 1, (n_devices, h, w)).astype(np.float32)
    imgs_b = imgs_a + 0.01 * rng.standard_normal(
        (n_devices, h, w)).astype(np.float32)
    fa, fb, m = (gather_shards(x) for x in dp_pipeline_step(
        imgs_a, imgs_b, plan, mesh))
    counts = fa.count.numpy()
    assert counts.shape == (n_devices,), counts.shape

    sm = gather_shards(sharded_match(
        fa.words[0], fa.valid[0], fb.words[0], fb.valid[0], fb.x[0],
        fb.y[0], mesh, cfg.max_dist))
    assert sm.index.shape == (cfg.max_pts,)

    # BA: observations sharded, the Schur CG's sums reduced over the mesh
    n_cams, n_pts = 4, 24
    X = torch.as_tensor(rng.uniform([-2, -2, 6], [2, 2, 10], (n_pts, 3)),
                        dtype=torch.float32)
    Rs, ts = [], []
    for c in range(n_cams):
        xi = torch.zeros(6)
        xi[0] = 0.3 * c
        Ri, ti = se3_inverse(*se3_exp(xi))
        Rs.append(Ri)
        ts.append(ti)
    R, t = torch.stack(Rs), torch.stack(ts)
    cam = torch.arange(n_cams, dtype=torch.int32).repeat_interleave(n_pts)
    pt = torch.arange(n_pts, dtype=torch.int32).repeat(n_cams)
    Xc = torch.einsum("cij,pj->cpi", R, X) + t[:, None, :]
    uv = (Xc[..., :2] / Xc[..., 2:3]).reshape(-1, 2)
    prob = pad_observations(BAProblem(cam, pt, uv, torch.ones(len(cam))),
                            n_devices)
    X0 = X + 0.01
    *_, ba_cost = sharded_bundle_adjust(R, t, X0, prob, mesh, iters=2,
                                        cg_iters=10)
    assert np.isfinite(float(ba_cost))

    # PGO: edges sharded, J^T J v summed over the mesh
    n_nodes = 6
    Rg = torch.eye(3).expand(n_nodes, 3, 3).contiguous()
    tg = torch.arange(n_nodes, dtype=torch.float32)[:, None] * torch.tensor(
        [1.0, 0.0, 0.0])
    ei = torch.arange(n_nodes - 1, dtype=torch.int32)
    g = pad_edges(PoseGraph(
        i=ei, j=ei + 1, R_ij=torch.eye(3).expand(n_nodes - 1, 3, 3),
        t_ij=torch.tensor([1.0, 0.0, 0.0]).expand(n_nodes - 1, 3),
        weight=torch.ones(n_nodes - 1)), n_devices)
    *_, pgo_cost = sharded_optimize_pose_graph(Rg, tg + 0.05, g, mesh,
                                               iters=3, cg_iters=10)
    assert np.isfinite(float(pgo_cost))

    # landmark blocks on a (host, chip) mesh: one [C, 6] sum per CG step
    hc_cost = float("nan")
    if n_devices % 2 == 0:
        mesh_hc = make_host_chip_mesh(2, n_devices // 2, devices=devs)
        part = partition_landmarks(prob, n_pts, n_devices)
        *_, c = landmark_sharded_bundle_adjust(
            R, t, gather_points(part, X0), part, mesh_hc, iters=2,
            cg_iters=10, axis=("chip", "host"))
        hc_cost = float(c)
        assert np.isfinite(hc_cost)

    # spatial front end on two shards (288x160: the WSIZE/2 descriptor
    # halo needs 65 local rows in octave 0)
    sp_count = -1
    if n_devices >= 2:
        hs, ws = 288, 160
        plan_sp = build_plan(hs, ws, cfg)
        ok, why = spatial_supported(plan_sp, 2, detect=True, describe=True)
        assert ok, why
        img = rng.uniform(0, 1, (hs, ws)).astype(np.float32)
        f = spatial_detect_and_compute(img, plan_sp,
                                       make_mesh(2, devices=devs[:2]))
        sp_count = int(f.count)
    return {"counts": counts.tolist(), "matched": int((sm.index >= 0).sum()),
            "ba_cost": float(ba_cost), "pgo_cost": float(pgo_cost),
            "hostchip_lm_ba_cost": hc_cost, "spatial_count": sp_count}
