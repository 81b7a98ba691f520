"""Worker of tests/test_torch_multiprocess.py (not collected by pytest).

Each of two processes owns four shards on the CPU, joins a two-process
``gloo`` group through ``initialize_distributed``, and runs the port's
sharded paths over meshes whose ``host`` (or ``data``) axis spans both
processes: landmark-sharded BA over ("chip", "host"), each collective,
the spatial front end with its halo exchange crossing the processes, and
the sharded matcher.  It writes its results for the parent to hold
against the one-process run of the same programs.

Usage: python torch_mp_worker.py <rank> <port> <out_prefix>
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SPATIAL_SHAPE = (224, 256)


def make_problem(n_cams: int = 5, n_pts: int = 48):
    """The deterministic BA problem of tests/mp_problem.py, built with the
    port (cameras on an arc looking at a point cloud, noisy landmarks)."""
    from akaze_tpu_torch.geometry import se3_exp, se3_inverse
    from akaze_tpu_torch.slam.ba import BAProblem

    rng = np.random.default_rng(1234)
    X = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3)).astype(np.float32)
    Rs, ts = [], []
    for c in range(n_cams):
        xi = torch.zeros(6)
        xi[0] = 0.4 * c
        xi[4] = 0.03 * c
        Ri, ti = se3_inverse(*se3_exp(xi))
        Rs.append(Ri.numpy())
        ts.append(ti.numpy())
    R, t = np.stack(Rs), np.stack(ts)
    cams, pts, uvs = [], [], []
    for c in range(n_cams):
        Xc = X @ R[c].T + t[c]
        uv = Xc[:, :2] / Xc[:, 2:3]
        for p in range(n_pts):
            if Xc[p, 2] > 0.5 and abs(uv[p, 0]) < 1 and abs(uv[p, 1]) < 1:
                cams.append(c)
                pts.append(p)
                uvs.append(uv[p])
    prob = BAProblem(torch.tensor(cams, dtype=torch.int32),
                     torch.tensor(pts, dtype=torch.int32),
                     torch.from_numpy(np.asarray(uvs, np.float32)),
                     torch.ones(len(cams)))
    X0 = X + rng.standard_normal(X.shape).astype(np.float32) * 0.04
    return torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(X0), prob


def collective_input():
    """48 rows of small integers: every sum is exact in any order."""
    return torch.arange(48 * 3, dtype=torch.float32).reshape(48, 3) % 17


def spatial_image():
    rng = np.random.default_rng(42)
    h, w = SPATIAL_SHAPE
    img = np.kron(rng.random((h // 8, w // 8)).astype(np.float32),
                  np.ones((8, 8), np.float32))
    img += 0.05 * rng.random((h, w)).astype(np.float32)
    return np.clip(img, 0, 1)


def match_input():
    rng = np.random.default_rng(3)
    n = 256
    w = rng.integers(0, 2 ** 32, (2, n, 16), dtype=np.uint32)
    w[..., 15] &= (1 << 6) - 1
    v2 = np.zeros(n, bool)
    for d, k in enumerate(rng.integers(3, 12, 8)):
        v2[d * 32:d * 32 + k] = True
    xy = rng.uniform(0, 100, (2, n)).astype(np.float32)
    return (torch.from_numpy(w[0].view(np.int32)), torch.ones(n, dtype=bool),
            torch.from_numpy(w[1].view(np.int32)), torch.from_numpy(v2),
            torch.from_numpy(xy[0]), torch.from_numpy(xy[1]))


def run(hc, dm) -> dict:
    """The programs, on a (host, chip) mesh and a data mesh; the same code
    runs in one process over eight local shards."""
    from akaze_tpu_torch import AkazeConfig, build_plan
    from akaze_tpu_torch import parallel as P
    from akaze_tpu_torch.parallel import collectives as col

    axes = ("chip", "host")
    R, t, X0, prob = make_problem()
    part = P.partition_landmarks(prob, X0.shape[0], 8)
    R1, t1, Xb, cost = P.landmark_sharded_bundle_adjust(
        R, t, P.gather_points(part, X0), part, hc, iters=4, cg_iters=12,
        axis=axes)
    out = {"R": R1.numpy(), "t": t1.numpy(), "cost": cost.numpy(),
           "X": P.scatter_points(part, col.all_gather(Xb, hc, axes,
                                                      home_only=True))}

    g = collective_input()
    xs = col.shard(g, dm)
    hs = col.shard(g, hc, axes)
    out["psum"] = torch.stack(col.psum(xs, dm)).numpy()
    out["pmax"] = torch.stack(col.pmax(xs, dm)).numpy()
    out["gather"] = torch.stack(col.all_gather(xs, dm)).numpy()
    out["extend"] = torch.stack(col.extend_rows(xs, dm, "data", 2)).numpy()
    out["extend_fill"] = torch.stack(col.extend_rows(
        xs, dm, "data", 3, edge=-5.0)).numpy()
    out["hc_psum"] = torch.stack(col.psum(hs, hc, axes)).numpy()
    out["hc_gather"] = torch.stack(col.all_gather(hs, hc, axes)).numpy()

    plan = build_plan(*SPATIAL_SHAPE, AkazeConfig(max_pts=1024))
    f = P.spatial_detect_and_compute(spatial_image(), plan, dm)
    for k in ("x", "y", "layer", "angle", "words", "valid", "count"):
        out["spatial_" + k] = getattr(f, k).numpy()

    m = P.gather_shards(P.sharded_match(*match_input(), dm, max_dist=486))
    out["match_index"] = m.index.numpy()
    out["match_distance"] = m.distance.numpy()
    return out


def main():
    rank, port, prefix = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from akaze_tpu_torch import parallel as P

    assert P.initialize_distributed(f"tcp://localhost:{port}", 2, rank)
    assert P.initialize_distributed()              # idempotent
    assert P.process_local_batch(8) == 4
    hc = P.make_host_chip_mesh(2, 4, devices=["cpu"] * 4)
    dm = P.make_mesh(8, devices=["cpu"] * 4)
    assert hc.shape == {"host": 2, "chip": 4} and dm.shape == {"data": 8}
    out = run(hc, dm)
    np.savez(f"{prefix}.{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {rank} done", flush=True)


if __name__ == "__main__":
    main()
