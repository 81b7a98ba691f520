"""Worker of tests/test_torch_multiprocess.py and the multi-process card
tests of tests/test_torch_cuda.py (not collected by pytest).

With two processes (the default), each owns four shards on the CPU, joins
a two-process ``gloo`` group through ``initialize_distributed``, and runs
the port's sharded paths over meshes whose ``host`` (or ``data``) axis
spans both processes: landmark-sharded BA over ("chip", "host"), each
collective, the spatial front end with its halo exchange crossing the
processes, and the sharded matcher.  With ``2x2`` each of two processes
owns two shards (two CPU shards on ``gloo``, or with ``cuda`` two cards of
its own, ``local_device_ids=[2 * rank, 2 * rank + 1]``, on NCCL) and runs
``run_hier``, JAX's (host, chip) runtime: the sums and the gather over
``"host"``, the halo exchange over a ``data`` axis of two shards per
process, landmark-sharded BA over ("chip", "host") and the multihost dp
step.  With four, each owns one shard (a CPU shard on ``gloo``, or with
``cuda`` its own card, ``local_device_ids=[rank]``, on NCCL) and runs
``run_four``: sums of real-valued inputs, sharded PGO and landmark-sharded
BA, whose results depend on the order of the sums across the processes.
With ``full`` two processes of four CPU shards run ``run_full``, the
counterpart of tests/test_multiprocess.py at its size.  It writes its
results for the parent to hold against the one-process run of the same
programs.

Usage: python torch_mp_worker.py <rank> <port> <out_prefix>
           [<world> [2x2 | full] [cuda]]
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


def make_frames(h: int = 96, w: int = 128, batch: int = 8):
    """The structured frame-pair batch of tests/mp_problem.py (blobby
    images with small per-frame shifts), built here without it."""
    rng = np.random.default_rng(77)
    hh, ww = h + 16, w + 16
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float64)
    img = np.zeros((hh, ww))
    for (cy, cx), s, a in zip(
            np.stack([rng.uniform(10, hh - 10, 30),
                      rng.uniform(10, ww - 10, 30)], -1),
            rng.uniform(2, 7, 30), rng.uniform(0.3, 1.0, 30)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += 0.05 * rng.standard_normal((hh, ww))
    img = np.clip(img, 0, 1).astype(np.float32)
    a = np.stack([img[i:i + h, i:i + w] for i in range(batch)])
    b = np.stack([img[i + 3:i + 3 + h, i + 5:i + 5 + w]
                  for i in range(batch)])
    return a, b


def make_big_image(h: int = 256, w: int = 320):
    """The blobby image of tests/mp_problem.py's spatial leg, built here
    without it."""
    rng = np.random.default_rng(55)
    base = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img += 0.05 * rng.random((h, w)).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


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


def real_input():
    """Normal float32 values: their sums depend on the order."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.standard_normal((4 * 96, 33))
                            .astype(np.float32))


def pose_graph():
    """24 drifted poses on a curve: a chain plus 20 seeded loop edges (one
    an outlier), in a seeded order so that each node's sums take terms
    from several edge shards; 48 edge slots."""
    from akaze_tpu_torch.geometry import se3_compose, se3_exp, se3_inverse
    from akaze_tpu_torch.parallel import pad_edges
    from akaze_tpu_torch.slam.posegraph import PoseGraph

    rng = np.random.default_rng(5)
    n = 24
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = np.arange(n) * 0.5
    xi[:, 4] = np.sin(np.arange(n) * 0.4) * 0.3
    Rt, tt = se3_exp(torch.from_numpy(xi))
    loops = rng.choice(n, (20, 2))
    loops = loops[loops[:, 0] != loops[:, 1]]
    ei = list(range(n - 1)) + loops[:, 0].tolist()
    ej = list(range(1, n)) + loops[:, 1].tolist()
    order = rng.permutation(len(ei))
    ei, ej = [ei[k] for k in order], [ej[k] for k in order]
    Ri, ti = se3_inverse(Rt[ei], tt[ei])
    Rij, tij = se3_compose(Ri, ti, Rt[ej], tt[ej])
    tij[0] += torch.tensor([1.5, 0.0, 0.0])
    g = pad_edges(PoseGraph(torch.tensor(ei, dtype=torch.int32),
                            torch.tensor(ej, dtype=torch.int32), Rij, tij,
                            torch.ones(len(ei))), 48)
    noise = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32)
                             * 0.05)
    noise[0] = 0
    return (*se3_compose(Rt, tt, *se3_exp(noise)), g)


def run_four(hc, dm) -> dict:
    """Sums of real-valued inputs, sharded PGO over ``data`` and
    landmark-sharded BA over ("chip", "host") on four shards; the same
    code runs in one process over four local shards."""
    from akaze_tpu_torch import parallel as P
    from akaze_tpu_torch.parallel import collectives as col

    home = dm.home
    g = real_input().to(home)
    out = {"psum": torch.stack(col.psum(col.shard(g, dm), dm)),
           "psum_home": col.psum_home(col.shard(g, dm), dm),
           "hc_psum": torch.stack(col.psum(col.shard(g, hc, ("chip", "host")),
                                           hc, ("chip", "host")))}
    R0, t0, graph = pose_graph()
    out["pgo_R"], out["pgo_t"], out["pgo_cost"] = \
        P.sharded_optimize_pose_graph(R0, t0, graph, dm, iters=4,
                                      cg_iters=20, robust="cauchy",
                                      robust_delta=0.5)
    R, t, X0, prob = make_problem()
    part = P.partition_landmarks(prob, X0.shape[0], 4)
    R1, t1, Xb, cost = P.landmark_sharded_bundle_adjust(
        R, t, P.gather_points(part, X0), part, hc, iters=4, cg_iters=12,
        axis=("chip", "host"))
    out.update(ba_R=R1, ba_t=t1, ba_cost=cost,
               ba_X=torch.as_tensor(P.scatter_points(part, col.all_gather(
                   Xb, hc, ("chip", "host"), home_only=True))))
    return {k: v.cpu().numpy() for k, v in out.items()}


DP_CFG = dict(max_pts=256, noctaves=2, dthreshold=1e-5)
DP_PAIRS = 4


def run_hier(hc, dm, rank=None) -> dict:
    """JAX's (host, chip) runtime on a (2, 2) mesh ``hc`` and a four-shard
    data mesh ``dm`` (two shards per process, or all four in one process):
    ``hier_psum``, ``psum`` and ``all_gather`` over ``"host"`` of
    real-valued inputs (``hier``, ``host_*``) and of integer-valued ones
    (``int_*``, exact in any order), ``extend_rows`` over ``data``,
    sharded PGO over ``data``, landmark-sharded BA over ("chip", "host")
    and the dp step on
    ``DP_PAIRS`` pairs (with ``rank``, this process's share through
    ``dp_pipeline_step_multihost``).  Per-shard outputs are stacked over
    this process's shards, in mesh order."""
    from akaze_tpu_torch import AkazeConfig, build_plan
    from akaze_tpu_torch import parallel as P
    from akaze_tpu_torch.parallel import collectives as col

    home, axes = hc.home, ("chip", "host")

    def stack(xs):
        return torch.stack([x.to(home) for x in xs])

    out = {}
    for tag, g in (("", real_input()[:64]), ("int_", collective_input())):
        xs = col.shard(g.to(home), hc, axes)
        out[tag + "hier"] = stack(P.hier_psum(xs, hc))
        out[tag + "host_psum"] = stack(col.psum(xs, hc, "host"))
        out[tag + "host_gather"] = stack(col.all_gather(xs, hc, "host"))
    ds = col.shard(real_input()[:64].to(home), dm)
    out["extend"] = stack(col.extend_rows(ds, dm, "data", 3))
    out["extend_fill"] = stack(col.extend_rows(ds, dm, "data", 2,
                                               edge=-5.0))
    R0, t0, graph = pose_graph()
    out["pgo_R"], out["pgo_t"], out["pgo_cost"] = \
        P.sharded_optimize_pose_graph(R0, t0, graph, dm, iters=4,
                                      cg_iters=20, robust="cauchy",
                                      robust_delta=0.5)
    R, t, X0, prob = make_problem()
    part = P.partition_landmarks(prob, X0.shape[0], 4)
    Xg = P.gather_points(part, X0).to(home)
    part = part._replace(prob=type(prob)(*(f.to(home) for f in part.prob)))
    R1, t1, Xb, cost = P.landmark_sharded_bundle_adjust(
        R.to(home), t.to(home), Xg, part, hc, iters=4, cg_iters=12,
        axis=axes)
    out.update(ba_R=R1, ba_t=t1, ba_cost=cost,
               ba_X=torch.as_tensor(P.scatter_points(part, col.all_gather(
                   Xb, hc, axes, home_only=True).cpu())))
    a, b = make_frames(96, 128, DP_PAIRS)
    plan = build_plan(96, 128, AkazeConfig(**DP_CFG))
    a, b = torch.as_tensor(a, device=home), torch.as_tensor(b, device=home)
    if rank is None:
        step = P.dp_pipeline_step(a, b, plan, dm)
    else:
        n = P.process_local_batch(DP_PAIRS)
        step = P.dp_pipeline_step_multihost(a[rank * n:(rank + 1) * n],
                                            b[rank * n:(rank + 1) * n],
                                            plan, dm)
    for name, shards in zip(("fa", "fb", "m"), step):
        for f in shards[0]._fields:
            out[f"dp_{name}_{f}"] = stack([getattr(x, f) for x in shards])
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_full(hc, dm, rank=None) -> dict:
    """tests/test_multiprocess.py's programs at its size on a (2, 4) mesh
    ``hc`` and an eight-shard data mesh ``dm``: landmark-sharded BA over
    ("chip", "host") (replicated results), the dp step on 8 pairs of
    96x128 (with ``rank``, this process's 4 through
    ``dp_pipeline_step_multihost``; per-shard counts, x and match
    indices), the gathered matcher on frames 0 and 4, and the spatial
    front end on a 256x320 image over ``dm`` (keypoints only, its halo
    crossing the processes between shards 3 and 4)."""
    from akaze_tpu_torch import AkazeConfig, build_plan
    from akaze_tpu_torch import parallel as P
    from akaze_tpu_torch.parallel import collectives as col
    from akaze_tpu_torch.pipeline import detect_and_compute

    axes = ("chip", "host")
    R, t, X0, prob = make_problem()
    part = P.partition_landmarks(prob, X0.shape[0], 8)
    R1, t1, Xb, cost = P.landmark_sharded_bundle_adjust(
        R, t, P.gather_points(part, X0), part, hc, iters=4, cg_iters=12,
        axis=axes)
    out = {"R": R1, "t": t1, "cost": cost,
           "X": torch.as_tensor(P.scatter_points(part, col.all_gather(
               Xb, hc, axes, home_only=True)))}
    cfg = AkazeConfig(max_pts=256, noctaves=2)
    plan = build_plan(96, 128, cfg)
    a, b = (torch.as_tensor(x) for x in make_frames(96, 128, 8))
    if rank is None:
        fa, fb, m = P.dp_pipeline_step(a, b, plan, dm)
    else:
        n = P.process_local_batch(8)
        fa, fb, m = P.dp_pipeline_step_multihost(
            a[rank * n:(rank + 1) * n], b[rank * n:(rank + 1) * n], plan, dm)
    fa, fb, m = (P.gather_shards(x) for x in (fa, fb, m))
    out.update(count=fa.count, x=fa.x, midx=m.index)
    # the gathered matcher: each process's first frames, queries sharded
    qs = [detect_and_compute(a[p * 4], plan) for p in (0, 1)]
    ts = [detect_and_compute(b[p * 4], plan) for p in (0, 1)]

    def cat(fs, k):
        return torch.cat([getattr(f, k) for f in fs])

    sm = P.gather_shards(P.sharded_match(
        cat(qs, "words"), cat(qs, "valid"), cat(ts, "words"),
        cat(ts, "valid"), cat(ts, "x"), cat(ts, "y"), dm, cfg.max_dist))
    out.update(sm_index=sm.index, sm_dist=sm.distance)
    plan_sp = build_plan(256, 320, AkazeConfig(max_pts=512))
    sp = P.spatial_detect_and_compute(make_big_image(256, 320), plan_sp, dm,
                                      describe=False)
    out.update({"spatial_" + k: getattr(sp, k)
                for k in ("count", "layer", "x", "y", "response")})
    return {k: v.cpu().numpy() for k, v in out.items()}


def card_programs(dm=None, hc=None) -> dict:
    """On this process's cards, over NCCL: the spatial program
    (``Akaze(mesh)``), sharded PGO and landmark-sharded BA, each captured
    (one graph per rank over its cards, holding its kernels and the NCCL
    calls), its replays equal to its eager call bit for bit with no host
    sync, and a repeated call capturing no new key; every mesh key of the
    process captured over its cards.  ``dm``, ``hc``: the meshes (default:
    four processes of one card each).  Returns the spatial features and
    the captured keys' count."""
    from torch.utils import _pytree as pytree
    from akaze_tpu_torch import Akaze, AkazeConfig, programs
    from akaze_tpu_torch import parallel as P

    if dm is None:
        dm, hc = P.make_mesh(4), P.make_host_chip_mesh(4, 1)
    home = dm.home
    det = Akaze(AkazeConfig(max_pts=1024), mesh=dm)
    img = torch.as_tensor(spatial_image(), device=home)
    R0, t0, graph = pose_graph()
    R0, t0 = R0.to(home), t0.to(home)
    graph = type(graph)(*(f.to(home) for f in graph))
    R, t, X0, prob = make_problem()
    part = P.partition_landmarks(prob, X0.shape[0], 4)
    Xg = P.gather_points(part, X0).to(home)
    part = part._replace(prob=type(prob)(*(f.to(home) for f in part.prob)))
    R, t = R.to(home), t.to(home)
    calls = {
        "spatial": lambda: det.detect_and_compute(img),
        "pgo": lambda: P.sharded_optimize_pose_graph(
            R0, t0, graph, dm, iters=4, cg_iters=20, robust="cauchy",
            robust_delta=0.5),
        "ba": lambda: P.landmark_sharded_bundle_adjust(
            R, t, Xg, part, hc, iters=4, cg_iters=12, axis=("chip", "host"))}
    out = {}
    for name, fn in calls.items():
        with programs.eager():
            want = pytree.tree_leaves(fn())
        fn()                                    # the capture
        captures = sum(p.captures for p in programs.programs())
        for d in dm.local_devices:
            torch.cuda.synchronize(d)
        torch.cuda.set_sync_debug_mode("error")
        try:
            replays = [pytree.tree_leaves(fn()) for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert sum(p.captures for p in programs.programs()) == captures, name
        for got in replays:
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        if name == "spatial":
            f = fn()
            for k in ("x", "y", "layer", "angle", "words", "valid", "count"):
                out["spatial_" + k] = getattr(f, k).cpu().numpy()
    keys = [s for s in programs.stats() if "Mesh(" in s["key"]]
    cards = [str(d) for d in dict.fromkeys(dm.local_devices)]
    # every key captured over the process's cards, its collectives across
    # the processes on NCCL (the dp step makes none)
    assert keys and all(
        not s["eager"] and s["cards"] == cards
        and s["nccl"] == (not s["program"].endswith("._dp_step"))
        for s in keys), keys
    out["captured_keys"] = np.array(len(keys))
    return out


def leave_together(prefix: str, rank: int, world: int,
                   timeout: float = 120.0) -> None:
    """Exit once every rank has written its results (each after its card
    finished its last collective), with no collective at teardown: the
    NCCL ranks' graphs hold the communicator, and a barrier or
    ``destroy_process_group`` there can wait forever."""
    import time
    open(f"{prefix}.{rank}.done", "w").close()
    t0 = time.monotonic()
    while not all(os.path.exists(f"{prefix}.{r}.done") for r in range(world)):
        if time.monotonic() - t0 > timeout:
            print(f"worker {rank}: the other ranks did not finish",
                  flush=True)
            os._exit(1)
        time.sleep(0.05)
    print(f"worker {rank} done", flush=True)
    os._exit(0)


def main():
    rank, port, prefix = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    world = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    card = "cuda" in sys.argv[5:]
    hier = "2x2" in sys.argv[5:]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from akaze_tpu_torch import parallel as P

    owned = None
    if card:
        owned = [2 * rank, 2 * rank + 1] if hier else [rank]
    assert P.initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                    local_device_ids=owned)
    assert P.initialize_distributed()              # idempotent
    if hier:
        devices = None if card else ["cpu"] * 2
        hc = P.make_host_chip_mesh(2, 2, devices=devices)
        dm = P.make_mesh(4, devices=devices)
        assert hc.shape == {"host": 2, "chip": 2} and dm.shape == {"data": 4}
        out = run_hier(hc, dm, rank)
        if card:
            out.update(card_programs(dm, hc))
            for d in dm.local_devices:
                torch.cuda.synchronize(d)
        np.savez(f"{prefix}.{rank}.npz", **out)
        if card:
            leave_together(prefix, rank, world)
        dist.barrier()
        dist.destroy_process_group()
        print(f"worker {rank} done", flush=True)
        return
    if "full" in sys.argv[5:]:
        out = run_full(P.make_host_chip_mesh(2, 4, devices=["cpu"] * 4),
                       P.make_mesh(8, devices=["cpu"] * 4), rank)
        np.savez(f"{prefix}.{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()
        print(f"worker {rank} done", flush=True)
        return
    if world == 4:
        devices = None if card else ["cpu"]
        out = run_four(P.make_host_chip_mesh(4, 1, devices=devices),
                       P.make_mesh(4, devices=devices))
        if card:
            out.update(card_programs())
            torch.cuda.synchronize()
        np.savez(f"{prefix}.{rank}.npz", **out)
        if card:
            leave_together(prefix, rank, world)
        dist.barrier()
        dist.destroy_process_group()
        print(f"worker {rank} done", flush=True)
        return
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
