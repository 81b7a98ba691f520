"""The port's multi-process runtime: two OS processes with four CPU shards
each, joined by ``initialize_distributed`` into one ``gloo`` group, run
the sharded programs of tests/torch_mp_worker.py over meshes whose
``host`` or ``data`` axis spans both processes, and must give the answers
of the same programs over eight shards in this one process.

Only the runtime differs (local sums and concatenations against
``torch.distributed``'s all-reduce, all-gather and point-to-point halo
exchange), so agreement validates the bootstrap, the meshes, every
collective across the process boundary, and the sums' fixed order: the
landmark-sharded BA over ("chip", "host") sums within a process first and
across the two processes last, in both runs, so its results are held
EXACTLY; so are the collectives (integer-valued inputs), the spatial front
end (its halo exchange between shards 3 and 4 crosses the processes) and
the sharded matcher.  Each worker has 60 s.

Four processes of one CPU shard each hold what two cannot show: sums of
REAL-valued inputs whose result depends on the order of their terms
(``psum``, sharded PGO's and landmark-sharded BA's), equal bit for bit to
the one-process mesh of the same shape and on every rank.

Two processes of two CPU shards each run JAX's own runtime shape, a
(host, chip) mesh with several chips per process: the sums and the gather
over ``"host"`` alone, the halo exchange over a ``data`` axis with two
shards per process, landmark-sharded BA and the multihost dp step, bit for
bit equal to the one-process (2, 2) mesh; the BA and the sums also match
JAX's in-process (2, 2) ``make_host_chip_mesh`` (BA within
tests/test_torch_parallel.py's tolerances, integer-valued sums and the
gather exactly).  The slow-marked full-size test is the counterpart of
tests/test_multiprocess.py at its size.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mp_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_workers(prefix: str, world: int, *extra: str) -> list:
    """Start ``world`` worker processes joined on a free port (``extra``:
    ``"cuda"`` for one card each on NCCL)."""
    port = free_port()
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mp_worker.py"), str(r),
         str(port), prefix, str(world), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def join_workers(procs: list, prefix: str, timeout: float = TIMEOUT_S):
    """Wait for the workers (killing any left at the end), fail with the
    tail of a failed worker's output, and load their results."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return [np.load(f"{prefix}.{r}.npz") for r in range(len(procs))]


def test_two_processes_equal_one(tmp_path):
    from akaze_tpu_torch import parallel as P

    prefix = str(tmp_path / "mp")
    port = free_port()
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mp_worker.py"), str(r),
         str(port), prefix], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in (0, 1)]
    # the one-process reference runs while the workers do
    torch.set_num_threads(1)
    ref = worker.run(P.make_host_chip_mesh(2, 4, devices=["cpu"] * 8),
                     P.make_mesh(8, devices=["cpu"] * 8))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    got = [np.load(f"{prefix}.{r}.npz") for r in (0, 1)]
    for g in got:
        # replicated results: equal in both processes, and to one process
        for k in ("R", "t", "cost", "X") + tuple(
                k for k in ref if k.startswith("spatial_")):
            np.testing.assert_array_equal(g[k], ref[k], err_msg=k)
    assert ref["spatial_count"] > 200
    assert float(ref["cost"]) < 1e-6
    # per-shard results: each process holds its own shards
    hc_local = {0: [0, 1, 2, 3], 1: [4, 5, 6, 7]}      # host-major order
    for r, g in enumerate(got):
        own = slice(4 * r, 4 * r + 4)
        for k in ("psum", "pmax", "gather", "extend", "extend_fill"):
            np.testing.assert_array_equal(g[k], ref[k][own], err_msg=k)
        for k in ("match_index", "match_distance"):   # this host's queries
            np.testing.assert_array_equal(g[k], ref[k][128 * r:128 * r + 128],
                                          err_msg=k)
        for k in ("hc_psum", "hc_gather"):
            np.testing.assert_array_equal(g[k], ref[k][hc_local[r]],
                                          err_msg=k)


def test_four_processes_sum_as_one(tmp_path):
    """Four gloo processes of one CPU shard each: ``psum`` of real-valued
    inputs, sharded PGO over ``data`` and landmark-sharded BA over
    ("chip", "host") equal the one-process four-shard meshes bit for bit,
    on every rank (the cross-process sums all-gather every shard's operand
    and fold them in index order; an ``all_reduce`` sums in the backend's
    order, which differs from it for real values)."""
    from akaze_tpu_torch import parallel as P

    prefix = str(tmp_path / "mp4")
    procs = spawn_workers(prefix, 4)
    torch.set_num_threads(1)
    ref = worker.run_four(P.make_host_chip_mesh(4, 1, devices=["cpu"] * 4),
                          P.make_mesh(4, devices=["cpu"] * 4))
    got = join_workers(procs, prefix)
    # the inputs are real-valued: another order of the terms moves bits
    g = worker.real_input().numpy()
    assert not np.array_equal(((g[:96] + g[96:192]) + g[192:288]) + g[288:],
                              (g[:96] + g[96:192]) + (g[192:288] + g[288:]))
    from akaze_tpu_torch.slam.posegraph import pose_graph_cost
    assert (float(ref["pgo_cost"])
            < 0.9 * float(pose_graph_cost(*worker.pose_graph())))
    assert float(ref["ba_cost"]) < 1e-6
    for r, gr in enumerate(got):
        assert sorted(gr.files) == sorted(ref)
        for k in ref:      # per-shard sums: this rank's one shard
            want = ref[k][r:r + 1] if k in ("psum", "hc_psum") else ref[k]
            np.testing.assert_array_equal(gr[k], want, err_msg=f"rank {r} {k}")


# the shards of the one-process (2, 2) mesh that each process holds (its
# host's two chips, host-major)
HIER_LOCAL = {0: slice(0, 2), 1: slice(2, 4)}
HIER_REPLICATED = ("ba_R", "ba_t", "ba_cost", "ba_X", "pgo_R", "pgo_t",
                   "pgo_cost")


def _ba_close(got, want):
    """tests/test_torch_parallel.py's BA tolerances (the JAX tests')."""
    R, t, X, c = (np.asarray(v) for v in got)
    np.testing.assert_allclose(float(c), float(want[3]), rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(X, np.asarray(want[2]), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(R, np.asarray(want[0]), atol=1e-4)


def jax_hier_runtime():
    """JAX's in-process (2, 2) ``make_host_chip_mesh`` (four of the eight
    virtual CPU devices) on the worker's inputs: ``hier_psum``, ``psum``
    and tiled ``all_gather`` over ``"host"`` of the integer-valued input
    (blocks in the port's shard order: shard (h, c) holds block c * 2 + h)
    and landmark-sharded BA over ("chip", "host")."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS
    from akaze_tpu import parallel as jpar
    from akaze_tpu.slam import ba as jba

    mesh = jpar.make_host_chip_mesh(num_hosts=2, chips_per_host=2)
    axes = ("chip", "host")
    g = worker.collective_input().numpy()
    order = [0, 2, 1, 3]                # port shard i = (h, c) -> block

    def per_shard(fn):
        out = shard_map(fn, mesh=mesh, in_specs=PS(axes),
                        out_specs=PS(axes), check_vma=False)(g)
        return np.asarray(out).reshape(4, -1, g.shape[1])[order]

    out = {"int_hier": per_shard(jpar.hier_psum),
           "int_host_psum": per_shard(lambda a: jax.lax.psum(a, "host")),
           "int_host_gather": per_shard(
               lambda a: jax.lax.all_gather(a, "host", tiled=True))}
    R, t, X0, prob = worker.make_problem()
    jprob = jba.BAProblem(*(jnp.asarray(f.numpy()) for f in prob))
    part = jpar.partition_landmarks(jprob, X0.shape[0], 4)
    Rj, tj, Xj, cj = jpar.landmark_sharded_bundle_adjust(
        jnp.asarray(R.numpy()), jnp.asarray(t.numpy()),
        jpar.gather_points(part, X0.numpy()), part, mesh, iters=4,
        cg_iters=12, axis=axes)
    out["ba"] = (Rj, tj, jpar.scatter_points(part, Xj), cj)
    return out


def test_two_processes_of_two_shards_equal_one(tmp_path):
    """JAX's (host, chip) runtime shape: two gloo processes of two CPU
    shards each equal the one-process (2, 2) mesh bit for bit, on every
    rank, in every sum (real-valued inputs: the order of their terms moves
    bits), gather, halo exchange (its seam between the processes' edge
    shards), sharded PGO, landmark-sharded BA and the multihost dp step;
    the BA and the sums match JAX's (2, 2) mesh."""
    from akaze_tpu_torch import parallel as P

    prefix = str(tmp_path / "hier")
    procs = spawn_workers(prefix, 2, "2x2")
    torch.set_num_threads(1)
    ref = worker.run_hier(P.make_host_chip_mesh(2, 2, devices=["cpu"] * 4),
                          P.make_mesh(4, devices=["cpu"] * 4))
    jx = jax_hier_runtime()
    got = join_workers(procs, prefix)
    g = worker.real_input()[:64].numpy()
    assert not np.array_equal((g[:16] + g[32:48]) + (g[16:32] + g[48:]),
                              ((g[:16] + g[16:32]) + g[32:48]) + g[48:])
    assert float(ref["ba_cost"]) < 1e-6
    from akaze_tpu_torch.slam.posegraph import pose_graph_cost
    assert (float(ref["pgo_cost"])
            < 0.9 * float(pose_graph_cost(*worker.pose_graph())))
    assert int(ref["dp_fa_count"].min()) > 20
    assert int((ref["dp_m_index"] >= 0).sum()) > 40
    for r, gr in enumerate(got):
        assert sorted(gr.files) == sorted(ref)
        for k in ref:
            want = (ref[k] if k in HIER_REPLICATED
                    else ref[k][HIER_LOCAL[r]])
            np.testing.assert_array_equal(gr[k], want, err_msg=f"rank {r} {k}")
    for k in ("int_hier", "int_host_psum", "int_host_gather"):
        np.testing.assert_array_equal(ref[k], jx[k], err_msg=k)
    _ba_close([ref[k] for k in ("ba_R", "ba_t", "ba_X", "ba_cost")],
              jx["ba"])


@pytest.mark.slow
def test_two_processes_full_size_equal_one(tmp_path):
    """The counterpart of tests/test_multiprocess.py at its size: two gloo
    processes of four CPU shards, a (2, 4) mesh: landmark-sharded BA equal
    bit for bit to the one-process mesh and within the BA tolerances of
    JAX's single-process (2, 4) run; the dp step on 8 pairs of 96x128 (4
    per process), the gathered matcher and the spatial front end on a
    256x320 image (its halo exchange crossing the processes between shards
    3 and 4) equal bit for bit to the one-process mesh, the spatial
    keypoints' counts and layers those of the unsharded path."""
    import jax.numpy as jnp
    from akaze_tpu import parallel as jpar
    from akaze_tpu.slam import ba as jba
    from akaze_tpu_torch import AkazeConfig, build_plan
    from akaze_tpu_torch import parallel as P
    from akaze_tpu_torch.pipeline import detect_and_compute

    prefix = str(tmp_path / "full")
    procs = spawn_workers(prefix, 2, "full")
    torch.set_num_threads(1)
    ref = worker.run_full(P.make_host_chip_mesh(2, 4, devices=["cpu"] * 8),
                          P.make_mesh(8, devices=["cpu"] * 8))
    R, t, X0, prob = worker.make_problem()
    jprob = jba.BAProblem(*(jnp.asarray(f.numpy()) for f in prob))
    part = jpar.partition_landmarks(jprob, X0.shape[0], 8)
    Rj, tj, Xj, cj = jpar.landmark_sharded_bundle_adjust(
        jnp.asarray(R.numpy()), jnp.asarray(t.numpy()),
        jpar.gather_points(part, X0.numpy()), part,
        jpar.make_host_chip_mesh(num_hosts=2, chips_per_host=4), iters=4,
        cg_iters=12, axis=("chip", "host"))
    unsharded = detect_and_compute(torch.as_tensor(
        worker.make_big_image(256, 320)),
                                   build_plan(256, 320,
                                              AkazeConfig(max_pts=512)),
                                   describe=False)
    got = join_workers(procs, prefix, timeout=600)
    _ba_close([ref[k] for k in ("R", "t", "X", "cost")],
              (Rj, tj, jpar.scatter_points(part, Xj), cj))
    n = int(ref["spatial_count"])
    assert n == int(unsharded.count) and n > 100
    np.testing.assert_array_equal(ref["spatial_layer"][:n],
                                  unsharded.layer[:n].numpy())
    assert int(ref["count"].min()) > 5
    # per process: its 4 pairs of the dp step, its half of the queries
    per_process = ("count", "x", "midx", "sm_index", "sm_dist")
    for r, gr in enumerate(got):
        assert sorted(gr.files) == sorted(ref)
        for k in ref:
            n = ref[k].shape[0] // 2 if k in per_process else None
            want = ref[k][n * r:n * r + n] if n else ref[k]
            np.testing.assert_array_equal(gr[k], want, err_msg=f"rank {r} {k}")
