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
"""

import os
import socket
import subprocess
import sys

import numpy as np
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
