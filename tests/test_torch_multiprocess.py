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
