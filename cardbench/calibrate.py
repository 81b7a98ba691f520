"""The readings that a cell's limits are set from, on the card.

``python -m cardbench.calibrate --workload NAME --seeds A,B,... --seconds S
[--control N] [--out FILE]`` runs the cell once per seed in one process
(each a short window, then the comparison) and prints each seed's
compared numbers: the program's readings.  With ``--control N`` it then
puts the reference computed one precision below the configuration's in
the program's place, on the first N seeds' samples: the control's
readings, which the limits must fail.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .run import environment, run_cell
from .spec import Spec

# the precision below the configuration's float32: its planes in bfloat16
CONTROL_DTYPE = torch.bfloat16


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cardbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    spec = Spec()
    environment(spec.root)
    cell = spec.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = run_cell(spec, cell, seed, args.seconds, False, start=t0)
        rows = [dict(kind="program", seed=seed,
                     numbers={k: v["value"] for k, v in
                              run["result"]["check"].items()},
                     correct=run["result"]["correct"],
                     e2e=run["e2e"],
                     shift_inliers=getattr(run["driver"], "shift_inliers",
                                           None))]
        if i < args.control:
            rows.append(dict(kind="control", seed=seed,
                             numbers=run["driver"].check(
                                 lower=CONTROL_DTYPE)))
        for row in rows:
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
