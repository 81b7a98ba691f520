"""One run of one cell: ``python -m cardbench --workload NAME --seed N
--seconds S --trace 0|1``, from the checkout's root.

Set-up (inputs from the seed on the device, the program, the warm-up of
every shape the cell uses) is timed as ``setup_s`` from the start of the
process; then the cell's driver runs its closed loop for ``--seconds``
with nothing left to compile.  With ``--trace 1`` the window carries CUDA
event spans, and a stretch of the same loop after it runs under the
profiler; the cell's per-layer readers take their metrics from both.
Once the window has closed and the peak memory is read, the program's
state is freed and a sample of what the window produced is held against
the plain reference: ``correct`` says whether every compared number lies
within its limit.  The last line of standard output is the result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

# top-level modules that no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "akaze_tpu")


def environment(root: Path) -> None:
    """Set before torch is imported: every build and kernel cache inside
    the checkout, at fixed paths (the program builds its kernels into
    ``akaze_tpu_torch/_build``), and one host thread for the CPU's
    arithmetic, so that a run's load is one process with few threads."""
    base = root / ".cardbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, str(base / sub))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def device_info(devices) -> dict:
    import torch
    cards = sorted({torch.device(d).index or 0 for d in devices})
    if torch.device(devices[0]).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(cards),
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cards[0]),
            "count": len(cards),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(c)
                                     for c in cards)}


def run_cell(spec, cell: dict, seed: int, seconds: float, trace: bool,
             devices=None, config=None, traffic=None, start=START) -> dict:
    """One run of ``cell``; ``devices`` (default: the cell's cards),
    ``config`` and ``traffic`` (default: their files) let a test run the
    same path on the CPU at a small size.  Returns the result's fields
    and the compared numbers (``check``)."""
    import torch
    from .trace import Spans, breakdown, profiled
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if devices is None:
        devices = [f"cuda:{i}" for i in range(cell["chips"])]
    config = config or spec.config(cell)
    traffic = traffic or spec.traffic(cell)
    limits = spec.limits(cell)
    spans = Spans(timed=bool(trace),
                  card=torch.device(devices[0]).type == "cuda")
    driver = spec.driver(traffic)(config, traffic, seed, devices, spans)
    driver.setup()
    # the loop itself until clocks and caches are steady, then from the top
    for _ in range(traffic.get("warm_steps", 0)):
        driver.step()
    driver.restart()
    sync(devices)
    setup_s = time.perf_counter() - start
    spans.clear()          # the warm-up's spans hold its captures

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        driver.step()
    sync(devices)
    window_s = time.perf_counter() - t0
    e2e = driver.end_to_end(window_s)
    e2e["setup_s"] = setup_s
    attempted = driver.done

    traced = None
    if trace:
        driver.begin_trace()

        def stretch():
            for _ in range(traffic["trace_steps"]):
                driver.step()
        traced = profiled(stretch, devices, spans)
        traced.facts.update(driver.facts())
    info = device_info(devices)

    driver.release()
    numbers = driver.check()
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in check.values())

    if trace:
        metrics = {}
        for m in spec.metrics(cell, "per_layer"):
            value = spec.reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = traced.busy_s()
        info["window_s"] = traced.window_s
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics(cell, "end_to_end")}
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else attempted, "metrics": metrics,
           "device": info}
    if trace:
        out["breakdown"] = breakdown(traced)
    out["check"] = check
    return {"result": out, "e2e": e2e, "driver": driver, "trace": traced}


def sync(devices) -> None:
    import torch
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cardbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from .spec import Spec
    spec = Spec()
    cell = spec.cell(args.workload)
    environment(spec.root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    res, e2e = run["result"], run["e2e"]
    notes = {k: v for k, v in e2e.items() if k not in res["metrics"]}
    if getattr(run["driver"], "shift_inliers", None) is not None:
        notes["shift_inliers"] = run["driver"].shift_inliers
    if run["trace"] is not None:
        t = run["trace"]
        notes["idle_share_by_card"] = {
            f"cuda:{c}": 1.0 - t.busy_s(c) / t.window_s
            for c in t.facts["cards"]}
    print("notes " + json.dumps(notes), file=sys.stderr)
    print(f"correct {res['correct']}", file=sys.stderr)
    for k, v in res["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
