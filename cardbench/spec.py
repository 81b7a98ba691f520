"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration, traffic and metrics; each of those is a file of its own
under this folder, found by that name alone:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the mix's parameters, whose ``driver``
  names the general generator in ``drivers/`` that reads them;
* ``limits/<cell>.json``: each compared number's limit, with the readings
  it was set from;
* ``metrics/<metric>.py``: a reader of one per-layer metric.

Adding a cell, configuration, mix or metric adds files and entries; no
file here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root = Path(root)
        self.here = Path(here)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"]
                     if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.here / "traffic" /
                           f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        data = json.loads((self.here / "limits" /
                           f"{cell['name']}.json").read_text())
        return {k: v["limit"] for k, v in data.items()
                if not k.startswith("_")}

    def driver(self, traffic: dict):
        """The generator class that reads this mix."""
        module = importlib.import_module(
            f"{__package__}.drivers.{traffic['driver']}")
        return module.Driver

    def metrics(self, cell: dict, kind: str) -> list:
        """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
        this cell reports: each metric without a ``workloads`` list, and
        each whose list names the cell."""
        return [m for m in self.data[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str):
        """The ``read(trace)`` function of one per-layer metric."""
        path = self.here / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.metrics.{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
