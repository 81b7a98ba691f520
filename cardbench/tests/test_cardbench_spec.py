"""BENCHMARK.json against the benchmark's contract, and the harness found
by name: a cell, configuration, mix, limit file or metric dropped into a
copy is found without an edit to any file already there."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from cardbench.spec import ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len(names) == len(set(names))
    metric_names = [m["name"] for g in ("end_to_end", "per_layer")
                    for m in bench[g]]
    assert len(metric_names) == len(set(metric_names))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_command_and_paths_stay_inside(bench):
    for p in bench["paths"]:
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert len(bench["command"]) <= 32
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        for key in c["reduced"]:
            assert NAME.match(key)


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_reports_what_it_must(bench):
    spec = Spec()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics(w, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w, "per_layer")
        assert spec.config(w) and spec.traffic(w) and spec.limits(w)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_moves_is_reported_by_every_listed_cell(bench):
    spec = Spec()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for name in m["workloads"]:
            cell = spec.cell(name)
            reported = [x["name"] for x in spec.metrics(cell, "end_to_end")]
            assert m["moves"] in reported, (m["name"], name)
        assert callable(spec.reader(m["name"]))


def test_layers_are_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    for layer in layers:
        assert 1 <= len(layer) <= 200 and "\n" not in layer


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_pieces_are_found_by_name(tmp_path, bench):
    """A new cell with its own configuration, mix, limits and per-layer
    metric: new files and new entries only."""
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "cardbench")
    here = tmp_path / "cardbench"
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg["akaze"]["diffusivity"] = "PM_G1"
    (here / "configs" / "demo-pm-g1.json").write_text(json.dumps(cfg))
    (here / "traffic" / "vo-pool2.json").write_text(json.dumps(
        {"driver": "pairs", "pool": 2, "max_shift": 8, "sample": 1,
         "trace_steps": 1}))
    (here / "limits" / "pair.g1.json").write_text(json.dumps(
        {"kp_unpaired": {"limit": 0.5}}))
    (here / "metrics" / "pairs.traced.py").write_text(
        "def read(trace):\n    return trace.facts.get('pairs')\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append(dict(bench["configs"][0], name="demo-pm-g1",
                               file="cardbench/configs/demo-pm-g1.json"))
    new["workloads"].append({"name": "pair.g1", "config": "demo-pm-g1",
                             "traffic": "vo-pool2", "chips": 1,
                             "why": "a test cell"})
    new["per_layer"].append({"name": "pairs.traced", "unit": "pairs",
                             "better": "higher", "source": "program_counter",
                             "layer": "entry", "moves": "setup_s",
                             "workloads": ["pair.g1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    spec = Spec(tmp_path, here)
    cell = spec.cell("pair.g1")
    assert spec.config(cell)["akaze"]["diffusivity"] == "PM_G1"
    assert spec.traffic(cell)["pool"] == 2
    assert spec.limits(cell) == {"kp_unpaired": 0.5}
    assert spec.driver(spec.traffic(cell)).__module__.endswith("pairs")
    assert [m["name"] for m in spec.metrics(cell, "per_layer")] == [
        "pairs.traced"]

    class Facts:
        facts = {"pairs": 3}
    assert spec.reader("pairs.traced")(Facts()) == 3
    after = _digest(here)
    assert all(after[k] == v for k, v in before.items())
