"""The command as the checker runs it: refusals without a card or without
the program, and (on a card) one short run of each one-card cell."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from cardbench.spec import ROOT, Spec


def command(cwd, workload, seconds=2, trace=0, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "cardbench", "--workload", workload,
         "--seed", str(2 ** 33 + 5), "--seconds", str(seconds),
         "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs none")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def test_no_card_no_result(no_card):
    out = command(ROOT, "pair.vo.960x1280")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path, "pair.vo.960x1280")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in Spec().data[
    "workloads"] if w["chips"] == 1])
def test_a_short_run_on_the_card(cuda, name):
    out = command(ROOT, name, seconds=2)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
