"""The reference against the port on the CPU, and what each imports."""

from __future__ import annotations

import subprocess
import sys

import torch

from cardbench import gen
from cardbench.reference import akaze as R
from cardbench.spec import ROOT

BANNED = ("jax", "jaxlib", "flax", "akaze_tpu")


def test_reference_equals_the_port_on_a_small_seeded_pair():
    from akaze_tpu_torch import Akaze, AkazeConfig
    world = gen.texture(200, 280, 11, 0, "cpu")
    a, b = world[:180, :240], world[7:187, 13:253]
    cfg = dict(max_pts=2000, noctaves=2)
    plan = R.build_plan(180, 240, R.AkazeConfig(**cfg))
    ra, rb = R.detect_and_compute_batch(torch.stack([a, b]), plan)
    rm = R.match_features(ra, rb)
    det = Akaze(AkazeConfig(**cfg), device="cpu")
    fa, fb = det.detect_and_compute_pair(a.numpy(), b.numpy())
    m = det.match(fa, fb)
    assert int(ra.count) > 20
    for got, want in ((fa, ra), (fb, rb)):
        for field in ("x", "y", "layer", "response", "angle", "words",
                      "valid", "count"):
            assert torch.equal(getattr(got, field), getattr(want, field))
    for field in m._fields:
        assert torch.equal(getattr(m, field), getattr(rm, field))


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_reference_imports_neither_package():
    found = _modules_after("import cardbench.reference.akaze, "
                           "cardbench.reference.slam, cardbench.roofline")
    assert not found & set(BANNED)
    assert "akaze_tpu_torch" not in found


def test_a_run_loads_no_jax():
    """A whole small run of every cell, in a process of its own: nothing
    it loads is JAX or the JAX package (names compared whole)."""
    found = _modules_after(
        "from cardbench.tests.small import run_small\n"
        "from cardbench.spec import Spec\n"
        "for w in Spec().data['workloads']:\n"
        "    run_small(w['name'])\n")
    assert "akaze_tpu_torch" in found
    assert not found & set(BANNED)
