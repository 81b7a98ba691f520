"""The port's row-sharded tier (``akaze_tpu_torch.parallel.spatial``)
against the JAX package's and against the port's own unsharded pipeline, on
the CPU (several shards on one CPU device).

The plain versions run here: each stencil with its own exchange, and the
gathered octaves through ``ops.sublevel.octave``'s plain version.

Tolerances:
  - ``spatial_supported`` and the routing rule equal to JAX's and to the
    stated table exactly;
  - scale space: the 16.16 fixed path bit-exact against both the JAX tier
    and the port's unsharded scale space; the float path equal to the
    port's unsharded planes bit for bit and within 1e-5 of each plane's
    max of JAX's (tests/test_spatial.py:38-56), kcontrast within 1e-6
    relative (tests/test_torch_ops.py);
  - detection and description: against the port's unsharded path every
    field exactly, in all four flavours (float on bf16 and on f32 planes,
    fixed exact and approximate); against the JAX tier counts and layers
    exactly, x/y within one float32 ulp at 128-256 px, 2^-16 = 1.53e-5 px
    (P1-1's bound: torch and XLA round the refinement's divisions
    differently), angles within 1e-3 rad, 0 flipped
    descriptor bits (the approximate fixed flavour has no JAX counterpart
    outside Pallas interpret mode; tests/test_torch_pipeline.py holds the
    unsharded one to it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu import parallel as jpar
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu_torch import (Akaze, AkazeConfig, build_plan, config_from,
                             detect_and_compute)
from akaze_tpu_torch import parallel as tpar
from akaze_tpu_torch.descriptor import words_to_numpy
from akaze_tpu_torch.parallel import collectives as col
from akaze_tpu_torch.scale_space import build_scale_space

torch.set_num_threads(1)

H, W = 224, 256
MAX_PTS = 1024
PLANE_TOL = 1e-5
XY_TOL = 2.0 ** -16      # one float32 ulp at 128-256 px: P1-1's 1.5e-5 px
FLAVOURS = {
    "float": (False, {}),
    "float_f32": (False, {"bf16_sampling": False}),
    "fixed_exact": (True, {"fixed_exact_sampling": True}),
    "fixed_approx": (True, {}),
}


def blob_image(seed=42, h=H, w=W):
    """Random 8x8 blobs plus noise (tests/test_spatial.py's image)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img += 0.05 * rng.random((h, w)).astype(np.float32)
    return np.clip(img, 0, 1)


def image_for(fixed):
    img = blob_image()
    return (img * 255).astype(np.int32) if fixed else img


def cpu_mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------

SHAPES = [(960, 1280, 4), (1920, 2560, 4), (480, 640, 4), (1280, 1920, 5),
          (224, 256, 4), (256, 320, 4), (512, 160, 3), (1024, 160, 4),
          (160, 200, 4), (162, 200, 4), (201, 333, 4)]


def test_spatial_supported_equals_jax():
    for h, w, no in SHAPES:
        jp = jbuild_plan(h, w, JConfig(noctaves=no))
        tp = build_plan(h, w, AkazeConfig(noctaves=no))
        for n in (1, 2, 3, 4, 8):
            for kw in ({}, {"detect": True},
                       {"detect": True, "describe": True}):
                assert (tpar.spatial_supported(tp, n, **kw)
                        == jpar.spatial_supported(jp, n, **kw)), (h, w, n, kw)


@pytest.mark.parametrize("h,w,no,n,ok", [
    (960, 1280, 4, 2, True), (960, 1280, 4, 4, True),
    (960, 1280, 4, 8, False), (1920, 2560, 4, 2, True),
    (1920, 2560, 4, 4, True), (1920, 2560, 4, 8, True),
    (480, 640, 4, 2, True), (480, 640, 4, 4, True), (480, 640, 4, 8, True),
    (1280, 1920, 5, 2, False), (1280, 1920, 5, 4, False),
    (1280, 1920, 5, 8, False)])
def test_supported_table(h, w, no, n, ok):
    plan = build_plan(h, w, AkazeConfig(noctaves=no))
    got, why = tpar.spatial_supported(plan, n, detect=True, describe=True)
    assert got == ok, why
    if (h, n) == (960, 8):
        assert "octave 3 needs halo 29" in why and "15" in why


def test_route_and_predicted_launches():
    """Thin and resident-sized octaves gather whole; the rest run sharded
    on the tiled kernel, as many launches per shard as the unsharded
    octave has."""
    plan = build_plan(960, 1280, AkazeConfig())
    for n in (2, 4):
        assert tpar.spatial_route(plan, n) == (False, False, False, True)
        assert tpar.spatial_launches(plan, n) == {"tiled": 12, "resident": 1}
    big = build_plan(1920, 2560, AkazeConfig())
    assert tpar.spatial_route(big, 4) == (False,) * 4
    assert tpar.spatial_route(big, 8) == (False, False, False, True)
    assert tpar.spatial_launches(big, 8) == {"tiled": 16, "resident": 0}
    slam = build_plan(480, 640, AkazeConfig(max_pts=4000))
    assert tpar.spatial_route(slam, 4) == (False, False, True)
    assert tpar.spatial_launches(slam, 4) == {"tiled": 8, "resident": 1}
    assert tpar.spatial_route(build_plan(H, W, AkazeConfig()), 4) == (
        False, True)


# --------------------------------------------------------------------------
# the scale space
# --------------------------------------------------------------------------

def _gathered(octs, mesh):
    """Each octave's planes gathered whole (rows in mesh order)."""
    return [[col.all_gather([o[oi][k] for o in octs], mesh, "data", dim=1,
                            home_only=True) for k in range(4)]
            for oi in range(len(octs[0]))]


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_spatial_scale_space_matches_unsharded_and_jax(fixed):
    x = image_for(fixed)
    cfg = AkazeConfig()
    plan = build_plan(H, W, cfg)
    ref, ref_kc = build_scale_space(torch.as_tensor(x), plan)
    jplan = jbuild_plan(H, W, JConfig())
    jo, jkc = jax.jit(lambda a: jpar.spatial_scale_space(
        a, jplan, jpar.make_mesh(8), fixed=fixed))(jnp.asarray(x))
    for n in (4, 8):
        mesh = cpu_mesh(n)
        octs, kc = tpar.spatial_scale_space(x, plan, mesh, fixed=fixed)
        assert len(octs) == n
        assert torch.equal(kc, ref_kc)
        if fixed:
            assert int(kc) == int(jkc)
        else:
            np.testing.assert_allclose(float(kc), float(jkc), rtol=1e-6)
        for oi, planes in enumerate(_gathered(octs, mesh)):
            for k, name in enumerate(("L", "det", "lx", "ly")):
                assert torch.equal(planes[k], ref[oi][k]), (n, oi, name)
                want = np.asarray(getattr(jo[oi], name))
                if fixed:
                    np.testing.assert_array_equal(planes[k].numpy(), want)
                else:
                    scale = max(float(np.abs(want).max()), 1e-6)
                    np.testing.assert_allclose(planes[k].numpy(), want,
                                               rtol=0,
                                               atol=PLANE_TOL * scale)


# --------------------------------------------------------------------------
# detection and description
# --------------------------------------------------------------------------

_UNSHARDED = {}


def unsharded(flavour):
    if flavour not in _UNSHARDED:
        fixed, kw = FLAVOURS[flavour]
        plan = build_plan(H, W, AkazeConfig(max_pts=MAX_PTS, **kw))
        _UNSHARDED[flavour] = detect_and_compute(
            torch.as_tensor(image_for(fixed)), plan, fixed=fixed)
    return _UNSHARDED[flavour]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_spatial_detect_and_compute_equals_unsharded(flavour, n):
    """Every field equal to the unsharded pipeline's.  At 224x256 octave 0
    runs sharded and octave 1 gathered; the descriptor's octave 0 is
    halo-extended over 2 shards and gathered over 4 and 8."""
    fixed, kw = FLAVOURS[flavour]
    plan = build_plan(H, W, AkazeConfig(max_pts=MAX_PTS, **kw))
    got = tpar.spatial_detect_and_compute(image_for(fixed), plan,
                                          cpu_mesh(n), fixed=fixed)
    want = unsharded(flavour)
    count = int(want.count)
    assert 200 < count < MAX_PTS and not bool(want.overflow)
    layers = want.layer[:count].numpy() // plan.config.max_scale
    assert layers.min() == 0 and layers.max() == 1
    assert_same_features(got, want)


def assert_same_features(got, want):
    """Validity, count, overflow and every live slot equal (dead slots
    hold zeros after the gather, as in the JAX tier)."""
    count = int(want.count)
    for f, v in want._asdict().items():
        g = getattr(got, f)
        if f in ("valid", "count", "overflow"):
            assert torch.equal(g, v), f
        else:
            assert torch.equal(g[:count], v[:count]), f


def _circular(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("flavour,n", [("float", 4), ("float_f32", 2),
                                       ("fixed_exact", 8)])
def test_spatial_detect_and_compute_matches_jax(flavour, n):
    fixed, kw = FLAVOURS[flavour]
    cfg = AkazeConfig(max_pts=MAX_PTS, **kw)
    jplan = jbuild_plan(H, W, JConfig(max_pts=MAX_PTS, **kw))
    x = image_for(fixed)
    want = jax.jit(lambda a: jpar.spatial_detect_and_compute(
        a, jplan, jpar.make_mesh(n), fixed=fixed))(jnp.asarray(x))
    got = tpar.spatial_detect_and_compute(x, build_plan(H, W, cfg),
                                          cpu_mesh(n), fixed=fixed)
    count = int(want.count)
    assert int(got.count) == count > 200
    assert bool(got.overflow) == bool(want.overflow)
    np.testing.assert_array_equal(got.layer[:count].numpy(),
                                  np.asarray(want.layer)[:count])
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(got, f)[:count].numpy(),
                                   np.asarray(getattr(want, f))[:count],
                                   rtol=0, atol=XY_TOL, err_msg=f)
    assert _circular(got.angle[:count].numpy(),
                     np.asarray(want.angle)[:count]).max() < 1e-3
    flips = words_to_numpy(got.words[:count]) ^ np.asarray(
        want.words)[:count]
    assert np.unpackbits(flips.view(np.uint8)).sum() == 0


def test_spatial_describe_false():
    plan = build_plan(H, W, AkazeConfig(max_pts=MAX_PTS))
    got = tpar.spatial_detect_and_compute(image_for(False), plan,
                                          cpu_mesh(4), describe=False)
    want = unsharded("float")
    n = int(want.count)
    for f in ("x", "y", "size", "layer", "response"):
        assert torch.equal(getattr(got, f)[:n], getattr(want, f)[:n]), f
    assert torch.equal(got.valid, want.valid)
    assert not got.angle.any() and not got.words.any()


# --------------------------------------------------------------------------
# Akaze(mesh=...)
# --------------------------------------------------------------------------

def test_akaze_with_a_mesh_and_its_fallback():
    cfg = AkazeConfig(max_pts=MAX_PTS)
    img = image_for(False)
    det = Akaze(cfg, mesh=cpu_mesh(2))
    got = det.detect_and_compute(img)
    assert_same_features(got, unsharded("float"))
    # the pair runs the spatial program per image
    img_b = blob_image(seed=7)
    sa, sb = det.detect_and_compute_pair(img, img_b)
    ra, rb = Akaze(cfg, device="cpu").detect_and_compute_pair(img, img_b)
    assert_same_features(sa, ra)
    assert_same_features(sb, rb)
    assert det.spatial_fallbacks == 0

    # 162 rows do not split over 4 shards
    odd = blob_image(h=168, w=200)[:162]
    with pytest.raises(ValueError, match="unsupported"):
        Akaze(cfg, mesh=cpu_mesh(4)).detect_and_compute(odd)
    fb = Akaze(cfg, mesh=cpu_mesh(4), spatial_fallback=True)
    got = fb.detect_and_compute(odd)
    assert fb.spatial_fallbacks == 1
    want = Akaze(cfg, device="cpu").detect_and_compute(odd)
    for f, v in want._asdict().items():
        assert torch.equal(getattr(got, f), v), f
    with pytest.raises(ValueError, match="unsupported"):
        tpar.spatial_detect_and_compute(np.zeros((960, 1280), np.float32),
                                        build_plan(960, 1280, cfg),
                                        cpu_mesh(8))
    assert config_from(JConfig(max_pts=MAX_PTS)) == cfg
