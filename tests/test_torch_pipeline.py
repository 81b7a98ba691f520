"""The PyTorch port's pair path end to end (scale space -> detect ->
describe -> match) against the JAX package with every kernel in Pallas
interpret mode: ``pallas_scale_space="interpret"``,
``pallas_descriptor="interpret"``, ``match(..., use_pallas="interpret")``.

The pair is two crops of the blob test image with a known shift
(dy, dx) = (7, 13).  Tolerances: keypoint count, layer, size and overflow
exactly; x/y within 1e-4 px; response within 1e-5 of the largest; angle
within 1e-3 rad (circular); descriptor words exactly (0 flipped bits);
``Matches`` index and distance exactly, match_x/match_y (which are train
keypoint coordinates) within 1e-4 px.

The 16.16 fixed-point pair (raw 0..255 input) is held exact throughout:
keypoints, responses, descriptor words and ``Matches``.  Its exact
descriptor flavour is held to the JAX package's XLA descriptor path
(``pallas_descriptor="off"``), its approximate flavour to the JAX kernel in
interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import Akaze as JAkaze
from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu.match import match as jmatch
from akaze_tpu.pipeline import detect_and_compute_pair as jpair
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu_torch import (Akaze, build_plan, config_from,
                             detect_and_compute, detect_and_compute_pair,
                             features_to_numpy, match)
from akaze_tpu_torch.descriptor import _compare_index_tensors, words_to_numpy
from akaze_tpu_torch.detect import const_table
from akaze_tpu_torch.pipeline import detect_batch
from akaze_tpu_torch.ops.describe import describe
from akaze_tpu_torch.ops.hamming import hamming_top2
from akaze_tpu_torch.ops.sublevel import octave, sublevel

torch.set_num_threads(1)

SHIFT = (7, 13)
COUNTERS = (sublevel, octave, describe, hamming_top2)


def _images(test_image):
    dy, dx = SHIFT
    return (test_image[:160, :208].copy(),
            test_image[dy:dy + 160, dx:dx + 208].copy())


@pytest.fixture(scope="module")
def runs(test_image):
    a, b = _images(test_image)
    jcfg = JConfig(max_pts=256, noctaves=2, pallas_scale_space="interpret",
                   pallas_descriptor="interpret")
    jf = jpair(jnp.asarray(a), jnp.asarray(b), jbuild_plan(*a.shape, jcfg))
    jm = jmatch(jf[0].words, jf[0].valid, jf[1].words, jf[1].valid,
                jf[1].x, jf[1].y, jcfg.max_dist, use_pallas="interpret")
    plan = build_plan(*a.shape, config_from(dataclasses.asdict(jcfg)))
    for c in COUNTERS:
        c.launches = 0
    tf = detect_and_compute_pair(a, b, plan, device="cpu")
    tm = match(tf[0].words, tf[0].valid, tf[1].words, tf[1].valid,
               tf[1].x, tf[1].y, plan.config.max_dist)
    return jf, jm, tf, tm, plan


@pytest.mark.parametrize("image", [0, 1])
def test_keypoints_match_jax(runs, image):
    jf, _, tf, _, _ = runs
    want, got = jf[image], tf[image]
    n = int(want.count)
    assert int(got.count) == n > 10
    assert bool(got.overflow) == bool(want.overflow)
    for name in ("layer", "size", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[:n],
                                      np.asarray(getattr(want, name))[:n],
                                      err_msg=name)
    for name in ("x", "y"):
        np.testing.assert_allclose(getattr(got, name).numpy()[:n],
                                   np.asarray(getattr(want, name))[:n],
                                   rtol=0, atol=1e-4, err_msg=name)
    r = np.asarray(want.response)[:n]
    np.testing.assert_allclose(got.response.numpy()[:n], r, rtol=0,
                               atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("image", [0, 1])
def test_descriptors_match_jax(runs, image):
    jf, _, tf, _, _ = runs
    want, got = jf[image], tf[image]
    n = int(want.count)
    d = np.abs(got.angle.numpy()[:n] - np.asarray(want.angle)[:n])
    assert (np.minimum(d, 2 * np.pi - d) < 1e-3).all()
    x = words_to_numpy(got.words)[:n] ^ np.asarray(want.words)[:n]
    assert np.unpackbits(x.view(np.uint8), axis=1).sum() == 0


def test_matches_match_jax(runs):
    _, jm, _, tm, _ = runs
    for name in ("index", "distance"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in ("match_x", "match_y"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_known_shift_recovered(runs):
    _, _, tf, tm, _ = runs
    n = int(tf[0].count)
    acc = tm.index.numpy()[:n] >= 0
    dx = tm.match_x.numpy()[:n][acc] - tf[0].x.numpy()[:n][acc]
    dy = tm.match_y.numpy()[:n][acc] - tf[0].y.numpy()[:n][acc]
    assert acc.sum() > 10
    assert np.median(dx) == -SHIFT[1] and np.median(dy) == -SHIFT[0]
    inliers = (np.abs(dx + SHIFT[1]) < 1.5) & (np.abs(dy + SHIFT[0]) < 1.5)
    assert inliers.mean() > 0.85


def test_cpu_path_launches_no_kernel(runs):
    assert [c.launches for c in COUNTERS] == [0, 0, 0, 0]


def test_single_image_equals_pair(runs, test_image):
    _, _, tf, _, plan = runs
    for img, want in zip(_images(test_image), tf):
        got = detect_and_compute(img, plan, device="cpu")
        for name in got._fields:
            torch.testing.assert_close(getattr(got, name),
                                       getattr(want, name), rtol=0, atol=0)


def test_akaze_class_and_export(runs, test_image):
    _, _, tf, tm, plan = runs
    det = Akaze(plan.config, device="cpu")
    fa, fb = det.detect_and_compute_pair(*_images(test_image))
    m = det.match(fa, fb)
    torch.testing.assert_close(m.index, tm.index, rtol=0, atol=0)
    out = features_to_numpy(fa)
    n = int(tf[0].count)
    assert out["count"] == n and out["words"].dtype == np.uint32
    assert out["x"].shape == (n,) and out["words"].shape == (n, 16)
    assert out["overflow"] is False


def test_constant_tables_built_once(runs, test_image):
    """The pair path's constant tables (border bounds, sizes, refinement
    offsets, plane widths and heights, compare indices) are copied to the
    device once: a second call builds none and returns the same objects,
    with the same keypoints."""
    _, _, tf, _, plan = runs
    images = torch.from_numpy(np.stack(_images(test_image)))
    kps1, pp1 = detect_batch(images, plan, device="cpu")
    misses = const_table.cache_info().misses
    kps2, pp2 = detect_batch(images, plan, device="cpu")
    assert const_table.cache_info().misses == misses
    assert pp1.widths is pp2.widths and pp1.heights is pp2.heights
    cpu = torch.device("cpu")
    assert all(a is b for a, b in zip(_compare_index_tensors(cpu),
                                      _compare_index_tensors(cpu)))
    for k1, k2, f in zip(kps1, kps2, tf):
        for name in k1._fields:
            assert torch.equal(getattr(k1, name), getattr(k2, name)), name
        assert torch.equal(k1.x, f.x) and torch.equal(k1.layer, f.layer)


KEYPOINT_FIELDS = ("x", "y", "size", "layer", "response", "valid", "count",
                   "overflow")


def test_describe_false_keeps_keypoints(runs, test_image, monkeypatch):
    """``describe=False``: the keypoint fields of ``describe=True``, angle 0
    and zero words, without the plane stack or K2."""
    import akaze_tpu_torch.pipeline as tpipe

    def never(*args, **kw):
        raise AssertionError("the descriptor stage ran")

    _, _, tf, _, plan = runs
    monkeypatch.setattr(tpipe, "build_padded_pyramid", never)
    monkeypatch.setattr(tpipe, "orient_describe_multi", never)
    det = Akaze(plan.config, device="cpu")
    for img, want in zip(_images(test_image), tf):
        for got in (det.detect_and_compute(img, describe=False),
                    detect_and_compute(img, plan, device="cpu",
                                       describe=False)):
            for name in KEYPOINT_FIELDS:
                assert torch.equal(getattr(got, name), getattr(want, name))
            assert got.words.shape == want.words.shape
            assert got.words.dtype == torch.int32
            assert not got.angle.any() and not got.words.any()


def test_describe_false_matches_jax(runs, test_image):
    """The JAX package's ``Akaze.detect_and_compute(image,
    describe=False)`` and the port's: the same keypoints (the tolerances
    above), angle 0 and zero words on both sides."""
    _, _, _, _, plan = runs
    jdet = JAkaze(JConfig(**dataclasses.asdict(plan.config)))
    det = Akaze(plan.config, device="cpu")
    img = _images(test_image)[0]
    want = jdet.detect_and_compute(jnp.asarray(img), describe=False)
    got = det.detect_and_compute(img, describe=False)
    n = int(want.count)
    assert int(got.count) == n > 10
    for name in ("layer", "size", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("x", "y"):
        np.testing.assert_allclose(getattr(got, name).numpy()[:n],
                                   np.asarray(getattr(want, name))[:n],
                                   rtol=0, atol=1e-4, err_msg=name)
    assert not np.asarray(want.angle).any() and not np.asarray(
        want.words).any()
    assert not got.angle.any() and not got.words.any()


def test_match_threshold_defaults_as_in_jax(runs):
    """``Akaze.match`` accepts below 96 unless told otherwise, whatever
    ``config.max_dist`` says, as the JAX package's ``Akaze.match``: at
    ``max_dist=50`` both give the Matches of the default threshold."""
    jf, _, tf, tm, plan = runs
    cfg = dataclasses.replace(plan.config, max_dist=50)
    got = Akaze(cfg, device="cpu").match(*tf)
    want = JAkaze(JConfig(**dataclasses.asdict(cfg))).match(*jf)
    for name in ("index", "distance"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("match_x", "match_y"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert torch.equal(got.index, tm.index)
    # the threshold a caller passes is the one applied
    assert bool((tm.distance >= 50).any())
    strict = Akaze.match(*tf, max_dist=50)
    assert bool((strict.index >= 0).any())
    assert not bool((strict.distance >= 50).any())


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Akaze(device="cuda")


def test_entry_points_default_to_the_card(monkeypatch, test_image):
    """``Akaze()`` and the module-level entry points put a numpy image on
    the card; with no card they raise, unless the caller asks for the
    CPU.  A tensor stays where it lies."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _images(test_image)
    plan = build_plan(*a.shape, config_from({"max_pts": 64, "noctaves": 1}))
    with pytest.raises(RuntimeError):
        Akaze()
    with pytest.raises(RuntimeError):
        Akaze(plan.config, fixed=True)
    with pytest.raises(RuntimeError):
        detect_and_compute(a, plan)
    with pytest.raises(RuntimeError):
        detect_and_compute_pair(a, b, plan)
    for c in COUNTERS:
        c.launches = 0
    det = Akaze(plan.config, device="cpu")
    assert det.device.type == "cpu"
    fa, fb = det.detect_and_compute_pair(a, b)
    det.match(fa, fb)
    got = detect_and_compute(torch.from_numpy(a), plan)
    assert got.x.device.type == "cpu"
    assert [c.launches for c in COUNTERS] == [0, 0, 0, 0]



# --------------------------------------------------------------------------
# the 16.16 fixed-point pair path, both descriptor flavours
# --------------------------------------------------------------------------

# the JAX descriptor selector of each flavour: its XLA path is the exact
# flavour, its kernel path (here in interpret mode) the approximate one
FLAVOURS = {"exact": "off", "approximate": "interpret"}


def _raw_images(test_image):
    """The whole blob image as raw 0..255 uint8, cropped to a pair with the
    known shift (the fixed threshold keeps too few keypoints on the float
    tests' smaller crop)."""
    raw = (test_image * 255).astype(np.uint8)
    dy, dx = SHIFT
    h, w = raw.shape[0] - dy, raw.shape[1] - dx
    return raw[:h, :w].copy(), raw[dy:dy + h, dx:dx + w].copy()


@pytest.fixture(scope="module")
def fixed_runs(test_image):
    """Per flavour: the JAX package's fixed pair (XLA scale space, which its
    tests hold bit-exact to its fixed kernel) and matches, and the port's."""
    a, b = _raw_images(test_image)
    out = {}
    for flavour, mode in FLAVOURS.items():
        jcfg = JConfig(max_pts=256, noctaves=2, pallas_descriptor=mode)
        jf = jpair(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                   jbuild_plan(*a.shape, jcfg), fixed=True)
        jm = jmatch(jf[0].words, jf[0].valid, jf[1].words, jf[1].valid,
                    jf[1].x, jf[1].y, jcfg.max_dist)
        plan = build_plan(*a.shape, config_from(dataclasses.asdict(jcfg)))
        assert plan.config.fixed_descriptor_exact == (flavour == "exact")
        for c in COUNTERS:
            c.launches = 0
        tf = detect_and_compute_pair(a, b, plan, fixed=True, device="cpu")
        tm = match(tf[0].words, tf[0].valid, tf[1].words, tf[1].valid,
                   tf[1].x, tf[1].y, plan.config.max_dist)
        assert [c.launches for c in COUNTERS] == [0, 0, 0, 0]
        out[flavour] = (jf, jm, tf, tm, plan)
    return out


@pytest.mark.parametrize("image", [0, 1])
def test_fixed_detection_matches_jax(fixed_runs, image):
    """Detection on the int32 planes: counts, layers, sizes, positions and
    responses all exact."""
    jf, _, tf, _, _ = fixed_runs["exact"]
    want, got = jf[image], tf[image]
    n = int(want.count)
    assert int(got.count) == n > 10
    assert bool(got.overflow) == bool(want.overflow)
    for name in ("layer", "size", "valid", "x", "y", "response"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[:n],
                                      np.asarray(getattr(want, name))[:n],
                                      err_msg=name)
    for f in fixed_runs.values():     # detection is the flavours' own
        torch.testing.assert_close(f[2][image].x, got.x, rtol=0, atol=0)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_fixed_descriptors_and_matches_match_jax(fixed_runs, flavour):
    """0 flipped bits and equal ``Matches`` for each descriptor flavour."""
    jf, jm, tf, tm, _ = fixed_runs[flavour]
    for want, got in zip(jf, tf):
        n = int(want.count)
        d = np.abs(got.angle.numpy()[:n] - np.asarray(want.angle)[:n])
        assert (np.minimum(d, 2 * np.pi - d) < 1e-3).all()
        x = words_to_numpy(got.words)[:n] ^ np.asarray(want.words)[:n]
        assert np.unpackbits(x.view(np.uint8), axis=1).sum() == 0
    for name in ("index", "distance", "match_x", "match_y"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_fixed_known_shift_recovered(fixed_runs, flavour):
    _, _, tf, tm, _ = fixed_runs[flavour]
    n = int(tf[0].count)
    acc = tm.index.numpy()[:n] >= 0
    dx = tm.match_x.numpy()[:n][acc] - tf[0].x.numpy()[:n][acc]
    dy = tm.match_y.numpy()[:n][acc] - tf[0].y.numpy()[:n][acc]
    assert acc.sum() > 10
    assert np.median(dx) == -SHIFT[1] and np.median(dy) == -SHIFT[0]
    inliers = (np.abs(dx + SHIFT[1]) < 1.5) & (np.abs(dy + SHIFT[0]) < 1.5)
    assert inliers.mean() > 0.85


def test_fixed_flavours_differ(fixed_runs):
    """The two flavours are different descriptors of the same keypoints."""
    ex, ap = fixed_runs["exact"][2][0], fixed_runs["approximate"][2][0]
    n = int(ex.count)
    assert not torch.equal(ex.words[:n], ap.words[:n])


def test_fixed_akaze_class(fixed_runs, test_image):
    """``Akaze(config, fixed=True)`` takes raw 0..255 images (uint8 here)
    and equals the functions; single images equal the pair."""
    for flavour, (_, _, tf, tm, plan) in fixed_runs.items():
        det = Akaze(plan.config, fixed=True, device="cpu")
        a, b = _raw_images(test_image)
        fa, fb = det.detect_and_compute_pair(a, b)
        torch.testing.assert_close(det.match(fa, fb).index, tm.index,
                                   rtol=0, atol=0)
        got = det.detect_and_compute(b)
        for name in got._fields:
            torch.testing.assert_close(getattr(got, name),
                                       getattr(tf[1], name), rtol=0, atol=0)
