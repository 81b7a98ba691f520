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
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu.match import match as jmatch
from akaze_tpu.pipeline import detect_and_compute_pair as jpair
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu_torch import (Akaze, build_plan, config_from,
                             detect_and_compute, detect_and_compute_pair,
                             features_to_numpy, match)
from akaze_tpu_torch.descriptor import words_to_numpy
from akaze_tpu_torch.ops.describe import describe
from akaze_tpu_torch.ops.hamming import hamming_top2
from akaze_tpu_torch.ops.sublevel import sublevel

torch.set_num_threads(1)

SHIFT = (7, 13)
COUNTERS = (sublevel, describe, hamming_top2)


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
    tf = detect_and_compute_pair(a, b, plan)
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
    assert [c.launches for c in COUNTERS] == [0, 0, 0]


def test_single_image_equals_pair(runs, test_image):
    _, _, tf, _, plan = runs
    for img, want in zip(_images(test_image), tf):
        got = detect_and_compute(img, plan)
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


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Akaze(device="cuda")

