"""Kernel K2 (orientation + MLDB cell sums) and the descriptor module of
the PyTorch port against the JAX package.

Both sides get the SAME keypoints and bf16 pyramid (the port's, handed
over as numpy; test_torch_sublevel.py and test_torch_pipeline.py hold those
to the JAX package), so this file isolates the descriptor.  The
reference is the JAX package's XLA descriptor path, which its own tests
hold equal to the Pallas kernel (0 flipped bits on the test image,
tests/test_pallas_descriptor.py); the pair pipeline test holds the port
against the Pallas kernel itself in interpret mode.

Tolerances: angle within 1e-3 rad (circular), descriptor words exactly (0
flipped bits), static tables exactly.  On the CPU the port's ``describe``
runs its plain version; tests/test_torch_cuda.py holds the CUDA kernel to
it on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu import descriptor as jdesc
from akaze_tpu.detect import Keypoints as JKeypoints
from akaze_tpu.detect import build_padded_pyramid as jpadded
from akaze_tpu.ops import pallas_describe as jpd
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu.scale_space import OctaveData as JOctaveData
from akaze_tpu_torch import build_plan, config_from
from akaze_tpu_torch import descriptor as tdesc
from akaze_tpu_torch.detect import build_padded_pyramid, detect_keypoints
from akaze_tpu_torch.ops import describe as tdescribe
from akaze_tpu_torch.scale_space import build_scale_space

torch.set_num_threads(1)


def bit_flips(w1, w2):
    x = (np.asarray(w1).astype(np.uint32) ^ np.asarray(w2).astype(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=1).sum(1)


def circular(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("patsize", [10, 8])
def test_static_tables_equal(patsize):
    np.testing.assert_array_equal(tdesc._orient_grid(), jdesc._orient_grid())
    for got, want in zip(tdesc._descriptor_window(patsize),
                         jdesc._descriptor_window(patsize)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tdesc._compare_indices(), jdesc._compare_indices()):
        np.testing.assert_array_equal(got, want)


def test_atan2_polynomials_match_kernel_forms():
    rng = np.random.default_rng(3)
    y = rng.standard_normal(4096).astype(np.float32)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:8] = 0.0
    y[:4] = 0.0
    for tf, jf in ((tdescribe.atan2_poly, jpd._atan2_poly),
                   (tdescribe.fast_atan2, jpd._fast_atan2)):
        got = tf(torch.from_numpy(y), torch.from_numpy(x)).numpy()
        want = np.asarray(jf(jnp.asarray(y), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tdescribe.atan2_poly(torch.from_numpy(y), torch.from_numpy(x)),
        np.arctan2(y, x), rtol=0, atol=1e-6)


def test_pack_bits_and_bytes():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (37, 486)).astype(bool)
    got = tdesc.pack_bits(torch.from_numpy(bits))
    want = np.asarray(jdesc.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(tdesc.words_to_numpy(got), want)
    # pad bits 486..511 are zero, so Hamming needs no mask
    assert (tdesc.words_to_numpy(got)[:, 15] >> 6 == 0).all()
    np.testing.assert_array_equal(
        tdesc.descriptors_to_bytes(got.numpy()),
        jdesc.descriptors_to_bytes(want))


def test_finish_descriptors_is_the_comparison_matmul():
    rng = np.random.default_rng(5)
    acc = rng.standard_normal((64, 87)).astype(np.float32)
    acc[:, 10] = acc[:, 13]           # ties compare as 0 bits
    _, want = jdesc._finish_descriptors(jnp.zeros(64), jnp.asarray(acc))
    got = tdesc.finish_descriptors(torch.from_numpy(acc))
    np.testing.assert_array_equal(tdesc.words_to_numpy(got),
                                  np.asarray(want.words))


def _to_jax(nt, cls):
    return cls(*(jnp.asarray(v.numpy()) for v in nt))


@pytest.fixture(scope="module")
def described(test_image):
    """The port's scale space and keypoints of a pair; the JAX package's
    XLA descriptors of those keypoints on the same pyramid, and the
    port's."""
    a = test_image[:160, :208]
    b = np.roll(a, (5, 9), axis=(0, 1))
    jcfg = JConfig(max_pts=256, noctaves=2, pallas_descriptor="off",
                   pallas_scale_space="off")
    jplan = jbuild_plan(*a.shape, jcfg)
    plan = build_plan(*a.shape, config_from(dataclasses.asdict(jcfg)))
    ref, kps_t, octs_t = [], [], []
    for img in (a, b):
        octs, _ = build_scale_space(torch.from_numpy(img), plan)
        kps = detect_keypoints(octs, plan)
        jkps = _to_jax(kps, JKeypoints)
        pp = jpadded([_to_jax(o, JOctaveData) for o in octs], jdesc.WSIZE,
                     dtype=jnp.bfloat16)
        wnd = jdesc.extract_windows(jkps, pp, jplan)
        angle = jdesc.compute_orientation(jkps, wnd, jplan)
        words = jdesc.compute_descriptors(jkps, angle, wnd, jplan).words
        ref.append((int(kps.count), np.asarray(angle), np.asarray(words),
                    np.asarray(wnd.x0), np.asarray(wnd.y0)))
        kps_t.append(kps)
        octs_t += octs
    pp = build_padded_pyramid(octs_t, tdesc.WSIZE)
    tdescribe.describe.launches = 0
    got = tdesc.orient_describe_multi(kps_t, pp, plan)
    return ref, got, kps_t, pp, plan


def test_descriptor_matches_jax(described):
    ref, got, _, _, _ = described
    for (n, angle, words, _, _), (t_angle, t_words) in zip(ref, got):
        assert n > 10
        assert (circular(t_angle.numpy()[:n], angle[:n]) < 1e-3).all()
        flips = bit_flips(tdesc.words_to_numpy(t_words)[:n], words[:n])
        assert flips.max() == 0, (flips.max(), (flips > 0).sum())
        # dead slots: angle 0 and zero words
        assert (t_angle.numpy()[n:] == 0).all()
        assert (t_words.numpy()[n:] == 0).all()


def test_window_rule_matches_jax(described):
    ref, _, kps_t, pp, plan = described
    nplanes = pp.L.shape[0] // 2
    for i, ((n, _, _, x0, y0), k) in enumerate(zip(ref, kps_t)):
        ip, fp = tdesc.slot_params(k, pp, plan, plane_base=i * nplanes,
                                   nplanes=nplanes)
        np.testing.assert_array_equal(ip[:n, 2].numpy(), x0[:n])
        np.testing.assert_array_equal(ip[:n, 1].numpy(), y0[:n])
        assert (ip[:n, 0].numpy() // nplanes == i).all()
        assert (ip[:, 6].numpy() == k.valid.numpy()).all()


def test_cpu_path_launches_no_kernel(described):
    assert tdescribe.describe.launches == 0


def test_describe_rejects_bad_input(described):
    _, _, kps_t, pp, plan = described
    ip, fp = tdesc.slot_params(kps_t[0], pp, plan)
    tables = tdescribe.describe_tables(10, ip.device)
    planes = (pp.L, pp.lx, pp.ly)
    with pytest.raises(TypeError):
        tdescribe.describe(ip, fp, tuple(p.float() for p in planes), tables)
    with pytest.raises(TypeError):
        tdescribe.describe(ip.long(), fp, planes, tables)
    with pytest.raises(ValueError):
        tdescribe.describe(ip, fp[:-1], planes, tables)

