"""Kernel K2 (orientation + MLDB cell sums) and the descriptor module of
the PyTorch port against the JAX package.

Both sides get the SAME keypoints and bf16 pyramid (the port's, handed
over as numpy; test_torch_sublevel.py and test_torch_pipeline.py hold those
to the JAX package), so this file isolates the descriptor.  The
reference is the JAX package's XLA descriptor path, which its own tests
hold equal to the Pallas kernel (0 flipped bits on the test image,
tests/test_pallas_descriptor.py); the pair pipeline test holds the port
against the Pallas kernel itself in interpret mode.

The fixed path's exact flavour (f32 planes) is held to the JAX package's
XLA fixed descriptor, and ``banded_windows=False`` to the JAX package's
private-window kernel (K3) in interpret mode, which the port serves with
K2.

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
from akaze_tpu.detect import PaddedPyramid as JPaddedPyramid
from akaze_tpu.detect import build_padded_pyramid as jpadded
from akaze_tpu.ops import pallas_describe as jpd
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu.scale_space import OctaveData as JOctaveData
from akaze_tpu_torch import build_plan, config_from, detect_and_compute_pair
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


@pytest.mark.parametrize("patsize", [10, 8])
def test_lane_taps_reproduce_cell_membership(patsize):
    """K2's per-cell tap lists: lane c walks exactly the taps of cell c in
    the JAX package's window table, ascending, then the zero tap T; lanes
    29-31 walk only T; every tap is in some cell."""
    _, _, member = jdesc._descriptor_window(patsize)
    ntaps = member.shape[0]
    lanes = tdescribe.describe_tables(patsize, "cpu").lane_taps.numpy()
    assert lanes.shape == (int(member.sum(0).max()), 32)
    covered = set()
    for c in range(32):
        col = lanes[:, c].astype(np.int64)
        want = (np.nonzero(member[:, c])[0] if c < tdescribe.NCELLS
                else np.zeros(0, np.int64))
        np.testing.assert_array_equal(col[:len(want)], want)
        assert (np.diff(want) > 0).all()
        assert (col[len(want):] == ntaps).all()
        covered.update(want.tolist())
    assert covered == set(range(ntaps))


@pytest.mark.parametrize("patsize", [10, 8])
def test_tap_order_is_a_permutation_per_angle_bucket(patsize):
    """Each angle bucket's MLDB load order holds every tap once, then the
    zero tap T up to 14 rounds of 32 lanes."""
    tables = tdescribe.describe_tables(patsize, "cpu")
    ntaps = tables.lof.shape[0]
    order = tables.tap_order.numpy()
    assert order.shape == (tdescribe.TAP_ORDERS, tdescribe.LOADS)
    for row in order:
        np.testing.assert_array_equal(np.sort(row[:ntaps]), np.arange(ntaps))
        assert (row[ntaps:] == ntaps).all()


def test_window_table_wraps():
    window = tdescribe.describe_tables(10, "cpu").window.numpy()
    b, d = np.meshgrid(np.arange(42), np.arange(7), indexing="ij")
    np.testing.assert_array_equal(window, (b + d) % 42)


@pytest.mark.parametrize("patsize", [10, 8])
def test_table_sum_order_is_the_plain_versions(patsize):
    """Sums taken the kernel's way (the lane lists step by step from 0, the
    window table d = 0..6) equal the plain version's bit for bit on seeded
    float32 values: cell sums as ``describe_plain`` groups them
    (``cell_members``), window sums as its rolls add them."""
    tables = tdescribe.describe_tables(patsize, "cpu")
    ntaps = tables.lof.shape[0]
    rng = np.random.default_rng(7)
    taps = torch.from_numpy(rng.standard_normal((64, ntaps + 1, 3))
                            .astype(np.float32))
    taps[:, ntaps] = 0.0
    grouped = taps[:, tdescribe.cell_members(tables.cells)]
    want = grouped[:, :, 0]
    for j in range(1, grouped.shape[2]):
        want = want + grouped[:, :, j]
    got = torch.zeros((64, 32, 3))
    for step in tables.lane_taps.long():
        got = got + taps[:, step]
    assert torch.equal(got[:, :tdescribe.NCELLS], want)

    res = torch.from_numpy(rng.standard_normal((64, 42)).astype(np.float32))
    want = res
    for d in range(1, 7):
        want = want + torch.roll(res, -d, 1)
    got = torch.zeros_like(res)
    for d in range(7):
        got = got + res[:, tables.window[:, d].long()]
    assert torch.equal(got, want)


@pytest.mark.parametrize("fixed", [False, True])
def test_plain_version_on_fixtures_unchanged(described, described_fixed,
                                             fixed):
    """``describe_plain`` with the grown tables still gives the JAX
    package's angles and words on the fixtures' live slots, and zeros on
    the dead ones."""
    ref, _, kps_t, pp, plan = described_fixed if fixed else described
    nplanes = pp.L.shape[0] // 2
    tables = tdescribe.describe_tables(10, "cpu")
    for i, (r, k) in enumerate(zip(ref, kps_t)):
        n, angle, words = r[:3]
        ip, fp = tdesc.slot_params(k, pp, plan, plane_base=i * nplanes,
                                   nplanes=nplanes)
        t_angle, acc = tdescribe.describe_plain(
            ip, fp, (pp.L, pp.lx, pp.ly), tables, fixed)
        assert (circular(t_angle.numpy()[:n], angle[:n]) < 1e-3).all()
        flips = bit_flips(tdesc.words_to_numpy(
            tdesc.finish_descriptors(acc))[:n], words[:n])
        assert flips.max() == 0
        assert (t_angle[n:] == 0).all() and (acc[n:] == 0).all()


def test_f32_planes_match_jax_xla_path(described, test_image):
    """``bf16_sampling=False``: the port's pair path describes float32
    planes with the float flavour, and the JAX package's XLA float path
    with the same configuration (float32 windows) gives the same angles
    and words on the same keypoints and planes."""
    ref_bf16, _, kps_t, _, plan = described
    cfg = dataclasses.replace(plan.config, bf16_sampling=False)
    plan = dataclasses.replace(plan, config=cfg)
    jplan = jbuild_plan(plan.height, plan.width,
                        JConfig(**dataclasses.asdict(cfg)))
    assert tdesc.plane_dtype(plan, False) == torch.float32
    a = test_image[:160, :208]           # the fixture's pair
    pair = (a, np.roll(a, (5, 9), axis=(0, 1)))
    got = detect_and_compute_pair(*pair, plan, device="cpu")
    flipped_from_bf16 = 0
    for img, f, k, r in zip(pair, got, kps_t, ref_bf16):
        n = int(k.count)
        assert int(f.count) == n > 10 and torch.equal(f.x, k.x)
        octs, _ = build_scale_space(torch.from_numpy(img), plan)
        jkps = _to_jax(k, JKeypoints)
        pp = jpadded([_to_jax(o, JOctaveData) for o in octs], jdesc.WSIZE)
        assert pp.L.dtype == jnp.float32
        wnd = jdesc.extract_windows(jkps, pp, jplan)
        angle = jdesc.compute_orientation(jkps, wnd, jplan)
        words = np.asarray(jdesc.compute_descriptors(jkps, angle, wnd,
                                                     jplan).words)
        assert (circular(f.angle.numpy()[:n], np.asarray(angle)[:n])
                < 1e-3).all()
        flips = bit_flips(tdesc.words_to_numpy(f.words)[:n], words[:n])
        assert flips.max() == 0, (flips.max(), (flips > 0).sum())
        assert (f.words.numpy()[n:] == 0).all()
        flipped_from_bf16 += int(bit_flips(words[:n], r[2][:n]).sum())
    assert flipped_from_bf16 > 0    # f32 sampling is not the bf16 one


def test_describe_rejects_bad_input(described):
    _, _, kps_t, pp, plan = described
    ip, fp = tdesc.slot_params(kps_t[0], pp, plan)
    tables = tdescribe.describe_tables(10, ip.device)
    planes = (pp.L, pp.lx, pp.ly)
    with pytest.raises(TypeError):
        tdescribe.describe(ip, fp, tuple(p.double() for p in planes), tables)
    with pytest.raises(TypeError):
        tdescribe.describe(ip.long(), fp, planes, tables)
    with pytest.raises(ValueError):
        tdescribe.describe(ip, fp[:-1], planes, tables)



# --------------------------------------------------------------------------
# the fixed path's exact flavour, and K3 (banded_windows=False)
# --------------------------------------------------------------------------

def _raw(test_image):
    """The whole blob image as raw 0..255 and a rolled copy: the fixed
    threshold keeps fewer keypoints than the float one on a crop."""
    a = (test_image * 255).astype(np.uint8).astype(np.int32)
    return a, np.roll(a, (5, 9), axis=(0, 1))


@pytest.fixture(scope="module")
def described_fixed(test_image):
    """The port's fixed scale space and keypoints of a raw pair, its f32
    pyramid and exact descriptors; the JAX package's XLA fixed descriptor
    of those keypoints on the same planes (int32, as its XLA path takes
    them).  Its own tests hold that path bit-equal to its exact kernel
    (tests/test_pallas_descriptor.py:143)."""
    images = _raw(test_image)
    jcfg = JConfig(max_pts=256, noctaves=2, fixed_exact_sampling=True)
    jplan = jbuild_plan(*images[0].shape, jcfg)
    plan = build_plan(*images[0].shape, config_from(dataclasses.asdict(jcfg)))
    ref, kps_t, octs_t = [], [], []
    for img in images:
        octs, _ = build_scale_space(torch.from_numpy(img), plan)
        kps = detect_keypoints(octs, plan)
        jkps = _to_jax(kps, JKeypoints)
        pp = jpadded([_to_jax(o, JOctaveData) for o in octs], jdesc.WSIZE)
        wnd = jdesc.extract_windows(jkps, pp, jplan)
        angle = jdesc.compute_orientation(jkps, wnd, jplan, fixed=True)
        words = jdesc.compute_descriptors(jkps, angle, wnd, jplan,
                                          fixed=True).words
        ref.append((int(kps.count), np.asarray(angle), np.asarray(words)))
        kps_t.append(kps)
        octs_t += octs
    assert tdesc.plane_dtype(plan, True) == torch.float32
    pp = build_padded_pyramid(octs_t, tdesc.WSIZE, torch.float32)
    tdescribe.describe.launches = 0
    got = tdesc.orient_describe_multi(kps_t, pp, plan, fixed=True)
    return ref, got, kps_t, pp, plan


def test_fixed_descriptor_matches_jax(described_fixed):
    ref, got, _, _, _ = described_fixed
    for (n, angle, words), (t_angle, t_words) in zip(ref, got):
        assert n > 10
        assert (circular(t_angle.numpy()[:n], angle[:n]) < 1e-3).all()
        flips = bit_flips(tdesc.words_to_numpy(t_words)[:n], words[:n])
        assert flips.max() == 0, (flips.max(), (flips > 0).sum())
        assert (t_words.numpy()[n:] == 0).all()
    assert tdescribe.describe.launches == 0


def test_fixed_flavour_differs_from_float(described_fixed):
    """The exact flavour is not the float one on the same planes: its
    integer cell sums tie where the float sums are rotated."""
    _, _, kps_t, pp, plan = described_fixed
    ip, fp = tdesc.slot_params(kps_t[0], pp, plan)
    tables = tdescribe.describe_tables(10, ip.device)
    planes = (pp.L, pp.lx, pp.ly)
    _, exact = tdescribe.describe(ip, fp, planes, tables, fixed=True)
    _, flt = tdescribe.describe_plain(ip, fp, planes, tables)
    n = int(kps_t[0].count)
    assert (exact[:n] == exact[:n].round()).all()
    assert not torch.equal(exact[:n], flt[:n])
    # the caller picks the flavour: the float one on the same f32 planes is
    # the plain float version; the fixed one needs f32 planes
    assert torch.equal(tdescribe.describe(ip, fp, planes, tables)[1], flt)
    with pytest.raises(TypeError):
        tdescribe.describe(ip, fp, tuple(p.bfloat16() for p in planes),
                           tables, fixed=True)


def _private_window_kernel(kps_t, pp, plan, fixed):
    """The JAX package's K3 (``orient_describe``, one private window per
    keypoint) in interpret mode on the live slots of both images, fed the
    port's keypoints and planes.  kb = 1: outputs are per keypoint, and a
    one-keypoint body compiles in about a second."""
    from akaze_tpu.ops.pallas_describe import orient_describe

    jplan = jbuild_plan(plan.height, plan.width,
                        JConfig(**dataclasses.asdict(plan.config)))
    dtype = jnp.float32 if fixed else jnp.bfloat16
    jpp = JPaddedPyramid(*(jnp.asarray(v.float().numpy()) for v in pp[:3]),
                         *(jnp.asarray(v.numpy()) for v in pp[3:]))
    nplanes = pp.L.shape[0] // len(kps_t)
    ips, fps = [], []
    for i, k in enumerate(kps_t):
        n = int(k.count)
        ip, fp = jdesc._band_kp_params(_to_jax(k, JKeypoints), jpp, jplan,
                                       120, 128, plane_base=i * nplanes,
                                       nplanes=nplanes)
        ips.append(ip[:n].at[:, 6].set(1))
        fps.append(fp[:n])
    planes = jdesc._padded_band_pyramid(jpp, 128, 256, dtype=dtype)
    angle, acc = orient_describe(jnp.concatenate(ips), jnp.concatenate(fps),
                                 planes, kb=1, interpret=True, wy=128,
                                 wx=256, fixed=fixed)
    _, desc = jdesc._finish_descriptors(angle, acc)
    return np.asarray(angle), np.asarray(desc.words)


@pytest.mark.parametrize("fixed", [False, True])
def test_private_window_kernel_k3_served_by_k2(described, described_fixed,
                                               fixed):
    """``banded_windows=False`` selects the JAX package's K3; the port
    serves it with K2, and its results equal K3's (float flavour on bf16
    planes, and the fixed path's exact flavour on f32 planes)."""
    _, _, kps_t, pp, plan = described_fixed if fixed else described
    plan = dataclasses.replace(plan, config=dataclasses.replace(
        plan.config, banded_windows=False))
    got = tdesc.orient_describe_multi(kps_t, pp, plan, fixed=fixed)
    angle, words = _private_window_kernel(kps_t, pp, plan, fixed)
    off = 0
    for k, (t_angle, t_words) in zip(kps_t, got):
        n = int(k.count)
        assert n > 10
        assert (circular(t_angle.numpy()[:n], angle[off:off + n])
                < 1e-3).all()
        flips = bit_flips(tdesc.words_to_numpy(t_words)[:n],
                          words[off:off + n])
        assert flips.max() == 0, (flips.max(), (flips > 0).sum())
        off += n
