"""Parity of the PyTorch port's pure-Python modules and float ops with the
JAX package on the same seeded inputs.

Tolerances: ops and planes within 1e-5 of the plane's max |value| (the
two frameworks may order or contract float operations differently);
kcontrast within a relative 1e-6; static plans and tables exactly.  The
16.16 fixed-point ops are integer planes and are held bit-exact, to the
JAX package and to tests/golden.py.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from akaze_tpu import config as jcfg
from akaze_tpu import fed as jfed
from akaze_tpu import plan as jplan
from akaze_tpu.ops import conv as jconv
from akaze_tpu.ops import contrast as jcontrast
from akaze_tpu.ops import diffusion as jdiff
from akaze_tpu.ops import scharr as jscharr
from akaze_tpu_torch import config as tcfg
from akaze_tpu_torch import fed as tfed
from akaze_tpu_torch import plan as tplan
from akaze_tpu_torch.ops import conv as tconv
from akaze_tpu_torch.ops import contrast as tcontrast
from akaze_tpu_torch.ops import diffusion as tdiff
from akaze_tpu_torch.ops import scharr as tscharr

torch.set_num_threads(1)

PLANE_TOL = 1e-5


def assert_plane_close(got, want, tol=PLANE_TOL, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, err_msg
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def planes():
    """Two seeded random planes of an odd size."""
    rng = np.random.default_rng(7)
    return rng.random((2, 61, 83), dtype=np.float32)


def test_import_leaves_jax_out():
    code = ("import sys, akaze_tpu_torch, akaze_tpu_torch.ops.sublevel, "
            "akaze_tpu_torch.ops.describe, akaze_tpu_torch.ops.hamming, "
            "akaze_tpu_torch.io, akaze_tpu_torch.io.dataset, "
            "akaze_tpu_torch.geometry, akaze_tpu_torch.slam; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'akaze_tpu.')) or m == 'akaze_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_config_fields_and_config_from():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.AkazeConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.AkazeConfig)]
    assert jf == tf
    j = jcfg.AkazeConfig(max_pts=123, noctaves=3, per=0.6,
                         diffusivity=jcfg.Diffusivity.CHARBONNIER)
    t = tcfg.config_from(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.diffusivity is tcfg.Diffusivity.CHARBONNIER
    assert t.smax == j.smax
    assert tcfg.config_from(j) == t
    with pytest.raises(ValueError):
        tcfg.config_from({"max_pts": 5, "no_such_field": 1})
    with pytest.raises(ValueError):
        tcfg.AkazeConfig(max_scale=6)
    assert (tcfg.DESCRIPTOR_BITS, tcfg.DESCRIPTOR_BYTES,
            tcfg.DESCRIPTOR_WORDS) == (jcfg.DESCRIPTOR_BITS,
                                       jcfg.DESCRIPTOR_BYTES,
                                       jcfg.DESCRIPTOR_WORDS)


@pytest.mark.parametrize("field, value, refused", [
    ("bf16_sampling", False, False),       # f32 float-path planes
    ("fixed_exact_sampling", True, False),  # the exact fixed descriptor
    ("pallas_descriptor", "off", False),   # kernel selectors: compatibility
    ("banded_windows", False, False),
])
def test_config_from_refuses_unimplemented_values(field, value, refused):
    j = dataclasses.asdict(jcfg.AkazeConfig(**{field: value}))
    if refused:
        with pytest.raises(ValueError, match=field):
            tcfg.config_from(j)
    else:
        assert getattr(tcfg.config_from(j), field) == value


@pytest.mark.parametrize("reordering", [True, False])
def test_fed_tables_equal(reordering):
    for t in (0.05, 0.7, 3.1, 12.8, 40.0):
        assert (tfed.fed_tau_by_process_time(t, 1, 0.25, reordering)
                == jfed.fed_tau_by_process_time(t, 1, 0.25, reordering))


@pytest.mark.parametrize("shape", [(960, 1280), (480, 640), (187, 251)])
def test_plan_equals_jax(shape):
    jp = jplan.build_plan(*shape, jcfg.AkazeConfig())
    tp = tplan.build_plan(*shape, tcfg.AkazeConfig())
    jd = dataclasses.asdict(jp)
    td = dataclasses.asdict(tp)
    jd.pop("config")
    td.pop("config")
    assert jd == td


def test_reflect_pad_is_numpy_reflect(planes):
    x = planes[0]
    for r in (1, 2, 4):
        got = tconv.pad_reflect(tconv.pad_reflect(torch.from_numpy(x), r, -1),
                                r, -2)
        np.testing.assert_array_equal(got.numpy(),
                                      np.pad(x, r, mode="reflect"))


@pytest.mark.parametrize("var,ksz", [(1.0, 5), (2.56, 9), (1.7, 7)])
def test_lowpass(planes, var, ksz):
    assert tconv.gauss_half_kernel(var, tconv.radius_for_ksize(ksz)) == \
        jconv.gauss_half_kernel(var, jconv.radius_for_ksize(ksz))
    for x in planes:
        assert_plane_close(tconv.lowpass(torch.from_numpy(x), var, ksz),
                           jconv.lowpass(jnp.asarray(x), var, ksz))


def test_lowpass_batched_equals_per_image(planes):
    got = tconv.lowpass(torch.from_numpy(planes), 1.0, 5)
    for i, x in enumerate(planes):
        torch.testing.assert_close(got[i], tconv.lowpass(torch.from_numpy(x),
                                                         1.0, 5),
                                   rtol=0, atol=0)


def test_down_with_smooth(planes, test_image):
    for x in (planes[0], test_image[:187, :251]):
        d_t, s_t = tconv.down_with_smooth(torch.from_numpy(x))
        d_j, s_j = jconv.down_with_smooth(jnp.asarray(x))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        assert_plane_close(s_t, s_j)


@pytest.mark.parametrize("step", [1, 2, 3, 4])
def test_scharr_derivatives_and_hessian(test_image, step):
    x = test_image[:96, :131]
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    lx_t, ly_t = tscharr.scaled_derivatives(xt, step)
    lx_j, ly_j = jscharr.scaled_derivatives(xj, step)
    assert_plane_close(lx_t, lx_j)
    assert_plane_close(ly_t, ly_j)
    assert_plane_close(tscharr.hessian_determinant(lx_t, ly_t, step),
                       jscharr.hessian_determinant(lx_j, ly_j, step))
    if step == 1:
        assert_plane_close(tscharr.scharr_magnitude(xt),
                           jscharr.scharr_magnitude(xj))


@pytest.mark.parametrize("diffusivity", list(tcfg.Diffusivity))
def test_conductivity(test_image, diffusivity):
    x = test_image[:80, :112]
    kc = np.float32(0.21)
    got = tdiff.conductivity(torch.from_numpy(x), diffusivity,
                             torch.tensor(kc))
    want = jdiff.conductivity(jnp.asarray(x), jcfg.Diffusivity(diffusivity),
                              jnp.float32(kc))
    assert_plane_close(got, want)


def test_nld_step(planes):
    rng = np.random.default_rng(5)
    flow = rng.uniform(0.2, 1.0, planes.shape[1:]).astype(np.float32)
    for tau in (0.1837, 2.5):
        got = tdiff.nld_step(torch.from_numpy(planes[0]),
                             torch.from_numpy(flow), tau)
        want = jdiff.nld_step(jnp.asarray(planes[0]), jnp.asarray(flow), tau)
        assert_plane_close(got, want)


def test_percentile_contrast(test_image, planes):
    for x in (test_image, planes[0], test_image[:67, :99] * 0.01):
        mag = np.asarray(jscharr.scharr_magnitude(
            jconv.lowpass(jnp.asarray(x), 1.0, 5)))
        want = float(jcontrast.percentile_contrast(jnp.asarray(mag), 0.7))
        got = tcontrast.percentile_contrast(torch.tensor(mag), 0.7)
        assert abs(float(got) - want) <= 1e-6 * want
    # batched: one kcontrast per image
    mags = np.stack([np.asarray(jscharr.scharr_magnitude(jnp.asarray(p)))
                     for p in planes])
    got = tcontrast.percentile_contrast(torch.tensor(mags), 0.7)
    for i, m in enumerate(mags):
        want = float(jcontrast.percentile_contrast(jnp.asarray(m), 0.7))
        assert abs(float(got[i]) - want) <= 1e-6 * want


# --------------------------------------------------------------------------
# 16.16 fixed-point ops: bit-exact against the JAX package and tests/golden
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw(test_image):
    """The blob test image quantised to raw 0..255 int32, the fixed path's
    input."""
    return (test_image * 255).astype(np.uint8).astype(np.int32)


def assert_equal(got, want, err_msg=""):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), err_msg=err_msg)


@pytest.mark.parametrize("var,ksz", [(1.0, 5), (2.56, 9), (1.7, 7)])
def test_lowpass_fixed(raw, var, ksz):
    r = tconv.radius_for_ksize(ksz)
    taps = tconv.gauss_half_kernel_fixed(var, r)
    assert taps == jconv.gauss_half_kernel_fixed(var, r)
    x = raw[:97, :131]
    got = tconv.lowpass_fixed(torch.from_numpy(x), var, ksz)
    assert got.dtype == torch.int32
    assert_equal(got, jconv.lowpass_fixed(jnp.asarray(x), var, ksz))
    assert_equal(got, golden.sep_conv2d_fixed(x, taps))


def test_down_with_smooth_fixed(raw):
    for x in (raw[:97, :131], raw[:186, :250]):
        d_t, s_t = tconv.down_with_smooth_fixed(torch.from_numpy(x))
        d_j, s_j = jconv.down_with_smooth_fixed(jnp.asarray(x))
        assert_equal(d_t, d_j)
        assert_equal(s_t, s_j)


@pytest.mark.parametrize("step", [1, 2, 3, 4])
def test_scharr_fixed(raw, step):
    assert (tscharr.SCHARR_IFAC1, tscharr.SCHARR_IFAC2) == \
        (jscharr.SCHARR_IFAC1, jscharr.SCHARR_IFAC2)
    x = raw[:96, :131]
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    lx_t, ly_t = tscharr.scaled_derivatives_fixed(xt, step)
    lx_j, ly_j = jscharr.scaled_derivatives_fixed(xj, step)
    assert_equal(lx_t, lx_j)
    assert_equal(ly_t, ly_j)
    assert_equal(tscharr.hessian_determinant_fixed(lx_t, ly_t, step),
                 jscharr.hessian_determinant_fixed(lx_j, ly_j, step))
    dx, dy = tscharr.scharr_gradient_xy(xt, step)
    for got, want in zip((dx, dy), golden.scharr_xy(x, step)):
        assert_equal(got, want)
    if step == 1:
        assert_equal(tscharr.scharr_magnitude_fixed(xt),
                     jscharr.scharr_magnitude_fixed(xj))


@pytest.mark.parametrize("diffusivity", list(tcfg.Diffusivity))
def test_conductivity_fixed(raw, diffusivity):
    x = raw[:80, :112]
    kc = np.int32(23)
    got = tdiff.conductivity_fixed(torch.from_numpy(x), diffusivity,
                                   torch.tensor(kc))
    assert got.dtype == torch.int32
    assert_equal(got, jdiff.conductivity_fixed(
        jnp.asarray(x), jcfg.Diffusivity(diffusivity), jnp.int32(kc)))


def test_nld_step_fixed():
    """Bit-exact, including int32 wrap-around: a long FED step's factor
    times the neighbourhood sum of a rough image leaves the int32 range."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (61, 83)).astype(np.int32)
    flow = rng.integers(0, 65537, x.shape).astype(np.int32)
    wrapped = False
    for tau in (0.1837, 2.5, 150.0):
        got = tdiff.nld_step_fixed(torch.from_numpy(x),
                                   torch.from_numpy(flow), tau)
        assert_equal(got, jdiff.nld_step_fixed(jnp.asarray(x),
                                               jnp.asarray(flow), tau))
        wide = tdiff.nld_step_fixed(torch.from_numpy(x).long(),
                                    torch.from_numpy(flow).long(), tau)
        wrapped |= bool((wide != got.long()).any())
    assert wrapped   # the trap is real


def test_percentile_contrast_fixed(raw):
    mags = []
    for x in (raw, raw[:67, :99], raw[:67, :99] // 16):
        mag = np.asarray(jscharr.scharr_magnitude_fixed(
            jconv.lowpass_fixed(jnp.asarray(x), 1.0, 5)))
        want = int(jcontrast.percentile_contrast_fixed(jnp.asarray(mag),
                                                       0.7))
        got = tcontrast.percentile_contrast_fixed(torch.tensor(mag), 0.7)
        assert got.dtype == torch.int32 and int(got) == want
        mags.append(mag[:60, :90])
    # batched: one kcontrast per image
    got = tcontrast.percentile_contrast_fixed(torch.from_numpy(
        np.stack(mags)), 0.7)
    for i, m in enumerate(mags):
        assert int(got[i]) == int(jcontrast.percentile_contrast_fixed(
            jnp.asarray(m), 0.7))
