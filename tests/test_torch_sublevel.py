"""Kernel K1 (the fused scale-space sublevel) and the scale space of the
PyTorch port against the JAX package's fused Pallas kernel, run in
interpret mode on the CPU as the JAX package's own tests run it.

On the CPU the port's ``sublevel`` runs its plain version;
tests/test_torch_cuda.py holds the CUDA kernel to it on the card.

Tolerance: 1e-5 of each plane's max |value|.  L, Lx and Ly are compared
everywhere; det only on the interior, outside a band of 2*step+2 px: there
the fused kernels take the analytic continuation of Lx/Ly across the
border, where the op path reflects the derivative plane (an odd function,
so its sign flips).  The band lies inside the extrema border, so detection
does not see it (``test_det_border_band_inside_extrema_border``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu.config import Diffusivity as JDiffusivity
from akaze_tpu.ops import conv as jconv
from akaze_tpu.ops.pallas_sublevel import fused_sublevel_batch
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu.scale_space import build_scale_space as jbuild_scale_space
from akaze_tpu_torch import build_plan, config_from
from akaze_tpu_torch.config import Diffusivity
from akaze_tpu_torch.ops.sublevel import (MAX_HALO, chain_launches,
                                          fused_supported, halo_for,
                                          sublevel)
from akaze_tpu_torch.scale_space import build_scale_space

torch.set_num_threads(1)

TOL = 1e-5
IKC = np.asarray([3.1, 8.7], np.float32)
CASES = {
    # first sublevel: base lowpass (var soffset^2, radius 4), no FED
    "first": dict(taus=(), step=2, smooth_var=2.56, smooth_radius=4,
                  first_sublevel=True),
    # octave start: the smooth comes from outside
    "octave_start": dict(taus=(0.25, 0.31, 0.18, 0.4), step=2,
                         smooth=True),
    # next sublevel: in-kernel sigma-1 smooth, FED chain, step 3
    "next": dict(taus=(0.25, 0.2, 0.15), step=3),
}


def _pair(test_image):
    a = test_image[:160, :208]
    return np.stack([a, np.roll(a, (3, 11), axis=(0, 1))])


def _smooth(pair):
    return np.stack([np.asarray(jconv.lowpass(jnp.asarray(p), 1.0, 5))
                     for p in pair])


def assert_planes_close(got, want, step, names=("L", "det", "lx", "ly")):
    m = 2 * step + 2
    for name, g, w in zip(names, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if name == "det":
            g, w = g[..., m:-m, m:-m], w[..., m:-m, m:-m]
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale,
                                   err_msg=name)


def _run_both(pair, case, diffusivity=Diffusivity.PM_G2):
    kw = dict(CASES[case])
    taus, step = kw.pop("taus"), kw.pop("step")
    smooth = _smooth(pair) if kw.pop("smooth", False) else None
    want = fused_sublevel_batch(
        jnp.asarray(pair), jnp.asarray(IKC), taus, step,
        smooth=None if smooth is None else jnp.asarray(smooth),
        interpret=True, diffusivity=JDiffusivity(int(diffusivity)), **kw)
    got = sublevel(torch.from_numpy(pair), torch.from_numpy(IKC), taus,
                   step, smooth=None if smooth is None
                   else torch.from_numpy(smooth),
                   diffusivity=diffusivity, **kw)
    return got, want, step


@pytest.mark.parametrize("case", sorted(CASES))
def test_sublevel_matches_fused_pallas(test_image, case):
    got, want, step = _run_both(_pair(test_image), case)
    assert_planes_close(got, want, step)


@pytest.mark.parametrize("diffusivity", [Diffusivity.PM_G1,
                                         Diffusivity.WEICKERT,
                                         Diffusivity.CHARBONNIER])
def test_sublevel_other_diffusivities(test_image, diffusivity):
    got, want, step = _run_both(_pair(test_image), "next", diffusivity)
    assert_planes_close(got, want, step)


def test_det_border_band_inside_extrema_border(test_image):
    """The only det difference from the fused kernel is the border band,
    and every sublevel's extrema rectangle starts beyond it."""
    got, want, step = _run_both(_pair(test_image), "next")
    m = 2 * step + 2
    diff = np.abs(got[1].numpy() - np.asarray(want[1]))
    scale = float(np.abs(np.asarray(want[1])).max())
    inner = np.zeros(diff.shape[1:], bool)
    inner[m:-m, m:-m] = True
    assert diff[:, inner].max() <= TOL * scale
    assert diff[:, ~inner].max() > TOL * scale   # the trap is real
    plan = build_plan(960, 1280, config_from({}))
    for octave in plan.octaves:
        for sp in octave.scales:
            band = 2 * sp.sigma_size + 2
            assert band < sp.x_lo and band < sp.y_lo
            assert octave.width - 1 - sp.x_hi > band
            assert octave.height - 1 - sp.y_hi > band


def test_halo_and_support_guard():
    from akaze_tpu.ops.pallas_sublevel import _halo_for
    for step, n, r in ((2, 0, 4), (3, 3, 2), (4, 29, 2), (2, 17, 2)):
        # the port drops the TPU's 8-row alignment, nothing else
        assert halo_for(step, n, r) <= _halo_for(step, n, r)
        assert _halo_for(step, n, r) == -(-halo_for(step, n, r) // 8) * 8
    taus = (0.1,) * 7
    halo = halo_for(4, len(taus))
    assert fused_supported(halo + 2, 500, taus, 4)
    assert not fused_supported(halo + 1, 500, taus, 4)
    assert not fused_supported(500, halo + 1, taus, 4)


@pytest.mark.parametrize("shape, noctaves, splits", [
    ((960, 1280), 4, 0),     # the main path: one launch per sublevel
    ((1280, 1920), 5, 4),    # the fifth octave's chains of 34-57 steps
])
def test_long_chains_split_into_launches(shape, noctaves, splits):
    """Each K1 launch's halo fits its shared memory (MAX_HALO); a longer
    FED chain is cut into launches that together run every step once, in
    order, and only the first (which also takes the derivatives) needs
    the derivative reach."""
    plan = build_plan(*shape, config_from({"noctaves": noctaves}))
    extra = 0
    for octave in plan.octaves:
        for sp in octave.scales:
            launches = chain_launches(sp.taus, sp.sigma_size)
            assert sum((c for c, _ in launches), ()) == tuple(sp.taus)
            assert launches[0][1] == halo_for(sp.sigma_size,
                                              len(launches[0][0]))
            for chunk, halo in launches:
                assert len(chunk) + 3 <= halo <= MAX_HALO
            extra += len(launches) - 1
    assert extra == splits


def test_sublevel_rejects_bad_input():
    x = torch.zeros((1, 40, 50))
    with pytest.raises(ValueError):
        sublevel(x[0], torch.ones(1), (), 2)
    with pytest.raises(TypeError):
        sublevel(x.double(), torch.ones(1), (), 2)
    with pytest.raises(ValueError):
        sublevel(x, torch.ones(2), (), 2)


@pytest.fixture(scope="module")
def scale_spaces(test_image):
    """The pair's scale space from both packages (2 octaves)."""
    pair = _pair(test_image)
    jcfg = JConfig(max_pts=256, noctaves=2, pallas_scale_space="interpret")
    jplan = jbuild_plan(*pair.shape[1:], jcfg)
    want, kc_want = jbuild_scale_space(jnp.asarray(pair), jplan)
    plan = build_plan(*pair.shape[1:], config_from(jcfg.__dict__))
    sublevel.launches = 0
    got, kc_got = build_scale_space(torch.from_numpy(pair), plan)
    return got, kc_got, want, kc_want, plan


def test_scale_space_matches_jax(scale_spaces):
    got, kc_got, want, kc_want, plan = scale_spaces
    np.testing.assert_allclose(kc_got.numpy(), np.asarray(kc_want),
                               rtol=1e-6, atol=0)
    for og, ow, oplan in zip(got, want, plan.octaves):
        for si, sp in enumerate(oplan.scales):
            assert_planes_close([getattr(og, n)[:, si] for n in og._fields],
                                [getattr(ow, n)[:, si] for n in og._fields],
                                sp.sigma_size, og._fields)


def test_cpu_path_launches_no_kernel(scale_spaces):
    assert sublevel.launches == 0


def test_small_plane_takes_op_path(test_image):
    """A plane no larger than the halo takes the op path; the result still
    matches the JAX package's op path, det included, border and all."""
    img = test_image[:11, :200]
    jcfg = JConfig(max_pts=64, noctaves=1, pallas_scale_space="off")
    plan = build_plan(*img.shape, config_from(jcfg.__dict__))
    last = plan.octaves[0].scales[-1]
    assert not fused_supported(*img.shape, last.taus, last.sigma_size)
    got, kc_got = build_scale_space(torch.from_numpy(img), plan)
    want, kc_want = jbuild_scale_space(jnp.asarray(img),
                                       jbuild_plan(*img.shape, jcfg))
    assert abs(float(kc_got) - float(kc_want)) <= 1e-6 * float(kc_want)
    for name in got[0]._fields:
        w = np.asarray(getattr(want[0], name))
        np.testing.assert_allclose(getattr(got[0], name).numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=name)

