"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
This file imports neither jax nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 planes within 1e-5 of each plane's max (det on the
interior for the tiled kernel, see test_torch_sublevel.py, and on the whole
plane for the octave-resident kernel); K2 angles within 1e-3 rad and 0
flipped descriptor bits; K4 and ``Matches`` exactly.  The 16.16 fixed
flavours are integer arithmetic and are held exactly: K1's planes against
its plain version run on the card, for every
diffusivity (the kernel's ``expf`` is PyTorch's CUDA ``exp`` bit for bit;
PyTorch's CPU ``exp`` is not, so PM_G1 and WEICKERT are compared on one
device), and the fixed pipeline's keypoints, words and ``Matches`` against
the CPU plain pipeline (PM_G2).
"""

import contextlib

import numpy as np
import pytest
import torch

from akaze_tpu_torch import Akaze, AkazeConfig, build_plan
from akaze_tpu_torch.config import Diffusivity
from akaze_tpu_torch.descriptor import (WSIZE, finish_descriptors,
                                        slot_params, words_to_numpy,
                                        pack_bits)
from akaze_tpu_torch.detect import build_padded_pyramid, detect_keypoints
from akaze_tpu_torch.ops import describe as k2
from akaze_tpu_torch.ops import hamming as k4
from akaze_tpu_torch.ops import sublevel as k1
from akaze_tpu_torch.ops.conv import (down_with_smooth, down_with_smooth_fixed,
                                     lowpass, lowpass_fixed)
from akaze_tpu_torch.scale_space import OctaveData, build_scale_space
from akaze_tpu_torch.testing import (HOMOGRAPHY_CARD_TOL, homography_distance,
                                     homography_outlier_case)

TOL = 1e-5
SHIFT = (7, 13)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def texture(h, w, seed=0):
    """Seeded float32 blob texture in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    for _ in range(600):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s, a = rng.uniform(2, 5), rng.uniform(-0.6, 0.6)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img = 0.5 + 0.5 * img / np.abs(img).max()
    img += 0.03 * rng.standard_normal((h, w))
    return np.clip(img, 0, 1).astype(np.float32)


def pair(h=256, w=320):
    dy, dx = SHIFT
    t = texture(h + dy, w + dx)
    return t[:h, :w].copy(), t[dy:, dx:].copy()


def raw_pair(h=256, w=320):
    """The textured pair quantised to raw 0..255, the fixed path's input."""
    return tuple((x * 255).astype(np.uint8) for x in pair(h, w))


def bit_flips(w1, w2):
    x = words_to_numpy(w1.cpu()) ^ words_to_numpy(w2.cpu())
    return np.unpackbits(x.view(np.uint8), axis=1).sum(1)


CASES = {
    "first": dict(taus=(), step=2, smooth_var=2.56, smooth_radius=4,
                  first_sublevel=True),
    "octave_start": dict(taus=(0.25, 0.31, 0.18, 0.4), step=2,
                         smooth=True),
    "next": dict(taus=(0.25, 0.2, 0.15), step=3),
    "long_chain": dict(taus=tuple(np.linspace(0.05, 0.25, 29)), step=4),
    # too long for one launch's halo: two launches continue one chain
    "split_chain": dict(taus=tuple(np.linspace(0.05, 0.25, 57)), step=4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("diffusivity", list(Diffusivity))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sublevel_kernel_matches_plain(cuda, case, diffusivity):
    src = torch.from_numpy(np.stack(pair(120, 160)))
    ikc = torch.tensor([9.0, 14.0])
    kw = dict(CASES[case])
    taus, step = kw.pop("taus"), kw.pop("step")
    smooth = lowpass(src, 1.0, 5) if kw.pop("smooth", False) else None
    want = k1.sublevel_plain(src, ikc, taus, step, smooth=smooth,
                             diffusivity=diffusivity, **kw)
    before = k1.sublevel.launches
    got = k1.sublevel(src.to(cuda), ikc.to(cuda), taus, step,
                      smooth=None if smooth is None else smooth.to(cuda),
                      diffusivity=diffusivity, **kw)
    torch.cuda.synchronize()
    n = len(k1.chain_launches(taus, step, kw.get("smooth_radius", 2)))
    assert k1.sublevel.launches == before + n
    assert n == (2 if case == "split_chain" else 1)
    assert_planes_close(got, want, step)


def assert_planes_close(got, want, step, names=("L", "det", "lx", "ly")):
    """det on the interior (``step``), or on the whole plane (None)."""
    m = 0 if step is None else 2 * step + 2
    for name, g, w in zip(names, got, want):
        g, w = g.cpu(), w.cpu()
        if name == "det" and m:
            g, w = g[..., m:-m, m:-m], w[..., m:-m, m:-m]
        scale = max(float(w.abs().max()), 1e-6)
        assert float((g - w).abs().max()) <= TOL * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("diffusivity", list(Diffusivity))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_sublevel_kernel_matches_plain(cuda, case, diffusivity):
    src = torch.from_numpy(np.stack(raw_pair(120, 160)).astype(np.int32))
    ikc = 1.0 / torch.tensor([37 * 37, 52 * 52], dtype=torch.int32).float()
    kw = dict(CASES[case])
    taus, step = kw.pop("taus"), kw.pop("step")
    smooth = (lowpass_fixed(src, 1.0, 5).to(cuda) if kw.pop("smooth", False)
              else None)
    args = (src.to(cuda), ikc.to(cuda), taus, step)
    kw.update(smooth=smooth, diffusivity=diffusivity, fixed=True)
    want = k1.sublevel_plain(*args, **kw)
    before = k1.sublevel.launches
    got = k1.sublevel(*args, **kw)
    torch.cuda.synchronize()
    n = len(k1.chain_launches(taus, step, kw.get("smooth_radius", 2)))
    assert k1.sublevel.launches == before + n
    m = 2 * step + 2
    for name, g, w in zip(("L", "det", "lx", "ly"), got, want):
        assert g.dtype == torch.int32, name
        d = (g.long() - w.long()).abs()
        if name == "det":
            d = d[..., m:-m, m:-m]
        assert int(d.max()) == 0, (name, int(d.max()), int((d > 0).sum()))


@pytest.mark.cuda
def test_five_octaves_of_a_large_image(cuda, monkeypatch):
    """noctaves=5 at 1280x1920: octaves 0-2 take the tiled kernel, octaves
    3-4 the resident one, whose FED chains of up to 57 steps run unsplit:
    4 + 4 + 4 + 1 + 1 = 14 launches.  Each of the scale space's K1 calls
    equals its plain version on the same inputs, and the pair path
    recovers a known shift.

    Lx, Ly and det are held to 1e-5 of the plane max (det on the whole
    plane in resident octaves).  So is L, except where the FED chain itself
    is ill-conditioned in float32 (the 40-step chain of octave 4, sublevel
    1 moves by ~6e-4 for a 1e-7 relative change of its input): there K1's
    L must lie no further from a float64 evaluation of the plain version
    than 4x the float32 plain version does."""
    import akaze_tpu_torch.scale_space as ss
    h, w = 1280, 1920
    coarse = texture((h + SHIFT[0]) // 4 + 2, (w + SHIFT[1]) // 4 + 2, seed=5)
    big = torch.nn.functional.interpolate(
        torch.from_numpy(coarse)[None, None], scale_factor=4,
        mode="bilinear", align_corners=False)[0, 0].numpy()
    rng = np.random.default_rng(5)
    big = np.clip(big + 0.03 * rng.standard_normal(big.shape), 0, 1)
    a = big[:h, :w].astype(np.float32)
    b = big[SHIFT[0]:SHIFT[0] + h, SHIFT[1]:SHIFT[1] + w].astype(np.float32)
    det = Akaze(AkazeConfig(max_pts=10000, noctaves=5), device=cuda)
    plan = det.plan_for(h, w)
    assert len(plan.octaves) == 5
    assert max(len(sp.taus) for sp in plan.octaves[4].scales) > 29
    resident = [o.octave for o in plan.octaves
                if k1.routes_resident(o, (2.56, 4) if o.octave == 0 else None)]
    assert resident == [3, 4]

    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return k1.octave(*args, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(ss, "octave", recording)
        build_scale_space(torch.from_numpy(a).to(cuda), plan)
    assert len(calls) == 5
    for o, ((src, ikc, op), kw) in zip(plan.octaves, calls):
        got = k1.octave(src, ikc, op, **kw)
        want = k1.octave_plain(src, ikc, op, **kw)
        kw64 = {k: v.double() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}
        exact = k1.octave_plain(src.double(), ikc.double(), op, **kw64)[0]
        for s, sp in enumerate(o.scales):
            step = None if o.octave in resident else sp.sigma_size
            plain_err = float((want[0][:, s].double()
                               - exact[:, s]).abs().max())
            got_err = float((got[0][:, s].double() - exact[:, s]).abs().max())
            scale = float(exact[:, s].abs().max())
            assert got_err <= max(TOL * scale, 4 * plain_err), (o.octave, s)
            assert_planes_close([p[:, s] for p in got[1:]],
                                [p[:, s] for p in want[1:]], step,
                                ("det", "lx", "ly"))
            if plain_err < 0.1 * TOL * scale:      # a well-conditioned chain
                assert_planes_close(got[0][:, s:s + 1], want[0][:, s:s + 1],
                                    step, ("L",))

    before = k1.launches()
    fa, fb = det.detect_and_compute_pair(a, b)
    m = det.match(fa, fb)
    torch.cuda.synchronize()
    assert k1.launches() - before == 14     # 4 + 4 + 4 + 1 + 1
    n = int(fa.count)
    acc = m.index[:n] >= 0
    dx = (m.match_x[:n] - fa.x[:n])[acc].cpu().numpy()
    dy = (m.match_y[:n] - fa.y[:n])[acc].cpu().numpy()
    assert acc.sum() > 100
    # the upsampled texture puts keypoints off the pixel grid, so the
    # shift is held to 0.1 px and the inliers to 1.5 px
    assert abs(np.median(dx) + SHIFT[1]) < 0.1
    assert abs(np.median(dy) + SHIFT[0]) < 0.1
    inliers = (np.abs(dx + SHIFT[1]) < 1.5) & (np.abs(dy + SHIFT[0]) < 1.5)
    assert inliers.mean() > 0.85


def _octave_inputs(cuda, fixed, h=160, w=200):
    """The inputs of both octaves of a 160x200 two-octave plan (both
    resident): octave 0 from the image with the base smooth, octave 1 from
    the decimated last L with its smooth."""
    plan = build_plan(h, w, AkazeConfig(max_pts=512, noctaves=2))
    if fixed:
        src = torch.from_numpy(np.stack(raw_pair(h, w)).astype(np.int32))
        ikc = 1.0 / torch.tensor([37 * 37, 52 * 52], dtype=torch.int32).float()
    else:
        src = torch.from_numpy(np.stack(pair(h, w)))
        ikc = torch.tensor([9.0, 14.0])
    src, ikc = src.to(cuda), ikc.to(cuda)
    first = k1.octave_plain(src, ikc, plan.octaves[0], base=(2.56, 4),
                            fixed=fixed)
    down = (down_with_smooth_fixed if fixed else down_with_smooth)(
        first[0][:, -1])
    return plan, [(src, dict(base=(2.56, 4))),
                  (down[0], dict(smooth=down[1]))], ikc


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("diffusivity", list(Diffusivity))
def test_octave_kernel_matches_plain(cuda, diffusivity, fixed):
    """The octave-resident kernel against the plain version on the card,
    every plane of every sublevel, det on the whole plane; float within
    1e-5 of each plane's max, fixed bit-exact (PM_G1 and WEICKERT too:
    both sides take CUDA's exp)."""
    plan, inputs, ikc = _octave_inputs(cuda, fixed)
    for op, (src, kw) in zip(plan.octaves, inputs):
        assert k1.routes_resident(op, kw.get("base"))
        kw.update(diffusivity=diffusivity, fixed=fixed)
        want = k1.octave_plain(src, ikc, op, **kw)
        before = (k1.octave.launches, k1.sublevel.launches)
        got = k1.octave(src, ikc, op, **kw)
        torch.cuda.synchronize()
        assert (k1.octave.launches, k1.sublevel.launches) == (
            before[0] + 1, before[1])
        for name, g, w in zip(("L", "det", "lx", "ly"), got, want):
            assert g.shape == w.shape == (2, 4, op.height, op.width)
            if fixed:
                d = (g.long() - w.long()).abs()
                assert int(d.max()) == 0, (op.octave, name, int(d.max()))
            else:
                for s in range(g.shape[1]):
                    scale = max(float(w[:, s].abs().max()), 1e-6)
                    err = float((g[:, s] - w[:, s]).abs().max())
                    assert err <= TOL * scale, (op.octave, name, s)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_small_plane_runs_on_the_resident_kernel(cuda, fixed):
    """An 11x200 plane, too small for the tiled kernel's halo, runs on the
    resident kernel and equals the plain version on every plane."""
    img = texture(11, 200, seed=3)
    plan = build_plan(11, 200, AkazeConfig(max_pts=64, noctaves=1))
    op = plan.octaves[0]
    last = op.scales[-1]
    assert not k1.fused_supported(11, 200, last.taus, last.sigma_size)
    src = torch.from_numpy(img[None])
    if fixed:
        src = (src * 255).to(torch.uint8).to(torch.int32)
    src = src.to(cuda)
    ikc = torch.tensor([11.0], device=cuda)
    kw = dict(base=(2.56, 4), fixed=fixed)
    want = k1.octave_plain(src, ikc, op, **kw)
    before = k1.octave.launches
    got = k1.octave(src, ikc, op, **kw)
    torch.cuda.synchronize()
    assert k1.octave.launches == before + 1
    for name, g, w in zip(("L", "det", "lx", "ly"), got, want):
        scale = max(float(w.abs().max()), 1e-6)
        tol = 0 if fixed else TOL * scale
        assert float((g.double() - w.double()).abs().max()) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, resident", [(120, 160, True),
                                            (480, 640, False)])
def test_octave_outputs_alias_one_stack(cuda, h, w, resident):
    """K1 writes L, det, Lx and Ly straight into one [4, B, S, H, W]
    allocation per octave (both kernels): the four planes are views of it,
    and what the kernels wrote there equals the plain version."""
    plan = build_plan(h, w, AkazeConfig(max_pts=512, noctaves=1))
    op = plan.octaves[0]
    assert k1.routes_resident(op, (2.56, 4)) == resident
    src = torch.from_numpy(np.stack(pair(h, w))).to(cuda)
    ikc = torch.tensor([9.0, 14.0], device=cuda)
    got = k1.octave(src, ikc, op, base=(2.56, 4))
    want = k1.octave_plain(src, ikc, op, base=(2.56, 4))
    torch.cuda.synchronize()
    base = got[0].untyped_storage().data_ptr()
    for i, g in enumerate(got):
        assert g.untyped_storage().data_ptr() == base
        assert g.storage_offset() == i * g.numel()
        assert g.is_contiguous() and g.shape == (2, 4, h, w)
    for s, sp in enumerate(op.scales):
        step = None if resident else sp.sigma_size
        assert_planes_close([p[:, s] for p in got], [p[:, s] for p in want],
                            step)


@pytest.mark.cuda
def test_describe_kernel_matches_plain(cuda):
    plan = build_plan(256, 320, AkazeConfig(max_pts=512, noctaves=2))
    images = torch.from_numpy(np.stack(pair()))
    octs, _ = build_scale_space(images, plan)
    per_image = [[OctaveData(*(p[i] for p in o)) for o in octs]
                 for i in range(2)]
    kps = [detect_keypoints(o, plan) for o in per_image]
    pp = build_padded_pyramid([o for img in per_image for o in img], WSIZE)
    nplanes = pp.L.shape[0] // 2
    params = [slot_params(k, pp, plan, plane_base=i * nplanes,
                          nplanes=nplanes) for i, k in enumerate(kps)]
    ip = torch.cat([p[0] for p in params])
    fp = torch.cat([p[1] for p in params])
    assert int(ip[:, 6].sum()) > 20
    planes = (pp.L, pp.lx, pp.ly)
    want = k2.describe_plain(ip, fp, planes, k2.describe_tables(10, ip.device))
    before = k2.describe.launches
    got = k2.describe(ip.to(cuda), fp.to(cuda),
                      tuple(p.to(cuda) for p in planes),
                      k2.describe_tables(10, cuda))
    torch.cuda.synchronize()
    assert k2.describe.launches == before + 1
    d = (got[0].cpu() - want[0]).abs()
    assert float(torch.minimum(d, 2 * np.pi - d).max()) < 1e-3
    assert bit_flips(finish_descriptors(got[1]),
                     finish_descriptors(want[1])).max() == 0


@pytest.mark.cuda
def test_fixed_describe_kernel_matches_plain(cuda):
    """The exact fixed flavour on f32 planes of the fixed scale space."""
    plan = build_plan(256, 320, AkazeConfig(max_pts=512, noctaves=2,
                                            fixed_exact_sampling=True))
    images = torch.from_numpy(np.stack(raw_pair()).astype(np.int32))
    octs, _ = build_scale_space(images, plan)
    per_image = [[OctaveData(*(p[i] for p in o)) for o in octs]
                 for i in range(2)]
    kps = [detect_keypoints(o, plan) for o in per_image]
    pp = build_padded_pyramid([o for img in per_image for o in img], WSIZE,
                              torch.float32)
    nplanes = pp.L.shape[0] // 2
    params = [slot_params(k, pp, plan, plane_base=i * nplanes,
                          nplanes=nplanes) for i, k in enumerate(kps)]
    ip = torch.cat([p[0] for p in params])
    fp = torch.cat([p[1] for p in params])
    assert int(ip[:, 6].sum()) > 20
    planes = (pp.L, pp.lx, pp.ly)
    want = k2.describe_plain(ip, fp, planes, k2.describe_tables(10, ip.device),
                             fixed=True)
    before = k2.describe.launches
    got = k2.describe(ip.to(cuda), fp.to(cuda),
                      tuple(p.to(cuda) for p in planes),
                      k2.describe_tables(10, cuda), fixed=True)
    torch.cuda.synchronize()
    assert k2.describe.launches == before + 1
    d = (got[0].cpu() - want[0]).abs()
    assert float(torch.minimum(d, 2 * np.pi - d).max()) < 1e-3
    assert bit_flips(finish_descriptors(got[1]),
                     finish_descriptors(want[1])).max() == 0


# K2 on hand-made slots: (plane, y0, x0, oy, ox, iscale, live, yf, xf), the
# window-local geometry that descriptor.slot_params produces
def _k2_planes(cuda, fixed, L, lx, ly):
    """[P, H, W] numpy planes as K2 takes them: bf16, or f32 integers (the
    fixed flavour; the values are scaled to 16.16)."""
    if fixed:
        return tuple(torch.from_numpy(np.round(p * 65536).astype(np.float32))
                     .to(cuda) for p in (L, lx, ly))
    return tuple(torch.from_numpy(p.astype(np.float32)).to(cuda)
                 .to(torch.bfloat16) for p in (L, lx, ly))


def _k2_case(cuda, fixed, planes, slots):
    """The kernel against its plain version, both on the card: angles within
    1e-3 rad and 0 flipped bits on live slots, zeros on dead ones.  Returns
    the plain version's angles."""
    s = np.asarray(slots, np.float64)
    ip = torch.zeros((len(slots), 8), dtype=torch.int32)
    ip[:, :7] = torch.from_numpy(s[:, :7].astype(np.int32))
    fp = torch.from_numpy(s[:, 7:9].astype(np.float32))
    ip, fp = ip.to(cuda), fp.to(cuda)
    tables = k2.describe_tables(10, cuda)
    want = k2.describe_plain(ip, fp, planes, tables, fixed)
    before = k2.describe.launches
    got = k2.describe(ip, fp, planes, tables, fixed)
    torch.cuda.synchronize()
    assert k2.describe.launches == before + 1
    live = ip[:, 6] > 0
    d = (got[0] - want[0]).abs()
    d = torch.minimum(d, 2 * np.pi - d)[live]
    flips = bit_flips(finish_descriptors(got[1]),
                      finish_descriptors(want[1]))[live.cpu().numpy()]
    print(f"K2 {'fixed' if fixed else 'float'}: {int(live.sum())} live of "
          f"{len(slots)}, max angle err {float(d.max())}, max cell-sum "
          f"difference {float((got[1] - want[1]).abs().max())}")
    assert float(d.max()) < 1e-3
    assert flips.max() == 0
    assert (got[0][~live] == 0).all() and (got[1][~live] == 0).all()
    return want[0].cpu().numpy()


def _random_planes(cuda, fixed, shape, seed):
    rng = np.random.default_rng(seed)
    return _k2_planes(cuda, fixed, rng.uniform(0, 1, shape),
                      rng.normal(0, 0.1, shape), rng.normal(0, 0.1, shape))


def _random_slots(rng, n, isc, plane=0, y0=0, x0=0, live=None):
    oy, ox = rng.integers(24, 104, (2, n))
    sub = rng.uniform(-0.5, 0.5, (2, n))
    live = np.ones(n, bool) if live is None else live
    return [(plane, y0, x0, oy[i], ox[i], isc, int(live[i]),
             oy[i] + sub[0, i], ox[i] + sub[1, i]) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_describe_orientation_ties(cuda, fixed):
    """Two taps of equal weight whose gradients have exactly equal
    magnitude put equal maxima in windows of different angle; the first
    maximum (the lowest window) must win, also when the two windows are a
    lane's two bins (b and b + 32)."""
    L, lx, ly = (np.zeros((2, 160, 160)) for _ in range(3))
    y0 = x0 = 16
    c = 64 + 16          # the slots' centre pixel, iscale 2: taps 6 px apart
    # plane 0: (1, 0) at (0, +3) (bin 21, windows 15-21) and (0, 1) at
    # (+3, 0) (bin 31, windows 25-31): window 15 wins, angle 0
    lx[0, c, c + 6] = 1.0
    ly[0, c + 6, c] = 1.0
    # plane 1: mirror images (bins 5 and 37): windows 0-5 tie with 32-37
    lx[1, c, c + 6], ly[1, c, c + 6] = -0.78125, -0.625
    lx[1, c, c - 6], ly[1, c, c - 6] = -0.78125, 0.625
    planes = _k2_planes(cuda, fixed, L, lx, ly)
    slots = [(p, y0, x0, 64, 64, 2, 1, 64.2, 63.9) for p in (0, 1)]
    angle = _k2_case(cuda, fixed, planes, slots)
    assert abs(angle[0]) < 1e-6
    first = 2 * np.pi + np.arctan2(-0.625, -0.78125)
    assert abs(angle[1] - first) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_describe_flat_planes(cuda, fixed):
    """Zero gradients: every tap falls in one bin with zero sums, every
    window ties at 0, the angle is 0."""
    shape = (1, 128, 128)
    planes = _k2_planes(cuda, fixed, np.full(shape, 0.5), np.zeros(shape),
                        np.zeros(shape))
    rng = np.random.default_rng(11)
    angle = _k2_case(cuda, fixed, planes, _random_slots(rng, 9, 3))
    assert (angle == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_describe_taps_leave_the_window(cuda, fixed):
    """Centres at each corner of a window lying inside a larger plane of
    non-zero values: the taps outside the window read 0, not the plane."""
    planes = _random_planes(cuda, fixed, (2, 300, 320), 12)
    slots = []
    for isc in (2, 4):
        for oy, ox in ((1, 2), (2, 126), (125, 1), (126, 125), (64, 0)):
            slots.append((1, 100, 120, oy, ox, isc, 1, oy + 0.3, ox - 0.4))
    _k2_case(cuda, fixed, planes, slots)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_describe_largest_iscale(cuda, fixed):
    """The largest iscale the 960x1280 plan produces (its largest sigma
    size, rounded)."""
    from akaze_tpu_torch.detect import size_table_for
    isc = max(int(s + 0.5) for s in size_table_for(
        build_plan(960, 1280, AkazeConfig())))
    assert isc >= 4
    planes = _random_planes(cuda, fixed, (3, 200, 240), 13)
    rng = np.random.default_rng(13)
    slots = [s for p in range(3)
             for s in _random_slots(rng, 12, isc, p, 30, 50)]
    _k2_case(cuda, fixed, planes, slots)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_describe_dead_slots_interleaved(cuda, fixed):
    planes = _random_planes(cuda, fixed, (2, 160, 192), 14)
    rng = np.random.default_rng(14)
    live = rng.random(64) < 0.5
    live[:2] = (False, True)
    slots = _random_slots(rng, 64, 3, 1, 10, 40, live)
    _k2_case(cuda, fixed, planes, slots)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("n", [1, 3, 131])
def test_describe_slot_count_not_a_block_multiple(cuda, fixed, n):
    planes = _random_planes(cuda, fixed, (1, 128, 128), 15)
    _k2_case(cuda, fixed, planes,
             _random_slots(np.random.default_rng(n), n, 2))


@pytest.mark.cuda
def test_hamming_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    n1, n2 = 1000, 1500
    b1 = rng.integers(0, 2, (n1, 486)).astype(bool)
    b2 = rng.integers(0, 2, (n2, 486)).astype(bool)
    b2[:n1] = b1 ^ (rng.random((n1, 486)) < 0.05)
    b2[n1:n1 + 100] = b2[:100]               # exact ties
    w1, w2 = pack_bits(torch.from_numpy(b1)), pack_bits(torch.from_numpy(b2))
    v2 = torch.from_numpy(rng.random(n2) > 0.2)
    v1 = torch.ones(n1, dtype=torch.bool)
    v1[-50:] = False
    c1, c2 = k4.last_live(v1), k4.last_live(v2)
    want = k4.hamming_top2_plain(w1, w2, v2, c1, c2)
    before = k4.hamming_top2.launches
    got = k4.hamming_top2(*(t.to(cuda) for t in (w1, w2, v2, c1, c2)))
    torch.cuda.synchronize()
    assert k4.hamming_top2.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(((want[0] == want[1]) & (want[2] >= 0)).any())


@pytest.mark.cuda
def test_wrappers_raise_on_mixed_devices(cuda):
    src = torch.zeros((1, 64, 64), device=cuda)
    with pytest.raises(ValueError):
        k1.sublevel(src, torch.ones(1), (0.2,), 2)
    w = torch.zeros((4, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k4.hamming_top2(w, w.cpu(), torch.ones(4, dtype=torch.bool),
                        k4.last_live(torch.ones(4, dtype=torch.bool)),
                        k4.last_live(torch.ones(4, dtype=torch.bool)))


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(cuda):
    a, b = pair()
    cfg = AkazeConfig(max_pts=512, noctaves=2)
    cpu = Akaze(cfg, device="cpu")
    ca, cb = cpu.detect_and_compute_pair(a, b)
    cm = cpu.match(ca, cb)
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_match)
    before = [c.launches for c in counters]
    gpu = Akaze(cfg, device=cuda)
    ga, gb = gpu.detect_and_compute_pair(a, b)
    gm = gpu.match(ga, gb)
    torch.cuda.synchronize()
    # octave 0 tiled (4 launches), octave 1 resident (1)
    assert [c.launches - n for c, n in zip(counters, before)] == [4, 1, 1, 1]
    for c, g in ((ca, ga), (cb, gb)):
        n = int(c.count)
        assert int(g.count) == n > 20
        assert torch.equal(c.layer, g.layer.cpu())
        assert float((c.x - g.x.cpu()).abs().max()) < 1e-4
        assert float((c.y - g.y.cpu()).abs().max()) < 1e-4
        assert bit_flips(c.words[:n], g.words[:n]).max() == 0
    assert torch.equal(cm.index, gm.index.cpu())
    n = int(ga.count)
    acc = gm.index[:n] >= 0
    dx = (gm.match_x[:n] - ga.x[:n])[acc].cpu().numpy()
    assert acc.sum() > 20 and np.median(dx) == -SHIFT[1]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_fixed_pipeline_on_card_matches_cpu(cuda, exact):
    """The fixed pair path, exact and approximate descriptor flavours: the
    card's keypoints, words and matches equal the CPU plain pipeline's."""
    a, b = raw_pair()
    cfg = AkazeConfig(max_pts=512, noctaves=2, fixed_exact_sampling=exact)
    cpu = Akaze(cfg, fixed=True, device="cpu")
    ca, cb = cpu.detect_and_compute_pair(a, b)
    cm = cpu.match(ca, cb)
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_match)
    before = [c.launches for c in counters]
    gpu = Akaze(cfg, fixed=True, device=cuda)
    ga, gb = gpu.detect_and_compute_pair(a, b)
    gm = gpu.match(ga, gb)
    torch.cuda.synchronize()
    # octave 0 tiled (4 launches), octave 1 resident (1)
    assert [c.launches - n for c, n in zip(counters, before)] == [4, 1, 1, 1]
    for c, g in ((ca, ga), (cb, gb)):
        n = int(c.count)
        assert int(g.count) == n > 20
        for name in ("layer", "x", "y", "response"):
            assert torch.equal(getattr(c, name), getattr(g, name).cpu()), name
        assert bit_flips(c.words[:n], g.words[:n]).max() == 0
    assert torch.equal(cm.index, gm.index.cpu())
    n = int(ga.count)
    acc = gm.index[:n] >= 0
    dx = (gm.match_x[:n] - ga.x[:n])[acc].cpu().numpy()
    assert acc.sum() > 20 and np.median(dx) == -SHIFT[1]


# --------------------------------------------------------------------------
# K4 on the tensor cores: edge cases against the plain version
# --------------------------------------------------------------------------

def _k4_case(cuda, w1, w2, v2, c1, c2, v1=None):
    """K4 against its plain version, bit for bit in all three outputs, and
    the ``Matches`` they give; one launch.  Returns the plain result."""
    from akaze_tpu_torch.match import matches_from_top2
    args = [t.to(cuda) for t in (w1, w2, v2,
                                 torch.tensor([c1], dtype=torch.int32),
                                 torch.tensor([c2], dtype=torch.int32))]
    want = k4.hamming_top2_plain(*args)
    before = k4.hamming_top2.launches
    got = k4.hamming_top2(*args)
    torch.cuda.synchronize()
    assert k4.hamming_top2.launches == before + 1
    for name, g, w in zip(("best", "second", "index"), got, want):
        assert torch.equal(g, w), (name, int((g != w).sum()))
    n1, n2 = w1.shape[0], w2.shape[0]
    v1 = torch.ones(n1, dtype=torch.bool) if v1 is None else v1
    rng = np.random.default_rng(n2)
    x2, y2 = (torch.from_numpy(rng.uniform(0, 500, n2).astype(np.float32))
              .to(cuda) for _ in range(2))
    for a, b in zip(matches_from_top2(*got, v1.to(cuda), x2, y2),
                    matches_from_top2(*want, v1.to(cuda), x2, y2)):
        assert torch.equal(a, b)
    return tuple(w.cpu() for w in want)


def _k4_bits(rng, n1, n2, near=0.05):
    """Random query bits, and train bits of which the first min(n1, n2)
    rows are near copies of the queries."""
    b1 = rng.integers(0, 2, (n1, 486)).astype(bool)
    b2 = rng.integers(0, 2, (n2, 486)).astype(bool)
    k = min(n1, n2)
    b2[:k] = b1[:k] ^ (rng.random((k, 486)) < near)
    return b1, b2


def _pack(bits):
    return pack_bits(torch.from_numpy(bits))


@pytest.mark.cuda
def test_hamming_ties_across_ranks_and_tiles(cuda):
    """Equal minima in different cluster ranks, in different chunks of one
    rank and in one n-tile: the lowest index wins and second == best."""
    rng = np.random.default_rng(21)
    n1, n2 = 700, 6000
    b1, b2 = _k4_bits(rng, n1, n2, near=0.3)
    # query i's exact copy at several train rows spread over the range
    # (the cluster's ranks split the 6000 live rows into shares of whole
    # 64-row chunks)
    for i in range(0, n1, 5):
        for j in (3 + i, 3 + i + 1, 3 + i + 64, 3000 + i, 5200 + i % 700):
            b2[j] = b1[i]
    v2 = np.ones(n2, bool)
    got = _k4_case(cuda, _pack(b1), _pack(b2), torch.from_numpy(v2), n1, n2)
    ties = (got[0] == got[1]) & (got[2] >= 0)
    assert int(ties.sum()) >= n1 // 5
    assert (got[0][::5] == 0).all()


@pytest.mark.cuda
def test_hamming_all_train_rows_invalid(cuda):
    rng = np.random.default_rng(22)
    b1, b2 = _k4_bits(rng, 300, 500)
    got = _k4_case(cuda, _pack(b1), _pack(b2),
                   torch.zeros(500, dtype=torch.bool), 300, 500)
    assert (got[2] == -1).all() and (got[0] == k4.BIG).all()


@pytest.mark.cuda
def test_hamming_invalid_rows_interleaved(cuda):
    """Invalid train rows before count2 never win, even as exact copies;
    valid rows at or past count2 are not scanned."""
    rng = np.random.default_rng(23)
    n1, n2, c2 = 900, 3000, 1777
    b1, b2 = _k4_bits(rng, n1, n2)
    v2 = rng.random(n2) > 0.4
    b2[1:n1:2] = b1[1:n1:2]          # exact copies on ...
    v2[1:n1:2] = False               # ... invalid rows
    b2[c2:c2 + n1] = b1              # exact copies past count2
    v2[c2:] = True
    got = _k4_case(cuda, _pack(b1), _pack(b2), torch.from_numpy(v2), n1, c2)
    won = got[2][got[2] >= 0]
    assert (won < c2).all() and torch.from_numpy(v2)[won].all()
    assert (got[0][1::2] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c1, c2", [(0, 400), (300, 0), (0, 0)])
def test_hamming_zero_counts(cuda, c1, c2):
    rng = np.random.default_rng(24)
    b1, b2 = _k4_bits(rng, 300, 400)
    got = _k4_case(cuda, _pack(b1), _pack(b2),
                   torch.ones(400, dtype=torch.bool), c1, c2)
    assert (got[2] == -1).all() and (got[1] == k4.BIG).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n1, n2, c1, c2", [
    (1, 1, 1, 1), (17, 9, 13, 9), (1037, 777, 1001, 701),
    (4099, 130, 4099, 129), (65, 8191, 64, 8190)])
def test_hamming_ragged_extents(cuda, n1, n2, c1, c2):
    """Capacities and live extents that are multiples of no tile (16-row
    warp tiles, 128-query CTAs, 8-column accumulator tiles, 64-row chunks,
    rank shares)."""
    rng = np.random.default_rng(n1 + n2)
    b1, b2 = _k4_bits(rng, n1, n2)
    v2 = rng.random(n2) > 0.2
    _k4_case(cuda, _pack(b1), _pack(b2), torch.from_numpy(v2), c1, c2)


@pytest.mark.cuda
def test_hamming_extreme_distances(cuda):
    """Distances 0 (a query's copy) and 486 (its complement on every
    descriptor bit, the pad bits zero on both sides)."""
    rng = np.random.default_rng(25)
    b1 = rng.integers(0, 2, (64, 486)).astype(bool)
    b2 = np.concatenate([~b1, b1[::-1]])
    v2 = torch.ones(128, dtype=torch.bool)
    got = _k4_case(cuda, _pack(b1), _pack(b2), v2, 64, 128)
    assert (got[0] == 0).all() and (got[2] == 127 - torch.arange(64)).all()
    far = _k4_case(cuda, _pack(b1), _pack(~b1[:1]), v2[:1], 64, 1)
    assert int(far[0][0]) == 486 and int(far[1][0]) == k4.BIG


@pytest.mark.cuda
@pytest.mark.parametrize("n1, n2", [(300, 5000), (5000, 300)])
def test_hamming_unequal_sets(cuda, n1, n2):
    rng = np.random.default_rng(26)
    b1, b2 = _k4_bits(rng, n1, n2)
    v2 = rng.random(n2) > 0.1
    v1 = torch.from_numpy(rng.random(n1) > 0.1)
    _k4_case(cuda, _pack(b1), _pack(b2), torch.from_numpy(v2),
             int(k4.last_live(v1)), int(k4.last_live(torch.from_numpy(v2))),
             v1)


# --------------------------------------------------------------------------
# the pair paths without host syncs; K2 on f32 planes; describe=False
# --------------------------------------------------------------------------

PATHS = {"float": (False, {}), "float_f32": (False, {"bf16_sampling": False}),
         "fixed_exact": (True, {"fixed_exact_sampling": True}),
         "fixed_approximate": (True, {})}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_warm_pair_iteration_never_syncs(cuda, path):
    """After a first pair, a pair iteration (detect + describe + match on
    card tensors) makes no call that synchronises the host with the card:
    ``torch.cuda.set_sync_debug_mode("error")`` raises on any."""
    fixed, kw = PATHS[path]
    a, b = raw_pair() if fixed else pair()
    det = Akaze(AkazeConfig(max_pts=512, noctaves=2, **kw), fixed=fixed,
                device=cuda)
    a, b = (torch.from_numpy(np.asarray(x)).to(cuda) for x in (a, b))
    want = det.match(*det.detect_and_compute_pair(a, b))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = det.match(*det.detect_and_compute_pair(a, b))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got.index, want.index)
    assert int((got.index >= 0).sum()) > 20


@pytest.mark.cuda
def test_f32_planes_describe_kernel_matches_plain(cuda):
    """The float flavour on f32 planes (``bf16_sampling=False``), on the
    keypoints and pyramid of a pair: angles within 1e-3 rad, 0 flipped
    bits."""
    plan = build_plan(256, 320, AkazeConfig(max_pts=512, noctaves=2,
                                            bf16_sampling=False))
    images = torch.from_numpy(np.stack(pair()))
    octs, _ = build_scale_space(images, plan)
    per_image = [[OctaveData(*(p[i] for p in o)) for o in octs]
                 for i in range(2)]
    kps = [detect_keypoints(o, plan) for o in per_image]
    pp = build_padded_pyramid([o for img in per_image for o in img], WSIZE,
                              torch.float32)
    nplanes = pp.L.shape[0] // 2
    params = [slot_params(k, pp, plan, plane_base=i * nplanes,
                          nplanes=nplanes) for i, k in enumerate(kps)]
    ip = torch.cat([p[0] for p in params]).to(cuda)
    fp = torch.cat([p[1] for p in params]).to(cuda)
    assert int(ip[:, 6].sum()) > 20
    planes = tuple(p.to(cuda) for p in (pp.L, pp.lx, pp.ly))
    tables = k2.describe_tables(10, cuda)
    want = k2.describe_plain(ip, fp, planes, tables)
    before = k2.describe.launches
    got = k2.describe(ip, fp, planes, tables)
    torch.cuda.synchronize()
    assert k2.describe.launches == before + 1
    d = (got[0] - want[0]).abs()
    assert float(torch.minimum(d, 2 * np.pi - d).max()) < 1e-3
    assert bit_flips(finish_descriptors(got[1]),
                     finish_descriptors(want[1])).max() == 0


@pytest.mark.cuda
def test_f32_planes_describe_kernel_hand_made_slots(cuda):
    """The float flavour on f32 planes of non-integer values, taps leaving
    the window, dead slots interleaved."""
    rng = np.random.default_rng(16)
    shape = (2, 300, 320)
    planes = tuple(torch.from_numpy(p.astype(np.float32)).to(cuda) for p in (
        rng.uniform(0, 1, shape), rng.normal(0, 0.1, shape),
        rng.normal(0, 0.1, shape)))
    slots = [(1, 100, 120, oy, ox, isc, 1, oy + 0.3, ox - 0.4)
             for isc in (2, 4)
             for oy, ox in ((1, 2), (2, 126), (125, 1), (126, 125), (64, 0))]
    live = rng.random(40) < 0.5
    slots += _random_slots(rng, 40, 3, 0, 10, 40, live)
    _k2_case(cuda, False, planes, slots)


@pytest.mark.cuda
def test_describe_false_launches_no_descriptor(cuda):
    """``detect_and_compute(image, describe=False)`` on the card runs K1 and
    neither K2 nor K4, and gives the keypoints of ``describe=True`` with
    angle 0 and zero words."""
    a, _ = pair()
    det = Akaze(AkazeConfig(max_pts=512, noctaves=2), device=cuda)
    want = det.detect_and_compute(a)
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_match)
    before = [c.launches for c in counters]
    got = det.detect_and_compute(a, describe=False)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [4, 1, 0, 0]
    for name in ("x", "y", "size", "layer", "response", "valid", "count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not bool(got.angle.any()) and not bool(got.words.any())


# --------------------------------------------------------------------------
# the SLAM path: geometry and solvers (plain PyTorch) on the card against
# the port's CPU run on the same inputs and the same minimal sets
# --------------------------------------------------------------------------

def _two_view_problem(rng, n=200, noise=5e-4, outlier_frac=0.3):
    """Normalised matches of a random 3-D scene seen from two poses, and
    the true (R, unit t)."""
    from akaze_tpu_torch.geometry import so3_exp
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    w = rng.standard_normal(3)
    R = so3_exp(torch.from_numpy(0.15 * w / np.linalg.norm(w))).numpy()
    t = rng.uniform(-1, 1, 3)
    t[2] *= 0.2
    t /= np.linalg.norm(t)
    X2 = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:3] + rng.standard_normal((n, 2)) * noise
    x2 = X2[:, :2] / X2[:, 2:3] + rng.standard_normal((n, 2)) * noise
    out = rng.choice(n, int(n * outlier_frac), replace=False)
    x2[out] = rng.uniform(-0.5, 0.5, (len(out), 2))
    return (torch.from_numpy(x1.astype(np.float32)),
            torch.from_numpy(x2.astype(np.float32)), R, t)


@pytest.mark.cuda
def test_ransac_on_card_matches_cpu(cuda):
    """The same draw on both devices.  The solvers (``geometry/linalg.py``)
    run the same ops on both devices, in float64, but the two devices
    round the float32 products around them differently, and a RANSAC
    winner can flip on a near tie: held are the inlier count within 2, the
    inlier masks on all but 3% of the rows, and both results within the
    JAX tests' bars of the true pose (R within 0.02, |cos t| > 0.99), E up
    to sign within 0.1 (bounds set when cuSOLVER's eigensolvers moved E by
    up to ~0.06 on an H100).  The card's own draw stays on the card (no
    host sync) and picks valid rows only."""
    from akaze_tpu_torch.geometry.ransac import (draw_minimal_sets,
                                                 ransac_essential)
    x1, x2, R, t = _two_view_problem(np.random.default_rng(3))
    valid = torch.ones(x1.shape[0], dtype=torch.bool)
    valid[150:] = False
    sets = draw_minimal_sets(torch.Generator().manual_seed(0), valid, 512)
    cpu = ransac_essential(None, x1, x2, valid, 5e-5, sets=sets)
    gpu = ransac_essential(None, x1.to(cuda), x2.to(cuda), valid.to(cuda),
                           5e-5, sets=sets.to(cuda))
    s = torch.sign((cpu.E * gpu.E.cpu()).sum())
    assert float((gpu.E.cpu() * s - cpu.E).abs().max()) < 0.1
    assert abs(int(gpu.num_inliers) - int(cpu.num_inliers)) <= 2
    assert int(cpu.num_inliers) > 80
    assert float((gpu.inliers.cpu() != cpu.inliers).float().mean()) <= 0.03
    for res in (cpu, gpu):
        assert np.abs(res.R.cpu().numpy() - R).max() < 0.02
        assert abs(float(res.t.cpu().numpy() @ t)) > 0.99

    gen = torch.Generator(device=cuda).manual_seed(1)
    v = valid.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        own = draw_minimal_sets(gen, v, 512)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert own.device.type == "cuda"
    assert bool(v[own].all())
    none = draw_minimal_sets(gen, torch.zeros_like(v), 16)
    assert int(none.min()) >= 0 and int(none.max()) < v.shape[0]


def _pose_graph(rng, n=7, cap=8):
    """A drifted chain with two loop edges (one an outlier), padded to
    ``cap`` as ``SlamSystem.optimize`` pads."""
    from akaze_tpu_torch.geometry import se3_compose, se3_exp, se3_inverse
    xi = torch.from_numpy(rng.standard_normal((n - 1, 6)).astype(np.float32)
                          * np.float32([0.5] * 3 + [0.1] * 3))
    R, t = [torch.eye(3)], [torch.zeros(3)]
    for x in xi:
        dR, dt = se3_exp(x[None])
        Rn, tn = se3_compose(R[-1], t[-1], dR[0], dt[0])
        R.append(Rn)
        t.append(tn)
    R, t = torch.stack(R), torch.stack(t)
    ei = list(range(n - 1)) + [0, 2]
    ej = list(range(1, n)) + [n - 1, 5]
    Ri, ti = se3_inverse(R[ei], t[ei])
    Rij, tij = se3_compose(Ri, ti, R[ej], t[ej])
    tij[-1] += torch.tensor([2.0, 0.0, 0.0])
    noise = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32)
                             * 0.05)
    noise[0] = 0
    dR, dt = se3_exp(noise)
    R0, t0 = se3_compose(R, t, dR, dt)
    Rp = torch.eye(3).repeat(cap, 1, 1)
    tp = torch.zeros(cap, 3)
    Rp[:n], tp[:n] = R0, t0
    fixed = torch.zeros(cap, dtype=torch.bool)
    fixed[0] = True
    fixed[n:] = True
    graph = (torch.tensor(ei, dtype=torch.int32),
             torch.tensor(ej, dtype=torch.int32), Rij, tij,
             torch.ones(len(ei)))
    return Rp, tp, graph, fixed


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "cauchy"])
def test_pose_graph_on_card_matches_cpu(cuda, robust):
    """Poses within 1e-4, the cost within 1e-4 relative."""
    from akaze_tpu_torch.slam.posegraph import PoseGraph, optimize_pose_graph
    R0, t0, graph, fixed = _pose_graph(np.random.default_rng(4))
    kw = dict(robust=robust, robust_delta=10.0 if robust == "cauchy" else 2.0)
    Rc, tc, cc = optimize_pose_graph(R0, t0, PoseGraph(*graph),
                                     fixed_mask=fixed, **kw)
    Rg, tg, cg = optimize_pose_graph(
        R0.to(cuda), t0.to(cuda), PoseGraph(*(a.to(cuda) for a in graph)),
        fixed_mask=fixed.to(cuda), **kw)
    assert float((Rg.cpu() - Rc).abs().max()) < 1e-4
    assert float((tg.cpu() - tc).abs().max()) < 1e-4
    assert abs(float(cg) - float(cc)) <= 1e-4 * float(cc)
    assert float((Rc - R0).abs().max()) > 1e-3


def _ba_problem(rng, n_cams=6, n_pts=80, noise=1e-3):
    from akaze_tpu_torch.geometry import se3_compose, se3_exp, se3_inverse
    from akaze_tpu_torch.slam.ba import BAProblem
    X = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3)).astype(np.float32)
    xi = torch.zeros(n_cams, 6)
    xi[:, 0] = 0.4 * torch.arange(n_cams)
    xi[:, 4] = 0.03 * torch.arange(n_cams)
    R, t = se3_inverse(*se3_exp(xi))
    Xc = torch.from_numpy(X)[None] @ R.transpose(1, 2) + t[:, None]
    uv = Xc[..., :2] / Xc[..., 2:]
    ok = (Xc[..., 2] > 0.5) & (uv.abs() < 1).all(-1)
    cam, pt = torch.nonzero(ok, as_tuple=True)
    obs = uv[cam, pt] + torch.from_numpy(
        rng.standard_normal((len(cam), 2)).astype(np.float32) * noise)
    prob = BAProblem(cam.to(torch.int32), pt.to(torch.int32), obs,
                     torch.ones(len(cam)))
    d = torch.from_numpy(rng.standard_normal((n_cams, 6)).astype(np.float32)
                         * 0.02)
    d[0] = 0
    R0, t0 = se3_compose(R, t, *se3_exp(d))
    X0 = torch.from_numpy(X + rng.standard_normal(X.shape).astype(
        np.float32) * 0.03)
    return R0, t0, X0, prob


@pytest.mark.cuda
def test_bundle_adjust_on_card_matches_cpu(cuda):
    """Rotations within 5e-4, translations within 2e-3, points within 1e-2
    (sums in another order: 1.2e-4 measured on rotations, H100), the cost
    within 1e-3 relative; the card's run repeats bit for bit."""
    from akaze_tpu_torch.slam.ba import BAProblem, bundle_adjust
    R0, t0, X0, prob = _ba_problem(np.random.default_rng(6))
    n = dict(n_cams=R0.shape[0], n_pts=X0.shape[0], iters=8)
    cpu = bundle_adjust(R0, t0, X0, prob, **n)
    args = [a.to(cuda) for a in (R0, t0, X0)]
    gprob = BAProblem(*(a.to(cuda) for a in prob))
    gpu = bundle_adjust(*args, gprob, **n)
    again = bundle_adjust(*args, gprob, **n)
    for g, c, tol in zip(gpu[:3], cpu[:3], (5e-4, 2e-3, 1e-2)):
        assert float((g.cpu() - c).abs().max()) < tol
    assert abs(float(gpu[3]) - float(cpu[3])) <= 1e-3 * float(cpu[3]) + 1e-9
    assert all(torch.equal(a, b) for a, b in zip(gpu, again))


# the small sequences of tests/test_torch_slam.py
SLAM_IMG_INTR = dict(fx=200.0, fy=200.0, cx=112.0, cy=80.0)
SLAM_CFG = dict(optimize_every=4, min_loop_gap=2, loop_min_matches=25,
                loop_min_inliers=8, loop_candidates=2, max_loops_per_kf=1,
                local_ba_every=3, local_ba_window=3, local_ba_points=64)
SLAM_VO = dict(min_inliers=6, keyframe_inlier_ratio=1.05)
SLAM_AKAZE = dict(max_pts=512, noctaves=2, dthreshold=5e-5)


def _slam_image_frames():
    from akaze_tpu_torch.io import synthetic_sequence
    frames, _ = synthetic_sequence(np.random.default_rng(3), n_frames=9,
                                   size=(160, 224),
                                   shift_per_frame=(0.0, 10.0), n_blobs=300)
    return [frames[k].astype(np.float32) / 255.0 for k in (0, 4, 8, 7, 3)]


def _slam_system(device, intr, sampler):
    from akaze_tpu_torch.slam import SlamConfig, SlamSystem
    from akaze_tpu_torch.slam.odometry import Intrinsics
    s = SlamSystem(Intrinsics(**intr), AkazeConfig(**SLAM_AKAZE),
                   SlamConfig(**SLAM_CFG), device=device, **SLAM_VO)
    s.vo.sampler = sampler
    return s


def _slam_pair(cuda, frames, intr, feeds=None):
    """The sequence on the CPU with the port's own draw, then on the card
    with the CPU run's draws replayed."""
    from akaze_tpu_torch.geometry.ransac import SetRecorder
    rec = SetRecorder()
    runs = []
    for dev, sampler in (("cpu", rec), (cuda, None)):
        s = _slam_system(dev, intr, sampler or rec.replay())
        if feeds is not None:
            s.vo.akaze.detect_and_compute = feeds[str(dev) == "cpu"]
        for f in frames:
            s.process(f)
        runs.append(s)
    return runs


def _same_structure(c, g):
    assert ([k.index for k in g.vo.keyframes]
            == [k.index for k in c.vo.keyframes])
    assert [e[:2] for e in g.edges] == [e[:2] for e in c.edges]
    assert any(e[0] - e[1] > 1 for e in c.edges), "no loop edge"
    assert np.isfinite(g.keyframe_trajectory()).all()


@pytest.mark.cuda
def test_slam_images_on_card_match_cpu(cuda):
    """``synthetic_sequence`` (a plane: degenerate two-view geometry, so
    trajectories are not compared): keyframes and edges equal; two card
    runs equal bit for bit."""
    from akaze_tpu_torch.geometry.ransac import sets_from_key
    frames = _slam_image_frames()
    c, g = _slam_pair(cuda, frames, SLAM_IMG_INTR)
    _same_structure(c, g)
    runs = []
    for _ in range(2):
        s = _slam_system(cuda, SLAM_IMG_INTR, sets_from_key)
        for f in frames:
            s.process(f)
        runs.append(s)
    assert np.array_equal(runs[0].keyframe_trajectory(),
                          runs[1].keyframe_trajectory())
    assert [e[:2] for e in runs[0].edges] == [e[:2] for e in runs[1].edges]


@pytest.mark.cuda
def test_slam_projected_on_card_matches_cpu(cuda):
    """``projected_sequence`` (a 3-D scene): keyframes and edges equal,
    edge weights within 0.3 and keyframe trajectories within 5e-2 of the
    map's extent.  The loose bounds date from cuSOLVER's eigensolvers
    (measured 0.139 and 0.022 on an H100); with the solvers of
    ``geometry/linalg.py``, which run the same ops on both devices,
    ``chip_smoke.py`` measured 5.1e-5 and 1.4e-5 (an H100, 700 W)."""
    from akaze_tpu_torch.io.dataset import projected_sequence
    from akaze_tpu_torch.pipeline import features_from_numpy
    frames, _ = projected_sequence(np.random.default_rng(5))
    feeds = {True: [features_from_numpy(f, "cpu") for f in frames],
             False: [features_from_numpy(f, cuda) for f in frames]}
    intr = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    c, g = _slam_pair(cuda, range(len(frames)), intr,
                      {k: v.__getitem__ for k, v in feeds.items()})
    _same_structure(c, g)
    np.testing.assert_allclose([e[4] for e in g.edges],
                               [e[4] for e in c.edges], atol=0.3)
    tc = c.keyframe_trajectory()
    np.testing.assert_allclose(g.keyframe_trajectory(), tc,
                               atol=5e-2 * float(np.abs(tc).max()))


# --------------------------------------------------------------------------
# homography, PnP, debug planes and the demo CLI on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [150, 2000])
def test_homography_on_card_matches_cpu(cuda, n):
    """``ransac_homography`` on the card with the CPU run's sets: H up to
    sign and scale within ``HOMOGRAPHY_CARD_TOL``; inlier masks equal but
    for rows within 1% of the threshold; the planted outliers rejected."""
    from akaze_tpu_torch.geometry.homography import (
        homography_transfer_error, ransac_homography)
    from akaze_tpu_torch.geometry.ransac import draw_minimal_sets
    x1, x2, out = homography_outlier_case(np.random.default_rng(42), n,
                                          n // 3)
    x1, x2 = torch.from_numpy(x1), torch.from_numpy(x2)
    valid = torch.ones(n, dtype=torch.bool)
    sets = draw_minimal_sets(torch.Generator().manual_seed(1), valid, 512, 4)
    cpu = ransac_homography(None, x1, x2, valid, 4.0, sets=sets)
    gpu = ransac_homography(None, x1.to(cuda), x2.to(cuda), valid.to(cuda),
                            4.0, sets=sets.to(cuda))
    assert gpu.H.device.type == "cuda"
    assert (homography_distance(gpu.H.cpu(), cpu.H)
            <= HOMOGRAPHY_CARD_TOL)
    diff = gpu.inliers.cpu() != cpu.inliers
    err = homography_transfer_error(cpu.H, x1, x2)
    assert bool(((err[diff] - 4.0).abs() < 0.04).all())
    assert int(gpu.num_inliers) == int(gpu.inliers.sum())
    assert int(cpu.num_inliers) > 0.6 * n
    assert int(gpu.inliers.cpu()[out].sum()) < max(5, n // 100)


@pytest.mark.cuda
def test_pnp_on_card_matches_cpu(cuda):
    """``pnp_dlt`` on the card against the CPU: R within 1e-3, t within
    1e-2 (the JAX tests' bars against the true pose), with and without
    weights."""
    from akaze_tpu_torch.geometry import so3_exp
    from akaze_tpu_torch.geometry.homography import pnp_dlt
    rng = np.random.default_rng(42)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (30, 3)).astype(np.float32)
    R = so3_exp(torch.tensor([0.1, -0.2, 0.15])).numpy()
    t = np.asarray([0.3, -0.2, 0.5], np.float32)
    Xc = X @ R.T + t
    u = torch.from_numpy((Xc[:, :2] / Xc[:, 2:3]).astype(np.float32))
    X = torch.from_numpy(X)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 30).astype(np.float32))
    for weights in (None, w):
        rc, tc = pnp_dlt(X, u, weights)
        rg, tg = pnp_dlt(X.to(cuda), u.to(cuda),
                         None if weights is None else weights.to(cuda))
        assert float((rg.cpu() - rc).abs().max()) < 1e-3
        assert float((tg.cpu() - tc).abs().max()) < 1e-2
        assert np.abs(rg.cpu().numpy() - R).max() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
def test_debug_planes_on_card_match_cpu(cuda, fixed):
    """``debug_planes`` on the card (K1) against the CPU (its plain
    version): float planes and kcontrast within ``TOL`` of their max, the
    fixed flavour bit for bit (PM_G2), det on the interior (the tiled
    kernel's border band, P1-3); the layer and size maps and the NMS mask
    equal; K1's launches those of ``describe=False``, and no K2 or K4."""
    from akaze_tpu_torch.debug import debug_planes
    a, _ = raw_pair() if fixed else pair()
    plan = build_plan(*a.shape, AkazeConfig(max_pts=2000))
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_match)
    for c in counters:
        c.launches = 0
    got = debug_planes(a, plan, fixed=fixed, device=cuda)
    launches = [c.launches for c in counters]
    want = debug_planes(a, plan, fixed=fixed, device="cpu")
    assert launches[2:] == [0, 0]
    assert launches[0] + launches[1] == sum(
        k1.octave_launches(o) for o in plan.octaves)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith("det"):
            oi, si = map(int, k[3:].split("_"))
            m = 2 * plan.octaves[oi].scales[si].sigma_size + 2
            g, w = g[m:-m, m:-m], w[m:-m, m:-m]
        if fixed or k in ("layer_map", "size_map", "nms_mask"):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        scale = max(float(np.abs(w[w > -1e5]).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale,
                                   err_msg=k)


@pytest.mark.cuda
def test_cli_on_card(cuda, tmp_path):
    """The demo CLI with its default device: the card, the counts of
    ``Akaze(device="cuda")`` on the same files, both drawings written."""
    import contextlib
    import io
    import json
    from akaze_tpu_torch import cli
    from akaze_tpu_torch.io import load_gray, save_pgm
    paths = []
    for name, img in zip(("l", "r"), raw_pair()):
        paths.append(str(tmp_path / f"{name}.pgm"))
        save_pgm(paths[-1], img)
    for fixed in (False, True):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["--left", paths[0], "--right", paths[1], "--json",
                      "--iters", "2", "--max-pts", "2000", "--out-dir",
                      str(tmp_path)] + (["--fixed"] if fixed else []))
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rec["backend"] == "cuda" and rec["fixed"] is fixed
        imgs = [load_gray(p) for p in paths]
        if not fixed:
            imgs = [i.astype(np.float32) / 255.0 for i in imgs]
        det = Akaze(AkazeConfig(max_pts=2000), fixed=fixed, device=cuda)
        fa, fb = det.detect_and_compute_pair(*imgs)
        m = det.match(fa, fb)
        n = int(fa.count)
        assert (rec["left_pts"], rec["right_pts"], rec["matches"]) == (
            n, int(fb.count), int((m.index[:n] >= 0).sum()))
        assert rec["matches"] > 50
        tag = "fastakaze" if fixed else "akaze"
        for kind in ("keypoints", "matches"):
            assert (tmp_path / f"{tag}_{kind}.png").exists()


# --------------------------------------------------------------------------
# the multi-device tier with several shards on the one card
# (akaze_tpu_torch.parallel): the sharded paths launch the kernels, never a
# plain version, and give the unsharded card path's results
# --------------------------------------------------------------------------

def _card_mesh(cuda, n):
    from akaze_tpu_torch.parallel import make_mesh
    return make_mesh(n, devices=[cuda] * n)


def _launch_counts():
    return {"tiled": k1.sublevel.launches, "resident": k1.octave.launches,
            "describe": k2.describe.launches,
            "hamming": k4.hamming_match.launches}


def _reset_counts():
    k1.sublevel.launches = k1.octave.launches = 0
    k2.describe.launches = k4.hamming_match.launches = 0


def _same_features(got, want):
    n = int(want.count)
    assert int(got.count) == n and torch.equal(got.valid, want.valid)
    for f in ("x", "y", "size", "layer", "response", "angle", "words"):
        assert torch.equal(getattr(got, f)[:n], getattr(want, f)[:n]), f


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("n", [2, 4])
def test_spatial_tier_on_card_equals_unsharded(cuda, monkeypatch, fixed, n):
    """480x640 (the SLAM cell's frame) row-sharded on the card: features
    bit for bit the unsharded card path's, K1/K2 launches per shard as the
    route predicts, no plain version run."""
    from akaze_tpu_torch.parallel import spatial_launches
    for mod, name in ((k1, "sublevel_plain"), (k1, "octave_plain"),
                      (k2, "describe_plain"), (k4, "hamming_top2_plain")):
        monkeypatch.setattr(mod, name, None)
    h, w = 480, 640
    img = texture(h, w, seed=3)
    if fixed:
        img = (img * 255).astype(np.uint8)
    cfg = AkazeConfig(max_pts=4000)
    ref = Akaze(cfg, fixed=fixed, device=cuda).detect_and_compute(img)
    det = Akaze(cfg, fixed=fixed, mesh=_card_mesh(cuda, n))
    _reset_counts()
    got = det.detect_and_compute(img)
    torch.cuda.synchronize()
    per = spatial_launches(det.plan_for(h, w), n)
    assert _launch_counts() == {"tiled": n * per["tiled"],
                                "resident": n * per["resident"],
                                "describe": n, "hamming": 0}
    assert int(ref.count) > 200
    _same_features(got, ref)


@pytest.mark.cuda
def test_sharded_match_on_card_equals_unsharded(cuda):
    from akaze_tpu_torch.match import match
    from akaze_tpu_torch.parallel import gather_shards, sharded_match
    rng = np.random.default_rng(5)
    n = 3000
    b = torch.from_numpy(rng.integers(0, 2, (2, n, 486)).astype(bool))
    w1, w2 = pack_bits(b[0]).to(cuda), pack_bits(b[1]).to(cuda)
    v1 = torch.ones(n, dtype=torch.bool, device=cuda)
    v2 = torch.from_numpy(rng.random(n) > 0.3).to(cuda)
    xy = torch.from_numpy(rng.uniform(0, 100, (2, n)).astype(np.float32))
    x2, y2 = xy[0].to(cuda), xy[1].to(cuda)
    _reset_counts()
    got = gather_shards(sharded_match(w1, v1, w2, v2, x2, y2,
                                      _card_mesh(cuda, 4), 200), cuda)
    assert k4.hamming_match.launches == 4
    want = match(w1, v1, w2, v2, x2, y2, 200)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_dp_step_on_card_equals_per_pair(cuda):
    from akaze_tpu_torch.parallel import dp_pipeline_step, gather_shards
    from akaze_tpu_torch.match import match
    a, b = pair()
    imgs_a = torch.stack([torch.as_tensor(a)] * 2 + [torch.as_tensor(b)] * 2)
    imgs_b = torch.stack([torch.as_tensor(b)] * 2 + [torch.as_tensor(a)] * 2)
    cfg = AkazeConfig(max_pts=2000)
    plan = build_plan(*a.shape, cfg)
    _reset_counts()
    fa, fb, m = (gather_shards(x, cuda) for x in dp_pipeline_step(
        imgs_a.to(cuda), imgs_b.to(cuda), plan, _card_mesh(cuda, 2)))
    assert _launch_counts()["describe"] == 4
    assert _launch_counts()["hamming"] == 4
    det = Akaze(cfg, device=cuda)
    for i in range(4):
        ra, rb = det.detect_and_compute_pair(imgs_a[i], imgs_b[i])
        rm = match(ra.words, ra.valid, rb.words, rb.valid, rb.x, rb.y,
                   cfg.max_dist)
        for got, want in ((fa, ra), (fb, rb), (m, rm)):
            for f, v in want._asdict().items():
                assert torch.equal(getattr(got, f)[i], v), f


@pytest.mark.cuda
def test_sharded_solvers_on_card(cuda):
    """Sharded PGO and landmark-sharded BA on 4 card shards against the
    single-device solvers on the card (R within 1e-3, JAX's
    tests/test_parallel.py bound; costs within 1e-3 relative); two runs
    bit for bit equal; no collective of the landmark-sharded BA carries a
    landmark-sized operand."""
    from akaze_tpu_torch.geometry import se3_compose, se3_exp, se3_inverse
    from akaze_tpu_torch.parallel import (gather_points,
                                          landmark_sharded_bundle_adjust,
                                          partition_landmarks,
                                          sharded_optimize_pose_graph)
    from akaze_tpu_torch.parallel.collectives import traced
    from akaze_tpu_torch.slam.ba import BAProblem, bundle_adjust
    from akaze_tpu_torch.slam.posegraph import (PoseGraph,
                                                optimize_pose_graph)
    mesh = _card_mesh(cuda, 4)
    rng = np.random.default_rng(8)
    n = 8
    xi = torch.zeros(n, 6)
    xi[:, 0] = torch.arange(n) * 0.5
    Rt, tt = se3_exp(xi)
    ei, ej = list(range(n - 1)) + [0], list(range(1, n)) + [n - 1]
    Rij, tij = se3_compose(*se3_inverse(Rt[ei], tt[ei]), Rt[ej], tt[ej])
    g = PoseGraph(torch.tensor(ei, dtype=torch.int32).to(cuda),
                  torch.tensor(ej, dtype=torch.int32).to(cuda),
                  Rij.to(cuda), tij.to(cuda), torch.ones(n, device=cuda))
    noise = torch.from_numpy(rng.standard_normal((n, 6)).astype(
        np.float32) * 0.03)
    noise[0] = 0
    R0, t0 = (v.to(cuda) for v in se3_compose(Rt, tt, *se3_exp(noise)))
    single = optimize_pose_graph(R0, t0, g, iters=6, robust="cauchy",
                                 robust_delta=10.0)
    runs = [sharded_optimize_pose_graph(R0, t0, g, mesh, iters=6,
                                        robust="cauchy", robust_delta=10.0)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert float((runs[0][0] - single[0]).abs().max()) < 1e-3
    assert abs(float(runs[0][2]) - float(single[2])) <= (
        1e-3 * float(single[2]) + 1e-9)

    n_cams, n_pts = 4, 64
    X = rng.uniform([-2, -2, 6], [2, 2, 10], (n_pts, 3)).astype(np.float32)
    xi = torch.zeros(n_cams, 6)
    xi[:, 0] = torch.arange(n_cams) * 0.3
    Rc, tc = se3_inverse(*se3_exp(xi))
    Xc = torch.einsum("cij,pj->cpi", Rc, torch.from_numpy(X)) + tc[:, None]
    uv = (Xc[..., :2] / Xc[..., 2:3]).reshape(-1, 2)
    prob = BAProblem(torch.arange(n_cams).repeat_interleave(n_pts).int(),
                     torch.arange(n_pts).repeat(n_cams).int(), uv,
                     torch.ones(n_cams * n_pts))
    X0 = torch.from_numpy(X + rng.standard_normal(X.shape).astype(
        np.float32) * 0.04)
    part = partition_landmarks(prob, n_pts, 4)
    with traced() as log:
        lb = [landmark_sharded_bundle_adjust(Rc, tc, gather_points(part, X0),
                                             part, mesh, iters=5)
              for _ in range(2)]
    assert max(k for _, k in log) <= n_cams * 36
    assert torch.equal(lb[0][3], lb[1][3])
    ref = bundle_adjust(Rc.to(cuda), tc.to(cuda), X0.to(cuda),
                        BAProblem(*(f.to(cuda) for f in prob)),
                        n_cams=n_cams, n_pts=n_pts, iters=5)
    np.testing.assert_allclose(float(lb[0][3]), float(ref[3]), rtol=1e-3,
                               atol=1e-7)
    assert float((lb[0][0] - ref[0]).abs().max()) < 1e-4


@pytest.mark.cuda
def test_slam_system_mesh_on_card(cuda):
    """``SlamSystem(mesh=2 card shards)`` on the small image route: the
    spatial tier's features are the single-device ones, so keyframes and
    edges equal the single-device card run's."""
    from akaze_tpu_torch.io import synthetic_sequence
    from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
    frames, _ = synthetic_sequence(np.random.default_rng(3), n_frames=9,
                                   size=(160, 224),
                                   shift_per_frame=(0.0, 10.0), n_blobs=300)
    images = [frames[k].astype(np.float32) / 255.0 for k in (0, 4, 8, 7, 3)]
    runs = []
    for kw in ({"device": cuda}, {"mesh": _card_mesh(cuda, 2)}):
        s = SlamSystem(Intrinsics(fx=200.0, fy=200.0, cx=112.0, cy=80.0),
                       AkazeConfig(max_pts=512, noctaves=2,
                                   dthreshold=5e-5),
                       SlamConfig(optimize_every=4, min_loop_gap=2,
                                  loop_min_matches=25, loop_min_inliers=8,
                                  loop_candidates=2, max_loops_per_kf=1,
                                  local_ba_every=3, local_ba_window=3,
                                  local_ba_points=64),
                       min_inliers=6, keyframe_inlier_ratio=1.05, **kw)
        for f in images:
            s.process(f)
        runs.append(s)
    single, sharded = runs
    assert sharded.vo.akaze.spatial_fallbacks == 0
    assert ([k.index for k in sharded.vo.keyframes]
            == [k.index for k in single.vo.keyframes])
    assert [e[:2] for e in sharded.edges] == [e[:2] for e in single.edges]
    for a, b in zip(sharded.vo.keyframes, single.vo.keyframes):
        assert torch.equal(a.features.words, b.features.words)


@pytest.mark.cuda
def test_cli_spatial_and_dryrun_on_card(cuda, tmp_path):
    import contextlib
    import io
    import json
    from akaze_tpu_torch import cli
    from akaze_tpu_torch.io import save_pgm
    from akaze_tpu_torch.parallel import dryrun_multichip
    paths = []
    for name, img in zip(("l", "r"), raw_pair()):
        paths.append(str(tmp_path / f"{name}.pgm"))
        save_pgm(paths[-1], img)
    recs = []
    for extra in ([], ["--spatial", "2", "--device", str(cuda) + ":0"
                       if cuda.index is None else str(cuda)]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["--left", paths[0], "--right", paths[1], "--json",
                      "--iters", "1", "--max-pts", "2000", "--no-draw"]
                     + extra)
        recs.append(json.loads(out.getvalue().strip().splitlines()[-1]))
    for k in ("left_pts", "right_pts", "matches"):
        assert recs[0][k] == recs[1][k], k
    res = dryrun_multichip(4, devices=[cuda] * 4)
    assert res["spatial_count"] > 0 and np.isfinite(res["ba_cost"])


# --------------------------------------------------------------------------
# compiled programs (akaze_tpu_torch/programs.py): captured = eager
# --------------------------------------------------------------------------

PROGRAM_FLAVOURS = {
    "float": (dict(), False),
    "float_f32": (dict(bf16_sampling=False), False),
    "fixed_exact": (dict(fixed_exact_sampling=True), True),
    "fixed_approx": (dict(), True),
}


def _counted(fn):
    """``fn()``'s result and the kernels' launches it counted."""
    before = _launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in _launch_counts().items()}


def _assert_trees_equal(got, want):
    from torch.utils import _pytree as pytree
    g, gs = pytree.tree_flatten(got)
    w, ws = pytree.tree_flatten(want)
    assert gs == ws
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), (
            i, int((a != b).sum()), a.flatten()[:8], b.flatten()[:8])


def _replayed(program, fn):
    """Run ``fn`` (one call of ``program``, or of each program of a tuple)
    eagerly, then, with every graph dropped, as its first (capturing) and
    second (replaying) call; check the programs' counts and that the
    replay equals the eager run bit for bit and counts the same launches.
    Returns the eager and replayed results."""
    from akaze_tpu_torch import programs
    progs = program if isinstance(program, tuple) else (program,)
    programs.clear()            # a key of an earlier test would replay
    with programs.eager():
        want, eager_n = _counted(fn)
    captures = [p.captures for p in progs]
    first, first_n = _counted(fn)
    assert [p.captures for p in progs] == [n + 1 for n in captures]
    replays = [p.replays for p in progs]
    got, got_n = _counted(fn)
    assert [p.captures for p in progs] == [n + 1 for n in captures]
    assert [p.replays for p in progs] == [n + 1 for n in replays]
    assert first_n == eager_n and got_n == eager_n
    _assert_trees_equal(first, want)
    _assert_trees_equal(got, want)
    return want, got


@pytest.mark.cuda
@pytest.mark.parametrize("flavour", sorted(PROGRAM_FLAVOURS))
def test_pair_program_equals_eager(cuda, flavour):
    from akaze_tpu_torch import pipeline, programs
    from akaze_tpu_torch.match import matches_from_top2
    kw, fixed = PROGRAM_FLAVOURS[flavour]
    a, b = raw_pair() if fixed else pair()
    det = Akaze(AkazeConfig(max_pts=2000, **kw), fixed=fixed, device=cuda)
    at, bt = (torch.as_tensor(x, device=cuda) for x in (a, b))
    (fa, fb), _ = _replayed(pipeline._jit_detect_and_compute_pair,
                            lambda: det.detect_and_compute_pair(at, bt))
    # the match is no program: one launch, equal to the plain chain
    keys = len(programs.stats())
    m, n = _counted(lambda: det.match(fa, fb))
    assert len(programs.stats()) == keys
    assert n == {"tiled": 0, "resident": 0, "describe": 0, "hamming": 1}
    want = matches_from_top2(*k4.hamming_top2_plain(
        fa.words, fb.words, fb.valid, k4.last_live(fa.valid),
        k4.last_live(fb.valid)), fa.valid, fb.x, fb.y)
    _assert_trees_equal(m, want)
    assert int(fa.count) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("describe", [True, False])
def test_single_image_program_equals_eager(cuda, describe):
    from akaze_tpu_torch import pipeline
    det = Akaze(AkazeConfig(max_pts=1000), device=cuda)
    a = torch.as_tensor(pair(240, 320)[0], device=cuda)
    want, _ = _replayed(pipeline._jit_detect_and_compute,
                        lambda: det.detect_and_compute(a, describe))
    assert int(want.count) > 50 and bool(want.words.any()) == describe


@pytest.mark.cuda
def test_program_outputs_are_fresh(cuda):
    """Call n's outputs stay as they were after call n+1 with other
    inputs, and a replay makes no host sync."""
    det = Akaze(AkazeConfig(max_pts=2000), device=cuda)
    a, b = (torch.as_tensor(x, device=cuda) for x in pair())
    det.match(*det.detect_and_compute_pair(a, b))   # captures the pair
    f1 = det.detect_and_compute_pair(a, b)
    keep = [x.clone() for x in f1[0]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f2 = det.detect_and_compute_pair(b.flip(0).contiguous(), a)
        m = det.match(*f2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for x, y in zip(f1[0], keep):
        assert torch.equal(x, y)
    assert not torch.equal(f2[0].x, f1[0].x) and m.index.shape[0] == 2000


@pytest.mark.cuda
def test_batched_match_counts_program_equals_eager(cuda):
    from akaze_tpu_torch.slam import system
    rng = np.random.default_rng(2)
    qw = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (512, 16),
                                       dtype=np.int64).astype(np.int32))
    words = qw[None].repeat(3, 1, 1)
    words[:, 200:] ^= torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (3, 312, 16), dtype=np.int64).astype(np.int32))
    valid = torch.arange(512)[None].repeat(3, 1) < torch.tensor(
        [[300], [400], [500]])
    args = [x.to(cuda) for x in (qw, torch.arange(512) < 450, words, valid)]
    want, _ = _replayed(system._batched_match_counts,
                        lambda: system._batched_match_counts(*args, 96))
    assert want.tolist() == [200, 200, 200]


@pytest.mark.cuda
def test_pose_graph_program_replays_damping(cuda):
    """Each damping value replays to the eager result: damping is an input
    of the graph, not a constant baked into it."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.slam.posegraph import PoseGraph, optimize_pose_graph
    R0, t0, graph, fixed = _pose_graph(np.random.default_rng(4))
    args = (R0.to(cuda), t0.to(cuda), PoseGraph(*(a.to(cuda) for a in graph)))
    kw = dict(fixed_mask=fixed.to(cuda), robust="cauchy", robust_delta=10.0)
    outs = []
    for damping in (1e-6, 10.0, 1e-6):
        with programs.eager():
            want = optimize_pose_graph(*args, damping=damping, **kw)
        got = optimize_pose_graph(*args, damping=damping, **kw)
        _assert_trees_equal(got, want)
        outs.append(got)
    assert not torch.equal(outs[0][0], outs[1][0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        optimize_pose_graph(*args, damping=1.0, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_bundle_adjust_program_replays_lam0(cuda):
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.slam.ba import BAProblem, bundle_adjust
    R0, t0, X0, prob = _ba_problem(np.random.default_rng(6))
    args = [a.to(cuda) for a in (R0, t0, X0)] + [
        BAProblem(*(a.to(cuda) for a in prob))]
    n = dict(n_cams=R0.shape[0], n_pts=X0.shape[0], iters=6)
    outs = []
    for lam0 in (1e-3, 1.0, 1e-3):
        with programs.eager():
            want = bundle_adjust(*args, lam0=lam0, **n)
        got = bundle_adjust(*args, lam0=lam0, **n)
        _assert_trees_equal(got, want)
        outs.append(got)
    assert not torch.equal(outs[0][2], outs[1][2])
    torch.cuda.set_sync_debug_mode("error")
    try:
        bundle_adjust(*args, lam0=0.1, **n)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _two_view_case(device):
    """Frames 0 and 1 of ``projected_sequence`` (a 3-D scene) on
    ``device``, and the call of ``_two_view`` on them."""
    from akaze_tpu_torch.io.dataset import projected_sequence
    from akaze_tpu_torch.pipeline import features_from_numpy
    frames, _ = projected_sequence(np.random.default_rng(5))
    f1, f2 = (features_from_numpy(f, device) for f in frames[:2])
    return f1, f2, (500.0, 500.0, 320.0, 240.0, 2e-5)


def _no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _close_ransac(gpu, cpu, tol_e=0.1):
    """Card against CPU on the same sets: the bounds of
    ``test_ransac_on_card_matches_cpu``."""
    s = torch.sign((cpu.E * gpu.E.cpu()).sum())
    assert float((gpu.E.cpu() * s - cpu.E).abs().max()) < tol_e
    assert abs(int(gpu.num_inliers) - int(cpu.num_inliers)) <= 2
    assert float((gpu.inliers.cpu() != cpu.inliers).float().mean()) <= 0.03


@pytest.mark.cuda
def test_two_view_programs_equal_eager(cuda):
    """``_two_view`` as its two programs (match and putative points, then
    RANSAC and triangulation) with the draw between them: captured equals
    eager bit for bit, no host sync inside or between them, and the card
    equals the CPU with the CPU's sets replayed."""
    from akaze_tpu_torch.geometry.ransac import SetRecorder, make_key
    from akaze_tpu_torch.slam import odometry
    f1, f2, args = _two_view_case(cuda)
    key = make_key(3)

    def call(sampler=odometry.sets_from_key):
        return odometry._two_view(key, f1, f2, *args, sampler=sampler)

    want, _ = _replayed((odometry._putative, odometry._solve), call)
    _no_sync(call)
    rec = SetRecorder()
    cpu = odometry._two_view(key, *_two_view_case("cpu")[:2], *args,
                             sampler=rec)
    gpu = call(rec.replay())
    for a, b in zip(gpu[0], cpu[0]):
        assert torch.equal(a.cpu(), b)
    _close_ransac(gpu[1], cpu[1])
    assert int(cpu[1].num_inliers) > 200
    assert float((gpu[1].R.cpu() - cpu[1].R).abs().max()) < 0.02
    assert float(gpu[1].t.cpu() @ cpu[1].t) > 0.99


@pytest.mark.cuda
def test_ransac_essential_program_equals_eager(cuda):
    from akaze_tpu_torch.geometry import ransac
    x1, x2, R, t = _two_view_problem(np.random.default_rng(3))
    valid = torch.ones(x1.shape[0], dtype=torch.bool)
    valid[150:] = False
    sets = ransac.draw_minimal_sets(torch.Generator().manual_seed(0), valid,
                                    512)
    args = [a.to(cuda) for a in (x1, x2, valid)]

    def call():
        gen = torch.Generator(device=cuda).manual_seed(1)
        return ransac.ransac_essential(gen, *args, 5e-5)

    _replayed(ransac._ransac_essential, call)
    _no_sync(call)
    gpu = ransac.ransac_essential(None, *args, 5e-5, sets=sets.to(cuda))
    _close_ransac(gpu, ransac.ransac_essential(None, x1, x2, valid, 5e-5,
                                               sets=sets))


@pytest.mark.cuda
def test_ransac_homography_program_equals_eager(cuda):
    from akaze_tpu_torch.geometry import homography
    from akaze_tpu_torch.geometry.ransac import draw_minimal_sets
    x1, x2, out = homography_outlier_case(np.random.default_rng(42), 2000,
                                          600)
    args = [torch.from_numpy(a).to(cuda) for a in (x1, x2)] + [
        torch.ones(2000, dtype=torch.bool, device=cuda)]

    def call():
        gen = torch.Generator(device=cuda).manual_seed(1)
        return homography.ransac_homography(gen, *args, 4.0)

    want, _ = _replayed(homography._ransac_homography, call)
    _no_sync(call)
    assert int(want.inliers.cpu()[out].sum()) < 20
    sets = draw_minimal_sets(torch.Generator().manual_seed(1),
                             torch.ones(2000, dtype=torch.bool), 512, 4)
    cpu = homography.ransac_homography(
        None, torch.from_numpy(x1), torch.from_numpy(x2),
        torch.ones(2000, dtype=torch.bool), 4.0, sets=sets)
    gpu = homography.ransac_homography(None, *args, 4.0, sets=sets.to(cuda))
    assert homography_distance(gpu.H.cpu(), cpu.H) <= HOMOGRAPHY_CARD_TOL


@pytest.mark.cuda
def test_capture_of_a_sync_raises(cuda):
    """A function that makes the host wait cannot be captured: the program
    raises, naming itself and its key, and never runs it eagerly instead;
    other programs capture and replay after it."""
    from akaze_tpu_torch import programs

    @programs.jit(static_argnames=("k",))
    def syncs(x, k):
        return x * float(x.sum()) + k

    x = torch.ones(4, device=cuda)
    with pytest.raises(programs.ProgramError, match="syncs"):
        syncs(x, k=1)
    assert syncs.captures == 0 and not syncs.entries
    with pytest.raises(programs.ProgramError):
        syncs(x, k=1)

    @programs.jit
    def fine(x):
        return x * 2 + 1

    for _ in range(3):
        assert torch.equal(fine(x), x * 2 + 1)
    assert fine.captures == 1 and fine.replays == 2
    programs.clear()            # no graph of this test outlives it


# --------------------------------------------------------------------------
# the multi-device programs on meshes whose shards share this card:
# captured = eager
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _no_item_assignment_on_the_card():
    """Fail on any item assignment to a CUDA tensor inside the block (a
    capture refuses the host-scalar copy it makes)."""
    real = torch.Tensor.__setitem__
    seen = []

    def setitem(self, key, value):
        if self.is_cuda:
            seen.append(tuple(self.shape))
        return real(self, key, value)

    torch.Tensor.__setitem__ = setitem
    try:
        yield
    finally:
        torch.Tensor.__setitem__ = real
    assert not seen, f"item assignments to card tensors {seen}"


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("n", [2, 4])
def test_spatial_program_equals_eager(cuda, fixed, n):
    """``Akaze(mesh)`` on 480x640 over n card shards: the spatial program
    captures once, replays bit for bit the eager call with its launches,
    makes no host sync in a replay, and a second instance with an equal
    mesh replays the same key."""
    from akaze_tpu_torch import pipeline
    h, w = 480, 640
    img = texture(h, w, seed=3)
    if fixed:
        img = (img * 255).astype(np.uint8)
    cfg = AkazeConfig(max_pts=4000)
    det = Akaze(cfg, fixed=fixed, mesh=_card_mesh(cuda, n))
    x = torch.as_tensor(img, device=det.device)
    prog = pipeline._jit_spatial_detect_and_compute
    want, _ = _replayed(prog, lambda: det.detect_and_compute(x))
    assert int(want.count) > 200
    _no_sync(lambda: det.detect_and_compute(x))
    other = Akaze(cfg, fixed=fixed, mesh=_card_mesh(cuda, n))
    captures = prog.captures
    _assert_trees_equal(other.detect_and_compute(x), want)
    assert prog.captures == captures and len(prog.entries) == 1
    keypoints, _ = _replayed(prog, lambda: det.detect_and_compute(
        x, describe=False))
    assert not bool(keypoints.words.any())


@pytest.mark.cuda
def test_dp_program_equals_eager(cuda):
    """The dp step over 2 card shards: one capture, each replay equal to
    the eager step bit for bit (features and matches per shard) with its
    launches, no host sync in a replay."""
    from akaze_tpu_torch.parallel import data_parallel, dp_pipeline_step
    a, b = pair()
    imgs_a = torch.stack([torch.as_tensor(a)] * 2 + [torch.as_tensor(b)] * 2)
    imgs_b = torch.stack([torch.as_tensor(b)] * 2 + [torch.as_tensor(a)] * 2)
    imgs_a, imgs_b = imgs_a.to(cuda), imgs_b.to(cuda)
    plan = build_plan(*a.shape, AkazeConfig(max_pts=2000))
    mesh = _card_mesh(cuda, 2)

    def step():
        return dp_pipeline_step(imgs_a, imgs_b, plan, mesh)

    want, got = _replayed(data_parallel._dp_step, step)
    assert len(want[0]) == 2 and int(want[0][0].count[0]) > 100
    _no_sync(step)


@pytest.mark.cuda
def test_sharded_solver_programs_equal_eager(cuda):
    """Sharded PGO, observation-sharded BA and landmark-sharded BA over 4
    card shards: each captures once and replays bit for bit the eager
    call; no host sync in a replay; the default gauge masks are made
    without an item assignment."""
    from akaze_tpu_torch.parallel import (gather_points,
                                          landmark_sharded_bundle_adjust,
                                          pad_edges, pad_observations,
                                          partition_landmarks, sharded_ba,
                                          sharded_bundle_adjust,
                                          sharded_optimize_pose_graph,
                                          sharded_pgo)
    from akaze_tpu_torch.slam.ba import BAProblem
    from akaze_tpu_torch.slam.posegraph import PoseGraph
    mesh = _card_mesh(cuda, 4)
    R0, t0, graph, _ = _pose_graph(np.random.default_rng(4))
    g = pad_edges(PoseGraph(*(a.to(cuda) for a in graph)), 4)
    R0, t0 = R0.to(cuda), t0.to(cuda)

    def pgo():
        return sharded_optimize_pose_graph(R0, t0, g, mesh, iters=6,
                                           robust="cauchy", robust_delta=10.0)

    want, _ = _replayed(sharded_pgo._run_sharded_pgo, pgo)
    assert float((want[0] - R0).abs().max()) > 1e-3
    with _no_item_assignment_on_the_card():
        _no_sync(pgo)

    Rc, tc, X0, prob = _ba_problem(np.random.default_rng(6))
    args = [a.to(cuda) for a in (Rc, tc, X0)]
    gprob = pad_observations(BAProblem(*(a.to(cuda) for a in prob)), 4)

    def ba():
        return sharded_bundle_adjust(*args, gprob, mesh, iters=5)

    _replayed(sharded_ba._run_sharded_ba, ba)
    with _no_item_assignment_on_the_card():
        _no_sync(ba)

    part = partition_landmarks(prob, X0.shape[0], 4)
    Xg = gather_points(part, X0).to(cuda)
    # the partition on the card, so that a call copies nothing from the
    # host
    part = part._replace(prob=BAProblem(*(f.to(cuda) for f in part.prob)))

    def lba():
        return landmark_sharded_bundle_adjust(args[0], args[1], Xg, part,
                                              mesh, iters=5)

    want, _ = _replayed(sharded_ba._run_landmark_sharded_ba, lba)
    assert len(want[2]) == 4 and bool(torch.isfinite(want[3]))
    with _no_item_assignment_on_the_card():
        _no_sync(lba)


@pytest.mark.cuda
def test_slam_system_mesh_programs_repeat(cuda):
    """``SlamSystem(mesh=2 card shards)`` on the small image route run
    eagerly and twice with programs: keyframes (frame indices, poses,
    words) and edges equal bit for bit; the second route captures no new
    key."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.io import synthetic_sequence
    from akaze_tpu_torch.slam import Intrinsics, SlamConfig, SlamSystem
    frames, _ = synthetic_sequence(np.random.default_rng(3), n_frames=9,
                                   size=(160, 224),
                                   shift_per_frame=(0.0, 10.0), n_blobs=300)
    images = [frames[k].astype(np.float32) / 255.0 for k in (0, 4, 8, 7, 3)]
    mesh = _card_mesh(cuda, 2)

    def route():
        s = SlamSystem(Intrinsics(fx=200.0, fy=200.0, cx=112.0, cy=80.0),
                       AkazeConfig(max_pts=512, noctaves=2,
                                   dthreshold=5e-5),
                       SlamConfig(optimize_every=2, min_loop_gap=2,
                                  loop_min_matches=25, loop_min_inliers=8,
                                  loop_candidates=2, max_loops_per_kf=1,
                                  local_ba_every=2, local_ba_window=3,
                                  local_ba_points=64),
                       min_inliers=6, keyframe_inlier_ratio=1.05, mesh=mesh)
        for f in images:
            s.process(f)
        return s

    programs.clear()
    with programs.eager():
        eager = route()
    first = route()
    captures = sum(p.captures for p in programs.programs())
    second = route()
    assert sum(p.captures for p in programs.programs()) == captures
    names = {s["program"].rsplit(".", 1)[1] for s in programs.stats()}
    assert "_jit_spatial_detect_and_compute" in names
    assert not any(s["eager"] for s in programs.stats())
    for run in (first, second):
        assert ([k.index for k in run.vo.keyframes]
                == [k.index for k in eager.vo.keyframes])
        assert len(run.edges) == len(eager.edges)
        for x, y in zip(run.edges, eager.edges):
            assert x[:2] == y[:2] and np.array_equal(x[2], y[2])
            assert np.array_equal(x[3], y[3]) and x[4] == y[4]
        for x, y in zip(run.vo.keyframes, eager.vo.keyframes):
            assert np.array_equal(x.R, y.R) and np.array_equal(x.t, y.t)
            assert torch.equal(x.features.words, y.features.words)
    assert len(eager.vo.keyframes) >= 2


@pytest.mark.cuda
def test_cli_spatial_twice_captures_nothing_new(cuda, tmp_path):
    """The CLI's ``--spatial 2`` run twice in one process: equal counts,
    and the second run captures no new key."""
    import io
    import json
    from akaze_tpu_torch import cli, programs
    from akaze_tpu_torch.io import save_pgm
    paths = []
    for name, img in zip(("l", "r"), raw_pair()):
        paths.append(str(tmp_path / f"{name}.pgm"))
        save_pgm(paths[-1], img)
    dev = str(cuda) + ":0" if cuda.index is None else str(cuda)
    recs, captures = [], []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["--left", paths[0], "--right", paths[1], "--json",
                      "--iters", "2", "--max-pts", "2000", "--no-draw",
                      "--spatial", "2", "--device", dev])
        recs.append(json.loads(out.getvalue().strip().splitlines()[-1]))
        captures.append(sum(p.captures for p in programs.programs()))
    assert captures[1] == captures[0]
    for k in ("left_pts", "right_pts", "matches"):
        assert recs[0][k] == recs[1][k] > 0, k


@pytest.mark.cuda
def test_programs_equal_eager_on_transposed_inputs(cuda):
    """Rotations as ``se3_inverse`` returns them (a transposed view): the
    sharded BA programs' captured calls equal their eager calls bit for
    bit (eager calls see contiguous inputs, as the graphs' buffers hold
    them; a matmul on the transposed layout rounds otherwise)."""
    import torch_mp_worker as worker
    from torch.utils import _pytree as pytree
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.parallel import (make_mesh, pad_observations,
                                          sharded_bundle_adjust)
    R, t, X0, prob = worker.make_problem()
    assert not R.is_contiguous()
    R = R.to(cuda)
    mesh = make_mesh(4, devices=[cuda] * 4)

    def call():
        return pytree.tree_leaves(sharded_bundle_adjust(
            R, t, X0, pad_observations(prob, 4), mesh, iters=4))

    with programs.eager():
        want = call()
    for got in (call(), call()):            # the capture, then a replay
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------------------
# four cards: one process over cuda:0..3, and four NCCL processes
# --------------------------------------------------------------------------

@pytest.fixture()
def cards4():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    return [torch.device("cuda", i) for i in range(4)]


def _same_leaves(got, want):
    from torch.utils import _pytree as pytree
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a.cpu(), b.cpu()), i


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_four_cards_spatial_equals_one_card(cards4, monkeypatch, fixed):
    """480x640 row-sharded over cuda:0..3 in one process: features and
    matches bit for bit the same mesh shape's with its four shards on
    cuda:0, K1/K2 launches as the route predicts, no plain version run."""
    from akaze_tpu_torch.parallel import make_mesh, spatial_launches
    for mod, name in ((k1, "sublevel_plain"), (k1, "octave_plain"),
                      (k2, "describe_plain"), (k4, "hamming_top2_plain")):
        monkeypatch.setattr(mod, name, None)
    a, b = pair(480, 640)
    if fixed:
        a, b = ((x * 255).astype(np.uint8) for x in (a, b))
    cfg = AkazeConfig(max_pts=4000)
    one = Akaze(cfg, fixed=fixed, mesh=make_mesh(4, devices=[cards4[0]] * 4))
    four = Akaze(cfg, fixed=fixed, mesh=make_mesh(4))
    assert four.mesh.local_devices == cards4
    want = one.detect_and_compute_pair(a, b)
    _reset_counts()
    got = four.detect_and_compute_pair(a, b)
    torch.cuda.synchronize()
    per = spatial_launches(four.plan_for(480, 640), 4)
    assert _launch_counts() == {"tiled": 8 * per["tiled"],
                                "resident": 8 * per["resident"],
                                "describe": 8, "hamming": 0}
    assert int(want[0].count) > 200
    _same_leaves(got, want)
    _same_leaves(four.match(*got), one.match(*want))


@pytest.mark.cuda
def test_four_cards_dp_and_solvers_equal_one_card(cards4):
    """The dp step (4 pairs), sharded PGO, observation- and
    landmark-sharded BA over cuda:0..3 in one process: bit for bit the same
    mesh shape's with its four shards on cuda:0."""
    import torch_mp_worker as worker
    from akaze_tpu_torch.parallel import (dp_pipeline_step, gather_points,
                                          landmark_sharded_bundle_adjust,
                                          make_host_chip_mesh, make_mesh,
                                          pad_observations,
                                          partition_landmarks,
                                          sharded_bundle_adjust,
                                          sharded_optimize_pose_graph)
    a, b = pair()
    imgs_a = torch.stack([torch.as_tensor(a)] * 2 + [torch.as_tensor(b)] * 2)
    imgs_b = torch.stack([torch.as_tensor(b)] * 2 + [torch.as_tensor(a)] * 2)
    plan = build_plan(*a.shape, AkazeConfig(max_pts=2000))
    R0, t0, graph = worker.pose_graph()
    R, t, X0, prob = worker.make_problem()
    part = partition_landmarks(prob, X0.shape[0], 4)
    runs = []
    for devices in ([cards4[0]] * 4, cards4):
        mesh = make_mesh(4, devices=devices)
        hc = make_host_chip_mesh(1, 4, devices=devices)
        runs.append((
            dp_pipeline_step(imgs_a, imgs_b, plan, mesh),
            sharded_optimize_pose_graph(R0, t0, graph, mesh, iters=4,
                                        robust="cauchy", robust_delta=0.5),
            sharded_bundle_adjust(R, t, X0, pad_observations(prob, 4), mesh,
                                  iters=4),
            landmark_sharded_bundle_adjust(
                R, t, gather_points(part, X0), part, hc, iters=4,
                axis=("chip", "host"))))
    assert [f.x.device for f in runs[1][0][0]] == cards4
    _same_leaves(runs[1], runs[0])


FOUR_CARD_PATHS = ("spatial float", "spatial fixed", "dp", "pgo",
                   "ba observations", "ba landmarks")


def _four_card_calls(devices):
    """{path: call}: the five mesh programs' public entry points over a
    four-shard mesh on ``devices``, every input first put on the mesh's
    home card (a host copy inside a call would synchronise)."""
    import torch_mp_worker as worker
    from akaze_tpu_torch.parallel import (dp_pipeline_step, gather_points,
                                          landmark_sharded_bundle_adjust,
                                          make_host_chip_mesh, make_mesh,
                                          pad_observations,
                                          partition_landmarks,
                                          sharded_bundle_adjust,
                                          sharded_optimize_pose_graph)
    mesh = make_mesh(4, devices=devices)
    hc = make_host_chip_mesh(1, 4, devices=devices)
    home = mesh.home
    cfg = AkazeConfig(max_pts=4000)
    sp = Akaze(cfg, mesh=mesh)
    spx = Akaze(cfg, fixed=True, mesh=mesh)
    img = torch.as_tensor(pair(480, 640)[0], device=home)
    raw = torch.as_tensor(raw_pair(480, 640)[0], device=home)
    a, b = (torch.as_tensor(x, device=home) for x in pair())
    imgs_a, imgs_b = torch.stack([a, a, b, b]), torch.stack([b, b, a, a])
    plan = build_plan(*a.shape, AkazeConfig(max_pts=2000))
    R0, t0, graph = worker.pose_graph()
    R0, t0 = R0.to(home), t0.to(home)
    graph = type(graph)(*(f.to(home) for f in graph))
    R, t, X0, prob = worker.make_problem()
    part = partition_landmarks(prob, X0.shape[0], 4)
    Xg = gather_points(part, X0).to(home)
    part = part._replace(prob=type(prob)(*(f.to(home) for f in part.prob)))
    R, t, X0 = R.to(home), t.to(home), X0.to(home)
    gprob = pad_observations(type(prob)(*(f.to(home) for f in prob)), 4)
    return {
        "spatial float": lambda: sp.detect_and_compute(img),
        "spatial fixed": lambda: spx.detect_and_compute(raw),
        "dp": lambda: dp_pipeline_step(imgs_a, imgs_b, plan, mesh),
        "pgo": lambda: sharded_optimize_pose_graph(
            R0, t0, graph, mesh, iters=4, robust="cauchy", robust_delta=0.5),
        "ba observations": lambda: sharded_bundle_adjust(
            R, t, X0, gprob, mesh, iters=4),
        "ba landmarks": lambda: landmark_sharded_bundle_adjust(
            R, t, Xg, part, hc, iters=4, axis=("chip", "host"))}


def _sync_cards(cards):
    for c in cards:
        torch.cuda.synchronize(c)


@pytest.mark.cuda
@pytest.mark.parametrize("path", FOUR_CARD_PATHS)
def test_four_card_program_replays_equal_eager_and_one_card(cards4, path):
    """Each mesh program over cuda:0..3 in one process is one graph over
    the four cards: ``stats()`` lists its key captured with the four
    cards (home first) and a pool per card; its capture and replays equal
    the same call under ``programs.eager()`` on the four cards and the
    one-card four-shard mesh bit for bit; a replay makes no host sync; a
    repeat adds no key; a call's outputs are unchanged by the next."""
    from torch.utils import _pytree as pytree
    from akaze_tpu_torch import programs
    programs.clear()
    four = _four_card_calls(cards4)[path]
    one = _four_card_calls([cards4[0]] * 4)[path]
    with programs.eager():
        want = four()
    ref = one()
    first = four()
    _sync_cards(cards4)
    rows = [r for r in programs.stats()
            if r["cards"] == [str(c) for c in cards4]]
    assert rows and not any(r["eager"] for r in rows), rows
    assert all(len(r["card_pool_bytes"]) == 4 for r in rows)
    captures = sum(p.captures for p in programs.programs())
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = four()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    keep = [x.clone() for x in pytree.tree_leaves(second)]
    third = four()
    _sync_cards(cards4)
    assert sum(p.captures for p in programs.programs()) == captures
    assert all(r["replays"] >= 2 for r in programs.stats()
               if r["cards"] == [str(c) for c in cards4])
    for got in (first, second, third, ref):
        _same_leaves(got, want)
    _same_leaves(keep, pytree.tree_leaves(second))


@pytest.mark.cuda
def test_four_card_replays_run_in_card_order(cards4):
    """The dp step over cuda:0..3 (its outputs per card), called on two
    inputs in turns: an op on each card's current stream, issued straight
    after a replay, reads that replay's values, and a call's outputs on
    cuda:1..3 are unchanged by the next call."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.parallel import dp_pipeline_step, make_mesh
    mesh = make_mesh(4, devices=cards4)
    a, b = (torch.as_tensor(x, device=cards4[0]) for x in pair())
    plan = build_plan(*a.shape, AkazeConfig(max_pts=2000))
    inputs = [(torch.stack([a, b, a, b]), torch.stack([b, a, b, a])),
              (torch.stack([b, b, a, a]), torch.stack([a, a, b, b]))]
    with programs.eager():
        wants = [dp_pipeline_step(x, y, plan, mesh) for x, y in inputs]
    dp_pipeline_step(*inputs[0], plan, mesh)          # the capture
    for _ in range(3):
        outs, reads = [], []
        for x, y in inputs:
            out = dp_pipeline_step(x, y, plan, mesh)
            reads.append([fa.x * 1 + fa.count[:, None] for fa in out[0]])
            outs.append(out)
        _sync_cards(cards4)
        for out, read, want in zip(outs, reads, wants):
            _same_leaves(out, want)
            for k, fa in enumerate(want[0]):
                assert read[k].device == cards4[k]
                assert torch.equal(read[k], fa.x * 1 + fa.count[:, None]), k


@pytest.mark.cuda
def test_four_card_capture_with_a_host_read_raises(cards4):
    """A function that reads a value to the host under a capture over four
    cards raises ``ProgramError`` naming its key, captures nothing and
    leaves no key; the cards capture another key afterwards."""
    from akaze_tpu_torch import programs
    from akaze_tpu_torch.parallel import make_mesh
    mesh = make_mesh(4, devices=cards4)

    @programs.jit(static_argnames=("mesh",))
    def reads(xs, mesh):
        total = sum(float(x.sum()) for x in xs)
        return [x * total for x in xs]

    @programs.jit(static_argnames=("mesh",))
    def folds(xs, mesh):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x.to(acc.device)
        return [x * 2 + acc.to(x.device) for x in xs]

    xs = [torch.full((8,), float(i + 1), device=c)
          for i, c in enumerate(cards4)]
    assert reads.route(xs, mesh) == "capture"
    with pytest.raises(programs.ProgramError, match="capture of"):
        reads(xs, mesh)
    assert not reads.entries and reads.captures == 0
    for _ in range(2):
        got = folds(xs, mesh)
        _sync_cards(cards4)
        for i, (g, c) in enumerate(zip(got, cards4)):
            assert g.device == c
            assert torch.equal(g.cpu(), torch.full((8,), 2.0 * (i + 1) + 10))
    assert folds.captures == 1 and folds.replays == 1


@pytest.mark.cuda
def test_four_nccl_processes_capture_equals_eager(cards4, tmp_path):
    """Four processes, one card each (``local_device_ids=[rank]``), on
    NCCL: each rank captures the spatial program, sharded PGO and
    landmark-sharded BA with their NCCL calls, and its replays equal its
    eager calls bit for bit without a host sync (in the worker); the sums
    of real-valued inputs, PGO and BA equal the one-process mesh of the
    same shape on cuda:0 bit for bit, on every rank."""
    import torch_mp_worker as worker
    from akaze_tpu_torch.parallel import make_host_chip_mesh, make_mesh
    from test_torch_multiprocess import join_workers, spawn_workers
    prefix = str(tmp_path / "nccl")
    procs = spawn_workers(prefix, 4, "cuda")
    one = [cards4[0]] * 4
    ref = worker.run_four(make_host_chip_mesh(4, 1, devices=one),
                          make_mesh(4, devices=one))
    f = Akaze(AkazeConfig(max_pts=1024), mesh=make_mesh(
        4, devices=one)).detect_and_compute(worker.spatial_image())
    ref.update({"spatial_" + k: getattr(f, k).cpu().numpy() for k in (
        "x", "y", "layer", "angle", "words", "valid", "count")})
    got = join_workers(procs, prefix, timeout=300)
    assert int(ref["spatial_count"]) > 100
    for r, g in enumerate(got):
        assert int(g["captured_keys"]) >= 3
        for k in ref:
            want = ref[k][r:r + 1] if k in ("psum", "hc_psum") else ref[k]
            np.testing.assert_array_equal(g[k], want, err_msg=f"rank {r} {k}")


@pytest.mark.cuda
def test_two_processes_of_two_cards_equal_one_process(cards4, tmp_path):
    """JAX's (host, chip) runtime on four cards: two processes of two
    cards each (``local_device_ids=[2 * rank, 2 * rank + 1]``) on NCCL.
    Each captures the spatial program, sharded PGO and landmark-sharded
    BA as one graph over its two cards holding the NCCL calls of both
    cards' communicators (in the worker: replays equal to the eager call
    bit for bit, no host sync, no new key on a repeat, every key
    ``nccl=True`` with the two cards); the sums and the gather over
    ``"host"``, the halo exchange over ``data``, sharded PGO,
    landmark-sharded BA, the multihost dp step and the spatial program
    equal the one-process mesh of the same shape over cuda:0..3 bit for
    bit, on every rank."""
    import torch_mp_worker as worker
    from akaze_tpu_torch.parallel import make_host_chip_mesh, make_mesh
    from test_torch_multiprocess import (HIER_LOCAL, HIER_REPLICATED,
                                         join_workers, spawn_workers)
    prefix = str(tmp_path / "hier")
    procs = spawn_workers(prefix, 2, "2x2", "cuda")
    ref = worker.run_hier(make_host_chip_mesh(2, 2, devices=cards4),
                          make_mesh(4, devices=cards4))
    f = Akaze(AkazeConfig(max_pts=1024), mesh=make_mesh(
        4, devices=cards4)).detect_and_compute(worker.spatial_image())
    spatial = {"spatial_" + k: getattr(f, k).cpu().numpy() for k in (
        "x", "y", "layer", "angle", "words", "valid", "count")}
    got = join_workers(procs, prefix, timeout=300)
    assert int(spatial["spatial_count"]) > 100
    for r, g in enumerate(got):
        assert int(g["captured_keys"]) >= 3
        for k in ref:
            want = ref[k] if k in HIER_REPLICATED else ref[k][HIER_LOCAL[r]]
            np.testing.assert_array_equal(g[k], want, err_msg=f"rank {r} {k}")
        for k, want in spatial.items():
            np.testing.assert_array_equal(g[k], want, err_msg=f"rank {r} {k}")
