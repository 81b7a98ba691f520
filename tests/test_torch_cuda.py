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
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_top2)
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
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_top2)
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
    counters = (k1.sublevel, k1.octave, k2.describe, k4.hamming_top2)
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
    """The same draw on both devices.  The 8-point normal matrix A^T A is
    ill-conditioned in float32 and cuSOLVER's eigensolvers round otherwise
    than LAPACK's, so E moves by up to ~0.06 (measured on an H100): held
    are the inlier count within 2, the inlier masks on all but 3% of the
    rows, and both results within the JAX tests' bars of the true pose
    (R within 0.02, |cos t| > 0.99), E up to sign within 0.1.  The card's
    own draw stays on the card (no host sync) and picks valid rows only."""
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
    map's extent.  The loose bounds are RANSAC's: on the same sets the
    card's E differs from the CPU's by up to ~0.06
    (``test_ransac_on_card_matches_cpu``); measured on an H100: 0.139 and
    0.022."""
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
