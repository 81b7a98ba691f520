"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
This file imports neither jax nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 planes within 1e-5 of each plane's max (det on the
interior, see test_torch_sublevel.py); K2 angles within 1e-3 rad and 0
flipped descriptor bits; K4 and ``Matches`` exactly.
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
from akaze_tpu_torch.ops.conv import lowpass
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
    m = 2 * step + 2
    for name, g, w in zip(names, got, want):
        g, w = g.cpu(), w.cpu()
        if name == "det":
            g, w = g[..., m:-m, m:-m], w[..., m:-m, m:-m]
        scale = max(float(w.abs().max()), 1e-6)
        assert float((g - w).abs().max()) <= TOL * scale, name


@pytest.mark.cuda
def test_five_octaves_of_a_large_image(cuda, monkeypatch):
    """noctaves=5 at 1280x1920: the fifth octave's FED chains (34-57 steps)
    exceed one launch's halo and are split.  Each of the scale space's K1
    calls equals its plain version on the same inputs, and the pair path
    recovers a known shift.

    Lx, Ly and det are held to 1e-5 of the plane max.  So is L, except
    where the FED chain itself is ill-conditioned in float32 (the 40-step
    chain of octave 4, sublevel 1 moves by ~6e-4 for a 1e-7 relative change
    of its input): there K1's L must lie no further from a float64
    evaluation of the plain version than 4x the float32 plain version
    does."""
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

    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return k1.sublevel(*args, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(ss, "sublevel", recording)
        build_scale_space(torch.from_numpy(a).to(cuda), plan)
    assert len(calls) == 20
    split = 0
    for (src, ikc, taus, step), kw in calls:
        split += len(k1.chain_launches(taus, step)) > 1
        got = k1.sublevel(src, ikc, taus, step, **kw)
        want = k1.sublevel_plain(src, ikc, taus, step, **kw)
        kw64 = {k: v.double() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}
        exact = k1.sublevel_plain(src.double(), ikc.double(), taus, step,
                                  **kw64)[0]
        plain_err = float((want[0].double() - exact).abs().max())
        got_err = float((got[0].double() - exact).abs().max())
        scale = float(exact.abs().max())
        assert got_err <= max(TOL * scale, 4 * plain_err), (step, len(taus))
        assert_planes_close(got[1:], want[1:], step, ("det", "lx", "ly"))
        if plain_err < 0.1 * TOL * scale:      # a well-conditioned chain
            assert_planes_close(got[:1], want[:1], step, ("L",))
    assert split == 4

    before = k1.sublevel.launches
    fa, fb = det.detect_and_compute_pair(a, b)
    m = det.match(fa, fb)
    torch.cuda.synchronize()
    assert k1.sublevel.launches - before == 24     # 20 sublevels, 4 split
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
    counters = (k1.sublevel, k2.describe, k4.hamming_top2)
    before = [c.launches for c in counters]
    gpu = Akaze(cfg, device=cuda)
    ga, gb = gpu.detect_and_compute_pair(a, b)
    gm = gpu.match(ga, gb)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [8, 1, 1]
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
