"""Detection's full-map kernel (``ops/detect.py``, ``csrc/detect.cu``)
against its plain twin, ``detect.build_extrema_maps`` then ``detect.nms``.

The CPU tests hold the wrapper's plain path, its parameter block and its
argument checks, and the pipeline's batched detection against the plain
single-image stage.  The tests marked ``cuda`` need an NVIDIA GPU and skip
elsewhere; they hold the kernel to the plain twin run on the same card,
bit for bit (response, layer and survivor mask), on float32 and int32 det
stacks, one and two images, the pair's and the SLAM path's shapes and
shapes whose octaves are no multiple of the kernel's tile, NMS radii at
and past the widest that one launch holds, and on dense
maps of few values, whose plateaus of equal responses exercise the
top-left tie-break of NMS and the strictly-greater octave merge.  This
file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_detect_kernel.py
"""

import numpy as np
import pytest
import torch

from akaze_tpu_torch import Akaze, AkazeConfig, build_plan
from akaze_tpu_torch.detect import (build_extrema_maps, const_table,
                                    detect_keypoints, nms)
from akaze_tpu_torch.ops import detect as kd
from akaze_tpu_torch.pipeline import _keypoints
from akaze_tpu_torch.scale_space import OctaveData, build_scale_space


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def images(h, w, fixed, b=2, seed=0):
    """[B, H, W] seeded textures: bicubically enlarged noise (blobs of
    ~8 px) with fine noise on top, float in [0, 1], or raw 0..255 as int32
    with ``fixed``."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((b, 1, -(-h // 8), -(-w // 8)), generator=g)
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic",
                                        align_corners=False)[:, 0]
    x = (x + 0.03 * torch.randn((b, h, w), generator=g)).clamp(0, 1)
    return (x * 255).to(torch.uint8).to(torch.int32) if fixed else x


def plain(octaves, plan):
    """The plain chain, image by image, as [B, H, W] maps."""
    out = []
    for i in range(octaves[0].det.shape[0]):
        image = [OctaveData(*(p[i] for p in o)) for o in octaves]
        resp, size, layer = build_extrema_maps(image, plan)
        out.append((resp, layer, nms(resp, size, layer, plan)))
    return tuple(torch.stack(m) for m in zip(*out))


def det_stacks(plan, b, fixed, dense, device, seed=0):
    """Seeded det stacks of ``plan``'s octaves.  Dense: each value one of a
    few, around the threshold (float: float32(dthreshold) itself and the
    next float32 above it among them), so that equal responses meet in
    plateaus, across scales and across octaves; else spread values."""
    g = torch.Generator(device=device).manual_seed(seed)
    cfg = plan.config
    if fixed:
        t = cfg.idthreshold
        values = torch.tensor([-5, 0, t, t + 1, t + 2, t + 3, t + 9],
                              dtype=torch.int32, device=device)
    else:
        t = np.float32(cfg.dthreshold)
        values = torch.tensor(
            [-0.5, 0.0, t, np.nextafter(t, np.float32(1)), 0.002, 0.003],
            dtype=torch.float32, device=device)
    octaves = []
    for op in plan.octaves:
        shape = (b, len(op.scales), op.height, op.width)
        if dense:
            det = values[torch.randint(0, len(values), shape, generator=g,
                                       device=device)]
        elif fixed:
            det = torch.randint(-200, 400, shape, generator=g, device=device,
                                dtype=torch.int32)
        else:
            det = 0.01 * torch.randn(shape, generator=g, device=device)
        octaves.append(OctaveData(det, det, det, det))
    return octaves


def assert_maps_equal(got, want):
    for g, w, name in zip(got, want, ("resp", "layer", "mask")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fixed", [False, True])
def test_wrapper_on_cpu_is_the_plain_chain(fixed):
    """On CPU tensors the wrapper returns the plain chain's maps and mask
    for every image of the batch, and launches nothing."""
    plan = build_plan(160, 224, AkazeConfig(max_pts=1000, noctaves=2))
    octaves, _ = build_scale_space(images(160, 224, fixed), plan)
    before = kd.extrema_nms.launches
    got = kd.extrema_nms(octaves, plan)
    assert kd.extrema_nms.launches == before
    want = plain(octaves, plan)
    assert got[0].dtype == (torch.int32 if fixed else torch.float32)
    assert_maps_equal(got, want)
    assert int(got[2].sum()) > 20
    assert_maps_equal(kd.extrema_nms_plain(octaves, plan), want)


@pytest.mark.parametrize("fixed", [False, True])
def test_wrapper_on_cpu_dense_plateaus(fixed):
    """The plateau maps of the card tests, on the CPU: many survivors, and
    equal candidates side by side, the right one suppressed."""
    plan = build_plan(171, 203, AkazeConfig(max_pts=1000))
    octaves = det_stacks(plan, 2, fixed, True, torch.device("cpu"))
    got = kd.extrema_nms(octaves, plan)
    assert_maps_equal(got, plain(octaves, plan))
    resp, layer, mask = got
    assert int(mask.sum()) > 100
    # of two equal horizontal neighbours inside the NMS region, both
    # candidates, the left one lies in the right one's top-left quadrant
    # and suppresses it (1 < int(size * size) for every size)
    psz, (h, w) = plan.psz, resp.shape[1:]
    region = torch.zeros((h, w), dtype=torch.bool)
    region[psz:h - psz, psz:w - psz] = True
    cand = (layer >= 0) & region
    ties = cand[..., 1:] & cand[..., :-1] & (resp[..., 1:] == resp[..., :-1])
    assert int(ties.sum()) > 0
    assert not bool(mask[..., 1:][ties].any())


@pytest.mark.parametrize("fixed", [False, True])
def test_layout_holds_the_plan(fixed):
    """The kernel's parameter block carries the plan as the plain chain
    reads it: the threshold and sizes as float32 values, the border
    rectangles, radius, psz and octave shapes."""
    cfg = AkazeConfig(max_pts=1000)
    plan = build_plan(480, 640, cfg)
    w = kd.layout(plan, fixed)
    n = len(plan.octaves)
    assert w.dtype == np.int32
    assert w.size == 8 + kd.MAX_OCTAVES * (2 + kd.MAX_SCALES * 5)
    assert list(w[:7]) == [int(fixed), 480, 640, n, cfg.max_scale,
                           plan.max_nms_radius, plan.psz]
    thr = (cfg.idthreshold if fixed
           else float(torch.tensor(cfg.dthreshold, dtype=torch.float32)))
    assert (w[7] if fixed else w[7:8].view(np.float32)[0]) == thr
    hw = w[8:8 + 2 * kd.MAX_OCTAVES].reshape(-1, 2)
    off = 8 + 2 * kd.MAX_OCTAVES
    rect = w[off:off + kd.MAX_OCTAVES * kd.MAX_SCALES * 4].reshape(
        kd.MAX_OCTAVES, kd.MAX_SCALES, 4)
    sizes = w[off + rect.size:].view(np.float32).reshape(
        kd.MAX_OCTAVES, kd.MAX_SCALES)
    for o, op in enumerate(plan.octaves):
        assert tuple(hw[o]) == (op.height, op.width)
        table = const_table(tuple(sp.size for sp in op.scales),
                            torch.float32, torch.device("cpu"))
        assert np.array_equal(sizes[o, :len(op.scales)], table.numpy())
        for s, sp in enumerate(op.scales):
            assert tuple(rect[o, s]) == (sp.x_lo, sp.x_hi, sp.y_lo, sp.y_hi)
    assert not hw[n:].any() and not rect[n:].any()


def test_wrapper_checks_its_inputs():
    plan = build_plan(160, 224, AkazeConfig(max_pts=1000, noctaves=2))
    octaves = det_stacks(plan, 2, False, False, torch.device("cpu"))
    with pytest.raises(ValueError, match="octaves"):
        kd.extrema_nms(octaves[:1], plan)
    wrong = [o._replace(det=o.det.double()) for o in octaves]
    with pytest.raises(TypeError, match="float32 or int32"):
        kd.extrema_nms(wrong, plan)
    with pytest.raises(TypeError):
        kd.extrema_nms([octaves[0], octaves[1]._replace(
            det=octaves[1].det.int())], plan)
    with pytest.raises(ValueError, match="shape"):
        kd.extrema_nms([octaves[0], octaves[1]._replace(
            det=octaves[1].det[:1])], plan)
    with pytest.raises(ValueError, match="contiguous"):
        kd.extrema_nms([octaves[0], octaves[1]._replace(
            det=octaves[1].det.transpose(2, 3).contiguous().transpose(
                2, 3))], plan)


@pytest.mark.parametrize("fixed", [False, True])
def test_pipeline_batch_equals_the_plain_stage(fixed):
    """The pipeline's detection (one wrapper call for the batch, then
    selection and refinement per image) gives each image the keypoints of
    the plain single-image stage."""
    plan = build_plan(160, 224, AkazeConfig(max_pts=1000, noctaves=2))
    x = images(160, 224, fixed)
    kps, per_image = _keypoints(x, plan, fixed, "cpu")
    assert len(kps) == 2
    for k, octs in zip(kps, per_image):
        want = detect_keypoints(octs, plan)
        assert int(k.count) > 10
        for name in k._fields:
            assert torch.equal(getattr(k, name), getattr(want, name)), name


# --------------------------------------------------------------------------
# card
# --------------------------------------------------------------------------

SHAPES = {"pair_960x1280": (960, 1280), "slam_480x640": (480, 640),
          "ragged_250x330": (250, 330), "ragged_701x1003": (701, 1003)}


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["spread", "dense"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_equals_plain(cuda, shape, fixed, b, dense):
    h, w = SHAPES[shape]
    plan = build_plan(h, w, AkazeConfig(max_pts=10000))
    seed = 8 * sorted(SHAPES).index(shape) + 4 * fixed + 2 * b + dense
    octaves = det_stacks(plan, b, fixed, dense, cuda, seed)
    before = kd.extrema_nms.launches
    got = kd.extrema_nms(octaves, plan)
    torch.cuda.synchronize()
    assert kd.extrema_nms.launches == before + 1
    want = plain(octaves, plan)
    assert_maps_equal(got, want)
    assert int(want[2].sum()) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_kernel_equals_plain_on_the_scale_space(cuda, fixed):
    """K1's det stacks of a textured pair at the pair's shape."""
    plan = build_plan(960, 1280, AkazeConfig(max_pts=10000))
    octaves, _ = build_scale_space(images(960, 1280, fixed).to(cuda), plan)
    got = kd.extrema_nms(octaves, plan)
    want = plain(octaves, plan)
    assert_maps_equal(got, want)
    assert int(want[2].sum()) > 1000


# (derivative_factor, max_scale) -> kernel launches: NMS radius 28 at 4
# scales is the widest one launch holds; radius 30 at 4 scales and 28 at
# 5 take the second, wide kernel
WIDE = {"r28_s4": (10.5, 4, 1), "r30_s4": (11.0, 4, 2),
        "r28_s5": (10.0, 5, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("case", sorted(WIDE))
def test_kernel_equals_plain_at_wide_radii(cuda, case, fixed):
    """Radii far above the shipped plans' 4, at and past the widest that
    one launch holds: no plan is refused, and the maps and survivors are
    the plain twin's, suppression reaching across the whole radius."""
    df, scales, launches = WIDE[case]
    plan = build_plan(960, 1280, AkazeConfig(max_pts=10000, max_scale=scales,
                                             derivative_factor=df))
    assert plan.max_nms_radius >= 28
    seed = 2 * sorted(WIDE).index(case) + fixed
    octaves = det_stacks(plan, 2, fixed, True, cuda, seed)
    before = kd.extrema_nms.launches
    got = kd.extrema_nms(octaves, plan)
    torch.cuda.synchronize()
    assert kd.extrema_nms.launches == before + launches
    want = plain(octaves, plan)
    assert_maps_equal(got, want)
    psz, (h, w) = plan.psz, want[0].shape[1:]
    cand = want[1][:, psz:h - psz, psz:w - psz] >= 0
    assert 10 < int(want[2].sum()) < int(cand.sum()) // 4


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
def test_captured_pair_launches_the_kernel_once(cuda, fixed):
    """A warm captured pair adds exactly one launch of the kernel per
    replay, and a single image one."""
    from akaze_tpu_torch import pipeline
    det = Akaze(AkazeConfig(max_pts=2000), fixed=fixed, device=cuda)
    a, b = (images(240, 320, fixed)[i].to(cuda) for i in range(2))
    for _ in range(2):              # capture, then a first replay
        det.detect_and_compute_pair(a, b)
        det.detect_and_compute(a)
    torch.cuda.synchronize()
    progs = (pipeline._jit_detect_and_compute_pair,
             pipeline._jit_detect_and_compute)
    replays = [p.replays for p in progs]
    before = kd.extrema_nms.launches
    fa, fb = det.detect_and_compute_pair(a, b)
    torch.cuda.synchronize()
    assert [p.replays for p in progs] == [replays[0] + 1, replays[1]]
    assert kd.extrema_nms.launches == before + 1
    f = det.detect_and_compute(a)
    torch.cuda.synchronize()
    assert [p.replays for p in progs] == [replays[0] + 1, replays[1] + 1]
    assert kd.extrema_nms.launches == before + 2
    assert int(fa.count) > 50 and torch.equal(f.x, fa.x)
