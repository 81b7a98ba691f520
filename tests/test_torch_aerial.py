"""The aerial-survey deployment (``cardbench/configs/aerial-p4pro-3648x5472
.json``) on four CPU shards: ``Akaze(mesh=...)`` against the benchmark's
plain reference at the cell's limits, ``parallel.spatial_exchange_bytes``
against the bytes the collectives move, and the spatial tier's counters
and span in the tracer.  Small shapes stand in for the 3648x5472 frames;
every other setting is the configuration's.  The file imports no JAX."""

import copy
import json

import pytest
import torch

from akaze_tpu_torch import Akaze, AkazeConfig, build_plan, tracing
from akaze_tpu_torch.parallel import (collectives, make_mesh, spatial,
                                      spatial_exchange_bytes)
from cardbench import compare, gen
from cardbench.drivers import akaze_fields
from cardbench.reference import akaze as reference
from cardbench.spec import ROOT, Spec

CELL = "pair.aerial.3648x5472.4cards"
CONFIG = json.loads((ROOT / "cardbench" / "configs" /
                     "aerial-p4pro-3648x5472.json").read_text())
SHARDS = 4


def aerial(height, width, **akaze):
    """The aerial configuration's ``AkazeConfig`` fields at a small size."""
    config = copy.deepcopy(CONFIG)
    config["image"] = [height, width]
    config["akaze"].update(akaze)
    return config


def mesh():
    return make_mesh(SHARDS, devices=["cpu"] * SHARDS)


def shifted_pair(height, width, seed, shift):
    """Two crops of one seeded texture, the second ``shift`` (dy, dx) px
    further."""
    dy, dx = shift
    m = max(abs(dy), abs(dx))
    world = gen.texture(height + 2 * m, width + 2 * m, seed, 0, "cpu")
    a = world[m:m + height, m:m + width]
    b = world[m + dy:m + dy + height, m + dx:m + dx + width]
    return a.contiguous(), b.contiguous()


def test_the_mesh_equals_the_reference_at_the_cells_limits():
    """480x720 (3:2, as the sensor), two octaves, 1000 points: the four
    shards' keypoints, descriptors and matches against the reference's
    unsharded pipeline, compared as the cell compares them."""
    torch.set_num_threads(2)
    config = aerial(480, 720, noctaves=2, max_pts=1000)
    fields = akaze_fields(config)
    det = Akaze(AkazeConfig(**fields), mesh=mesh())
    assert det.sharded(480, 720)
    a, b = shifted_pair(480, 720, 2 ** 35 + 3, (44, -30))
    fa, fb = det.detect_and_compute_pair(a, b)
    m = det.match(fa, fb)
    assert det.spatial_fallbacks == 0
    plan = reference.build_plan(480, 720, reference.AkazeConfig(**fields))
    ra, rb = reference.detect_and_compute_batch(torch.stack([a, b]), plan)
    rm = reference.match_features(ra, rb)
    numbers = compare.compare_pair((fa, fb, m), (ra, rb, rm))
    limits = Spec().limits(Spec().cell(CELL))
    assert set(numbers) == set(limits)
    for k, limit in limits.items():
        assert numbers[k] <= limit, (k, numbers[k], limit)
    n = int(fa.count)
    assert 100 < n < 1000 and not bool(fa.overflow)
    assert int((m.index[:n] >= 0).sum()) > n // 4


def moved_bytes(monkeypatch):
    """Wrap the collectives that carry rows between shards; the list holds
    each call's bytes that leave one shard for another."""
    moved = []
    real_shard = collectives.shard
    real_extend = collectives.extend_rows
    real_gather = collectives.all_gather

    def shard(x, mesh, axes="data", dim=0):
        out = real_shard(x, mesh, axes, dim)
        # the global tensor lies with the first shard; the others' blocks
        # leave it
        moved.append(sum(b.numel() * b.element_size() for b in out[1:]))
        return out

    def extend_rows(xs, mesh, axis, r, dim=0, edge="reflect"):
        n = len(xs)
        if r:
            moved.append(sum(((i > 0) + (i < n - 1)) * r
                             * x.narrow(dim, 0, 1).numel() * x.element_size()
                             for i, x in enumerate(xs)))
        return real_extend(xs, mesh, axis, r, dim, edge)

    def all_gather(xs, mesh, axes="data", dim=0, home_only=False):
        size = [x.numel() * x.element_size() for x in xs]
        takers = [0] if home_only else range(len(xs))
        moved.append(sum(s for j in takers
                         for i, s in enumerate(size) if i != j))
        return real_gather(xs, mesh, axes, dim, home_only)

    monkeypatch.setattr(collectives, "shard", shard)
    monkeypatch.setattr(collectives, "extend_rows", extend_rows)
    monkeypatch.setattr(collectives, "all_gather", all_gather)
    return moved


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("fixed,describe", [(False, True), (False, False),
                                            (True, True)])
def test_exchange_bytes_equal_what_the_collectives_move(
        monkeypatch, kernels, fixed, describe):
    """480x720, three octaves over four shards: octaves 0 and 1 sharded
    (1 decimated across the seams), octave 2 gathered (its tiled reach
    exceeds its 30 local rows), octaves 1 and 2 too thin for the
    descriptor's halo.  ``kernels``: the card's sublevel route (one
    exchange of each sublevel's reach), run here on the CPU through the
    kernel wrappers' plain versions.  ``fixed``: the raw 0..255 path
    moves the same bytes, which the count does not ask for."""
    torch.set_num_threads(2)
    fields = akaze_fields(aerial(480, 720, noctaves=3, max_pts=500))
    plan = build_plan(480, 720, AkazeConfig(**fields))
    assert spatial.spatial_route(plan, SHARDS) == (False, False, True)
    if kernels:
        monkeypatch.setattr(spatial, "_sublevel_plain",
                            spatial._sublevel_kernel)
    image, _ = shifted_pair(480, 720, 11, (0, 0))
    if fixed:
        image = (image * 255).round()
    moved = moved_bytes(monkeypatch)
    spatial.spatial_detect_and_compute(image, plan, mesh(), fixed=fixed,
                                       describe=describe)
    want = spatial_exchange_bytes(plan, SHARDS, describe, kernels=kernels)
    assert sum(moved) == want
    assert want > (SHARDS - 1) * 120 * 720 * 4      # more than the split


def test_exchange_bytes_of_the_cells_shape():
    """3648x5472 over four: every octave sharded (octave 3's 114 local rows
    hold its tiled reach), so no block is gathered but the features; one
    shard fewer moves fewer bytes, one shard moves none, and a refused
    shape raises."""
    fields = akaze_fields(CONFIG)
    plan = build_plan(3648, 5472, AkazeConfig(**fields))
    assert spatial.spatial_route(plan, SHARDS) == (False,) * 4
    four = spatial_exchange_bytes(plan, SHARDS)
    assert four > 3 * 912 * 5472 * 4                # the row split alone
    assert spatial_exchange_bytes(plan, 2) < four
    assert spatial_exchange_bytes(plan, 1) == 0
    with pytest.raises(ValueError):
        spatial_exchange_bytes(build_plan(3650, 5472, AkazeConfig(**fields)),
                               SHARDS)


@pytest.fixture
def tracer():
    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


def test_the_tier_counts_and_spans_in_the_tracer(tracer):
    """A pair through the tier counts two images and their exchange bytes,
    each inside an ``akaze.spatial`` span under ``akaze.detect``; a shape
    the tier refuses counts a fallback; the tracer off records nothing."""
    torch.set_num_threads(2)
    cfg = AkazeConfig(**akaze_fields(aerial(240, 360, noctaves=2,
                                            max_pts=500)))
    det = Akaze(cfg, mesh=mesh(), spatial_fallback=True)
    a, b = shifted_pair(240, 360, 5, (6, -4))
    odd, _ = shifted_pair(242, 360, 5, (0, 0))      # 242 rows: refused

    det.detect_and_compute_pair(a, b)
    det.detect_and_compute(odd)
    assert tracing.summary()["spans"] == {}
    assert not any(k.startswith("spatial.")
                   for k in tracing.summary()["counters"])
    assert det.spatial_fallbacks == 1

    tracing.reset()
    tracing.enable(labelled=True)
    det.detect_and_compute_pair(a, b)
    det.detect_and_compute(odd)
    tracing.disable()
    counters = tracing.summary()["counters"]
    per_image = spatial_exchange_bytes(det.plan_for(240, 360), SHARDS,
                                       kernels=False)
    assert counters["spatial.images"] == 2
    assert counters["spatial.exchange_bytes"] == 2 * per_image
    assert counters["spatial.fallbacks"] == 1
    assert det.spatial_fallbacks == 2
    spans = {r[0]: r for r in tracing.spans()}
    names = [r[3] for r in spans.values()]
    assert names.count("akaze.upload") == 2      # the pair's, and odd's
    assert names.count("akaze.detect") == 3
    assert names.count("akaze.spatial") == 2
    for r in spans.values():
        if r[3] == "akaze.spatial":
            assert spans[r[1]][3] == "akaze.detect"
    # one request for the pair, one for the fallback's image
    assert len({r[2] for r in spans.values()}) == 2
