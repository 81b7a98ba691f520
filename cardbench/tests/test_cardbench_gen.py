"""The device-side generators: one seed gives the same inputs, another
seed independent ones, and what each input is known to be is kept."""

from __future__ import annotations

import numpy as np
import torch

from cardbench import gen

BIG = 2 ** 40 + 12345          # seeds go past 32 bits


def test_texture_repeats_for_a_seed_and_differs_between_seeds():
    a = gen.texture(480, 640, BIG, 0, "cpu")
    assert torch.equal(a, gen.texture(480, 640, BIG, 0, "cpu"))
    assert a.dtype == torch.float32 and 0.0 <= float(a.min()) <= float(
        a.max()) <= 1.0
    for other in (gen.texture(480, 640, BIG + 1, 0, "cpu"),
                  gen.texture(480, 640, BIG, 1, "cpu")):
        r = np.corrcoef(a.flatten().numpy(), other.flatten().numpy())[0, 1]
        assert abs(r) < 0.1


def test_texture_keeps_its_distribution():
    """Mean 0.5 after the normalisation; blobs of every level and noise
    make it neither flat nor saturated."""
    a = gen.texture(240, 320, 3, 0, "cpu")
    assert abs(float(a.mean()) - 0.5) < 0.02
    assert 0.03 < float(a.std()) < 0.2
    assert float((a == 0).float().mean() + (a == 1).float().mean()) < 0.01


def test_shifts_are_seeded_and_bounded():
    s = gen.shifts(BIG, 16, 40)
    assert s == gen.shifts(BIG, 16, 40) and s != gen.shifts(BIG + 1, 16, 40)
    assert all(-40 <= v <= 40 for pair in s for v in pair)


def test_route_frames_are_crops_at_the_known_offsets():
    frames, offsets = gen.route_frames(48, 64, 4, 16, 0.01, BIG, "cpu")
    xs, order = gen.route(4, 16)
    assert frames.shape == (len(order), 48, 64)
    assert offsets[:, 1].tolist() == [xs[k] for k in order]
    # two frames a step apart overlap where the offsets say
    k0, k1 = order.index(0), order.index(4)
    q = xs[4] - xs[0]
    assert torch.equal(frames[k0][:, q:], frames[k1][:, :-q])
    again, _ = gen.route_frames(48, 64, 4, 16, 0.01, BIG, "cpu")
    assert torch.equal(frames, again)
    # quantised to 0..255
    assert torch.equal(torch.round(frames * 255) / 255, frames)
