"""Kernel K4 (running-top-2 Hamming matcher) and the match module of the
PyTorch port against the JAX package, whose matcher runs its Pallas kernel
in interpret mode (``match(..., use_pallas="interpret")``).

Distances are integers, so everything is compared exactly: ``Matches``
(index, distance, match_x, match_y) equal, and the plain top-2 equal to a
brute-force numpy reference.  The raw ``second`` is not compared with the
JAX kernel, which gives invalid train rows the pseudo-distance 243 where
the port skips them; acceptance is the same either way.

The tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere: on the
card ``match`` is one launch (``ops.hamming.hamming_match``: scan extents,
top-2 and acceptance), held bit for bit against the plain chain
(``hamming_top2_plain`` + ``matches_from_top2``) on the same card.  JAX is
imported only by the tests that compare with it, so the card tests also
run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_match.py
"""

import importlib
import math

import numpy as np
import pytest
import torch

from akaze_tpu_torch import Akaze, hamming_distance_matrix, match, programs
from akaze_tpu_torch.descriptor import pack_bits, words_to_numpy
from akaze_tpu_torch.match import matches_from_top2
from akaze_tpu_torch.ops import hamming as thamming
from akaze_tpu_torch.pipeline import Features

torch.set_num_threads(1)


def seeded_sets(n1, n2, seed, invalid=0.2):
    """Query and train words from packed random bits, with planted exact
    duplicates (ties), near copies and ~``invalid`` of invalid rows."""
    rng = np.random.default_rng(seed)
    b1 = rng.integers(0, 2, (n1, 486)).astype(bool)
    b2 = rng.integers(0, 2, (n2, 486)).astype(bool)
    # near copies: query i close to train 2i
    k = min(n1, n2 // 2)
    for i in range(k):
        b2[2 * i] = b1[i]
        flip = rng.choice(486, rng.integers(0, 40), replace=False)
        b2[2 * i, flip] ^= True
    # exact ties: train rows duplicated later in the set
    for i in range(0, k, 7):
        b2[min(2 * i + 5, n2 - 1)] = b2[2 * i]
    w1 = pack_bits(torch.from_numpy(b1))
    w2 = pack_bits(torch.from_numpy(b2))
    v1 = torch.from_numpy(rng.random(n1) > invalid / 2)
    v2 = torch.from_numpy(rng.random(n2) > invalid)
    x2 = torch.from_numpy(rng.uniform(0, 500, n2).astype(np.float32))
    y2 = torch.from_numpy(rng.uniform(0, 400, n2).astype(np.float32))
    return w1, v1, w2, v2, x2, y2


def brute_top2(w1, w2, valid2, count1):
    d = np.asarray(hamming_distance_matrix(w1, w2)).astype(np.int64)
    d[:, ~valid2.numpy()] = thamming.BIG
    n1 = d.shape[0]
    best = np.full(n1, thamming.BIG)
    second = np.full(n1, thamming.BIG)
    idx = np.full(n1, -1)
    for q in range(min(n1, int(count1))):
        for j, v in enumerate(d[q]):
            if v < best[q]:
                second[q], best[q], idx[q] = best[q], v, j
            elif v < second[q]:
                second[q] = v
    return best, second, idx


def jax_modules():
    """jax.numpy and the JAX package's match module, imported here so that
    the card run (``-m cuda``, which deselects the tests that call this)
    collects the file without JAX; an import error fails the test."""
    return (importlib.import_module("jax.numpy"),
            importlib.import_module("akaze_tpu.match"))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def test_distance_matrix_exact():
    jnp, jm = jax_modules()
    w1, _, w2, _, _, _ = seeded_sets(37, 53, 0)
    got = hamming_distance_matrix(w1, w2).numpy()
    want = np.asarray(jm.hamming_distance_matrix(
        jnp.asarray(words_to_numpy(w1)),
                                jnp.asarray(words_to_numpy(w2))))
    np.testing.assert_array_equal(got, want)


def test_plain_top2_matches_brute_force():
    w1, v1, w2, v2, _, _ = seeded_sets(60, 90, 1)
    c1, c2 = thamming.last_live(v1), thamming.last_live(v2)
    got = thamming.hamming_top2(w1, w2, v2, c1, c2)
    want = brute_top2(w1, w2, v2, c1)
    for g, w, name in zip(got, want, ("best", "second", "index")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the planted ties exist: some minimum is not unique
    assert (got[0] == got[1]).any()


def test_last_live():
    assert int(thamming.last_live(torch.tensor([True, False, True, False]))
               ) == 3
    assert int(thamming.last_live(torch.zeros(5, dtype=torch.bool))) == 0
    assert int(thamming.last_live(torch.zeros(0, dtype=torch.bool))) == 0


@pytest.mark.parametrize("n1,n2,seed", [(200, 256, 2), (256, 130, 3)])
def test_matches_equal_jax_pallas(n1, n2, seed):
    jnp, jm = jax_modules()
    w1, v1, w2, v2, x2, y2 = seeded_sets(n1, n2, seed)
    # prefix-compacted validity, as the pipeline produces it
    v1[n1 - 17:] = False
    v2[n2 - 9:] = False
    got = match(w1, v1, w2, v2, x2, y2, 96)
    want = jm.match(jnp.asarray(words_to_numpy(w1)), jnp.asarray(v1.numpy()),
                    jnp.asarray(words_to_numpy(w2)), jnp.asarray(v2.numpy()),
                    jnp.asarray(x2.numpy()), jnp.asarray(y2.numpy()), 96,
                    use_pallas="interpret")
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.index.numpy() >= 0).sum() > 10
    # invalid train rows are never accepted
    acc = got.index.numpy()
    assert v2.numpy()[acc[acc >= 0]].all()


def test_match_rules():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (4, 486)).astype(bool)
    far = bits[1:2].copy()
    far[0, :120] ^= True          # 120 bits from train row 1
    train = np.vstack([bits, bits[:1], far])
    wq = pack_bits(torch.from_numpy(np.vstack([bits, far])))
    wt = pack_bits(torch.from_numpy(train))
    x = torch.arange(6.0)
    valid_q = torch.ones(5, dtype=torch.bool)
    valid_t = torch.tensor([True, True, True, True, True, False])
    m = match(wq, valid_q, wt, valid_t, x, x, 96)
    assert int(m.index[0]) == -1      # duplicate minimum -> rejected
    assert [int(i) for i in m.index[1:4]] == [1, 2, 3]
    # query 4's exact copy (train 5) is invalid; its best valid row, train
    # 1, lies 120 bits away: rejected at max_dist 96, accepted at 200
    assert int(m.index[4]) == -1
    m = match(wq, valid_q, wt, valid_t, x, x, 200)
    assert int(m.index[4]) == 1 and float(m.distance[4]) == 120.0


def test_cpu_path_launches_no_kernel():
    """On the CPU ``match`` is the plain twin: ``hamming_top2_plain`` and
    ``matches_from_top2``, and neither wrapper's counter moves."""
    thamming.hamming_top2.launches = 0
    thamming.hamming_match.launches = 0
    w1, v1, w2, v2, x2, y2 = seeded_sets(40, 40, 5)
    got = match(w1, v1, w2, v2, x2, y2)
    assert thamming.hamming_top2.launches == 0
    assert thamming.hamming_match.launches == 0
    want = matches_from_top2(*thamming.hamming_top2_plain(
        w1, w2, v2, thamming.last_live(v1), thamming.last_live(v2)),
        v1, x2, y2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _bad(case):
    """``hamming_match``'s arguments with one of them wrong."""
    w1, v1, w2, v2, x2, y2 = seeded_sets(6, 8, 1)
    args = dict(words1=w1, valid1=v1, words2=w2, valid2=v2, x2=x2, y2=y2)
    name, wrong = case
    args[name] = wrong(args[name])
    return args


@pytest.mark.parametrize("case,error", [
    (("words1", lambda t: t.to(torch.int64)), TypeError),
    (("valid1", lambda t: t.to(torch.uint8)), TypeError),
    (("valid1", lambda t: t[:-1]), ValueError),
    (("words2", lambda t: t[:, :8]), ValueError),
    (("valid2", lambda t: t.to(torch.int32)), TypeError),
    (("x2", lambda t: t.double()), TypeError),
    (("y2", lambda t: t[:-2]), ValueError),
    (("y2", lambda t: t.to("meta")), ValueError),
], ids=["words1-dtype", "valid1-dtype", "valid1-shape", "words2-shape",
        "valid2-dtype", "x2-dtype", "y2-shape", "y2-device"])
def test_match_wrapper_checks_arguments(case, error):
    with pytest.raises(error, match=case[0]):
        thamming.hamming_match(**_bad(case))


def test_match_threshold_is_exact_for_every_distance():
    """The kernel's int threshold accepts a distance exactly when the
    plain rule's ``best < max_dist`` does, for any number."""
    d = np.arange(0, 513)
    for max_dist in (0, 1, 96, 96.5, 95.01, 486, 512, 513, 4096, 2 ** 40,
                     -3, -0.5, math.inf, -math.inf, math.nan,
                     np.int64(60)):
        np.testing.assert_array_equal(d < thamming._threshold(max_dist),
                                      d < max_dist, err_msg=str(max_dist))
    with pytest.raises(TypeError):
        thamming._threshold(torch.tensor(96))


# --- on the card: one launch --------------------------------------------

SIZES = [0, 1, 127, 128, 129, 2017, 10000]


def _card_sets(n1, n2, seed, dev):
    """``seeded_sets`` on the card with holes in both validities and a dead
    tail on each (the extents fall inside the capacity)."""
    w1, v1, w2, v2, x2, y2 = seeded_sets(n1, n2, seed)
    v1[n1 - n1 // 5:] = False
    v2[n2 - n2 // 7:] = False
    return tuple(t.to(dev) for t in (w1, v1, w2, v2, x2, y2))


def _hold(w1, v1, w2, v2, x2, y2, max_dist):
    """The one-launch match against the plain chain on the same card, bit
    for bit in all four fields; one launch (none for no query), and no
    top-2 launch.  Returns the match and the plain top-2."""
    top2 = thamming.hamming_top2_plain(w1, w2, v2, thamming.last_live(v1),
                                       thamming.last_live(v2))
    want = matches_from_top2(*top2, v1, x2, y2, max_dist)
    before = (thamming.hamming_match.launches,
              thamming.hamming_top2.launches)
    got = match(w1, v1, w2, v2, x2, y2, max_dist)
    torch.cuda.synchronize()
    assert (thamming.hamming_match.launches,
            thamming.hamming_top2.launches) == (
        before[0] + (w1.shape[0] > 0), before[1])
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        # bit patterns: -1.0 and the gathered coordinates alike
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    return got, top2


@pytest.mark.cuda
@pytest.mark.parametrize("n2", SIZES)
@pytest.mark.parametrize("n1", SIZES)
def test_one_launch_match_equals_plain_chain(cuda, n1, n2):
    sets = _card_sets(n1, n2, 100 * n1 + n2, cuda)
    for max_dist in (0, 96, 512):
        got, (best, second, _) = _hold(*sets, max_dist)
        if max_dist == 0:
            assert (got.index == -1).all()
    if min(n1, n2) >= 127:
        # the planted duplicates reach the rule: tied minima (rejected)
        # beside accepted matches
        assert (best == second).any() and (got.index >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["train", "query", "interleaved"])
def test_one_launch_match_invalid_rows(cuda, which):
    """An all-invalid train set, an all-invalid query set, and validity
    with every other row dead on both sides."""
    w1, v1, w2, v2, x2, y2 = _card_sets(2017, 3001, 7, cuda)
    if which == "train":
        v2 = torch.zeros_like(v2)
    elif which == "query":
        v1 = torch.zeros_like(v1)
    else:
        v1 = v1 & (torch.arange(2017, device=cuda) % 2 == 0)
        v2 = v2 & (torch.arange(3001, device=cuda) % 2 == 1)
    got, _ = _hold(w1, v1, w2, v2, x2, y2, 96)
    if which != "interleaved":
        assert (got.index == -1).all() and (got.match_x == -1).all()
    else:
        assert (got.index >= 0).any()
        assert (got.index[got.index >= 0] % 2 == 1).all()


@pytest.mark.cuda
def test_akaze_match_is_one_kernel(cuda):
    """``Akaze.match`` on the card: no program, no host sync, one launch of
    the fused kernel and no other kernel or copy on the device."""
    from torch.profiler import ProfilerActivity, profile
    w1, v1, w2, v2, x2, y2 = _card_sets(2017, 2008, 11, cuda)

    def feats(w, v, x, y):
        n = torch.zeros(w.shape[0], device=cuda)
        return Features(x=x, y=y, size=n, response=n, angle=n,
                        layer=n.to(torch.int32), words=w, valid=v,
                        count=torch.tensor(w.shape[0], dtype=torch.int32),
                        overflow=torch.tensor(False))

    f1 = feats(w1, v1, x2[:1].expand(2017).contiguous(),
               y2[:1].expand(2017).contiguous())
    f2 = feats(w2, v2, x2, y2)
    want = match(w1, v1, w2, v2, x2, y2)       # warm: the library is built
    keys = len(programs.stats())
    before = thamming.hamming_match.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(5):
                got = Akaze.match(f1, f2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert thamming.hamming_match.launches == before + 5
    assert len(programs.stats()) == keys
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cuda_ = torch.autograd.DeviceType.CUDA
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda_]
    # the trace can drop an event, never add one: no other kernel, no copy
    assert 1 <= len(names) <= 5, names
    assert all("hamming_kernel" in n for n in names), names
