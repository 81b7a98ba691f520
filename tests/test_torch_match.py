"""Kernel K4 (running-top-2 Hamming matcher) and the match module of the
PyTorch port against the JAX package, whose matcher runs its Pallas kernel
in interpret mode (``match(..., use_pallas="interpret")``).

Distances are integers, so everything is compared exactly: ``Matches``
(index, distance, match_x, match_y) equal, and the plain top-2 equal to a
brute-force numpy reference.  The raw ``second`` is not compared with the
JAX kernel, which gives invalid train rows the pseudo-distance 243 where
the port skips them; acceptance is the same either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.match import hamming_distance_matrix as jdistance
from akaze_tpu.match import match as jmatch
from akaze_tpu_torch import hamming_distance_matrix, match
from akaze_tpu_torch.descriptor import pack_bits, words_to_numpy
from akaze_tpu_torch.ops import hamming as thamming

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


def test_distance_matrix_exact():
    w1, _, w2, _, _, _ = seeded_sets(37, 53, 0)
    got = hamming_distance_matrix(w1, w2).numpy()
    want = np.asarray(jdistance(jnp.asarray(words_to_numpy(w1)),
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
    w1, v1, w2, v2, x2, y2 = seeded_sets(n1, n2, seed)
    # prefix-compacted validity, as the pipeline produces it
    v1[n1 - 17:] = False
    v2[n2 - 9:] = False
    got = match(w1, v1, w2, v2, x2, y2, 96)
    want = jmatch(jnp.asarray(words_to_numpy(w1)), jnp.asarray(v1.numpy()),
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
    thamming.hamming_top2.launches = 0
    w1, v1, w2, v2, x2, y2 = seeded_sets(40, 40, 5)
    match(w1, v1, w2, v2, x2, y2)
    assert thamming.hamming_top2.launches == 0

