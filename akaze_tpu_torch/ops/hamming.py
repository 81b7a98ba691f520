"""Kernel K4: brute-force Hamming 1-NN with a running top-2.

Replaces ``akaze_tpu/ops/pallas_match.py:hamming_top2``.  The CUDA kernel is
``csrc/hamming.cu``; its header says what bounds it on the card and what its
design does about that.

Two wrappers launch it.  ``hamming_match`` is the whole match of
``match.match`` in one launch: the scan extents, the top-2 and the
acceptance rule (``accept_top2``) on the card, returning the four fields of
``Matches``; CPU tensors run ``hamming_match_plain`` (``hamming_top2_plain``
over ``last_live``'s extents, then ``accept_top2``).  ``hamming_top2``
returns the raw top-2 for extents the caller gives; CPU tensors run
``hamming_top2_plain``.  Each raises for another device.  The top-2 is, per
query, the smallest distance to a valid train row, the second smallest
(equal to the smallest when the minimum is not unique) and the lowest index
reaching the minimum.  Invalid train rows never count; queries at or past
``count1`` return (BIG, BIG, -1).
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..config import DESCRIPTOR_WORDS

BIG = 1 << 20   # "no distance": larger than any of the 486 bits
CHUNK = 512     # query rows per [CHUNK, N2, 16] block of the plain version


def last_live(valid: torch.Tensor) -> torch.Tensor:
    """[1] int32: one past the index of the last True in ``valid`` (0 if
    none) - the scan extent of a prefix-compacted slot set."""
    n = valid.shape[0]
    pos = torch.arange(0, n + 1, dtype=torch.int32, device=valid.device)
    live = torch.cat([valid.new_ones(1), valid])   # slot 0 stands for "none"
    return torch.where(live, pos, torch.zeros_like(pos)).amax(
        dim=0, keepdim=True)


def _bits(words: torch.Tensor) -> torch.Tensor:
    """[N, 16] int32 words -> [N, 512] float32 bits (0 or 1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(
        words.shape[0], 32 * DESCRIPTOR_WORDS).to(torch.float32)


def distance_matrix(words1: torch.Tensor,
                    words2: torch.Tensor) -> torch.Tensor:
    """Exact [N1, N2] int64 Hamming distances of int32 word rows:
    |a| + |b| - 2 a.b over the bit vectors, a float32 product of 0/1
    entries whose sums (at most 512) are exact."""
    b = _bits(words2)
    nb = b.sum(1)
    out = []
    for i in range(0, words1.shape[0], CHUNK):
        a = _bits(words1[i:i + CHUNK])
        d = a.sum(1)[:, None] + nb[None, :] - 2.0 * (a @ b.T)
        out.append(d.to(torch.int64))
    if not out:
        return torch.zeros((0, words2.shape[0]), dtype=torch.int64,
                           device=words1.device)
    return torch.cat(out)


def hamming_top2_plain(words1, words2, valid2, count1, count2):
    """The plain PyTorch version; same arguments and results as
    ``hamming_top2``."""
    n1, n2 = words1.shape[0], words2.shape[0]
    dev = words1.device
    live2 = valid2 & (torch.arange(n2, device=dev) < count2)
    # one BIG column past the train set: a query with no valid train row
    # finds best = BIG there and reports index -1
    live2 = torch.cat([live2, live2.new_zeros(1)])
    words2 = torch.cat([words2, words2.new_zeros(1, DESCRIPTOR_WORDS)])
    best, second, idx = [], [], []
    for i in range(0, n1, CHUNK):
        d = distance_matrix(words1[i:i + CHUNK], words2)
        d = torch.where(live2[None, :], d, torch.full_like(d, BIG))
        j = torch.argmin(d, dim=1)      # the first minimum
        b = d.gather(1, j[:, None])[:, 0]
        best.append(b)
        second.append(d.scatter(1, j[:, None], BIG).amin(dim=1))
        idx.append(torch.where(b < BIG, j, torch.full_like(j, -1)))
    best, second, idx = (
        torch.cat(v).to(torch.int32) if v
        else torch.zeros(0, dtype=torch.int32, device=dev)
        for v in (best, second, idx))
    dead = torch.arange(n1, device=dev) >= count1
    big = torch.full_like(best, BIG)
    return (torch.where(dead, big, best), torch.where(dead, big, second),
            torch.where(dead, torch.full_like(idx, -1), idx))


def accept_top2(best, second, idx, valid1, x2, y2, max_dist: int = 96):
    """Acceptance (match.py:117-122 of the JAX package): a unique minimum
    below ``max_dist`` for a valid query.  Returns (index, distance,
    match_x, match_y), rejected queries -1 in each."""
    accept = (best < second) & (best < max_dist) & valid1
    neg = torch.full(idx.shape, -1.0, dtype=torch.float32,
                     device=idx.device)
    if x2.shape[0]:
        safe = idx.clamp(min=0).to(torch.int64)
        mx, my = x2[safe], y2[safe]
    else:
        mx = my = neg
    return (torch.where(accept, idx, torch.full_like(idx, -1)),
            torch.where(accept, best.to(torch.float32), neg),
            torch.where(accept, mx, neg),
            torch.where(accept, my, neg))


def hamming_match_plain(words1, valid1, words2, valid2, x2, y2,
                        max_dist: int = 96):
    """The plain twin of ``hamming_match``; same arguments and results."""
    best, second, idx = hamming_top2_plain(
        words1, words2, valid2, last_live(valid1), last_live(valid2))
    return accept_top2(best, second, idx, valid1, x2, y2, max_dist)


def _threshold(max_dist) -> int:
    """``max_dist`` as the kernel's int: a distance d in [0, 512] is below
    it exactly when it is below its ceiling, clamped to [0, 513]."""
    if isinstance(max_dist, torch.Tensor):
        raise TypeError("max_dist must be a number, not a tensor")
    if math.isnan(max_dist):   # ``best < nan`` rejects every distance
        return 0
    bound = 32 * DESCRIPTOR_WORDS + 1
    return max(math.ceil(min(max(max_dist, -1), bound)), 0)


def _launch_match(words1, valid1, words2, valid2, x2, y2, max_dist):
    n1, n2 = words1.shape[0], words2.shape[0]
    for name, t in (("words1", words1), ("words2", words2)):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    # one allocation; the four fields are its rows
    out = torch.empty((4, n1), dtype=torch.float32, device=words1.device)
    index, distance, mx, my = out.unbind(0)
    index = index.view(torch.int32)
    if n1:
        err = _build.library().akaze_hamming_match(
            words1.device.index, words1.data_ptr(), valid1.data_ptr(), n1,
            words2.data_ptr(), valid2.data_ptr(), n2, x2.data_ptr(),
            y2.data_ptr(), _threshold(max_dist), index.data_ptr(),
            distance.data_ptr(), mx.data_ptr(), my.data_ptr(),
            _build.stream_of(words1))
        _build.check(err, "hamming_kernel")
        hamming_match.launches += 1
    return index, distance, mx, my


def hamming_match(words1: torch.Tensor, valid1: torch.Tensor,
                  words2: torch.Tensor, valid2: torch.Tensor,
                  x2: torch.Tensor, y2: torch.Tensor, max_dist: int = 96):
    """1-NN Hamming match with strict-uniqueness acceptance, one launch on
    the card: no host sync, no other kernel, no copy.

    Args:
      words1/valid1: [N1, 16] int32 query words and [N1] bool validity.
      words2/valid2: [N2, 16] int32 train words and [N2] bool validity.
      x2, y2: [N2] float32 train coordinates.
      max_dist: a number; distances below it are accepted.

    Holes in either validity are legal; work scales with the last valid
    row of each set.  Returns (index [N1] int32, distance, match_x,
    match_y [N1] float32), rejected queries -1 in each.
    """
    dev = words1.device
    n1, n2 = words1.shape[0], words2.shape[0]
    card = dev.type != "cpu"
    check = _build.check_tensor
    check("words1", words1, torch.int32, (n1, DESCRIPTOR_WORDS), dev)
    check("valid1", valid1, torch.bool, (n1,), dev, card)
    check("words2", words2, torch.int32, (n2, DESCRIPTOR_WORDS), dev)
    check("valid2", valid2, torch.bool, (n2,), dev)
    check("x2", x2, torch.float32, (n2,), dev, card)
    check("y2", y2, torch.float32, (n2,), dev, card)
    if not card:
        return hamming_match_plain(words1, valid1, words2, valid2, x2, y2,
                                   max_dist)
    if dev.type == "cuda":
        return _launch_match(words1, valid1, words2, valid2, x2, y2,
                             max_dist)
    raise ValueError(f"no hamming kernel for device {dev}")


def _launch(words1, words2, valid2, count1, count2):
    n1, n2 = words1.shape[0], words2.shape[0]
    for name, t in (("words1", words1), ("words2", words2)):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    outs = [torch.empty(n1, dtype=torch.int32, device=words1.device)
            for _ in range(3)]
    lib = _build.library()
    with torch.cuda.device(words1.device):
        err = lib.akaze_hamming_top2(
            _build.ptr(words1), n1, _build.ptr(count1), _build.ptr(words2),
            _build.ptr(valid2), n2, _build.ptr(count2),
            *(_build.ptr(o) for o in outs), _build.stream_of(words1))
    _build.check(err, "hamming_kernel")
    hamming_top2.launches += 1
    return tuple(outs)


def hamming_top2(words1: torch.Tensor, words2: torch.Tensor,
                 valid2: torch.Tensor, count1: torch.Tensor,
                 count2: torch.Tensor):
    """Running-top-2 Hamming matcher.

    Args:
      words1: [N1, 16] int32 query descriptor words (uint32 bit patterns).
      words2: [N2, 16] int32 train descriptor words.
      valid2: [N2] bool train validity.
      count1, count2: [1] int32, one past the last live query / train row
        (``last_live``); work scales with these extents.

    Returns (best, second, index), each [N1] int32.
    """
    dev = words1.device
    n1, n2 = words1.shape[0], words2.shape[0]
    check = _build.check_tensor
    check("words1", words1, torch.int32, (n1, DESCRIPTOR_WORDS), dev)
    check("words2", words2, torch.int32, (n2, DESCRIPTOR_WORDS), dev)
    check("valid2", valid2, torch.bool, (n2,), dev)
    check("count1", count1, torch.int32, (1,), dev)
    check("count2", count2, torch.int32, (1,), dev)
    if dev.type == "cpu":
        return hamming_top2_plain(words1, words2, valid2, count1, count2)
    if dev.type == "cuda":
        return _launch(words1, words2, valid2, count1, count2)
    raise ValueError(f"no hamming kernel for device {dev}")


# kernel launches; a replayed program adds the launches its capture
# recorded (programs.py), so the count covers graphs too
hamming_top2.launches = 0
hamming_match.launches = 0
