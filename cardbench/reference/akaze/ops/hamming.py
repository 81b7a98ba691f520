"""K4's plain version: brute-force Hamming 1-NN with a running top-2.

A frozen copy of the port's ``hamming_top2_plain`` and its helpers
(``akaze_tpu_torch/ops/hamming.py``): per query the smallest distance to
a valid train row, the second smallest (equal to it when the minimum is
not unique) and the lowest index reaching the minimum.
"""

from __future__ import annotations

import torch

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


hamming_top2 = hamming_top2_plain
