"""Brute-force Hamming matching (PyTorch).

Port of ``akaze_tpu/match.py``.  The reference matcher (gHammingMatch,
akazed.cu:2144-2241) keeps a match only if its distance is < MAX_DIST and
the minimum is unique; both reference matchers collapse to ``best <
second_best`` (see the JAX module's docstring).  Kernel K4
(ops/hamming.py) finds (best, second, index) per query; acceptance is
decided here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.hamming import distance_matrix, hamming_top2, last_live


class Matches(NamedTuple):
    """Per-query match results, mirroring the AkazePoint match fields
    (akaze_structures.h:33-39).  Rejected queries hold -1."""
    index: torch.Tensor      # [N1] int32 index into the train set
    distance: torch.Tensor   # [N1] float32 Hamming distance
    match_x: torch.Tensor    # [N1] float32 matched point x
    match_y: torch.Tensor    # [N1] float32 matched point y


def hamming_distance_matrix(words1: torch.Tensor,
                            words2: torch.Tensor) -> torch.Tensor:
    """Exact [N1, N2] Hamming distances (float32 integer values)."""
    return distance_matrix(words1, words2).to(torch.float32)


def match(words1, valid1, words2, valid2, x2, y2,
          max_dist: int = 96) -> Matches:
    """1-NN Hamming match with strict-uniqueness acceptance.

    Args:
      words1/valid1: query descriptors [N1, 16] int32 and validity [N1].
      words2/valid2/x2/y2: train descriptors, validity and coordinates.
      max_dist: acceptance threshold (MAX_DIST, akazed.cu:11).
    """
    best, second, idx = hamming_top2(words1, words2, valid2,
                                     last_live(valid1), last_live(valid2))
    return matches_from_top2(best, second, idx, valid1, x2, y2, max_dist)


def matches_from_top2(best, second, idx, valid1, x2, y2,
                      max_dist: int = 96) -> Matches:
    """Acceptance (match.py:117-122 of the JAX package): a unique minimum
    below ``max_dist`` for a valid query."""
    accept = (best < second) & (best < max_dist) & valid1
    neg = torch.full(idx.shape, -1.0, dtype=torch.float32,
                     device=idx.device)
    if x2.shape[0]:
        safe = idx.clamp(min=0).to(torch.int64)
        mx, my = x2[safe], y2[safe]
    else:
        mx = my = neg
    return Matches(
        index=torch.where(accept, idx, torch.full_like(idx, -1)),
        distance=torch.where(accept, best.to(torch.float32), neg),
        match_x=torch.where(accept, mx, neg),
        match_y=torch.where(accept, my, neg))
