"""The reference pipeline: images -> features -> matches, in plain PyTorch.

The port's ``pipeline.detect_and_compute_batch`` and ``Akaze.match``
without programs or kernels: the scale space of a batch, detection per
image, one describe call for the batch, then the Hamming match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .descriptor import WSIZE, orient_describe_multi, plane_dtype
from .detect import build_padded_pyramid, detect_keypoints
from .match import Matches, match
from .plan import PipelinePlan
from .scale_space import OctaveData, build_scale_space


class Features(NamedTuple):
    """Detection + description results in fixed-capacity tensors."""
    x: torch.Tensor
    y: torch.Tensor
    size: torch.Tensor
    layer: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    words: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor


def detect_and_compute_batch(images: torch.Tensor,
                             plan: PipelinePlan) -> list:
    """Features of each image of a [B, H, W] float32 batch in [0, 1]."""
    if images.dim() != 3 or tuple(images.shape[1:]) != (plan.height,
                                                        plan.width):
        raise ValueError(f"images must be [B, {plan.height}, {plan.width}]"
                         f", got {tuple(images.shape)}")
    octs, _ = build_scale_space(images.to(torch.float32).contiguous(), plan)
    per_image = [[OctaveData(*(p[i] for p in o)) for o in octs]
                 for i in range(images.shape[0])]
    kps = [detect_keypoints(o, plan) for o in per_image]
    pp = build_padded_pyramid([o for img in per_image for o in img], WSIZE,
                              plane_dtype(plan, False))
    described = orient_describe_multi(kps, pp, plan, False)
    return [Features(x=k.x, y=k.y, size=k.size, layer=k.layer,
                     response=k.response, angle=angle, words=words,
                     valid=k.valid, count=k.count, overflow=k.overflow)
            for k, (angle, words) in zip(kps, described)]


def match_features(f1, f2, max_dist: int = 96) -> Matches:
    """Brute-force Hamming match of f1 against f2 (``Akaze.match``)."""
    return match(f1.words, f1.valid, f2.words, f2.valid, f2.x, f2.y,
                 max_dist)
