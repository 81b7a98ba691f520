"""End-to-end AKAZE pipeline (PyTorch): image(s) -> features -> matches.

Port of the float path of ``akaze_tpu/pipeline.py``.  One code path serves
one image and a pair: the scale space of all B images runs with one K1
launch per sublevel, detection runs per image, and one K2 launch describes
every image's keypoints.  ``Akaze.match`` runs K4.  On CPU tensors every
kernel's plain version runs instead; nothing chooses a device behind the
caller's back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import AkazeConfig
from .descriptor import WSIZE, orient_describe_multi, words_to_numpy
from .detect import build_padded_pyramid, detect_keypoints
from .match import Matches, match
from .plan import PipelinePlan, build_plan
from .scale_space import OctaveData, build_scale_space


class Features(NamedTuple):
    """Detection + description results in fixed-capacity tensors."""
    x: torch.Tensor         # [max_pts] float32 full-resolution coords
    y: torch.Tensor
    size: torch.Tensor      # [max_pts] float32
    layer: torch.Tensor     # [max_pts] int32 octave * max_scale + scale
    response: torch.Tensor  # [max_pts] float32
    angle: torch.Tensor     # [max_pts] float32 in [0, 2*pi)
    words: torch.Tensor     # [max_pts, 16] int32 MLDB bits (uint32 patterns)
    valid: torch.Tensor     # [max_pts] bool
    count: torch.Tensor     # scalar int32
    overflow: torch.Tensor  # scalar bool: NMS survivors dropped by a cap


def _as_images(images, device) -> torch.Tensor:
    """[B, H, W] float32 on ``device`` (default: where a tensor already is,
    else the CPU)."""
    if device is None:
        device = images.device if isinstance(images, torch.Tensor) else "cpu"
    return torch.as_tensor(images, dtype=torch.float32,
                           device=device).contiguous()


def detect_batch(images, plan: PipelinePlan, *, device=None):
    """Scale space and keypoints of each image of a [B, H, W] float batch
    in [0, 1], plus the batch's bf16 plane stack for the descriptor.
    Returns (list of Keypoints, PaddedPyramid)."""
    x = _as_images(images, device)
    if x.dim() != 3 or tuple(x.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"images must be [B, {plan.height}, {plan.width}],"
                         f" got {tuple(x.shape)}")
    octs, _ = build_scale_space(x, plan)
    per_image = [[OctaveData(*(p[i] for p in o)) for o in octs]
                 for i in range(x.shape[0])]
    kps = [detect_keypoints(o, plan) for o in per_image]
    pp = build_padded_pyramid([o for img in per_image for o in img], WSIZE)
    return kps, pp


def detect_and_compute_batch(images, plan: PipelinePlan, *,
                             device=None) -> list:
    """Features of each image of a [B, H, W] float batch in [0, 1]: one K1
    launch per sublevel and one K2 launch for the whole batch."""
    kps, pp = detect_batch(images, plan, device=device)
    described = orient_describe_multi(kps, pp, plan)
    return [Features(x=k.x, y=k.y, size=k.size, layer=k.layer,
                     response=k.response, angle=angle, words=words,
                     valid=k.valid, count=k.count, overflow=k.overflow)
            for k, (angle, words) in zip(kps, described)]


def detect_and_compute(image, plan: PipelinePlan, *,
                       device=None) -> Features:
    """Features of one [H, W] float image in [0, 1]."""
    return detect_and_compute_batch(_as_images(image, device)[None],
                                    plan)[0]


def detect_and_compute_pair(image_a, image_b, plan: PipelinePlan, *,
                            device=None):
    """Features of both images of a matching pair, batched: 16 K1 launches
    and one K2 launch for the pair.  Returns (features_a, features_b)."""
    a = _as_images(image_a, device)
    b = _as_images(image_b, a.device)
    if a.shape != b.shape:
        raise ValueError("pair batching needs equal shapes")
    fa, fb = detect_and_compute_batch(torch.stack([a, b]), plan)
    return fa, fb


class Akaze:
    """Plans cached per image shape; every tensor on ``device``."""

    def __init__(self, config: Optional[AkazeConfig] = None,
                 device="cpu"):
        self.config = config or AkazeConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               f"not available")
        self._plans = {}

    def plan_for(self, height: int, width: int) -> PipelinePlan:
        key = (height, width)
        if key not in self._plans:
            self._plans[key] = build_plan(height, width, self.config)
        return self._plans[key]

    def detect_and_compute(self, image) -> Features:
        """image: [H, W] float in [0, 1] (numpy or tensor)."""
        x = _as_images(image, self.device)
        return detect_and_compute(x, self.plan_for(*x.shape))

    def detect_and_compute_pair(self, image_a, image_b):
        """Both images of a pair in one batch.  Returns (fa, fb)."""
        a = _as_images(image_a, self.device)
        return detect_and_compute_pair(a, image_b, self.plan_for(*a.shape))

    def match(self, f1: Features, f2: Features,
              max_dist: Optional[int] = None) -> Matches:
        """Brute-force Hamming match of f1 against f2 (cuMatch,
        akaze.cpp:55-64)."""
        return match(f1.words, f1.valid, f2.words, f2.valid, f2.x, f2.y,
                     self.config.max_dist if max_dist is None else max_dist)


def features_to_numpy(f: Features) -> dict:
    """Host-side export trimmed to the live count; words as uint32."""
    n = int(f.count)
    out = {}
    for k, v in f._asdict().items():
        if k in ("count", "overflow"):
            continue
        out[k] = (words_to_numpy(v) if k == "words"
                  else v.detach().cpu().numpy())[:n]
    out["count"] = n
    out["overflow"] = bool(f.overflow)
    return out
