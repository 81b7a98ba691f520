"""End-to-end AKAZE pipeline (PyTorch): image(s) -> features -> matches.

Port of ``akaze_tpu/pipeline.py``.  One code path serves one image and a
pair: the scale space of all B images runs with the same K1 launches
(13 per pair at 960x1280), one launch finds every image's extrema and NMS
survivors (``ops/detect.py``), selection and refinement run per image, and
one K2 launch describes every image's keypoints.  ``Akaze.match`` runs K4.  ``Akaze`` runs
each of its calls as a compiled program (``programs.py``, the JAX
package's ``_jit_*`` wrappers, the row-sharded one with a mesh): one CUDA
graph per static signature, shared between instances.  Entry points run on the card: ``Akaze()`` and a numpy image default to CUDA (and
raise without a card), a tensor stays where it lies, and ``device="cpu"``
runs every kernel's plain version instead.

``fixed=True`` selects the 16.16 fixed-point path (the reference's
``fastDetectAndCompute``): images are raw 0..255 values taken as int32,
and the configuration picks the descriptor's flavour
(``AkazeConfig.fixed_descriptor_exact``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import DESCRIPTOR_WORDS, AkazeConfig
from .descriptor import (WSIZE, orient_describe_multi, plane_dtype,
                         words_to_numpy)
from .detect import build_padded_pyramid, select_and_refine
from .match import Matches, match
from .ops.detect import extrema_nms
from .plan import PipelinePlan, build_plan
from . import tracing
from .programs import jit
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


def _device(device) -> torch.device:
    """``device``, checked: a CUDA device needs a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available; pass device=\"cpu\" to run the "
                           f"plain versions on the CPU")
    return device


def _on_mesh(device: torch.device, mesh) -> bool:
    """Whether ``device`` names the mesh's devices: each of them when it
    has no index (``"cuda"``, ``"cpu"``), one of them when it has."""
    devs = mesh.local_devices
    if device.index is None and device.type != "cpu":
        return all(d.type == device.type for d in devs)
    return device in devs


def _as_images(images, device, fixed: bool = False) -> torch.Tensor:
    """[B, H, W] on ``device`` (default: where a tensor already is, else the
    card): float32, or int32 for the fixed path."""
    if device is None:
        device = (images.device if isinstance(images, torch.Tensor)
                  else "cuda")
    dtype = torch.int32 if fixed else torch.float32
    return torch.as_tensor(images, device=_device(device)).to(
        dtype).contiguous()


def _keypoints(images, plan: PipelinePlan, fixed: bool, device):
    """Scale space and keypoints of each image of a [B, H, W] batch.
    Returns (list of Keypoints, per image its list of OctaveData)."""
    x = _as_images(images, device, fixed)
    if x.dim() != 3 or tuple(x.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"images must be [B, {plan.height}, {plan.width}],"
                         f" got {tuple(x.shape)}")
    octs, _ = build_scale_space(x, plan)
    resp, layer, mask = extrema_nms(octs, plan)
    per_image = [[OctaveData(*(p[i] for p in o)) for o in octs]
                 for i in range(x.shape[0])]
    return [select_and_refine(mask[i], resp[i], layer[i], o, plan)
            for i, o in enumerate(per_image)], per_image


def detect_batch(images, plan: PipelinePlan, *, fixed: bool = False,
                 device=None):
    """Scale space and keypoints of each image of a [B, H, W] batch (float
    in [0, 1], or raw 0..255 with ``fixed``), plus the batch's plane stack
    for the descriptor (``descriptor.plane_dtype``).  Returns (list of
    Keypoints, PaddedPyramid)."""
    kps, per_image = _keypoints(images, plan, fixed, device)
    pp = build_padded_pyramid([o for img in per_image for o in img], WSIZE,
                              plane_dtype(plan, fixed))
    return kps, pp


def _features(k, angle, words) -> Features:
    return Features(x=k.x, y=k.y, size=k.size, layer=k.layer,
                    response=k.response, angle=angle, words=words,
                    valid=k.valid, count=k.count, overflow=k.overflow)


def detect_and_compute_batch(images, plan: PipelinePlan, *,
                             fixed: bool = False, device=None,
                             describe: bool = True) -> list:
    """Features of each image of a [B, H, W] batch (float in [0, 1], or raw
    0..255 with ``fixed``): the K1 launches of one scale space and one K2
    launch for the whole batch.  ``describe=False`` skips the plane stack
    and K2: angles are 0 and words zero, as in the JAX package."""
    if not describe:
        kps, _ = _keypoints(images, plan, fixed, device)
        return [_features(k, torch.zeros_like(k.x),
                          torch.zeros((k.x.shape[0], DESCRIPTOR_WORDS),
                                      dtype=torch.int32, device=k.x.device))
                for k in kps]
    kps, pp = detect_batch(images, plan, fixed=fixed, device=device)
    described = orient_describe_multi(kps, pp, plan, fixed)
    return [_features(k, angle, words)
            for k, (angle, words) in zip(kps, described)]


def detect_and_compute(image, plan: PipelinePlan, *, fixed: bool = False,
                       device=None, describe: bool = True) -> Features:
    """Features of one [H, W] image (float in [0, 1], or raw 0..255 with
    ``fixed``); ``describe`` as in ``detect_and_compute_batch``."""
    return detect_and_compute_batch(_as_images(image, device, fixed)[None],
                                    plan, fixed=fixed, describe=describe)[0]


def detect_and_compute_pair(image_a, image_b, plan: PipelinePlan, *,
                            fixed: bool = False, device=None):
    """Features of both images of a matching pair, batched: the K1
    launches of one scale space and one K2 launch for the pair.  Returns
    (features_a, features_b)."""
    a = _as_images(image_a, device, fixed)
    b = _as_images(image_b, a.device, fixed)
    if a.shape != b.shape:
        raise ValueError("pair batching needs equal shapes")
    fa, fb = detect_and_compute_batch(torch.stack([a, b]), plan,
                                      fixed=fixed)
    return fa, fb


# The programs of ``Akaze``, as the JAX package's module-level jit
# entries: plans are frozen (hashable) dataclasses, so every Akaze instance
# with the same (shape, config) shares one captured graph.
@jit(static_argnums=(6,))
def _jit_match(w1, v1, w2, v2, x2, y2, max_dist):
    return match(w1, v1, w2, v2, x2, y2, max_dist)


@jit(static_argnames=("plan", "fixed", "describe"))
def _jit_detect_and_compute(image, plan, fixed, describe):
    return detect_and_compute(image, plan, fixed=fixed, describe=describe)


# Mesh is hashable, so the row-sharded program shares its graph across
# Akaze instances exactly like the single-device program above; its
# collectives run over the mesh's "data" axis (``programs.mesh_route``
# decides from the mesh whether a key is captured)
@jit(static_argnames=("plan", "mesh", "fixed", "describe"),
     collective_axes=lambda statics: "data")
def _jit_spatial_detect_and_compute(image, plan, mesh, fixed, describe):
    from .parallel.spatial import spatial_detect_and_compute
    return spatial_detect_and_compute(image, plan, mesh, fixed=fixed,
                                      describe=describe)


@jit(static_argnames=("plan", "fixed"))
def _jit_detect_and_compute_pair(image_a, image_b, plan, fixed):
    return detect_and_compute_pair(image_a, image_b, plan, fixed=fixed)


class Akaze:
    """Plans cached per image shape, and a compiled program per call
    signature (``programs.py``: one CUDA graph per static signature on the
    card; the CPU runs the functions as they are); every tensor on
    ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``, where every kernel's plain version runs).  Without
    a card, the default raises.

    ``fixed=True``: the 16.16 fixed-point path; images are raw 0..255
    (as the reference's demo feeds its fast path, main.cpp:257-258).

    ``mesh``: a ``parallel.Mesh`` with a ``data`` axis of more than one
    shard: each image's rows are then sharded over it (the spatial tier,
    ``parallel/spatial.py``), and features come back on the mesh's first
    device.  The mesh's devices hold the tensors: a ``device`` that
    disagrees with them raises.  A one-shard mesh means no mesh.

    ``spatial_fallback``: with a mesh, shapes the spatial tier cannot
    shard run the single-device program on the mesh's first device instead
    of raising (for callers feeding mixed frame sizes, such as the SLAM
    front end); ``spatial_fallbacks`` counts those images.

    Each call is one request of ``tracing``: ``akaze.upload`` (the images
    to ``device``: a host array's copy and cast) and ``akaze.detect`` (the
    program's call; with a mesh one per image), or ``akaze.match``.  An
    image through the spatial tier opens ``akaze.spatial`` inside
    ``akaze.detect`` and counts ``spatial.images`` and its
    ``spatial.exchange_bytes`` (``parallel.spatial_exchange_bytes``,
    cached per shape); a fallback counts ``spatial.fallbacks``."""

    def __init__(self, config: Optional[AkazeConfig] = None,
                 fixed: bool = False, device=None, mesh=None,
                 spatial_fallback: bool = False):
        self.config = config or AkazeConfig()
        self.fixed = fixed
        if mesh is not None:
            if "data" not in mesh.shape:
                raise ValueError(
                    f"mesh axes {tuple(mesh.shape)} have no 'data' axis: "
                    "the spatial tier shards image rows over mesh['data']")
            if device is not None and not _on_mesh(torch.device(device),
                                                   mesh):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh}")
            device = mesh.home
        self.device = _device("cuda" if device is None else device)
        self.mesh = mesh if mesh is not None and mesh.shape["data"] > 1 \
            else None
        self.spatial_fallback = spatial_fallback
        self.spatial_fallbacks = 0
        self._plans = {}
        self._spatial = {}      # shape: (sharded, bytes between shards)

    def plan_for(self, height: int, width: int) -> PipelinePlan:
        key = (height, width)
        if key not in self._plans:
            self._plans[key] = build_plan(height, width, self.config)
        return self._plans[key]

    def sharded(self, height: int, width: int, describe: bool = True
                ) -> bool:
        """Whether images of this shape run the spatial tier (cached per
        shape); raises ValueError for an unsupported shape without
        ``spatial_fallback``.  Callers may ask before the first image."""
        if self.mesh is None:
            return False
        key = (height, width, describe)
        if key not in self._spatial:
            from .parallel.spatial import (spatial_exchange_bytes,
                                           spatial_supported)
            n = self.mesh.shape["data"]
            plan = self.plan_for(height, width)
            ok, why = spatial_supported(plan, n, detect=True,
                                        describe=describe)
            if not ok and not self.spatial_fallback:
                raise ValueError(f"spatial sharding unsupported for "
                                 f"{height}x{width} over {n} devices: "
                                 f"{why}")
            self._spatial[key] = (ok, spatial_exchange_bytes(
                plan, n, describe, kernels=self.device.type == "cuda")
                if ok else 0)
        return self._spatial[key][0]

    def detect_and_compute(self, image, describe: bool = True) -> Features:
        """image: [H, W] (numpy or tensor), float in [0, 1], or raw 0..255
        on the fixed path.  ``describe=False``: keypoints only, with angle
        0 and zero words (no plane stack, no K2)."""
        with tracing.request():
            with tracing.span("akaze.upload"):
                x = _as_images(image, self.device, self.fixed)
            return self._detect(x, describe)

    def _detect(self, x: torch.Tensor, describe: bool = True) -> Features:
        """The program's call on an image already on ``device``: the
        spatial tier with a mesh where it shards the shape, else the
        single-device program."""
        plan = self.plan_for(*x.shape)
        with tracing.span("akaze.detect"):
            if self.sharded(*x.shape, describe):
                if tracing.enabled():
                    tracing.count("spatial.images")
                    tracing.count("spatial.exchange_bytes", self._spatial[
                        (*x.shape, describe)][1])
                with tracing.span("akaze.spatial"):
                    return _jit_spatial_detect_and_compute(
                        x, plan, self.mesh, self.fixed, describe)
            if self.mesh is not None:
                self.spatial_fallbacks += 1
                tracing.count("spatial.fallbacks")
            return _jit_detect_and_compute(x, plan, self.fixed, describe)

    def detect_and_compute_pair(self, image_a, image_b):
        """Both images of a pair in one batch.  Returns (fa, fb).  With a
        mesh each image runs the spatial program instead (per-image memory
        is why the mesh exists; batching the pair onto one device would
        defeat it)."""
        with tracing.request():
            with tracing.span("akaze.upload"):
                a = _as_images(image_a, self.device, self.fixed)
                b = _as_images(image_b, self.device, self.fixed)
            if a.shape != b.shape:
                raise ValueError("pair batching needs equal shapes")
            if self.mesh is not None:
                return self._detect(a), self._detect(b)
            with tracing.span("akaze.detect"):
                return _jit_detect_and_compute_pair(
                    a, b, self.plan_for(*a.shape), self.fixed)

    @staticmethod
    def match(f1: Features, f2: Features, max_dist: int = 96) -> Matches:
        """Brute-force Hamming match of f1 against f2 (cuMatch,
        akaze.cpp:55-64), accepting distances below ``max_dist`` (MAX_DIST,
        akazed.cu:11).  As in the JAX package, ``config.max_dist`` is not
        read here: a caller that wants it passes it (as the JAX package's
        ``cli.py:119`` does)."""
        with tracing.request(), tracing.span("akaze.match"):
            return _jit_match(f1.words, f1.valid, f2.words, f2.valid, f2.x,
                              f2.y, max_dist)


def features_from_numpy(f, device, max_pts: Optional[int] = None
                        ) -> Features:
    """``Features`` on ``device`` from numpy arrays (the inverse of
    ``features_to_numpy``): ``f`` is a mapping or a named tuple of arrays
    with the fields of ``Features``, such as the JAX package's (uint32
    words; an ``overflow`` of None reads as False).  Rows are kept as given,
    or padded with dead slots to ``max_pts``."""
    d = f if isinstance(f, dict) else f._asdict()
    n = np.asarray(d["x"]).shape[0]
    pad = (max_pts or n) - n
    if pad < 0:
        raise ValueError(f"{n} rows do not fit max_pts={max_pts}")
    dev = _device(device)
    out = {}
    for k in Features._fields:
        v = d.get(k)
        if k == "count":
            v = np.int32(n if v is None else v)
        elif k == "overflow":
            v = np.bool_(False if v is None else v)
        else:
            v = np.asarray(v)
            if k == "words":
                v = v.astype(np.uint32).view(np.int32)
            v = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
        out[k] = torch.as_tensor(np.ascontiguousarray(v), device=dev)
    return Features(**out)


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
