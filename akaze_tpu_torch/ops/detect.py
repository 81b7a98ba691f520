"""Detection's full-map stages in one kernel: per-scale extrema, the
octave merge and circular NMS of every image of a batch.

The CUDA kernel is ``csrc/detect.cu``.  It replaces no TPU kernel; its
header says why it was added and what bounds it on the card.

``extrema_nms`` is the wrapper: on CUDA tensors it launches the kernel
(one launch for the batch; two where the NMS radius is too wide for the
kernel's shared-memory halo, which no shipped configuration reaches) or
raises, on CPU tensors it runs ``extrema_nms_plain``, which is
``detect.build_extrema_maps`` followed by ``detect.nms`` per image.  Both return the full-resolution response and
layer maps and the NMS survivor mask of each image.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List

import numpy as np
import torch

from .. import _build
from ..detect import build_extrema_maps, nms
from ..plan import PipelinePlan
from ..scale_space import OctaveData

# limits of csrc/detect.cu (AkazeConfig allows at most 5 scales; an
# octave under 80 pixels ends the pyramid)
MAX_OCTAVES = 16
MAX_SCALES = 8


def extrema_nms_plain(octaves: List[OctaveData], plan: PipelinePlan):
    """The plain PyTorch version; same arguments and results as
    ``extrema_nms``."""
    maps = []
    for i in range(octaves[0].det.shape[0]):
        image = [OctaveData(*(p[i] for p in o)) for o in octaves]
        resp, size, layer = build_extrema_maps(image, plan)
        maps.append((resp, layer, nms(resp, size, layer, plan)))
    return tuple(torch.stack(m) for m in zip(*maps))


def _bits(value) -> int:
    return int(np.float32(value).view(np.int32))


@lru_cache(maxsize=None)
def layout(plan: PipelinePlan, fixed: bool) -> np.ndarray:
    """The kernel's static parameters (csrc/detect.cu ``Layout``), int32
    words: float numbers as their float32 bits, as the plain version's
    float32 tensors hold them."""
    cfg = plan.config
    n = len(plan.octaves)
    head = np.array([int(fixed), plan.height, plan.width, n, cfg.max_scale,
                     plan.max_nms_radius, plan.psz,
                     cfg.idthreshold if fixed else _bits(cfg.dthreshold)],
                    np.int32)
    hw = np.zeros((MAX_OCTAVES, 2), np.int32)
    rect = np.zeros((MAX_OCTAVES, MAX_SCALES, 4), np.int32)
    size = np.zeros((MAX_OCTAVES, MAX_SCALES), np.int32)
    for o, op in enumerate(plan.octaves):
        hw[o] = op.height, op.width
        for s, sp in enumerate(op.scales):
            rect[o, s] = sp.x_lo, sp.x_hi, sp.y_lo, sp.y_hi
            size[o, s] = _bits(sp.size)
    return np.concatenate([head, hw.ravel(), rect.ravel(), size.ravel()])


def _check(octaves, plan: PipelinePlan):
    """The det stacks' type; raises unless they are ``plan``'s, of one
    batch, type and device."""
    if len(octaves) != len(plan.octaves):
        raise ValueError(f"{len(octaves)} octaves, the plan has "
                         f"{len(plan.octaves)}")
    det0 = octaves[0].det
    if det0.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"det must be float32 or int32, got {det0.dtype}")
    for o, (od, op) in enumerate(zip(octaves, plan.octaves)):
        shape = (det0.shape[0], len(op.scales), op.height, op.width)
        _build.check_tensor(f"octave {o} det", od.det, det0.dtype, shape,
                            det0.device)
    return det0.dtype


def _launch(octaves, plan: PipelinePlan, fixed: bool):
    if len(plan.octaves) > MAX_OCTAVES or plan.config.max_scale > MAX_SCALES:
        raise ValueError(
            f"no extrema_nms kernel for {len(plan.octaves)} octaves of "
            f"{plan.config.max_scale} scales (at most {MAX_OCTAVES}, "
            f"{MAX_SCALES})")
    det0 = octaves[0].det
    b, dev = det0.shape[0], det0.device
    shape = (b, plan.height, plan.width)
    resp = torch.empty(shape, dtype=det0.dtype, device=dev)
    layer = torch.empty(shape, dtype=torch.int32, device=dev)
    mask = torch.empty(shape, dtype=torch.bool, device=dev)
    words = layout(plan, fixed)
    dets = (ctypes.c_void_p * len(octaves))(*(o.det.data_ptr()
                                              for o in octaves))
    lib = _build.library()
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.akaze_extrema_nms(words.ctypes.data, words.size, dets,
                                    len(octaves), b, resp.data_ptr(),
                                    layer.data_ptr(), mask.data_ptr(),
                                    _build.stream_of(det0), ctypes.byref(n))
    _build.check(err, "extrema_nms_kernel")
    extrema_nms.launches += n.value
    return resp, layer, mask


def extrema_nms(octaves: List[OctaveData], plan: PipelinePlan):
    """Full-resolution maps and NMS survivors of a batch.

    Args:
      octaves: the scale space of B images (``build_scale_space`` of a
        [B, H, W] batch): per octave its [B, S, h, w] planes, of which only
        ``det`` is read (float32, or int32 on the 16.16 fixed path).
      plan: the plan the scale space was built with.

    Returns (resp, layer, mask), each [B, H, W]: the merged response (the
    det type; the min fill where no extremum), the layer code (int32, -1
    for none) and the NMS survivors (bool), as ``detect.build_extrema_maps``
    and ``detect.nms`` give them for each image.
    """
    dtype = _check(octaves, plan)
    dev = octaves[0].det.device
    if dev.type == "cpu":
        return extrema_nms_plain(octaves, plan)
    if dev.type == "cuda":
        return _launch(octaves, plan, dtype == torch.int32)
    raise ValueError(f"no extrema_nms kernel for device {dev}")


# kernel launches; a replayed program adds the launches its capture
# recorded (programs.py), so the count covers graphs too
extrema_nms.launches = 0
