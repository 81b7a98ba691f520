"""Keyframe-based visual odometry: AKAZE front-end, RANSAC two-view pose,
triangulated local map and the local bundle-adjustment problem.

Port of ``akaze_tpu/slam/odometry.py``.  Each step (detect + describe,
match, RANSAC, triangulate) runs on the device over fixed-capacity tensors;
Python sequences keyframe decisions between them, and fetches results to
the host where the JAX package does.

Monocular scale: the first two-view baseline defines the unit; later
relative translations are scaled so that re-triangulated common landmarks
agree in depth (per-landmark depth ratios against the keyframe's seeded
metric depths, with median fallbacks).

Randomness: the VO keeps a uint32[2] key on the host and splits it once per
two-view solve (``geometry.ransac.split_key``); ``sampler(key, mask,
num_hyps)`` turns the subkey into the [K, 8] minimal sets on the device
(default ``sets_from_key``).  A two-view solve is two compiled programs
(``programs.py``) around that draw, which runs eagerly: the match and
the putative points, then RANSAC and triangulation on the sets.

``mesh=``: frames big enough for the row-sharded spatial tier
(``parallel/spatial.py``) run detection sharded over the mesh's ``data``
axis; smaller frames fall back to the single-device program
(``Akaze(spatial_fallback=True)``).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import programs, tracing
from ..config import AkazeConfig
from ..geometry import se3_compose, se3_inverse, triangulate
from ..geometry.ransac import (_ransac_essential, make_key, normalize_points,
                               sets_from_key, split_key)
from ..match import match
from ..pipeline import Akaze, Features
from .ba import BAProblem


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float


class Keyframe(NamedTuple):
    index: int            # frame index in the sequence
    features: Features
    R: np.ndarray         # [3, 3] world -> camera
    t: np.ndarray         # [3]
    # per-slot metric landmark depths in this keyframe's camera (seeded from
    # the matched triangulation when the keyframe was made) and their
    # validity; loop closures measure their translation magnitude from
    # them.  None when unavailable (first keyframe, tracking failures).
    z: np.ndarray = None
    z_ok: np.ndarray = None


def to_numpy(v) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array.  Every read of
    a tensor to the host on the SLAM path comes through here, and counts
    as one ``host_syncs`` of ``tracing``."""
    if isinstance(v, torch.Tensor):
        tracing.count("host_syncs")
        return v.detach().cpu().numpy()
    return np.asarray(v)


@programs.jit
def _putative(words1, valid1, x1, y1, words2, valid2, x2, y2, fx, fy, cx,
              cy):
    """The first program of a two-view solve: matches of view 1 against
    view 2 (K4), both views' normalised coordinates and the putative mask
    (accepted matches of valid slots)."""
    m = match(words1, valid1, words2, valid2, x2, y2)
    p1 = normalize_points(torch.stack([x1, y1], -1), fx, fy, cx, cy)
    p2 = normalize_points(torch.stack([m.match_x, m.match_y], -1),
                          fx, fy, cx, cy)
    return m, p1, p2, (m.index >= 0) & valid1


@programs.jit(static_argnames=("num_hyps",))
def _solve(x1, x2, putative, sets, threshold, num_hyps: int = 512):
    """The second program of a two-view solve: RANSAC on the drawn sets,
    then triangulation of every slot under the recovered pose."""
    res = _ransac_essential.fn(x1, x2, putative, sets, threshold,
                               num_hyps=num_hyps)
    X1, z1, z2 = triangulate(res.R, res.t, x1, x2)
    return res, X1, z1, z2


def _two_view(key, f1: Features, f2: Features, fx, fy, cx, cy, threshold,
              num_hyps: int = 512, sampler=sets_from_key):
    """Match (K4), RANSAC essential and triangulation on the device: the
    programs ``_putative`` and ``_solve``, with the draw between them.

    ``sampler(key, putative_mask, num_hyps)`` gives the [num_hyps, 8]
    minimal sets.  Returns (m, res, X1, z1, z2): matches of f1 against f2,
    the RANSAC result (its pose maps camera-1 points into camera 2), and
    landmark estimates in camera-1 coordinates for every query slot.
    """
    m, x1, x2, putative = _putative(f1.words, f1.valid, f1.x, f1.y,
                                    f2.words, f2.valid, f2.x, f2.y,
                                    fx, fy, cx, cy)
    sets = sampler(key, putative, num_hyps)
    res, X1, z1, z2 = _solve(x1, x2, putative,
                             sets.to(device=x1.device, dtype=torch.int64),
                             threshold, num_hyps=num_hyps)
    return m, res, X1, z1, z2


class VisualOdometry:
    """Incremental monocular odometry over a frame stream.

    Usage::

        vo = VisualOdometry(Intrinsics(fx, fy, cx, cy))   # on the card
        for img in frames:
            pose = vo.process(img)     # (R, t) world->camera, numpy
        traj = vo.trajectory()          # [N, 3] camera centres

    ``device``: the card by default (raises without one); ``"cpu"`` runs
    every kernel's plain version.  ``mesh``: an optional ``parallel.Mesh``
    with a ``data`` axis; frames the spatial tier can shard are detected
    row-sharded over it, the rest on its first device, where every other
    tensor of the VO lives.
    """

    def __init__(self, intr: Intrinsics,
                 config: Optional[AkazeConfig] = None,
                 ransac_threshold: float = 2e-5,
                 min_inliers: int = 30,
                 keyframe_inlier_ratio: float = 0.6,
                 seed: int = 0,
                 local_ba_window: int = 5,
                 device=None, mesh=None):
        self.intr = intr
        self.akaze = Akaze(config or AkazeConfig(max_pts=4000), device=device,
                           mesh=mesh, spatial_fallback=True)
        self.device = self.akaze.device
        self.threshold = ransac_threshold
        self.min_inliers = min_inliers
        self.kf_ratio = keyframe_inlier_ratio
        self.local_ba_window = local_ba_window
        self._key = make_key(seed)
        # the minimal-set draw of every two-view solve (a seam for tests
        # that replay given draws)
        self.sampler = sets_from_key
        self.keyframes: List[Keyframe] = []
        self.poses: List[tuple] = []       # per-frame (R, t) world->camera
        # True when the last frame's detection dropped NMS survivors
        # (Features.overflow), and the frames where that happened
        self.last_overflow = False
        self.overflow_frames: List[int] = []
        self._frame_idx = 0
        self._kf_inliers0 = None           # inlier count right after a kf
        self._scale = 1.0
        self._last_depth_med = None
        # per-kf-slot metric depths of the previous frame's triangulation
        self._last_z = None
        self._last_z_ok = None

    def _next_key(self):
        self._key, sub = split_key(self._key)
        return sub

    def process(self, image) -> tuple:
        """Ingest one frame; returns its (R, t) world->camera pose."""
        with tracing.span("vo.detect"):
            feats = self.akaze.detect_and_compute(image)
            self.last_overflow = bool(to_numpy(feats.overflow))
        if self.last_overflow:
            self.overflow_frames.append(self._frame_idx)
        intr = self.intr
        if not self.keyframes:
            R = np.eye(3, dtype=np.float32)
            t = np.zeros(3, np.float32)
            self.keyframes.append(Keyframe(self._frame_idx, feats, R, t))
            self.poses.append((R, t))
            self._frame_idx += 1
            return R, t

        kf = self.keyframes[-1]
        with tracing.span("vo.two_view"):
            m, res, X1, z1, z2 = _two_view(
                self._next_key(), kf.features, feats,
                intr.fx, intr.fy, intr.cx, intr.cy, self.threshold,
                sampler=self.sampler)
            with tracing.span("vo.fetch"):
                n_inl = int(to_numpy(res.num_inliers))
                inl = to_numpy(res.inliers)

        if n_inl < self.min_inliers:
            # tracking failure: hold the last pose
            R, t = self.poses[-1]
            self.poses.append((R, t))
            self.keyframes.append(Keyframe(self._frame_idx, feats,
                                           np.asarray(R), np.asarray(t)))
            self._kf_inliers0 = None
            # the next depth median is measured against a new keyframe
            self._last_depth_med = None
            self._last_z = None
            self._frame_idx += 1
            return R, t

        with tracing.span("vo.scale"):
            # scale propagation (see the JAX module for the derivation):
            # a landmark's depth at unit baseline is z_metric / baseline,
            # so the per-landmark ratio of stored metric depths to this
            # frame's depths measures the metric baseline with the
            # structure cancelled
            z_all = to_numpy(z1)
            ok = inl & (z_all > 0)
            z = z_all[inl]
            depth_med = (float(np.median(z[z > 0])) if (z > 0).any()
                         else None)
            scale = self._scale
            kf_common = ((ok & kf.z_ok) if kf.z is not None
                         else np.zeros(0))
            if kf.z is not None and kf_common.sum() >= 8:
                scale = float(np.median(kf.z[kf_common]
                                        / z_all[kf_common]))
                scale = float(np.clip(scale, 0.1 * self._scale,
                                      10.0 * self._scale))
            elif self._last_z is not None:
                common = ok & self._last_z_ok
                if common.sum() >= 8:
                    scale = float(np.median(self._last_z[common]
                                            / z_all[common]))
                elif self._last_depth_med and depth_med:
                    scale = (self._scale * self._last_depth_med
                             / max(depth_med, 1e-6))
                scale = float(np.clip(scale, 0.1 * self._scale,
                                      10.0 * self._scale))
            elif self._last_depth_med and depth_med:
                scale = (self._scale * self._last_depth_med
                         / max(depth_med, 1e-6))
                scale = float(np.clip(scale, 0.1 * self._scale,
                                      10.0 * self._scale))
            # metric depths of this triangulation, for the next frame's
            # ratio
            self._last_z = z_all * scale
            self._last_z_ok = ok

            # compose: T_cur_world = T_rel * T_kf_world
            R_rel = to_numpy(res.R)
            t_rel = to_numpy(res.t) * scale
            R = R_rel @ kf.R
            t = R_rel @ kf.t + t_rel
            self.poses.append((R.astype(np.float32),
                               t.astype(np.float32)))

        if self._kf_inliers0 is None:
            self._kf_inliers0 = max(n_inl, 1)
        if n_inl < self.kf_ratio * self._kf_inliers0:
            with tracing.span("vo.keyframe"):
                # seed the new keyframe's slots with metric depths: z2 is
                # the depth in this frame of each matched landmark at unit
                # baseline, and m.index maps old-kf slots to this frame's
                midx = to_numpy(m.index)
                z2_m = to_numpy(z2) * scale
                n_slots = z_all.shape[0]
                zref = np.zeros(n_slots, np.float32)
                zok = np.zeros(n_slots, bool)
                sel = ok & (midx >= 0) & (z2_m > 0)
                tgt = midx[sel]
                zref[tgt] = z2_m[sel]
                zok[tgt] = True
                self.keyframes.append(Keyframe(
                    self._frame_idx, feats, R.astype(np.float32),
                    t.astype(np.float32), zref, zok))
                self._kf_inliers0 = None
                self._scale = scale
                self._last_depth_med = None
                self._last_z = zref
                self._last_z_ok = zok
        else:
            # commit the scale with the rolling depth median, so that the
            # telescoped product stays anchored at the keyframe epoch
            self._scale = scale
            self._last_depth_med = depth_med
        self._frame_idx += 1
        return self.poses[-1]

    def trajectory(self) -> np.ndarray:
        """[N, 3] camera centres c = -R^T t."""
        out = [-(np.asarray(R).T @ np.asarray(t)) for R, t in self.poses]
        return np.stack(out) if out else np.zeros((0, 3), np.float32)


def build_local_ba(kf_feats: List[Features], kf_poses, intr: Intrinsics,
                   max_pts: int, matches_fn=None):
    """Build a BAProblem from a window of keyframes by chaining matches
    from each keyframe to the next (track stitching on the host, numpy).

    Returns (R [C,3,3], t [C,3], X0 [P,3], BAProblem) on the features'
    device, ready for ``bundle_adjust``.  Landmarks are seeded by
    triangulating each track's first two observations.
    """
    c = len(kf_feats)
    if c < 2:
        raise ValueError("a local BA window needs two keyframes")
    fx, fy, cx, cy = intr.fx, intr.fy, intr.cx, intr.cy
    dev = kf_feats[0].x.device

    # pairwise consecutive matches (matches_fn injectable for testing:
    # takes (f1, f2), returns an [N] index array, -1 = unmatched)
    if matches_fn is None:
        def matches_fn(f1, f2):
            return match(f1.words, f1.valid, f2.words, f2.valid,
                         f2.x, f2.y).index
    pair_matches = [to_numpy(matches_fn(kf_feats[a], kf_feats[a + 1]))
                    for a in range(c - 1)]

    # A track is a chain of consecutive matches starting at a kf0 slot: it
    # lives in keyframes 0..last-contiguous-match.
    valid0 = to_numpy(kf_feats[0].valid)
    n_slots = valid0.shape[0]
    cur = np.where(valid0)[0]            # track order = kf0 slot order
    T = len(cur)
    if T == 0:
        raise ValueError("no tracks with >= 2 observations")
    slots = np.full((c, T), -1, np.int64)
    slots[0] = cur
    alive = np.ones(T, bool)
    for a in range(c - 1):
        idx = pair_matches[a]
        nxt = np.where(alive, idx[np.clip(slots[a], 0, n_slots - 1)], -1)
        ok = nxt >= 0
        # first-wins on collisions: when several tracks match into the same
        # next-keyframe slot, only the first (in track order) keeps it
        first = np.zeros(T, bool)
        if ok.any():
            tgt = nxt[ok]
            _, first_idx = np.unique(tgt, return_index=True)
            keep = np.zeros(tgt.shape[0], bool)
            keep[first_idx] = True
            first[np.nonzero(ok)[0]] = keep
        alive = alive & first
        slots[a + 1] = np.where(alive, nxt, -1)

    nobs = (slots >= 0).sum(axis=0)      # contiguous run length from kf0
    xs = np.stack([np.stack([to_numpy(f.x), to_numpy(f.y)], -1)
                   for f in kf_feats])   # [c, n_slots, 2]
    Rs = np.stack([np.asarray(p[0]) for p in kf_poses])
    ts = np.stack([np.asarray(p[1]) for p in kf_poses])

    def dev_tensor(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    cand = np.nonzero(nobs >= 2)[0]
    if len(cand) == 0:
        raise ValueError("no tracks with >= 2 observations")
    # every >=2-observation track starts with keyframes (0, 1): one batched
    # triangulation against the relative pose 0 -> 1 seeds them all
    xa = normalize_points(dev_tensor(xs[0, slots[0, cand]]), fx, fy, cx, cy)
    xb = normalize_points(dev_tensor(xs[1, slots[1, cand]]), fx, fy, cx, cy)
    Rai_inv, tai_inv = se3_inverse(dev_tensor(Rs[0]), dev_tensor(ts[0]))
    Rab, tab = se3_compose(dev_tensor(Rs[1]), dev_tensor(ts[1]),
                           Rai_inv, tai_inv)
    Xa, z1, _ = triangulate(Rab, tab, xa, xb)
    good = to_numpy(z1) > 0
    kept = cand[good][:max_pts]
    P = len(kept)
    if P == 0:
        raise ValueError("no tracks with >= 2 observations")
    # to world coordinates: X_w = R_0^T (X_0 - t_0)
    X0 = (to_numpy(Xa)[good][:max_pts] - ts[0]) @ Rs[0]

    counts = nobs[kept]
    M = int(counts.sum())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rows = np.arange(M)
    cams = (rows - np.repeat(starts, counts)).astype(np.int32)
    pts = np.repeat(np.arange(P, dtype=np.int32), counts)
    slot_rows = slots[cams, np.repeat(kept, counts)]
    uvs = normalize_points(dev_tensor(xs[cams, slot_rows], torch.float32),
                           fx, fy, cx, cy)
    prob = BAProblem(cam=dev_tensor(cams), pt=dev_tensor(pts), uv=uvs,
                     w=torch.ones(M, dtype=torch.float32, device=dev))
    return (dev_tensor(Rs), dev_tensor(ts), dev_tensor(X0, torch.float32),
            prob)
