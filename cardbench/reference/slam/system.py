"""A frozen plain copy of the port's SLAM system: visual odometry (two-view
solve, scale propagation, keyframes), loop closure, pose-graph
optimisation and local bundle adjustment, over the reference AKAZE.

It replays a whole pass of frames on its own: its own features and
matches, its own minimal-set draws from the same key chain (the port's
``make_key``/``split_key``/``sets_from_key``), its own solver calls.  The
state machine is a copy of ``akaze_tpu_torch.slam.odometry`` and
``slam.system`` with the programs and kernels taken away.  ``lower``: a
floating type below float32; the scale space's planes are then made in
it, and the two-view, PGO and BA inputs and outputs rounded through it
(the control).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from .. import akaze as reference
from ..akaze.descriptor import words_to_numpy
from ..akaze.match import match
from .ba import BAProblem, bundle_adjust
from .epipolar import triangulate
from .posegraph import PoseGraph, optimize_pose_graph
from .ransac import (_ransac_essential, make_key, normalize_points,
                     sets_from_key, split_key)
from .se3 import se3_compose, se3_inverse


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float


@dataclasses.dataclass
class SlamConfig:
    min_loop_gap: int = 5
    loop_min_matches: int = 40
    loop_min_inliers: int = 30
    loop_weight: float = 1.0
    odom_weight: float = 1.0
    optimize_every: int = 4
    loop_candidates: int = 4
    robust: str = "cauchy"
    robust_delta: float = 10.0
    max_loops_per_kf: int = 3
    loop_dedup_gap: int = 0
    local_ba_every: int = 0
    local_ba_window: int = 5
    local_ba_points: int = 512


class Keyframe(NamedTuple):
    index: int
    features: reference.Features
    R: np.ndarray
    t: np.ndarray
    z: np.ndarray = None
    z_ok: np.ndarray = None


def to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def rounded(x, dtype):
    """Floating tensors (also inside tuples) rounded through ``dtype``."""
    if dtype is None:
        return x
    if isinstance(x, torch.Tensor):
        return x.to(dtype).to(x.dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        items = [rounded(v, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def traced(v, like):
    """A number as the port's compiled calls hand it to their function: a
    0-d tensor on ``like``'s device (on the card, dividing by one rounds
    otherwise than dividing by a Python number, which is multiplied by
    its reciprocal)."""
    return torch.full((), v, dtype=torch.as_tensor(v).dtype,
                      device=like.device)


def two_view(key, f1, f2, intr, threshold, num_hyps=512, lower=None):
    """Match, RANSAC essential on the key's draw and triangulation:
    (m, res, X1, z1, z2), as the port's ``odometry._two_view``."""
    m = match(f1.words, f1.valid, f2.words, f2.valid, f2.x, f2.y)
    k = [traced(v, f1.x) for v in (intr.fx, intr.fy, intr.cx, intr.cy)]
    x1 = normalize_points(torch.stack([f1.x, f1.y], -1), *k)
    x2 = normalize_points(torch.stack([m.match_x, m.match_y], -1), *k)
    putative = (m.index >= 0) & f1.valid
    sets = sets_from_key(key, putative, num_hyps)
    x1, x2 = rounded(x1, lower), rounded(x2, lower)
    res = _ransac_essential(x1, x2, putative,
                            sets.to(device=x1.device, dtype=torch.int64),
                            traced(threshold, x1), num_hyps=num_hyps)
    res = rounded(res, lower)
    X1, z1, z2 = rounded(triangulate(res.R, res.t, x1, x2), lower)
    return m, res, X1, z1, z2


class Odometry:
    """``VisualOdometry.process`` on the reference's features."""

    def __init__(self, intr, plan, ransac_threshold=2e-5, min_inliers=30,
                 keyframe_inlier_ratio=0.6, seed=0, local_ba_window=5,
                 lower=None):
        self.intr, self.plan, self.lower = intr, plan, lower
        self.threshold = ransac_threshold
        self.min_inliers = min_inliers
        self.kf_ratio = keyframe_inlier_ratio
        self._key = make_key(seed)
        self.keyframes: List[Keyframe] = []
        self.poses = []
        self.features = []
        self._frame_idx = 0
        self._kf_inliers0 = None
        self._scale = 1.0
        self._last_depth_med = None
        self._last_z = None
        self._last_z_ok = None

    def next_key(self):
        self._key, sub = split_key(self._key)
        return sub

    def detect(self, image):
        with (reference.planes_in(self.lower) if self.lower
              else contextlib.nullcontext()):
            return reference.detect_and_compute_batch(image[None],
                                                      self.plan)[0]

    def process(self, image):
        feats = self.detect(image)
        self.features.append(feats)
        intr = self.intr
        if not self.keyframes:
            R = np.eye(3, dtype=np.float32)
            t = np.zeros(3, np.float32)
            self.keyframes.append(Keyframe(self._frame_idx, feats, R, t))
            self.poses.append((R, t))
            self._frame_idx += 1
            return R, t

        kf = self.keyframes[-1]
        m, res, X1, z1, z2 = two_view(self.next_key(), kf.features, feats,
                                      intr, self.threshold,
                                      lower=self.lower)
        n_inl = int(res.num_inliers)
        inl = to_numpy(res.inliers)

        if n_inl < self.min_inliers:
            R, t = self.poses[-1]
            self.poses.append((R, t))
            self.keyframes.append(Keyframe(self._frame_idx, feats,
                                           np.asarray(R), np.asarray(t)))
            self._kf_inliers0 = None
            self._last_depth_med = None
            self._last_z = None
            self._frame_idx += 1
            return R, t

        z_all = to_numpy(z1)
        ok = inl & (z_all > 0)
        z = z_all[inl]
        depth_med = float(np.median(z[z > 0])) if (z > 0).any() else None
        scale = self._scale
        kf_common = (ok & kf.z_ok) if kf.z is not None else np.zeros(0)
        if kf.z is not None and kf_common.sum() >= 8:
            scale = float(np.median(kf.z[kf_common] / z_all[kf_common]))
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
            scale = self._scale * self._last_depth_med / max(depth_med, 1e-6)
            scale = float(np.clip(scale, 0.1 * self._scale,
                                  10.0 * self._scale))
        self._last_z = z_all * scale
        self._last_z_ok = ok

        R_rel = to_numpy(res.R)
        t_rel = to_numpy(res.t) * scale
        R = R_rel @ kf.R
        t = R_rel @ kf.t + t_rel
        self.poses.append((R.astype(np.float32), t.astype(np.float32)))

        if self._kf_inliers0 is None:
            self._kf_inliers0 = max(n_inl, 1)
        if n_inl < self.kf_ratio * self._kf_inliers0:
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
            self._scale = scale
            self._last_depth_med = depth_med
        self._frame_idx += 1
        return self.poses[-1]


def signature(words: np.ndarray, valid: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(np.ascontiguousarray(words[valid]).view(np.uint8),
                         axis=None).astype(np.float32)
    sig = bits.reshape(-1, 512).mean(axis=0) if valid.any() else \
        np.zeros(512, np.float32)
    n = np.linalg.norm(sig)
    return sig / n if n > 0 else sig


def loop_edge_measurement(R_new, t_new, R_old, t_old, R_rel, t_dir,
                          scale=None):
    R_rel = np.asarray(R_rel, np.float64)
    t_dir = np.asarray(t_dir, np.float64)
    Rn = np.asarray(R_new, np.float64)
    t_new = np.asarray(t_new, np.float64)
    t_old = np.asarray(t_old, np.float64)
    if scale is None:
        scale = float(np.linalg.norm(t_old - R_rel @ t_new))
    t_rel = t_dir * scale
    R_ij = (Rn.T @ R_rel @ Rn).astype(np.float32)
    t_ij = (Rn.T @ (R_rel @ t_new + t_rel - t_new)).astype(np.float32)
    return R_ij, t_ij


def bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def build_local_ba(kf_feats, kf_poses, intr, max_pts: int):
    """The port's ``odometry.build_local_ba``: tracks chained through
    consecutive matches, seeded by triangulating their first two
    observations."""
    c = len(kf_feats)
    if c < 2:
        raise ValueError("a local BA window needs two keyframes")
    fx, fy, cx, cy = intr.fx, intr.fy, intr.cx, intr.cy
    dev = kf_feats[0].x.device
    pair_matches = [to_numpy(match(f1.words, f1.valid, f2.words, f2.valid,
                                   f2.x, f2.y).index)
                    for f1, f2 in zip(kf_feats[:-1], kf_feats[1:])]
    valid0 = to_numpy(kf_feats[0].valid)
    n_slots = valid0.shape[0]
    cur = np.where(valid0)[0]
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
        first = np.zeros(T, bool)
        if ok.any():
            tgt = nxt[ok]
            _, first_idx = np.unique(tgt, return_index=True)
            keep = np.zeros(tgt.shape[0], bool)
            keep[first_idx] = True
            first[np.nonzero(ok)[0]] = keep
        alive = alive & first
        slots[a + 1] = np.where(alive, nxt, -1)

    nobs = (slots >= 0).sum(axis=0)
    xs = np.stack([np.stack([to_numpy(f.x), to_numpy(f.y)], -1)
                   for f in kf_feats])
    Rs = np.stack([np.asarray(p[0]) for p in kf_poses])
    ts = np.stack([np.asarray(p[1]) for p in kf_poses])

    def dev_tensor(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    cand = np.nonzero(nobs >= 2)[0]
    if len(cand) == 0:
        raise ValueError("no tracks with >= 2 observations")
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


class System:
    """``SlamSystem.process`` over ``Odometry``: keyframe edges, loop
    closure, PGO every ``optimize_every`` keyframes, local BA every
    ``local_ba_every``."""

    def __init__(self, intr, plan, cfg: SlamConfig, lower=None,
                 **vo_kwargs):
        self.cfg, self.intr, self.lower = cfg, intr, lower
        self.vo = Odometry(intr, plan, lower=lower, **vo_kwargs)
        self.edges = []
        self.sigs = []
        self._since_opt = 0

    def _tensor(self, a, dtype=None):
        dev = self.vo.keyframes[0].features.x.device
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    @staticmethod
    def _relative(Ra, ta, Rb, tb):
        Ri, ti = se3_inverse(torch.tensor(np.asarray(Ra, np.float32)),
                             torch.tensor(np.asarray(ta, np.float32)))
        R, t = se3_compose(Ri, ti, torch.tensor(np.asarray(Rb, np.float32)),
                           torch.tensor(np.asarray(tb, np.float32)))
        return R.numpy(), t.numpy()

    @staticmethod
    def _loop_scale(new, res, z1):
        if new.z is None:
            return None
        z1 = to_numpy(z1)
        common = (to_numpy(res.inliers) & new.z_ok & (z1 > 0)
                  & (new.z > 0))
        if common.sum() < 8:
            return None
        ratios = new.z[common] / z1[common]
        med = float(np.median(ratios))
        spread = float(np.median(np.abs(ratios - med))) / max(med, 1e-9)
        return med, spread

    def _loop_edge_weight(self, n_inl, scale_info) -> float:
        w = self.cfg.loop_weight * min(
            1.0, n_inl / max(3.0 * self.cfg.loop_min_inliers, 1.0))
        if scale_info is None:
            return 0.3 * w
        _, spread = scale_info
        return w / (1.0 + 10.0 * spread)

    def _candidates(self, query_idx, gap, top):
        hi = query_idx - gap
        if hi <= 0:
            return np.empty(0, np.int64)
        sims = np.asarray(self.sigs[:hi]) @ self.sigs[query_idx]
        top = min(top, hi)
        cand = np.argpartition(-sims, top - 1)[:top]
        return cand[np.argsort(-sims[cand])]

    def _match_counts(self, query_idx, cand):
        if len(cand) == 0:
            return np.empty(0, np.int64)
        q = self.vo.keyframes[query_idx].features
        counts = []
        for c in cand:
            f = self.vo.keyframes[int(c)].features
            zeros = torch.zeros(f.words.shape[0], dtype=torch.float32,
                                device=f.words.device)
            counts.append((match(q.words, q.valid, f.words, f.valid, zeros,
                                 zeros).index >= 0).sum())
        return to_numpy(torch.stack(counts).to(torch.int32))

    def _try_loop_closure(self, new_idx):
        kfs = self.vo.keyframes
        new = kfs[new_idx]
        cand = self._candidates(new_idx, self.cfg.min_loop_gap,
                                self.cfg.loop_candidates)
        counts = self._match_counts(new_idx, cand)
        order = np.argsort(-counts) if len(cand) else []
        accepted = []
        for k in order:
            old_idx, n_acc = int(cand[k]), int(counts[k])
            if n_acc < self.cfg.loop_min_matches:
                continue
            if len(accepted) >= self.cfg.max_loops_per_kf:
                break
            if any(abs(old_idx - a) < self.cfg.loop_dedup_gap
                   for a in accepted):
                continue
            old = kfs[old_idx]
            _, res, _, z1, _ = two_view(self.vo.next_key(), new.features,
                                        old.features, self.intr,
                                        self.vo.threshold, lower=self.lower)
            n_inl = int(res.num_inliers)
            if n_inl < self.cfg.loop_min_inliers:
                continue
            scale_info = self._loop_scale(new, res, z1)
            R_ij, t_ij = loop_edge_measurement(
                new.R, new.t, old.R, old.t, to_numpy(res.R),
                to_numpy(res.t),
                scale=scale_info[0] if scale_info else None)
            self.edges.append((int(new_idx), old_idx, R_ij, t_ij,
                               self._loop_edge_weight(n_inl, scale_info)))
            accepted.append(old_idx)

    def process(self, image):
        n_before = len(self.vo.keyframes)
        pose = self.vo.process(image)
        if len(self.vo.keyframes) > n_before:
            new_idx = len(self.vo.keyframes) - 1
            f = self.vo.keyframes[new_idx].features
            self.sigs.append(signature(words_to_numpy(f.words),
                                       to_numpy(f.valid)))
            if n_before > 0:
                prev = self.vo.keyframes[new_idx - 1]
                new = self.vo.keyframes[new_idx]
                R_ij, t_ij = self._relative(prev.R, prev.t, new.R, new.t)
                self.edges.append((new_idx - 1, new_idx, R_ij, t_ij,
                                   self.cfg.odom_weight))
                self._try_loop_closure(new_idx)
                self._since_opt += 1
                if self._since_opt >= self.cfg.optimize_every:
                    self.optimize()
                    self._since_opt = 0
                if (self.cfg.local_ba_every
                        and (new_idx + 1) % self.cfg.local_ba_every == 0):
                    self.local_bundle_adjust(
                        window=self.cfg.local_ba_window,
                        max_pts=self.cfg.local_ba_points)
        return pose

    def optimize(self, iters: int = 10):
        kfs = self.vo.keyframes
        if len(kfs) < 2 or not self.edges:
            return
        K, E = len(kfs), len(self.edges)
        kcap, ecap = bucket(K), bucket(E)
        R0 = np.tile(np.eye(3, dtype=np.float32), (kcap, 1, 1))
        t0 = np.zeros((kcap, 3), np.float32)
        R0[:K] = np.stack([k.R for k in kfs])
        t0[:K] = np.stack([k.t for k in kfs])
        Re = np.tile(np.eye(3, dtype=np.float32), (ecap, 1, 1))
        te = np.zeros((ecap, 3), np.float32)
        ij = np.zeros((2, ecap), np.int32)
        w = np.zeros(ecap, np.float32)
        for e, (i, j, R_ij, t_ij, wt) in enumerate(self.edges):
            ij[0, e], ij[1, e] = i, j
            Re[e], te[e], w[e] = R_ij, t_ij, wt
        lower = self.lower
        g = PoseGraph(i=self._tensor(ij[0]), j=self._tensor(ij[1]),
                      R_ij=rounded(self._tensor(Re), lower),
                      t_ij=rounded(self._tensor(te), lower),
                      weight=self._tensor(w))
        fixed = np.zeros(kcap, bool)
        fixed[0] = True
        fixed[K:] = True
        R1, t1, _ = rounded(optimize_pose_graph(
            rounded(self._tensor(R0), lower), rounded(self._tensor(t0), lower),
            g, iters=iters, fixed_mask=self._tensor(fixed),
            robust=self.cfg.robust, robust_delta=self.cfg.robust_delta),
            lower)
        R1, t1 = to_numpy(R1), to_numpy(t1)
        for k in range(len(kfs)):
            kfs[k] = kfs[k]._replace(R=R1[k], t=t1[k])

    def local_bundle_adjust(self, window: int = 5, max_pts: int = 512,
                            iters: int = 6):
        kfs = self.vo.keyframes
        if len(kfs) < 2:
            return
        lo = max(0, len(kfs) - window)
        feats = [k.features for k in kfs[lo:]]
        poses = [(k.R, k.t) for k in kfs[lo:]]
        try:
            Rs, ts, X0, prob = build_local_ba(feats, poses, self.intr,
                                              max_pts=max_pts)
        except ValueError:
            return
        C = Rs.shape[0]
        ccap = max(window, C)
        Pn = X0.shape[0]
        pcap = min(bucket(Pn), max(max_pts, Pn))
        M = prob.cam.shape[0]
        mcap = bucket(M)
        Rp = np.tile(np.eye(3, dtype=np.float32), (ccap, 1, 1))
        tp = np.zeros((ccap, 3), np.float32)
        Rp[:C] = to_numpy(Rs)
        tp[:C] = to_numpy(ts)
        Xp = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (pcap, 1))
        Xp[:Pn] = to_numpy(X0)
        lower = self.lower
        prob = BAProblem(
            cam=self._tensor(np.pad(to_numpy(prob.cam), (0, mcap - M))),
            pt=self._tensor(np.pad(to_numpy(prob.pt), (0, mcap - M))),
            uv=rounded(self._tensor(np.pad(to_numpy(prob.uv),
                                           ((0, mcap - M), (0, 0)))), lower),
            w=self._tensor(np.pad(to_numpy(prob.w), (0, mcap - M))))
        fixed = np.zeros(ccap, bool)
        fixed[0] = True
        fixed[C:] = True
        R1, t1, _, _ = rounded(bundle_adjust(
            rounded(self._tensor(Rp), lower), rounded(self._tensor(tp), lower),
            rounded(self._tensor(Xp), lower), prob, n_cams=ccap, n_pts=pcap,
            iters=iters, fixed_cam_mask=self._tensor(fixed)), lower)
        R1, t1 = to_numpy(R1), to_numpy(t1)
        for o, k in enumerate(range(lo, len(kfs))):
            kfs[k] = kfs[k]._replace(R=R1[o], t=t1[o])
