"""Full SLAM system: visual odometry, loop closure, pose-graph
optimisation and windowed bundle adjustment.

Port of ``akaze_tpu/slam/system.py`` (the TUM-RGBD-style configuration:
keyframe tracking with PGO and local BA, one device):

  frames -> VisualOdometry (AKAZE + RANSAC two-view pose)
         -> keyframe store with descriptor-based loop-closure proposals
         -> PoseGraph (odometry + loop edges) -> optimize_pose_graph
         -> build_local_ba + bundle_adjust on a keyframe window

Checkpoints use the JAX package's file format (``save``/``restore``): a
map saved by either package restores in the other.  The sharded solvers
of the JAX package (``mesh=``) wait for the port of ``parallel/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import AkazeConfig
from ..descriptor import words_to_numpy
from ..geometry import se3_compose, se3_inverse
from ..match import match
from ..pipeline import Features
from .ba import BAProblem, bundle_adjust
from .checkpoint import load_checkpoint, save_checkpoint
from .odometry import (Intrinsics, Keyframe, VisualOdometry, _two_view,
                       build_local_ba, to_numpy)
from .posegraph import PoseGraph, optimize_pose_graph


@dataclasses.dataclass
class SlamConfig:
    min_loop_gap: int = 5          # keyframes between loop candidates
    loop_min_matches: int = 40     # accepted matches to propose a loop
    loop_min_inliers: int = 30     # RANSAC inliers to accept a loop edge
    loop_weight: float = 1.0
    odom_weight: float = 1.0
    optimize_every: int = 4        # run PGO every N new keyframes
    loop_candidates: int = 4       # keyframes fully matched per new keyframe
    robust: str = "cauchy"         # PGO loss: "cauchy", "huber" or "none"
    robust_delta: float = 10.0     # robust threshold in residual medians
    max_loops_per_kf: int = 3      # accepted loop edges per new keyframe
    loop_dedup_gap: int = 0        # min keyframe distance between a new
    #                                keyframe's accepted loop partners
    local_ba_every: int = 0        # run windowed BA every N new keyframes
    #                                (0 = only on explicit calls)
    local_ba_window: int = 5       # keyframes per local BA window
    local_ba_points: int = 512     # landmark capacity per local BA


class KeyframeIndex:
    """Host-side loop-closure index over keyframe descriptor sets.

    A 512-lane bit-frequency signature per keyframe gives a cosine
    prefilter on the host; the top candidates are then matched on the
    device, one K4 launch per candidate, with the accepted counts fetched
    once for all of them.
    """

    def __init__(self):
        self._sigs: List[np.ndarray] = []    # [512] unit-norm bit freqs
        self._feats: List[Features] = []     # descriptor sets, on the device

    def __len__(self):
        return len(self._feats)

    @staticmethod
    def _signature(words: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """``words``: uint32 (the port's int32 words, viewed as uint32)."""
        bits = np.unpackbits(
            np.ascontiguousarray(words[valid]).view(np.uint8),
            axis=None).astype(np.float32)
        if valid.any():
            sig = bits.reshape(-1, 512).mean(axis=0)
        else:
            sig = np.zeros(512, np.float32)
        n = np.linalg.norm(sig)
        return sig / n if n > 0 else sig

    def add(self, feats: Features) -> None:
        self._sigs.append(self._signature(words_to_numpy(feats.words),
                                          to_numpy(feats.valid)))
        self._feats.append(feats)

    def candidates(self, query_idx: int, gap: int, top: int) -> np.ndarray:
        """Indices of the ``top`` most signature-similar keyframes at least
        ``gap`` behind ``query_idx`` (may return fewer)."""
        hi = query_idx - gap
        if hi <= 0:
            return np.empty(0, np.int64)
        sims = np.asarray(self._sigs[:hi]) @ self._sigs[query_idx]
        top = min(top, hi)
        cand = np.argpartition(-sims, top - 1)[:top]
        return cand[np.argsort(-sims[cand])]

    def match_counts(self, query_idx: int, cand: np.ndarray,
                     max_dist: int = 96) -> np.ndarray:
        """Accepted-match counts of the query against each candidate."""
        if len(cand) == 0:
            return np.empty(0, np.int64)
        q = self._feats[query_idx]
        counts = []
        for c in cand:
            f = self._feats[int(c)]
            zeros = torch.zeros_like(f.x)
            m = match(q.words, q.valid, f.words, f.valid, zeros, zeros,
                      max_dist)
            counts.append((m.index >= 0).sum())
        return to_numpy(torch.stack(counts).to(torch.int32))


def loop_edge_measurement(R_new, t_new, R_old, t_old, R_rel, t_dir,
                          scale=None):
    """Express a two-view loop-closure result in the pose-graph edge frame.

    The two-view solver returns (R_rel, t_dir) mapping new-camera points
    to the old camera: T_old = T_rel * T_new, t_dir unit-norm.  The
    pose-graph residual predicts T_ij = T_i^-1 * T_j, so for the edge
    (i=new, j=old) the measurement is M = T_new^-1 * T_rel * T_new.

    ``scale``: metric magnitude of the loop translation (the depth-ratio
    baseline, ``SlamSystem._loop_scale``).  When None, it falls back to
    |t_old - R_rel t_new| from the current (drifted) pose estimates.

    Returns (R_ij [3,3], t_ij [3]) float32 numpy arrays.
    """
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


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity >= n (>= minimum): pose-graph and BA
    tensors are padded to these capacities, as in the JAX package."""
    b = minimum
    while b < n:
        b *= 2
    return b


class SlamSystem:
    """Incremental SLAM over a frame stream.

    ``device``: the card by default (raises without one); ``"cpu"`` runs
    every kernel's plain version.  ``vo_kwargs`` go to VisualOdometry.
    """

    def __init__(self, intr: Intrinsics,
                 akaze_config: Optional[AkazeConfig] = None,
                 slam_config: Optional[SlamConfig] = None,
                 device="cuda", **vo_kwargs):
        self.cfg = slam_config or SlamConfig()
        self.vo = VisualOdometry(intr, akaze_config, device=device,
                                 **vo_kwargs)
        self.device = self.vo.device
        self.intr = intr
        # pose-graph edges between keyframes (indices into vo.keyframes)
        self.edges = []            # (i, j, R_ij np, t_ij np, weight)
        self.index = KeyframeIndex()
        self._n_kf_seen = 1
        self._since_opt = 0
        # opt-in host wall-time profile: a defaultdict(float) of seconds
        # per section
        self.prof = None

    @contextlib.contextmanager
    def _timed(self, section: str):
        if self.prof is None:
            yield
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.prof[section] += time.perf_counter() - t0

    @staticmethod
    def _relative(Ra, ta, Rb, tb):
        """T_a^-1 T_b of two host poses, in float32 on the host (two 3x3
        products: the JAX package computes them on its default device and
        fetches them back, which would only add two syncs here)."""
        Ri, ti = se3_inverse(torch.tensor(np.asarray(Ra, np.float32)),
                             torch.tensor(np.asarray(ta, np.float32)))
        R, t = se3_compose(Ri, ti, torch.tensor(np.asarray(Rb, np.float32)),
                           torch.tensor(np.asarray(tb, np.float32)))
        return R.numpy(), t.numpy()

    @staticmethod
    def _loop_scale(new, res, z1):
        """Metric magnitude of a loop translation from depth ratios, and
        its relative spread (MAD / median), or None when fewer than 8
        common slots survive.  ``z1``: the loop pair's depths in the new
        keyframe's camera at unit baseline; the keyframe's stored metric
        depths for the same slots give z_metric / z_unit = baseline."""
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

    def _loop_edge_weight(self, n_inl: int, scale_info) -> float:
        """Information weight of a loop edge: saturating in the RANSAC
        inlier count, discounted by the spread of the depth-ratio scale
        (and heavily when the scale fell back to the pose difference)."""
        w = self.cfg.loop_weight * min(
            1.0, n_inl / max(3.0 * self.cfg.loop_min_inliers, 1.0))
        if scale_info is None:
            return 0.3 * w
        _, spread = scale_info
        return w / (1.0 + 10.0 * spread)

    def _try_loop_closure(self, new_idx: int):
        """Propose loop candidates (signature prefilter, device match
        counts) and add loop edges where RANSAC agrees: best match count
        first, at most ``max_loops_per_kf`` per new keyframe, partners
        ``loop_dedup_gap`` keyframes apart."""
        kfs = self.vo.keyframes
        new = kfs[new_idx]
        cand = self.index.candidates(new_idx, self.cfg.min_loop_gap,
                                     self.cfg.loop_candidates)
        counts = self.index.match_counts(new_idx, cand)
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
            _, res, _, z1, _ = _two_view(
                self.vo._next_key(), new.features, old.features,
                self.intr.fx, self.intr.fy, self.intr.cx, self.intr.cy,
                self.vo.threshold, sampler=self.vo.sampler)
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

    def process(self, image) -> tuple:
        n_before = len(self.vo.keyframes)
        with self._timed("vo.process"):
            pose = self.vo.process(image)
        if len(self.vo.keyframes) > n_before:
            new_idx = len(self.vo.keyframes) - 1
            with self._timed("index.add"):
                self.index.add(self.vo.keyframes[new_idx].features)
            if n_before > 0:
                prev = self.vo.keyframes[new_idx - 1]
                new = self.vo.keyframes[new_idx]
                R_ij, t_ij = self._relative(prev.R, prev.t, new.R, new.t)
                self.edges.append((new_idx - 1, new_idx, R_ij, t_ij,
                                   self.cfg.odom_weight))
                with self._timed("loop_closure"):
                    self._try_loop_closure(new_idx)
                self._since_opt += 1
                if self._since_opt >= self.cfg.optimize_every:
                    with self._timed("pgo"):
                        self.optimize()
                    self._since_opt = 0
                if (self.cfg.local_ba_every
                        and (new_idx + 1) % self.cfg.local_ba_every == 0):
                    with self._timed("local_ba"):
                        self.local_bundle_adjust(
                            window=self.cfg.local_ba_window,
                            max_pts=self.cfg.local_ba_points)
        return pose

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def optimize(self, iters: int = 10):
        """Run PGO over the keyframe graph and write back keyframe poses.

        Poses and edges are padded to power-of-two capacity buckets
        (identity pads, gauge-fixed; weight-0 edges), as in the JAX
        package, so that the robust loss's masked median and the fixed
        masks see the same problem.  Returns the final cost."""
        kfs = self.vo.keyframes
        if len(kfs) < 2 or not self.edges:
            return
        K, E = len(kfs), len(self.edges)
        kcap = _bucket(K)
        ecap = _bucket(E)
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
        g = PoseGraph(i=self._tensor(ij[0]), j=self._tensor(ij[1]),
                      R_ij=self._tensor(Re), t_ij=self._tensor(te),
                      weight=self._tensor(w))
        # pads are gauge-fixed so their (unconstrained) updates stay zero
        fixed = np.zeros(kcap, bool)
        fixed[0] = True
        fixed[K:] = True
        R1, t1, cost = optimize_pose_graph(
            self._tensor(R0), self._tensor(t0), g, iters=iters,
            fixed_mask=self._tensor(fixed), robust=self.cfg.robust,
            robust_delta=self.cfg.robust_delta)
        R1 = to_numpy(R1)
        t1 = to_numpy(t1)
        for k in range(len(kfs)):
            kfs[k] = kfs[k]._replace(R=R1[k], t=t1[k])
        return float(cost)

    def local_bundle_adjust(self, window: int = 5, max_pts: int = 512,
                            iters: int = 6):
        """Refine the last ``window`` keyframes and their triangulated
        landmarks with the Schur-complement BA (the window's first keyframe
        fixed).  Returns the final cost, or None if the window has too few
        keyframes or tracks.  Cameras are padded to ``window``, landmarks
        and observations to power-of-two buckets (weight 0), as in the JAX
        package."""
        kfs = self.vo.keyframes
        if len(kfs) < 2:
            return None
        lo = max(0, len(kfs) - window)
        feats = [k.features for k in kfs[lo:]]
        poses = [(k.R, k.t) for k in kfs[lo:]]
        try:
            with self._timed("local_ba.build"):
                Rs, ts, X0, prob = build_local_ba(feats, poses, self.intr,
                                                  max_pts=max_pts)
        except ValueError:
            return None

        C = Rs.shape[0]
        ccap = max(window, C)
        Pn = X0.shape[0]
        pcap = min(_bucket(Pn), max(max_pts, Pn))
        M = prob.cam.shape[0]
        mcap = _bucket(M)
        Rp = np.tile(np.eye(3, dtype=np.float32), (ccap, 1, 1))
        tp = np.zeros((ccap, 3), np.float32)
        Rp[:C] = to_numpy(Rs)
        tp[:C] = to_numpy(ts)
        Xp = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (pcap, 1))
        Xp[:Pn] = to_numpy(X0)
        prob = BAProblem(
            cam=self._tensor(np.pad(to_numpy(prob.cam), (0, mcap - M))),
            pt=self._tensor(np.pad(to_numpy(prob.pt), (0, mcap - M))),
            uv=self._tensor(np.pad(to_numpy(prob.uv),
                                   ((0, mcap - M), (0, 0)))),
            w=self._tensor(np.pad(to_numpy(prob.w), (0, mcap - M))))
        fixed = np.zeros(ccap, bool)
        fixed[0] = True
        fixed[C:] = True
        R1, t1, _, cost = bundle_adjust(
            self._tensor(Rp), self._tensor(tp), self._tensor(Xp), prob,
            n_cams=ccap, n_pts=pcap, iters=iters,
            fixed_cam_mask=self._tensor(fixed))
        R1 = to_numpy(R1)
        t1 = to_numpy(t1)
        for o, k in enumerate(range(lo, len(kfs))):
            kfs[k] = kfs[k]._replace(R=R1[o], t=t1[o])
        return float(cost)

    @property
    def last_overflow(self) -> bool:
        """True when the last frame's detection dropped NMS survivors to a
        capacity cap (Features.overflow)."""
        return self.vo.last_overflow

    @property
    def overflow_frames(self):
        """Frame indices whose detection overflowed a capacity cap."""
        return self.vo.overflow_frames

    def keyframe_trajectory(self) -> np.ndarray:
        """[K, 3] keyframe camera centres."""
        out = [-(np.asarray(k.R).T @ np.asarray(k.t))
               for k in self.vo.keyframes]
        return np.stack(out) if out else np.zeros((0, 3), np.float32)

    # --- persistence -----------------------------------------------------

    _FEAT_FIELDS = ("x", "y", "size", "layer", "response", "angle",
                    "words", "valid", "count", "overflow")

    @staticmethod
    def _feat_numpy(feats: Features, f: str) -> np.ndarray:
        """A feature field as stored: words as uint32, as the JAX package
        stores them."""
        v = getattr(feats, f)
        return words_to_numpy(v) if f == "words" else to_numpy(v)

    def save(self, path: str):
        """Full map checkpoint, in the JAX package's format: keyframe poses,
        descriptor sets, the per-frame trajectory, pose-graph edges and the
        VO tracking state (its uint32[2] key included).  ``restore``
        rebuilds a fresh system from it, the loop-closure index included.
        Landmarks are derived state (local BA retriangulates its window), so
        no point cloud is stored."""
        kfs = self.vo.keyframes
        state = {
            "kf_R": (np.stack([k.R for k in kfs]) if kfs
                     else np.zeros((0, 3, 3), np.float32)),
            "kf_t": (np.stack([k.t for k in kfs]) if kfs
                     else np.zeros((0, 3), np.float32)),
            "kf_frame_idx": np.asarray([k.index for k in kfs], np.int32),
            "pose_R": (np.stack([p[0] for p in self.vo.poses])
                       if self.vo.poses
                       else np.zeros((0, 3, 3), np.float32)),
            "pose_t": (np.stack([p[1] for p in self.vo.poses])
                       if self.vo.poses
                       else np.zeros((0, 3), np.float32)),
            "edge_i": np.asarray([e[0] for e in self.edges], np.int32),
            "edge_j": np.asarray([e[1] for e in self.edges], np.int32),
            "edge_R": (np.stack([e[2] for e in self.edges])
                       if self.edges else np.zeros((0, 3, 3), np.float32)),
            "edge_t": (np.stack([e[3] for e in self.edges])
                       if self.edges else np.zeros((0, 3), np.float32)),
            "edge_w": np.asarray([e[4] for e in self.edges], np.float32),
            "vo_key": np.asarray(self.vo._key, np.uint32),
        }
        if kfs:
            # keyframe metric depths; keyframes without them carry
            # all-False validity
            nsl = kfs[0].features.x.shape[0]
            state["kf_z"] = np.stack(
                [k.z if k.z is not None else np.zeros(nsl, np.float32)
                 for k in kfs])
            state["kf_z_ok"] = np.stack(
                [k.z_ok if k.z_ok is not None else np.zeros(nsl, bool)
                 for k in kfs])
        for f in self._FEAT_FIELDS:
            state[f"feat_{f}"] = (
                np.stack([self._feat_numpy(k.features, f) for k in kfs])
                if kfs else np.zeros((0,), np.float32))
        meta = {
            "state_keys": sorted(state.keys()),
            "frame_idx": int(self.vo._frame_idx),
            "kf_inliers0": self.vo._kf_inliers0,
            "scale": float(self.vo._scale),
            "last_depth_med": self.vo._last_depth_med,
            "n_kf_seen": int(self._n_kf_seen),
            "since_opt": int(self._since_opt),
            "overflow_frames": [int(i) for i in self.vo.overflow_frames],
        }
        return save_checkpoint(path, state, metadata=meta)

    def _features(self, state, k: int) -> Features:
        """Keyframe ``k``'s features from checkpoint arrays, on the
        device (uint32 words viewed as the port's int32)."""
        out = {}
        for f in self._FEAT_FIELDS:
            key = f"feat_{f}"
            if key not in state:
                # feat_overflow is absent from checkpoints written before
                # the flag was stored
                out[f] = torch.zeros((), dtype=torch.bool,
                                     device=self.device)
                continue
            a = np.asarray(state[key][k])
            if f == "words":
                a = a.astype(np.uint32).view(np.int32)
            out[f] = self._tensor(a)
        return Features(**out)

    def restore(self, path: str):
        """Load a ``save`` checkpoint (written by either package) into this
        system, replacing its map: keyframes with features, trajectory,
        edges, VO tracking state and the loop-closure index (signatures
        recomputed)."""
        leaves, meta = load_checkpoint(path)
        state = self._checkpoint_state(leaves, meta)
        if "feat_x" not in state:
            raise ValueError(
                "checkpoint holds poses only (pre-full-map format: keys "
                f"{sorted(state)}); use restore_poses() for it")
        K = state["kf_R"].shape[0]

        self.vo.keyframes = []
        self.index = KeyframeIndex()
        for k in range(K):
            feats = self._features(state, k)
            kf = Keyframe(int(state["kf_frame_idx"][k]), feats,
                          np.asarray(state["kf_R"][k]),
                          np.asarray(state["kf_t"][k]),
                          z=(np.asarray(state["kf_z"][k])
                             if "kf_z" in state else None),
                          z_ok=(np.asarray(state["kf_z_ok"][k])
                                if "kf_z_ok" in state else None))
            self.vo.keyframes.append(kf)
            self.index.add(feats)
        self.vo.poses = [(state["pose_R"][i], state["pose_t"][i])
                         for i in range(state["pose_R"].shape[0])]
        self.edges = [(int(state["edge_i"][e]), int(state["edge_j"][e]),
                       state["edge_R"][e], state["edge_t"][e],
                       float(state["edge_w"][e]))
                      for e in range(state["edge_i"].shape[0])]
        self.vo._key = np.asarray(state["vo_key"], np.uint32)
        self.vo.overflow_frames = [int(i) for i
                                   in meta.get("overflow_frames", [])]
        self.vo._frame_idx = meta["frame_idx"]
        self.vo._kf_inliers0 = meta["kf_inliers0"]
        self.vo._scale = meta["scale"]
        self.vo._last_depth_med = meta["last_depth_med"]
        self._n_kf_seen = meta["n_kf_seen"]
        self._since_opt = meta["since_opt"]
        return meta

    @staticmethod
    def _checkpoint_state(leaves, meta):
        """Key the flat checkpoint leaves.  Full-map files carry their key
        list in the metadata; older files stored a plain {R, t, frame_idx}
        dict, whose leaves come in sorted-key order."""
        if "state_keys" in meta:
            return dict(zip(meta["state_keys"], leaves))
        old = dict(zip(("kf_R", "kf_frame_idx", "kf_t"), leaves))
        if (len(leaves) != 3 or old["kf_R"].ndim != 3
                or old["kf_t"].ndim != 2):
            raise ValueError("unrecognised checkpoint layout "
                             f"({len(leaves)} leaves, no state_keys)")
        return old

    def restore_poses(self, path: str):
        """Geometry-only restore: keyframe poses from a full (or old
        poses-only) checkpoint, into a system that already holds the same
        keyframes."""
        leaves, meta = load_checkpoint(path)
        state = self._checkpoint_state(leaves, meta)
        R = np.asarray(state["kf_R"])
        t = np.asarray(state["kf_t"])
        for k in range(len(self.vo.keyframes)):
            self.vo.keyframes[k] = self.vo.keyframes[k]._replace(
                R=R[k], t=t[k])
        return meta
