"""The comparison that decides ``correct``: the program's features and
matches against the reference's, on the same images.

Keypoints are paired per layer by mutual nearest position within
``PAIR_TOL`` px.  Four numbers come out, each the larger the worse:

* ``kp_unpaired``: keypoints of either side without a partner, over the
  reference's count (detection and the scale space's det planes, K1);
* ``response_err``: the largest gap of a paired keypoint's response, over
  the reference's largest (the det planes that K1 writes);
* ``bits_flipped``: descriptor bits that differ between paired keypoints,
  over all their bits (orientation and MLDB, K2);
* ``match_diff``: paired queries whose match differs (accepted on one
  side only, or to a train keypoint that is not the other side's), over
  the paired queries accepted on either side (K4 and acceptance).
"""

from __future__ import annotations

import torch

PAIR_TOL = 0.05          # px: a keypoint's partner lies this close
DESCRIPTOR_BITS = 486
NUMBERS = ("kp_unpaired", "response_err", "bits_flipped", "match_diff")


def live(f) -> dict:
    """The live prefix of a ``Features`` (either side's) as tensors."""
    n = int(f.count)
    return dict(x=f.x[:n], y=f.y[:n], layer=f.layer[:n],
                response=f.response[:n], words=f.words[:n], n=n)


def pair_keypoints(p: dict, r: dict, tol: float = PAIR_TOL):
    """(ip, ir): indices of paired keypoints of ``p`` and ``r``, each
    pair of one layer and each the other's nearest within ``tol``."""
    dev = r["x"].device
    ips, irs = [], []
    player = p["layer"].to(dev)
    pxy = torch.stack([p["x"], p["y"]], 1).to(dev, torch.float64)
    rxy = torch.stack([r["x"], r["y"]], 1).to(torch.float64)
    for layer in torch.unique(r["layer"]).tolist():
        jp = torch.nonzero(player == layer)[:, 0]
        jr = torch.nonzero(r["layer"] == layer)[:, 0]
        if not len(jp) or not len(jr):
            continue
        d = torch.cdist(pxy[jp], rxy[jr])
        near_r = d.argmin(1)                      # per program keypoint
        near_p = d.argmin(0)                      # per reference keypoint
        k = torch.arange(len(jp), device=dev)
        mutual = (near_p[near_r] == k) & (d[k, near_r] <= tol)
        ips.append(jp[mutual])
        irs.append(jr[near_r[mutual]])
    if not ips:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    return torch.cat(ips), torch.cat(irs)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per row of [N, 16] int32 words."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words[:, :, None] >> shifts) & 1).sum((1, 2))


def compare_image(p: dict, r: dict) -> tuple:
    """(numbers of one image, (ip, ir))."""
    ip, ir = pair_keypoints(p, r)
    unpaired = (p["n"] - len(ip)) + (r["n"] - len(ir))
    out = dict(kp_unpaired=unpaired / max(r["n"], 1))
    if len(ip):
        resp_p = p["response"].to(r["response"].device)[ip].double()
        resp_r = r["response"][ir].double()
        scale = r["response"].abs().max().double().clamp(min=1e-12)
        out["response_err"] = float((resp_p - resp_r).abs().max() / scale)
        diff = p["words"].to(r["words"].device)[ip] ^ r["words"][ir]
        out["bits_flipped"] = float(popcount(diff).sum()) / (
            len(ip) * DESCRIPTOR_BITS)
    else:
        out["response_err"] = out["bits_flipped"] = 1.0
    return out, (ip, ir)


def compare_matches(pm, rm, pairs_a, pairs_b, n_pb: int) -> float:
    """``match_diff`` of the program's matches ``pm`` against the
    reference's ``rm``, through the keypoint pairings of both images."""
    ip_a, ir_a = pairs_a
    ip_b, ir_b = pairs_b
    dev = ir_a.device
    to_ref = torch.full((max(n_pb, 1),), -2, dtype=torch.int64, device=dev)
    to_ref[ip_b] = ir_b
    p_idx = pm.index.to(dev)[ip_a].long()
    r_idx = rm.index[ir_a].long()
    p_acc, r_acc = p_idx >= 0, r_idx >= 0
    either = p_acc | r_acc
    mapped = torch.where(p_acc, to_ref[p_idx.clamp(min=0)],
                         torch.full_like(p_idx, -1))
    same = (p_acc & r_acc & (mapped == r_idx)) | ~either
    return float((~same).sum()) / max(int(either.sum()), 1)


def compare_pair(prog, ref) -> dict:
    """Numbers of one pair: ``prog`` and ``ref`` are (features a, features
    b, matches of a against b) of each side."""
    pa, pb, pm = prog
    ra, rb, rm = ref
    la, lb = live(pa), live(pb)
    na, pairs_a = compare_image(la, live(ra))
    nb, pairs_b = compare_image(lb, live(rb))
    out = {k: max(na[k], nb[k]) for k in na}
    out["match_diff"] = compare_matches(pm, rm, pairs_a, pairs_b, lb["n"])
    return out


def worst(readings: list) -> dict:
    """Each number's largest reading over several pairs; with no pair to
    compare, every number reads infinite (a run without answers is not
    correct)."""
    return {k: max((r[k] for r in readings), default=float("inf"))
            for k in NUMBERS}
