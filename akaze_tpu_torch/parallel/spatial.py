"""Row-sharded scale space, detection and description with halo exchange.

Port of ``akaze_tpu/parallel/spatial.py``, the tier for images too large
for one device: each image is split by ROWS over a mesh axis and the whole
front end runs on the row blocks, each stencil's ghost rows exchanged
with the neighbouring shards (``collectives.extend_rows``, neighbour-only
traffic); only the keypoints are gathered at the end.

Exactness.  Every stencil pads reflect-101.  Extending a block by ``r``
genuine neighbour rows (reflect-101 of the block itself at the global
edges) and keeping the middle rows reproduces the unsharded op value for
value: interior shards see genuine data for the whole footprint, edge
shards exactly the rows the reflect pad would synthesise.  The invariants
the JAX package states hold here too:

* every extension covers its consumer's FULL stencil reach, so kept rows
  never read a pad made at a block's edge on an interior shard;
* per-octave local row counts stay even, so decimation keeps whole source
  row pairs (its 4 ghost source rows give 2 cropped destination rows),
  and keypoint rows shift into a shard's frame by exact octave-grid
  multiples (``row0 >> o << o == row0``);
* the contrast percentile is the one global quantity of the scale space:
  its maximum and its 9 bisection counts are reduced over the shards, with
  the GLOBAL pixel count.

How a sublevel runs on a shard follows the tensor's device, as every
kernel wrapper does:

* on the card, K1's tiled kernel (``ops.sublevel.sublevel``) runs on the
  block extended by the sublevel's whole reach (``halo_for``); where
  ``chain_launches`` splits the FED chain, the successive launches run on
  that one extended block, and each launch's own reflect pad at the
  block's edge reaches only rows that are cropped.  The tiled kernel
  computes every output row from the source rows within its reach, so a
  shard's kept rows equal the unsharded launch's bit for bit;
* on the CPU, the plain version: the ported ops one by one, each with its
  own exchange, derivatives and Hessian in TWO rounds (Ly is
  antisymmetric under row reflection, so one wider exchange would flip
  its sign in the global border band), as the JAX package's op path.

Gathered octaves.  An octave whose tiled reach exceeds the local rows
(``h_loc - 1``), or which the unsharded scale space runs on the
octave-resident kernel (``ops.sublevel.routes_resident``: at most 40,000
pixels), gathers its source rows whole and runs the unsharded octave
(``ops.sublevel.octave``: the resident kernel, or the tiled one, by its
own rule) on every shard, each keeping its rows.  Such planes are small,
and the result is the unsharded octave exactly, border rows included.
``spatial_route`` is the rule, computed from (plan, number of shards)
alone, and ``spatial_launches`` the K1 launches it predicts per shard.

Detection reads one MIN-filled ghost row of each det stack (extrema),
``max_nms_radius`` rows of the response map (NMS) and the same halo-1
det stacks (refinement).  Description runs K2 per shard on its
``WSIZE/2``-extended plane stack (zero fill at the global edges; octaves
too thin for that halo are gathered whole), with the per-octave row
offset applied in the integer domain (``descriptor.slot_params``).  The
keypoints are all-gathered in mesh order, which is global row-major
order, and compacted to the valid prefix the matcher expects.
"""

from __future__ import annotations

from functools import lru_cache
from math import prod
from typing import List, Tuple

import torch

from ..config import DESCRIPTOR_WORDS
from ..descriptor import WSIZE, orient_describe_multi, plane_dtype
from ..detect import (FMIN_VAL, IMIN_VAL, Keypoints, build_extrema_maps,
                      build_padded_pyramid, nms, refine_keypoints,
                      select_keypoints, size_table_for)
from ..ops.contrast import (bisect_bin, contrast_bins, contrast_floor,
                            contrast_from_bin)
from ..ops.conv import (down_with_smooth, down_with_smooth_fixed,
                        gauss_half_kernel, gauss_half_kernel_fixed,
                        lowpass, lowpass_fixed, sep_conv2d, sep_conv2d_fixed)
from ..ops.diffusion import (conductivity_fixed_ikc, conductivity_ikc,
                             inverse_square, nld_step, nld_step_fixed)
from ..ops.scharr import (hessian_determinant, hessian_determinant_fixed,
                          scaled_derivatives, scaled_derivatives_fixed,
                          scharr_magnitude, scharr_magnitude_fixed)
from ..ops.sublevel import (halo_for, octave, octave_launches, octave_specs,
                            routes_resident, sublevel, chain_launches)
from ..plan import PipelinePlan
from ..scale_space import OctaveData, base_smooth
from . import collectives as col
from .mesh import Mesh
from .sharded_match import prefix_rows

# ---------------------------------------------------------------------------
# the rules: which shapes shard, and how each octave runs
# ---------------------------------------------------------------------------


def _octave_radii(plan: PipelinePlan, oi: int) -> List[int]:
    """Every row-halo radius the op path needs at octave ``oi``."""
    radii = []
    if oi == 0:
        # pre-smooth, Scharr, base
        radii += [2, 1, base_smooth(plan.config)[1]]
    else:
        radii.append(4)                            # down_with_smooth taps
    for sp in plan.octaves[oi].scales:
        radii += [2, 1, len(sp.taus), sp.sigma_size]
    return radii


def spatial_supported(plan: PipelinePlan, n_dev: int, detect: bool = False,
                      describe: bool = False) -> Tuple[bool, str]:
    """Whether every octave keeps whole, large-enough row blocks per shard
    (the JAX package's rule, so that both accept and refuse the same
    shapes).

    Each halo of radius r needs r rows from ONE neighbour (and reflect-101
    needs r <= h_local - 1); decimation needs the local row count even so
    that each shard keeps whole source row pairs.  ``detect`` adds the NMS
    radius (full-resolution rows).  ``describe`` adds no constraint: deep
    octaves too thin for the WSIZE/2 window halo are gathered whole."""
    for oi, op in enumerate(plan.octaves):
        if op.height % n_dev:
            return False, (f"octave {oi} height {op.height} not divisible "
                           f"by {n_dev} devices")
        h_loc = op.height // n_dev
        if oi + 1 < len(plan.octaves) and h_loc % 2:
            return False, (f"octave {oi} local rows {h_loc} odd — cannot "
                           "decimate whole row pairs per device")
        radii = _octave_radii(plan, oi)
        if detect:
            radii.append(1)                      # extrema / refine halos
            if oi == 0:
                radii.append(plan.max_nms_radius)
        r = max(radii)
        if r > h_loc - 1:
            return False, (f"octave {oi} needs halo {r} > local rows "
                           f"{h_loc} - 1; use fewer devices or a larger "
                           "image")
    return True, ""


def _base(plan: PipelinePlan, oi: int):
    """The first octave's base smooth (``base_smooth``), else None."""
    return None if oi else base_smooth(plan.config)


@lru_cache(maxsize=None)
def spatial_route(plan: PipelinePlan, n_dev: int) -> Tuple[bool, ...]:
    """Per octave: True when it is gathered whole (its tiled reach exceeds
    the local rows, or the unsharded scale space runs it on the
    octave-resident kernel), False when it runs sharded."""
    route = []
    for oi, op in enumerate(plan.octaves):
        base = _base(plan, oi)
        h_loc = op.height // n_dev
        reach = max(halo_for(sp.step, len(sp.taus), sp.smooth_radius)
                    for sp in octave_specs(op, base))
        route.append(n_dev > 1 and (routes_resident(op, base)
                                    or reach > h_loc - 1))
    return tuple(route)


@lru_cache(maxsize=None)
def spatial_launches(plan: PipelinePlan, n_dev: int) -> dict:
    """K1 launches on each shard of one image's spatial scale space on the
    card: {"tiled": n, "resident": n}.  A gathered octave launches what
    the unsharded octave launches; a sharded one its sublevels' tiled
    launches (``chain_launches``)."""
    out = {"tiled": 0, "resident": 0}
    for oi, (op, gathered) in enumerate(zip(plan.octaves,
                                            spatial_route(plan, n_dev))):
        base = _base(plan, oi)
        if gathered and routes_resident(op, base):
            out["resident"] += 1
        elif gathered:
            out["tiled"] += octave_launches(op, base)
        else:
            out["tiled"] += sum(len(chain_launches(sp.taus, sp.step,
                                                   sp.smooth_radius))
                                for sp in octave_specs(op, base))
    return out


def spatial_exchange_bytes(plan: PipelinePlan, n_dev: int,
                           describe: bool = True,
                           kernels: bool = True) -> int:
    """Bytes that one image's ``spatial_detect_and_compute`` moves from
    shard to shard, from (plan, number of shards) alone: the global
    image's row split (``collectives.shard``), every ghost row that a
    neighbour sends (``extend_rows``: 2 (n - 1) seams of ``r`` rows; the
    reflect or fill rows at the global edges are each shard's own), each
    gathered block (``all_gather``: the n - 1 other blocks to every shard,
    or to the home shard alone for the features), and nothing of the
    contrast's scalar reductions.  ``kernels``: the card's sublevels (one
    exchange of each sublevel's whole reach), else the plain version's
    op-by-op exchanges (the CPU).  Raises where ``spatial_supported``
    refuses the shape."""
    ok, why = spatial_supported(plan, n_dev, detect=True, describe=describe)
    if not ok:
        raise ValueError(f"spatial sharding unsupported: {why}")
    n, word = n_dev, 4                    # float32 or int32 planes,
                                          # on either path
    seams = 2 * (n - 1)

    def rows(r, *shape):                  # extend_rows of [..., h, w]
        return seams * r * word * prod(shape)

    def gathered(*shape, home=False):     # all_gather of per-shard blocks
        return (n - 1) * (1 if home else n) * word * prod(shape)

    h, w = plan.height // n, plan.width
    total = (n - 1) * h * w * word + rows(2, w) + rows(1, w)
    prev = (h, w)
    for oi, (op, whole) in enumerate(zip(plan.octaves,
                                         spatial_route(plan, n))):
        h_o, w_o = op.height // n, op.width
        if whole:
            total += gathered(*prev)
        else:
            if oi:
                total += rows(4, prev[1])         # decimation's 4 source rows
            for s_i, sp in enumerate(octave_specs(op, _base(plan, oi))):
                smooth_given = oi > 0 and s_i == 0
                if kernels:
                    r = halo_for(sp.step, len(sp.taus), sp.smooth_radius)
                    total += rows(r, w_o) * (2 if smooth_given else 1)
                    continue
                if not smooth_given:
                    total += rows(sp.smooth_radius, w_o)
                if sp.taus:                       # flow, then the FED chain
                    total += rows(1, w_o) + 2 * rows(len(sp.taus), w_o)
                total += 3 * rows(sp.step, w_o)   # smooth, then lx and ly
        prev = (h_o, w_o)
    scales = [len(op.scales) for op in plan.octaves]
    for op, s in zip(plan.octaves, scales):       # extrema's halo-1 det
        total += rows(1, s, op.width)
    total += rows(plan.max_nms_radius, w)         # NMS's response rows
    if describe:
        hd = WSIZE // 2
        for op, s in zip(plan.octaves, scales):   # L, lx, ly
            h_o = op.height // n
            total += 3 * (gathered(s, h_o, op.width) if h_o - 1 < hd
                          else rows(hd, s, op.width))
    m = plan.config.max_pts                       # the features to home
    total += gathered(m * (6 + DESCRIPTOR_WORDS), home=True)
    total += (n - 1) * (m + 1)                    # valid and overflow, bool
    return total


# ---------------------------------------------------------------------------
# the scale space on row shards
# ---------------------------------------------------------------------------

class _Shards:
    """The row blocks of one image over ``mesh[axis]``."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.shape[axis]
        self.index = [c[axis] for c in mesh.coords()]
        self.devices = mesh.local_devices

    def extend(self, xs, r: int, dim: int = 0, edge="reflect"):
        return col.extend_rows(xs, self.mesh, self.axis, r, dim, edge)

    def stencil(self, op, xs, r: int):
        """A same-shape row stencil of radius ``r`` across the seams."""
        if r == 0:
            return [op(x) for x in xs]
        return [op(e)[r:r + x.shape[0]]
                for e, x in zip(self.extend(xs, r), xs)]

    def gather(self, xs, dim: int = 0):
        return col.all_gather(xs, self.mesh, self.axis, dim)


def _percentile_global(mags, per: float, npix: int, fixed: bool,
                       sh: _Shards):
    """``ops.contrast``'s percentile over the row shards of one magnitude
    plane: the maximum and the bisection's counts reduced over the mesh,
    the threshold from the GLOBAL pixel count."""
    mesh, axis = sh.mesh, sh.axis
    max_contrast = torch.clamp(
        col.pmax_home([m.amax() for m in mags], mesh, axis),
        min=contrast_floor(fixed))
    binned = [contrast_bins(m, max_contrast.to(m.device), fixed)
              for m in mags]
    bins = [b for b, _ in binned]

    def count(pred):
        return col.psum_home([pred(b).sum(dtype=torch.int32) for b in bins],
                             mesh, axis)

    hist0 = count(lambda b: b == 0)
    k = bisect_bin(lambda mid: count(lambda b: b <= mid.to(b.device)),
                   hist0, npix, per)
    return contrast_from_bin(k, max_contrast, binned[0][1].to(k.device),
                             fixed)


def _sublevel_kernel(sh: _Shards, srcs, smooths, ikc, sp, diffusivity,
                     fixed: bool):
    """One sublevel per shard on K1's tiled kernel, on the block extended
    by the sublevel's whole reach."""
    r = halo_for(sp.step, len(sp.taus), sp.smooth_radius)
    src_e = sh.extend(srcs, r)
    sm_e = (sh.extend(smooths, r) if smooths is not None
            else [None] * len(srcs))
    out = []
    for x, e, s in zip(srcs, src_e, sm_e):
        planes = sublevel(e[None], ikc.to(e.device).reshape(1), sp.taus,
                          sp.step, smooth=None if s is None else s[None],
                          smooth_var=sp.smooth_var,
                          smooth_radius=sp.smooth_radius,
                          first_sublevel=sp.first_sublevel,
                          diffusivity=diffusivity, fixed=fixed)
        out.append(tuple(p[0, r:r + x.shape[0]] for p in planes))
    return out


def _sublevel_plain(sh: _Shards, srcs, smooths, ikc, sp, diffusivity,
                    fixed: bool):
    """The plain version of ``_sublevel_kernel``: ``sublevel_plain``'s ops
    one by one, each with its own exchange (derivatives and Hessian in two
    rounds)."""
    conv = sep_conv2d_fixed if fixed else sep_conv2d
    taps = (gauss_half_kernel_fixed if fixed else gauss_half_kernel)(
        sp.smooth_var, sp.smooth_radius)
    cond = conductivity_fixed_ikc if fixed else conductivity_ikc
    step_fn = nld_step_fixed if fixed else nld_step
    deriv = scaled_derivatives_fixed if fixed else scaled_derivatives
    hess = hessian_determinant_fixed if fixed else hessian_determinant
    if smooths is None:
        smooths = sh.stencil(lambda a: conv(a, taps), srcs, sp.smooth_radius)
    if sp.taus:
        flows = sh.stencil(
            lambda s: cond(s, diffusivity, ikc.to(s.device)), smooths, 1)
        T = len(sp.taus)
        Ls = []
        for L, f, x in zip(sh.extend(srcs, T), sh.extend(flows, T), srcs):
            for tau in sp.taus:
                L = step_fn(L, f, tau)
            Ls.append(L[T:T + x.shape[0]])
    else:
        Ls = smooths if sp.first_sublevel else srcs
    ss = sp.step
    lxy = [deriv(e, ss) for e in sh.extend(smooths, ss)]
    lx = [a[ss:ss + x.shape[0]] for (a, _), x in zip(lxy, srcs)]
    ly = [b[ss:ss + x.shape[0]] for (_, b), x in zip(lxy, srcs)]
    det = [hess(a, b, ss)[ss:ss + x.shape[0]] for a, b, x in
           zip(sh.extend(lx, ss), sh.extend(ly, ss), srcs)]
    return list(zip(Ls, det, lx, ly))


def _build_shards(xs, plan: PipelinePlan, sh: _Shards, fixed: bool):
    """``scale_space.build_scale_space`` of one image on its row shards.
    Returns (per shard its list of OctaveData [S, h_o, w_o], kcontrast on
    the mesh's first device)."""
    cfg = plan.config
    route = spatial_route(plan, sh.n)
    on_card = xs[0].device.type == "cuda"
    run_sublevel = _sublevel_kernel if on_card else _sublevel_plain
    down = down_with_smooth_fixed if fixed else down_with_smooth

    pre = sh.stencil(lambda a: (lowpass_fixed if fixed else lowpass)(
        a, 1.0, 5), xs, 2)
    mags = sh.stencil(scharr_magnitude_fixed if fixed else scharr_magnitude,
                      pre, 1)
    kcontrast = _percentile_global(mags, cfg.per, plan.height * plan.width,
                                   fixed, sh)
    octaves = [[] for _ in xs]
    last = None                      # each shard's last L of the octave
    for oi, (op, gathered) in enumerate(zip(plan.octaves, route)):
        if oi:
            kcontrast = ((kcontrast.to(torch.float32) * 0.75 + 0.5)
                         .to(torch.int32) if fixed else kcontrast * 0.75)
        ikc = inverse_square(kcontrast)
        base = _base(plan, oi)
        h_o = op.height // sh.n
        if gathered:
            whole = sh.gather(xs if oi == 0 else last)
            planes = []
            for w in whole:
                src, smooth = (w, None) if oi == 0 else down(w)
                planes.append(octave(
                    src[None].contiguous(), ikc.to(w.device).reshape(1), op,
                    smooth=None if smooth is None else smooth[None],
                    base=base, diffusivity=cfg.diffusivity, fixed=fixed))
            for s, (p, i) in enumerate(zip(planes, sh.index)):
                octaves[s].append(OctaveData(*(
                    q[0, :, i * h_o:(i + 1) * h_o] for q in p)))
        else:
            smooths = None
            if oi == 0:
                srcs = xs
            else:
                # crop 2 destination rows <-> the 4 ghost source rows
                dec = [down(e) for e in sh.extend(last, 4)]
                srcs = [d[2:-2] for d, _ in dec]
                smooths = [s[2:-2] for _, s in dec]
            per_level = []
            for s_i, sp in enumerate(octave_specs(op, base)):
                outs = run_sublevel(sh, srcs, smooths if s_i == 0 else None,
                                    ikc, sp, cfg.diffusivity, fixed)
                per_level.append(outs)
                srcs = [o[0] for o in outs]
            for s in range(len(xs)):
                octaves[s].append(OctaveData(*(
                    torch.stack([lvl[s][k] for lvl in per_level])
                    for k in range(4))))
        last = [o[-1].L[-1] for o in octaves]
    return octaves, kcontrast


def _shard_image(image, plan: PipelinePlan, sh: _Shards, fixed: bool):
    """The image's row blocks: a global [H, W] image (numpy or a tensor)
    split over the axis, or the list of this process's blocks."""
    dtype = torch.int32 if fixed else torch.float32
    if isinstance(image, (list, tuple)):
        xs = [torch.as_tensor(x).to(dtype) for x in image]
        return [x.to(d).contiguous() for x, d in zip(xs, sh.devices)]
    x = torch.as_tensor(image).to(dtype)
    if tuple(x.shape) != (plan.height, plan.width):
        raise ValueError(f"image must be [{plan.height}, {plan.width}], "
                         f"got {tuple(x.shape)}")
    return col.shard(x, sh.mesh, sh.axis)


def _check(plan: PipelinePlan, mesh: Mesh, axis: str, **kw) -> _Shards:
    if mesh.shape.get(axis, 0) < 1:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} have no {axis!r} "
                         "axis")
    sh = _Shards(mesh, axis)
    if any(mesh.shape[a] > 1 for a in mesh.axis_names if a != axis):
        raise ValueError(f"the spatial tier shards rows over {axis!r} "
                         f"only; mesh {mesh.shape}")
    ok, why = spatial_supported(plan, sh.n, **kw)
    if not ok:
        raise ValueError(f"spatial sharding unsupported: {why}")
    return sh


def spatial_scale_space(image, plan: PipelinePlan, mesh: Mesh,
                        axis: str = "data", fixed: bool = False):
    """Build the scale space with image rows sharded over ``mesh[axis]``.

    Args:
      image: [H, W] global image (float in [0, 1], or raw 0..255 with
        ``fixed``), or the list of this process's row blocks.
      plan: static plan for (H, W).
      mesh: a mesh whose other axes have size 1.

    Returns (octaves, kcontrast): for each local shard its list of
    ``OctaveData`` with that shard's rows of every [S, H_o, W_o] stack, on
    its device, and the contrast factor after all octave decays on the
    mesh's first device.  Raises ValueError where ``spatial_supported``
    refuses the (plan, shard count)."""
    sh = _check(plan, mesh, axis)
    return _build_shards(_shard_image(image, plan, sh, fixed), plan, sh,
                         fixed)


# ---------------------------------------------------------------------------
# detection and description on row shards
# ---------------------------------------------------------------------------

def _detect_shards(octs, plan: PipelinePlan, sh: _Shards, fixed: bool):
    """Keypoints of each shard (global coordinates), and its halo-1 det
    stacks' row offsets."""
    cfg = plan.config
    minval = IMIN_VAL if fixed else FMIN_VAL
    h_loc = plan.height // sh.n
    row0 = [i * h_loc for i in sh.index]
    # extrema (halo 1, the min fill at the global edges, as the unsharded
    # constant pad), NMS (halo rmax), then each shard's own selection
    det_pads = list(zip(*(sh.extend([o[oi].det for o in octs], 1, dim=1,
                                    edge=minval)
                          for oi in range(len(plan.octaves)))))
    maps = [build_extrema_maps(o, plan, det_pads=list(d), row0=r)
            for o, d, r in zip(octs, det_pads, row0)]
    resp_pads = sh.extend([m[0] for m in maps], plan.max_nms_radius,
                          edge=minval)
    kps = []
    for (resp, size, layer), rp, r, dp in zip(maps, resp_pads, row0,
                                              det_pads):
        mask = nms(resp, size, layer, plan, resp_pad=rp, row0=r,
                   h_global=plan.height)
        k = select_keypoints(mask, resp, layer, cfg.max_pts,
                             size_table_for(plan))
        k = k._replace(y=k.y + float(r))
        # refinement on the same halo-1 det stacks (seam-exact: the
        # extrema border keeps every keypoint a row inside the image)
        fake = [OctaveData(L=d, det=d, lx=d, ly=d) for d in dp]
        shift = tuple((r >> oi) - 1 for oi in range(len(plan.octaves)))
        kps.append(refine_keypoints(k, fake, plan, row_shift=shift))
    return kps, row0


def _describe_shards(octs, kps, row0, plan: PipelinePlan, sh: _Shards,
                     fixed: bool):
    """K2 per shard on its WSIZE/2-extended plane stack; thin octaves
    gathered whole (offset 0)."""
    hd = WSIZE // 2
    gathered = [octs[0][oi].L.shape[1] - 1 < hd
                for oi in range(len(plan.octaves))]
    hmax = max(octs[0][oi].L.shape[1] * (sh.n if g else 1)
               for oi, g in enumerate(gathered)) + WSIZE
    fill = 0 if fixed else 0.0
    ext_octs = [[] for _ in octs]
    for oi, g in enumerate(gathered):
        stacks = []
        for name in ("L", "lx", "ly"):
            xs = [getattr(o[oi], name) for o in octs]
            if g and sh.n > 1:
                ext = [torch.nn.functional.pad(w, (0, 0, hd, hd),
                                               value=fill)
                       for w in sh.gather(xs, dim=1)]
            else:
                ext = sh.extend(xs, hd, dim=1, edge=fill)
            stacks.append([torch.nn.functional.pad(
                e, (0, 0, 0, hmax - e.shape[1])) for e in ext])
        for s, (eL, elx, ely) in enumerate(zip(*stacks)):
            ext_octs[s].append(OctaveData(L=eL, det=eL, lx=elx, ly=ely))
    out = []
    for eo, k, r in zip(ext_octs, kps, row0):
        pp = build_padded_pyramid(eo, WSIZE, plane_dtype(plan, fixed))
        row_off = tuple(hd - (0 if g else (r >> oi))
                        for oi, g in enumerate(gathered))
        out.append(orient_describe_multi([k], pp, plan, fixed,
                                         row_off=row_off)[0])
    return out


def _gather_features(kps: List[Keypoints], described, sh: _Shards,
                     max_pts: int):
    """All-gather the shards' features in mesh order (contiguous row bands
    in order: the unsharded emission order) and compact them to the global
    valid prefix, on the mesh's first device."""
    from ..pipeline import Features

    def gathered(xs):
        return col.all_gather(xs, sh.mesh, sh.axis, home_only=True)

    fields = {f: gathered([getattr(k, f) for k in kps])
              for f in ("x", "y", "size", "layer", "response")}
    fields["angle"] = gathered([a for a, _ in described])
    fields["words"] = gathered([w for _, w in described])
    valid = gathered([k.valid for k in kps])
    sel, got, total = prefix_rows(valid, max_pts)
    count = torch.clamp(total, max=max_pts)

    def take(a):
        t = a[sel]
        m = got if t.dim() == 1 else got[:, None]
        return torch.where(m, t, torch.zeros_like(t))

    overflow = (gathered([k.overflow.reshape(1) for k in kps]).any()
                | (total > max_pts))
    return Features(**{f: take(v) for f, v in fields.items()}, valid=got,
                    count=count, overflow=overflow)


def spatial_detect_and_compute(image, plan: PipelinePlan, mesh: Mesh,
                               axis: str = "data", fixed: bool = False,
                               describe: bool = True):
    """``detect_and_compute`` with image rows sharded over ``mesh[axis]``.

    The whole front end (scale space, extrema, NMS, selection, sub-pixel
    refinement, orientation, MLDB descriptors) runs on the row shards with
    neighbour-only halo traffic; only the keypoints are all-gathered.
    ``image``: as in ``spatial_scale_space``.  Returns ``Features`` on the
    mesh's first device, equal to the unsharded pipeline's (the same
    keypoints in the same row-major order).  ``describe=False``: angle 0
    and zero words, no plane stack and no K2."""
    sh = _check(plan, mesh, axis, detect=True, describe=describe)
    octs, _ = _build_shards(_shard_image(image, plan, sh, fixed), plan, sh,
                            fixed)
    kps, row0 = _detect_shards(octs, plan, sh, fixed)
    if describe:
        described = _describe_shards(octs, kps, row0, plan, sh, fixed)
    else:
        described = [(torch.zeros_like(k.x),
                      torch.zeros((k.x.shape[0], DESCRIPTOR_WORDS),
                                  dtype=torch.int32, device=k.x.device))
                     for k in kps]
    return _gather_features(kps, described, sh, plan.config.max_pts)
