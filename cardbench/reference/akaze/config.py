"""Configuration of the PyTorch AKAZE pipeline.

A copy of ``akaze_tpu/config.py``: the same frozen dataclass with the same
fields, defaults and validation (the reference exposes these parameters
through ``Akazer::init``, akaze.cpp:80-98, with demo defaults at
main.cpp:156-166).  The port must not import the JAX package, so the class
is duplicated rather than shared; ``config_from`` carries a configuration
across from any object with the same fields.

The system has no weights: a configuration plus the plan built from it
(plan.py) is its whole state.
"""

from __future__ import annotations

import dataclasses
import enum
from collections.abc import Mapping


class Diffusivity(enum.IntEnum):
    """Conductivity function g(|grad L|) selecting the diffusion flavour.

    Reference: akaze_structures.h:53-59 and the kernels at akazed.cu:1091-1106.
    """

    PM_G1 = 0
    PM_G2 = 1
    WEICKERT = 2
    CHARBONNIER = 3


@dataclasses.dataclass(frozen=True)
class AkazeConfig:
    """Tuning parameters of the AKAZE detector/descriptor.

    Defaults mirror the reference demo configuration (main.cpp:156-166).
    """

    max_pts: int = 10000            # capacity of the keypoint tensors
    noctaves: int = 4               # pyramid octaves (may shrink for small images)
    max_scale: int = 4              # sublevels per octave
    per: float = 0.7                # percentile for the contrast factor
    kcontrast: float = 0.03         # initial contrast factor
    soffset: float = 1.6            # base scale offset (sigma units)
    reordering: bool = True         # FED step reordering
    derivative_factor: float = 1.5  # multiscale derivative factor
    dthreshold: float = 0.001       # detector response threshold (float path)
    idthreshold: int = 65           # detector response threshold (int path,
                                    # reference: akaze.cpp:560)
    diffusivity: Diffusivity = Diffusivity.PM_G2
    descriptor_pattern_size: int = 10
    tau_max: float = 0.25           # max FED step size (reference: akaze.cpp:268)
    max_dist: int = 96              # Hamming acceptance threshold
                                    # (MAX_DIST, akazed.cu:11)
    # The fields below select kernels and sampling types of the JAX
    # package.  They are kept so that one configuration describes both
    # packages (``config_from``).  The port runs its CUDA kernels on CUDA
    # tensors whatever the kernel selectors (``pallas_*``,
    # ``banded_windows``) say: where the JAX package's kernel and XLA
    # paths compute the same results, only the delivery differs.  Two
    # settings change results, and the port follows them:
    #   * ``bf16_sampling``: the float path's descriptor samples bf16
    #     planes, or float32 planes when False, as the JAX package's XLA
    #     float path does.  The fixed path ignores it.
    #   * the fixed (16.16) path's descriptor flavour.  The JAX kernel path
    #     (which "auto" takes on a TPU) samples bf16 planes with the float
    #     kernel ("approximate"), and so does the port by default; ``fixed_exact_sampling=True`` gives the
    #     bit-faithful flavour (f32 planes, per-tap rotation and
    #     truncation), and so does ``pallas_descriptor="off"``, because the
    #     JAX package's XLA descriptor path IS that flavour on the fixed
    #     path.  That is why "off" is the one kernel-selector value the
    #     port reads (``fixed_descriptor_exact``).  The float path ignores
    #     both: its kernel and XLA paths agree.
    bf16_sampling: bool = True
    pallas_descriptor: str = "auto"
    pallas_scale_space: str = "auto"
    fixed_exact_sampling: bool = False
    banded_windows: bool = True

    # smax scale multiplier for the extrema border; 10*sqrt(2) for the MLDB
    # descriptor family (FEATURE_TYPE 5; reference: akaze.cpp:277-285).
    @property
    def smax(self) -> float:
        return 10.0 * (2.0 ** 0.5)

    @property
    def fixed_descriptor_exact(self) -> bool:
        """On the fixed path: whether the descriptor is the bit-faithful
        flavour (f32 planes) rather than the approximate bf16 one."""
        return self.fixed_exact_sampling or self.pallas_descriptor == "off"

    def __post_init__(self):
        if self.max_scale < 1 or self.max_scale > 5:
            raise ValueError("max_scale must be in [1, 5]")
        if self.noctaves < 1:
            raise ValueError("noctaves must be >= 1")
        for field in ("pallas_descriptor", "pallas_scale_space"):
            if getattr(self, field) not in ("auto", "on", "interpret",
                                            "off"):
                raise ValueError(
                    f"{field} must be 'auto', 'on', 'interpret' or 'off'")


def config_from(obj) -> AkazeConfig:
    """The port's ``AkazeConfig`` with the field values of ``obj``.

    ``obj`` is a mapping (e.g. ``dataclasses.asdict`` of the JAX package's
    ``AkazeConfig``) or any dataclass instance with the same fields.
    Fields ``obj`` lacks keep their defaults; a field the port does not
    know raises, so a configuration never loses a setting silently.
    """
    if isinstance(obj, Mapping):
        values = dict(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        values = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)}
    else:
        raise TypeError(f"cannot read a configuration from {type(obj)!r}")
    known = {f.name for f in dataclasses.fields(AkazeConfig)}
    unknown = sorted(set(values) - known)
    if unknown:
        raise ValueError(f"fields unknown to the port: {unknown}")
    if "diffusivity" in values:
        values["diffusivity"] = Diffusivity(int(values["diffusivity"]))
    return AkazeConfig(**values)


DESCRIPTOR_BITS = 486     # 3 channels x (C(4,2) + C(9,2) + C(16,2)) comparisons
DESCRIPTOR_BYTES = 61     # ceil(486 / 8); reference: akaze_structures.h:29
DESCRIPTOR_WORDS = 16     # 486 bits padded into 16 32-bit words (512 bits)
