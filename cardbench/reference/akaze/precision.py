"""The precision of the reference's scale-space planes.

The reference keeps every plane in float32, as the configuration states.
``planes_in(torch.bfloat16)`` rounds each plane that a sublevel computes
(the smooth, every FED step's L, the derivatives, the determinant) to
that type as it is made: the benchmark's control, the scale space one
precision below the stated one.
"""

from __future__ import annotations

import contextlib

import torch

_DTYPE = None


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through the planes' type, when one is set."""
    if _DTYPE is None or x.dtype != torch.float32:
        return x
    return x.to(_DTYPE).to(torch.float32)


@contextlib.contextmanager
def planes_in(dtype):
    """Compute the scale space's planes in ``dtype`` inside the block."""
    global _DTYPE
    before, _DTYPE = _DTYPE, dtype
    try:
        yield
    finally:
        _DTYPE = before
