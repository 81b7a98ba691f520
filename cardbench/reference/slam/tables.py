"""Constant tables on a device, built once per (values, type, device)."""

from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def const_table(values: tuple, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)
