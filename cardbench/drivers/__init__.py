"""The general generators: each reads a traffic mix's parameters and
drives the program with it in a closed loop.

A driver is made with (configuration, mix, seed, devices, spans) and
offers ``setup()`` (inputs from the seed, the program, the warm-up of
every shape it will use), ``step()`` (one unit of the loop),
``end_to_end(window_s)`` (every end-to-end number it measures),
``facts()`` (what the per-layer readers need of the traced stretch),
``release()`` (the program's state freed, the sample of its outputs kept)
and ``check()`` (the sample against the reference: each compared number).
"""

from __future__ import annotations

import numpy as np

from ..reference import akaze as reference


def akaze_fields(config: dict) -> dict:
    """The configuration's ``akaze`` fields, the diffusivity by name."""
    fields = dict(config["akaze"])
    if isinstance(fields.get("diffusivity"), str):
        fields["diffusivity"] = int(reference.Diffusivity[
            fields["diffusivity"]])
    return fields


def program(config: dict, devices: list):
    """The port's ``Akaze`` of this configuration: over a mesh of the
    devices when there are several, else on the one."""
    from akaze_tpu_torch import Akaze, AkazeConfig
    cfg = AkazeConfig(**akaze_fields(config))
    if len(devices) > 1:
        from akaze_tpu_torch.parallel import make_mesh
        return Akaze(cfg, mesh=make_mesh(len(devices), devices=devices))
    return Akaze(cfg, device=devices[0])


def reference_plan(config: dict, height: int, width: int):
    return reference.build_plan(height, width, reference.AkazeConfig(
        **akaze_fields(config)))


def release_program() -> None:
    """Drop the program's captured graphs and their pools, and the
    allocator's cache."""
    import torch
    from akaze_tpu_torch import programs
    programs.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length,
    drawn from the seed: the same seed and stream keep the same items."""

    def __init__(self, size: int, seed: int, purpose: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 9,
                                          purpose])
        self.items = []
        self.seen = 0

    def wants(self) -> int:
        """The slot the next item goes to, or -1 (call once per item)."""
        self.seen += 1
        if len(self.items) < self.size:
            return len(self.items)
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else -1

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item
