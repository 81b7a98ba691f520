"""Device kernels per pair of the traced stretch, on every card, that are
none of the hand-written ones (K1's ``tiled_kernel`` and
``octave_kernel``, K2's ``describe_kernel``, K4's ``hamming_kernel``,
detection's ``extrema_nms_kernel``): the plain PyTorch chain that the
row-sharded tier runs.  Copies and memsets are not kernels."""

HAND_WRITTEN = ("tiled_kernel", "octave_kernel", "describe_kernel",
                "hamming_kernel", "extrema_nms_kernel")


def read(trace):
    pairs = trace.facts.get("pairs", 0)
    if not pairs:
        return None
    n = sum(1 for evs in trace.device.values() for name, _, _ in evs
            if not name.startswith(("Memcpy", "Memset"))
            and not any(k in name for k in HAND_WRITTEN))
    return n / pairs
