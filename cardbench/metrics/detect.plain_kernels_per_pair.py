"""Device kernels per pair of the traced stretch that are none of the
hand-written ones (K1's ``tiled_kernel`` and ``octave_kernel``, K2's
``describe_kernel``, K4's ``hamming_kernel``): detection's and the
describe stage's plain PyTorch pieces.  Copies and memsets are not
kernels."""

HAND_WRITTEN = ("tiled_kernel", "octave_kernel", "describe_kernel",
                "hamming_kernel")


def read(trace):
    pairs = trace.facts.get("pairs", 0)
    if not pairs:
        return None
    n = sum(1 for evs in trace.device.values() for name, _, _ in evs
            if not name.startswith(("Memcpy", "Memset"))
            and not any(k in name for k in HAND_WRITTEN))
    return n / pairs
