"""K1 (``tiled_kernel`` + ``octave_kernel``) against its bound, in %:
the least time of the traced stretch's scale spaces (``roofline``) over
the profiler's device time of those kernels."""

from cardbench import roofline


def read(trace):
    f = trace.facts
    spent = trace.kernel_s("tiled_kernel", "octave_kernel")
    n = f.get("scale_spaces", f.get("pairs", 0))
    if not n or not spent:
        return None
    plan = roofline.plan_for(f["akaze"], *f["image"])
    return 100.0 * n * roofline.k1_bound_s(plan, f["batch"]) / spent
