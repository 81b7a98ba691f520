"""K4 (``hamming_kernel``) against its bound, in %: the least time of the
traced stretch's launches at their live counts (``roofline``) over the
profiler's device time of the kernel."""

from cardbench import roofline


def read(trace):
    calls = trace.facts.get("k4", ())
    spent = trace.kernel_s("hamming_kernel")
    if not calls or not spent:
        return None
    return 100.0 * sum(roofline.k4_bound_s(*c) for c in calls) / spent
