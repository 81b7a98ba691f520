"""``Akaze.match`` with the fetch of its result to the host: its calls'
time between CUDA events over their count, in ms, over the traced run's
window."""


def read(trace):
    ms = trace.spans.ms("match")
    return sum(ms) / len(ms) if ms else None
