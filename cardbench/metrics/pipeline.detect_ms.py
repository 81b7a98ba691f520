"""``Akaze.detect_and_compute_pair`` (or the single-image call): its
calls' time between CUDA events over their count, in ms, over the
traced run's window."""


def read(trace):
    ms = trace.spans.ms("detect")
    return sum(ms) / len(ms) if ms else None
