"""``SlamSystem.optimize`` (the pose graph padded, ``optimize_pose_graph``
and the poses written back): its calls' time between CUDA events over
their count, in ms, over the traced run's window."""


def read(trace):
    ms = trace.spans.ms("pgo")
    return sum(ms) / len(ms) if ms else None
