"""Frames that add no keyframe: their ``SlamSystem.process`` time between
CUDA events over their count, in ms, over the traced run's window."""


def read(trace):
    ms = trace.facts.get("tracked_frame_ms")
    return sum(ms) / len(ms) if ms else None
