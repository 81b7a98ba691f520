"""The cards' idle share over the traced stretch, in %: 1 - the mean over
the cards of the union of each card's device events, over the stretch's
wall time."""


def read(trace):
    if not trace.window_s or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
