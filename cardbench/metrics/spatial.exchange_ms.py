"""Card-to-card copies per pair of the traced stretch, in ms: the device
time of the profiler's peer copies (``Memcpy PtoP``), summed over the
cards: the row split, the halo rows, the gathered blocks and the
features sent home."""


def read(trace):
    pairs = trace.facts.get("pairs", 0)
    spent = trace.kernel_s("Memcpy PtoP")
    if not pairs or not spent:
        return None
    return 1e3 * spent / pairs
