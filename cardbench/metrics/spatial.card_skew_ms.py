"""The busiest card's busy time less the least busy card's, per pair of
the traced stretch, in ms: the work the mesh leaves on one card (on the
home card: the row split, the gather and compaction, K4).  Copies between
the host and a card (``Memcpy HtoD``, ``Memcpy DtoH``: the upload and
the fetch, the entry layer's) are left out of each card's busy time."""

from cardbench.trace import union_ns

HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def read(trace):
    pairs = trace.facts.get("pairs", 0)
    cards = sorted(set(trace.facts.get("cards", ())))
    if not pairs or len(cards) < 2 or not trace.device:
        return None
    busy = [union_ns([(a, b) for name, a, b in trace.device.get(c, ())
                      if not name.startswith(HOST_COPIES)])
            for c in cards]
    return (max(busy) - min(busy)) / 1e6 / pairs
