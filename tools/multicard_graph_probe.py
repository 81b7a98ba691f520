"""Whether one captured CUDA graph can span several cards of one process.

The primitive under ``programs.py``'s multi-card keys, tried alone and
reported step by step:

1. ``two cards``: a capture on a side stream of cuda:0 forks a side
   stream of cuda:1 in by an event, runs one K1 launch (the tiled kernel)
   and a peer copy to cuda:0 there, and joins cuda:1 back; cuda:1
   allocates into a ``torch.cuda.MemPool`` of its own
   (``use_mem_pool``).  The graph is replayed on new inputs and compared
   with the eager result bit for bit.
2. ``every card``: the same over every card (up to four), with a sum
   folded on cuda:0 in card order and sent back to every card
   (``collectives.psum``'s pattern), and a non-contiguous view copied
   across cards.
3. ``ordering``: an op on the last card's current stream, issued straight
   after a replay (its stream made to wait on the origin stream), reads
   the replay's values.
4. ``host read``: ``.item()`` on cuda:1 under such a capture raises, and
   a later capture over the same cards still works.
5. ``host copy``: a pageable host -> card copy under capture.

Prints one line per step and, last, a JSON object of the results::

    python3 tools/multicard_graph_probe.py     # needs two or more cards
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Capture:
    """One graph over ``cards`` (the first is the origin): warm-up and
    capture with every card's side stream current, the other cards forked
    in by an event and joined back, each allocating into its own pool."""

    def __init__(self, cards):
        self.cards = cards
        self.side = [torch.cuda.Stream(c) for c in cards]
        self.pools = []
        for c in cards:
            with torch.cuda.device(c):
                self.pools.append(torch.cuda.MemPool())
        self.graph = torch.cuda.CUDAGraph()

    @contextlib.contextmanager
    def streams(self):
        with contextlib.ExitStack() as st:
            for s in self.side[::-1]:
                st.enter_context(torch.cuda.stream(s))
            st.enter_context(torch.cuda.device(self.cards[0]))
            yield

    def warm(self, fn, *args):
        for c, s in zip(self.cards, self.side):
            s.wait_stream(torch.cuda.current_stream(c))
        with self.streams():
            out = fn(*args)
        for c, s in zip(self.cards, self.side):
            torch.cuda.current_stream(c).wait_stream(s)
        return out

    def capture(self, fn, *args):
        origin = self.side[0]
        with contextlib.ExitStack() as st:
            st.enter_context(torch.cuda.graph(
                self.graph, pool=self.pools[0].id, stream=origin,
                capture_error_mode="thread_local"))
            for c, s in zip(self.cards[1:], self.side[1:]):
                st.enter_context(torch.cuda.stream(s))
            st.enter_context(torch.cuda.device(self.cards[0]))
            for c, p in zip(self.cards[1:], self.pools[1:]):
                st.enter_context(torch.cuda.use_mem_pool(p, device=c))
            fork = torch.cuda.Event()
            fork.record(origin)
            for s in self.side[1:]:
                s.wait_event(fork)
            out = fn(*args)
            for s in self.side[1:]:
                join = torch.cuda.Event()
                join.record(s)
                origin.wait_event(join)
        return out

    def replay(self):
        home = torch.cuda.current_stream(self.cards[0])
        for c in self.cards[1:]:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(c))
            home.wait_event(ev)
        with torch.cuda.device(self.cards[0]):
            self.graph.replay()
        done = torch.cuda.Event()
        done.record(home)
        for c in self.cards[1:]:
            torch.cuda.current_stream(c).wait_event(done)


def k1_on(src, ikc):
    from akaze_tpu_torch.ops import sublevel as k1
    return k1.sublevel(src, ikc, (0.25, 0.31, 0.18), 2)


def two_cards(cards, res):
    c0, c1 = cards[:2]
    g = torch.Generator().manual_seed(0)
    src = torch.rand(1, 120, 160, generator=g).to(c1)
    ikc = torch.tensor([9.0], device=c1)

    def fn(x):
        L, det, lx, ly = k1_on(x, ikc)
        return det.to(c0) * 2, L

    cap = Capture([c0, c1])
    buf = src.clone()
    cap.warm(fn, buf)
    out = cap.capture(fn, buf)
    new = torch.rand(1, 120, 160, generator=g).to(c1)
    want = fn(new)
    buf.copy_(new)
    cap.replay()
    torch.cuda.synchronize(c0)
    torch.cuda.synchronize(c1)
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(out, want))
    res["two_cards"] = dict(equal=same, out_devices=[str(o.device)
                                                     for o in out])
    print(f"[probe two cards] capture over {c0}, {c1} with a K1 launch and "
          f"a peer copy: replay equal to eager bit for bit: {same}")


def psum_fn(xs, cards):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    # a non-contiguous view across cards
    col = acc[:, 1::2].to(cards[-1])
    return [acc.to(c) for c in cards], col


def every_card(cards, res):
    g = torch.Generator().manual_seed(1)
    xs = [torch.rand(256, 64, generator=g).to(c) for c in cards]
    bufs = [x.clone() for x in xs]
    cap = Capture(cards)
    before = [torch.cuda.memory_reserved(c) for c in cards]
    cap.warm(psum_fn, bufs, cards)
    out = cap.capture(psum_fn, bufs, cards)
    pool = [torch.cuda.memory_reserved(c) - b for c, b in zip(cards, before)]
    ok = True
    for rep in range(3):
        new = [torch.rand(256, 64, generator=g).to(c) for c in cards]
        want = psum_fn(new, cards)
        for b, x in zip(bufs, new):
            b.copy_(x)
        cap.replay()
        # ordering: an op on the last card straight after the replay
        late = out[0][-1] * 1.0
        for c in cards:
            torch.cuda.synchronize(c)
        ok &= all(torch.equal(a.cpu(), b.cpu())
                  for a, b in zip(out[0], want[0]))
        ok &= torch.equal(out[1].cpu(), want[1].cpu())
        ok &= torch.equal(late.cpu(), want[0][-1].cpu())
    res["every_card"] = dict(equal=bool(ok), cards=len(cards),
                             pool_bytes=pool)
    print(f"[probe every card] capture over {len(cards)} cards: fold on "
          f"{cards[0]}, replicated back, a strided view across cards; three "
          f"replays on new inputs equal to eager and read in order on "
          f"{cards[-1]}: {bool(ok)}; reserved per card {pool}")


def host_read(cards, res):
    c0, c1 = cards[:2]
    x = torch.ones(8, device=c1)

    def bad(x):
        y = x * 2
        return y.sum().item()

    cap = Capture([c0, c1])
    cap.warm(bad, x)
    try:
        cap.capture(bad, x)
        res["host_read"] = dict(raised=False)
    except Exception as e:          # the probe reports what CUDA says
        res["host_read"] = dict(raised=True, error=str(e)[:300])
    # the cards still capture afterwards
    after = {}
    try:
        every_card(cards, after)
        res["host_read"]["later_capture_ok"] = after["every_card"]["equal"]
    except Exception as e:
        res["host_read"]["later_capture_ok"] = False
        res["host_read"]["later_error"] = str(e)[:300]
    print(f"[probe host read] {res['host_read']}")


def host_copy(cards, res):
    c0, c1 = cards[:2]

    def fn(x):
        return x + torch.tensor([1.0, 2.0], device=c1).sum()

    cap = Capture([c0, c1])
    x = torch.ones(2, device=c1)
    cap.warm(fn, x)
    try:
        cap.capture(fn, x)
        res["host_copy"] = dict(raised=False)
    except Exception as e:
        res["host_copy"] = dict(raised=True, error=str(e)[:300])
    print(f"[probe host copy] {res['host_copy']}")


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("needs two or more CUDA cards", file=sys.stderr)
        return 1
    cards = [torch.device("cuda", i)
             for i in range(min(4, torch.cuda.device_count()))]
    print(f"[probe] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {len(cards)}", flush=True)
    res = {}
    for step in (two_cards, every_card, host_read, host_copy):
        try:
            step(cards, res)
        except Exception:
            res[step.__name__] = dict(failed=traceback.format_exc()[-1500:])
            print(f"[probe {step.__name__}] failed:\n"
                  f"{res[step.__name__]['failed']}", flush=True)
    print(json.dumps(res))
    return 0 if all("failed" not in v for v in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
