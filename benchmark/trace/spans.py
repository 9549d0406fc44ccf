"""The program's spans laid on a traced window's device trace, and the
per-layer numbers they give.

jpeg2png_tpu_torch.utils.profiling records a span at each layer boundary
of the port (cli.main, read, solve.setup, solve.loop, fetch, png, and the
runner's read.pool, solve.pool, item and on_pixels) on
time.perf_counter_ns, with its thread's pthread id, inside
profiling.recording().  traced() wraps
capture.traced: just inside its marks, it synchronises the first card
through a CUDA event and reads perf_counter_ns as the synchronise
returns, once at the start and once at the end, and records the spans in
between.  The two pairs (the event synchronise's end in the trace, the
clock reading) map a span's times onto the trace's microseconds, offset
and rate.  The window's own start mark makes no such pair: the trace
puts its end 1-4 ms before the call returns, while synchronises made in
the window and clock readings after them agree to a few us:

  mark_times(events, cards)  the window (summarize's w0 and w1) and the
                             ends of the first and the last event
                             synchronise in it (the clock pairs');
  clock_map(...)             ns -> trace us, and both pairs' offsets;
  card_busy(events, ...)     each card's busy intervals in the window (the
                             union summarize's busy_s sums);
  idle_shares(spans, ...)    % of cards x window in which a card was idle,
                             claimed in this order and never twice: while
                             its own worker had an `item` open; from a
                             call's cli.main start to the call's first
                             item; from its last item's end to the
                             cli.main end while a `png` was open; the
                             residual (device_idle_share.batch less the
                             three);
  per_file_ms(spans)         per cli.main call: read, solve.setup,
                             solve.loop + fetch, png, and cli.main's self
                             time (its duration less what its children
                             cover), which add up to the mean call;
  fetch_in_copies(spans, ...)the shares of fetch spans that hold the host
                             call of a device -> host copy of exactly their
                             `bytes` (a check of the map between the pairs,
                             to a fetch's length), on any thread and on
                             their own (a trace names the thread of a CUDA
                             call by the low 32 bits of its pthread id in
                             some runs, by another id in others).

A span here is a dict: name, t0, t1, tid, id, parent, request, attrs.
The harness does not read these yet; benchmark/span_run.py runs a cell
with them.
"""

from __future__ import annotations

import bisect
import contextlib
import time

from benchmark.trace import capture, intervals as iv

SPAN_KEYS = ("name", "t0", "t1", "tid", "id", "parent", "request", "attrs")
PAIR = "cudaEventSynchronize"     # the clock pairs' call; the port makes none
# the harness's own traced window (benchmark/span_run.py puts traced()
# in its place)
_traced = capture.traced


def as_dict(sp) -> dict:
    return {k: getattr(sp, k) for k in SPAN_KEYS}


def _clock_pair() -> int:
    """Synchronise the first card through a CUDA event, then read the
    clock: in the trace, the synchronise ends where the reading is."""
    import torch

    event = torch.cuda.Event()
    event.record()
    event.synchronize()
    return time.perf_counter_ns()


@contextlib.contextmanager
def traced(cards: int, sink: dict):
    """capture.traced with the program's spans recorded inside it: on
    exit sink["spans"] (dicts, perf_counter_ns times) and sink["clock"]
    (the clock pairs' readings, after the start marks and before the end
    marks)."""
    from jpeg2png_tpu_torch.utils import profiling

    with _traced(cards, sink):
        p0 = _clock_pair()
        with profiling.recording() as spans:
            yield
        p1 = _clock_pair()
    sink["clock"] = (p0, p1)
    sink["spans"] = [as_dict(sp) for sp in spans]


def mark_times(events, cards: int):
    """(w0, w1, a0, a1) in trace us: the window as capture.summarize
    takes it, and the ends of the first and the last event synchronise
    (PAIR) in it."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e
          and e.get("cat") in capture.HOST_API_CATS]
    ends = sorted(e["ts"] + e.get("dur", 0) for e in xs
                  if e.get("name") == capture.MARK)
    if len(ends) < 2 * cards:
        raise RuntimeError("the trace holds no window marks")
    w0, w1 = ends[cards - 1], ends[-1]
    pairs = sorted(e["ts"] + e.get("dur", 0) for e in xs
                   if e.get("name") == PAIR and w0 <= e["ts"] <= w1)
    if len(pairs) < 2:
        raise RuntimeError("the trace holds no clock pairs")
    return w0, w1, pairs[0], pairs[-1]


def clock_map(p0: int, a0: float, p1: int, a1: float):
    """(fn: perf_counter_ns -> trace us, offset at the first pair, offset
    at the last, rate), each offset the trace's us less the clock's; the
    rate is trace us per clock us between the pairs."""
    rate = (a1 - a0) / ((p1 - p0) / 1e3)

    def to_us(ns):
        return a0 + (ns - p0) / 1e3 * rate

    return to_us, a0 - p0 / 1e3, a1 - p1 / 1e3, rate


def mapped(spans, to_us) -> list:
    """The spans with t0 and t1 in trace us."""
    return [dict(s, t0=to_us(s["t0"]), t1=to_us(s["t1"])) for s in spans]


def card_busy(events, cards: int, w0: float, w1: float) -> list:
    """[per card: the union of its kernels, copies and memsets that start
    in the window, cut to it], as capture.summarize counts busy_s."""
    per = [[] for _ in range(cards)]
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in capture.DEVICE_CATS
                and w0 <= e["ts"] <= w1):
            d = int(e.get("args", {}).get("device", 0))
            per[d].append([e["ts"], e["ts"] + e.get("dur", 0)])
    return [iv.intersect(iv.union(v), [[w0, w1]]) for v in per]


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def idle_shares(spans, busy, w0: float, w1: float) -> dict:
    """The card idle time's shares (% of cards x window) by what the
    program had open, for spans in the trace's us (mapped()): in_items,
    before_items, png_tail, residual, and idle (all of it)."""
    cards = len(busy)
    window = [[w0, w1]]
    items = _named(spans, "item")
    pre, post = [], []
    for call in _named(spans, "cli.main"):
        its = [i for i in items if i["request"] == call["request"]]
        if not its:
            continue
        pre.append([call["t0"], min(i["t0"] for i in its)])
        pngs = iv.union([[p["t0"], p["t1"]] for p in _named(spans, "png")
                         if p["request"] == call["request"]])
        post += iv.intersect(
            [[max(i["t1"] for i in its), call["t1"]]], pngs)
    pre, post = iv.union(pre), iv.union(post)
    out = {"in_items": 0.0, "before_items": 0.0, "png_tail": 0.0,
           "idle": 0.0}
    for k in range(cards):
        left = iv.subtract(window, busy[k])
        out["idle"] += iv.length(left)
        own = iv.union([[i["t0"], i["t1"]] for i in items
                        if i["attrs"].get("card") == k])
        for key, claim in (("in_items", own), ("before_items", pre),
                           ("png_tail", post)):
            mine = iv.intersect(left, claim)
            out[key] += iv.length(mine)
            left = iv.subtract(left, mine)
    total = cards * (w1 - w0)
    out = {k: 100.0 * v / total for k, v in out.items()}
    out["residual"] = out["idle"] - (out["in_items"] + out["before_items"]
                                     + out["png_tail"])
    return out


def per_file_ms(spans, per_ms: float = 1e6) -> dict:
    """Per cli.main call, in ms: read, solve_setup, solve (solve.loop +
    fetch), png, cli_self (cli.main less what its children cover), call
    (the mean cli.main), residual (call less the five) and calls; the
    spans' times are in units of 1 / per_ms ms (ns; 1e3 for trace us)."""
    calls = _named(spans, "cli.main")
    n = len(calls)
    if not n:
        return {}
    ids = {c["id"] for c in calls}

    def total(*names):
        return sum(s["t1"] - s["t0"] for s in spans
                   if s["name"] in names and s["parent"] in ids)

    own = 0
    for c in calls:
        kids = iv.union([[s["t0"], s["t1"]] for s in spans
                         if s["parent"] == c["id"]])
        own += (c["t1"] - c["t0"]) - iv.length(
            iv.intersect(kids, [[c["t0"], c["t1"]]]))
    out = {"read": total("read"), "solve_setup": total("solve.setup"),
           "solve": total("solve.loop", "fetch"), "png": total("png"),
           "cli_self": own}
    out = {k: v / n / per_ms for k, v in out.items()}
    out["call"] = sum(c["t1"] - c["t0"] for c in calls) / n / per_ms
    out["residual"] = out["call"] - sum(
        out[k] for k in ("read", "solve_setup", "solve", "png", "cli_self"))
    out["calls"] = n
    return out


def _thread(tid) -> int:
    """A thread's id as a trace gives it: the low 32 bits of pthread_self
    (a span's tid) for the thread of a CUDA call."""
    return int(tid) & 0xFFFFFFFF


def fetch_in_copies(spans, events):
    """(any thread, own thread): the shares of fetch spans (trace us,
    mapped()) that hold the host call of a device -> host copy whose
    bytes are the span's `bytes` count, on any thread and on the span's
    own; (None, None) without fetch spans."""
    fetches = _named(spans, "fetch")
    if not fetches:
        return None, None
    copies = {e["args"]["correlation"]: e["args"].get("bytes")
              for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "")
              and "correlation" in e.get("args", {})}
    calls = sorted((e["ts"], e["ts"] + e.get("dur", 0),
                    copies[e["args"]["correlation"]],
                    _thread(e.get("tid", 0)))
                   for e in events
                   if e.get("cat") in capture.HOST_API_CATS
                   and e.get("args", {}).get("correlation") in copies)
    starts = [c[0] for c in calls]
    anywhere = own = 0
    for f in fetches:
        inside = [c for c in calls[bisect.bisect_left(starts, f["t0"]):
                                   bisect.bisect_right(starts, f["t1"])]
                  if c[1] <= f["t1"] and c[2] == f["attrs"]["bytes"]]
        anywhere += bool(inside)
        own += any(c[3] == _thread(f["tid"]) for c in inside)
    return anywhere / len(fetches), own / len(fetches)


def metrics(spans, busy, w0, w1, mp, events) -> dict:
    """The per-layer metrics the spans give, for spans in the trace's us
    (mapped()), under the names a cell would report them by (None where
    the run has nothing for one)."""
    out = {}
    if _named(spans, "item"):
        sh = idle_shares(spans, busy, w0, w1)
        out["idle_in_items_share.batch"] = sh["in_items"]
        out["idle_before_items_share.batch"] = sh["before_items"]
        out["idle_png_tail_share.batch"] = sh["png_tail"]
        out["fetch_mb_per_mp.batch"] = (
            sum(f["attrs"]["bytes"] for f in _named(spans, "fetch"))
            / 1e6 / mp if mp else None)
    else:
        ms = per_file_ms(spans, per_ms=1e3)
        for key in ("read", "solve_setup", "solve", "png", "cli_self"):
            out[f"{key}_ms.single"] = ms.get(key)
    return out
