"""A torch.profiler trace of the measured window and what it says.

The profiler records the CUDA activity alone (kernels, copies and
memsets on every card, and every host thread's CUDA calls), not the
host's aten ops, whose recording would slow the host-bound layers it is
meant to see.  The window is marked on the host by a device synchronise
at its start and at its end.  summarize() reduces the trace to:

  window_s                the marked window;
  busy_s                  [per card, the seconds of the window in which a
                          kernel, copy or memset ran on it];
  kernel_s                the summed durations of every CUDA kernel;
  device_ops              [(name, seconds)], the largest ten, named by
                          K-number or by what a PyTorch op computes;
  idle_gaps               [(what the host was doing, seconds)], the ten
                          longest stretches in which no card was busy,
                          each named by the host class that took most of
                          it (a synchronise, a copy or allocation, a
                          launch, another CUDA call, or none: python).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

from benchmark.trace import intervals as iv

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
MARK = "cudaDeviceSynchronize"


def _mark(cards: int) -> None:
    for d in range(cards):
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def traced(cards: int, sink: dict):
    """Trace the block's CUDA activity; on exit sink["events"] holds the
    trace's events."""
    from torch.profiler import ProfilerActivity, profile

    _mark(cards)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _mark(cards)
        yield
        _mark(cards)
        t0 = time.perf_counter()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        t2 = time.perf_counter()
        with open(path) as f:
            sink["events"] = json.load(f)["traceEvents"]
    sink["seconds"] = {"stop": t1 - t0, "export": t2 - t1,
                       "load": time.perf_counter() - t2}


def summarize(events, cards: int) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    marks = sorted(e["ts"] + e.get("dur", 0) for e in xs
                   if e.get("cat") in HOST_API_CATS and e.get("name") == MARK)
    if len(marks) < 2:
        raise RuntimeError("the trace holds no window marks")
    # the first card's synchronise at each end: the marks of one end are
    # `cards` calls in a row
    w0, w1 = marks[cards - 1], marks[-1]
    window = [[w0, w1]]
    per_card, by_name, kernel_us, names = {}, {}, 0.0, {}
    host = {c: [] for c in iv.HOST_CLASSES[:-1]}
    for e in xs:
        cat, a = e.get("cat"), e["ts"]
        b = a + e.get("dur", 0)
        if cat in HOST_API_CATS:
            name = e["name"]
            if name not in names:
                names[name] = iv.host_class(name)
            host[names[name]].append([a, b])
        elif cat in DEVICE_CATS and w0 <= a <= w1:
            per_card.setdefault(int(e.get("args", {}).get("device", 0)),
                                []).append([a, b])
            name = ("dev", e["name"])
            if name not in names:
                names[name] = iv.device_op_name(e["name"])
            by_name[names[name]] = by_name.get(names[name], 0.0) + (b - a)
            if cat == "kernel":
                kernel_us += b - a
    if not per_card:
        raise RuntimeError("no kernel, copy or memset ran in the window")
    # a card the trace never saw was idle all through
    busy = [iv.length(iv.intersect(iv.union(v), window)) / 1e6
            for _, v in sorted(per_card.items())]
    busy += [0.0] * (cards - len(busy))
    gaps = iv.subtract(window, iv.union([ab for v in per_card.values()
                                         for ab in v]))
    host = {c: iv.union(v) for c, v in host.items()}
    named = []
    for g in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        left, share = [g], {}
        for c in iv.HOST_CLASSES[:-1]:
            mine = iv.intersect(left, host[c])
            share[c] = iv.length(mine)
            left = iv.subtract(left, mine)
        share["python"] = iv.length(left)
        named.append((max(share, key=share.get), (g[1] - g[0]) / 1e6))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy,
            "kernel_s": kernel_us / 1e6,
            "device_ops": [(n, us / 1e6) for n, us in ops],
            "idle_gaps": named}
