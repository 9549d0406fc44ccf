"""Profiling and tracing helpers.

The counterpart of jpeg2png_tpu/utils/profiling.py.  The reference ships
clock() timer macros and gprof hooks (utils.h:64-65, Makefile:61-63); the
JAX package captures XLA device traces.  Here:

  * device_trace: a torch.profiler trace (host and CUDA activity: CUPTI
    sees the hand-written kernels, which launch through ctypes, like
    PyTorch's own), exported as a Chrome/Perfetto trace;
  * trace_breakdown: one solve's time per iteration split into the
    hand-written kernels (by K-number), PyTorch's small device ops, the
    device's idle time and what the host was doing meanwhile — the
    question the kernel timers cannot answer;
  * kernel_cost_table: the bytes and operations each kernel K1-K7 must
    move or do at given shapes, and the least time an H100 could take for
    them (the bounds of chip_smoke.py's kernel records and PERF.md);
  * span / recording / within / count / collected: the port's spans, one
    per layer boundary (the CLI call, a file's read, a solve's set-up and
    loop, the pixel fetch, a PNG write, the runner's read and solve pools,
    work items and pixel callbacks), on time.perf_counter_ns and the
    thread's id, kept in memory inside recording() and nowhere else; the
    runner's stage seconds are read from them.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Optional

# ----------------------------------------------------------------- bounds

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, f32 flop/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# operations per pixel and channel of K1 (extrapolation 3, differences
# 2, TV norm and gather 12, TGV2 differences, norm and 7-point gather
# 43) and per coefficient of K2 (three 8x8 transform pairs: 3 * 2 * 16
# flops) — counted from the kernels' formulas
K1_OPS_PER_CHANNEL_PIXEL = 60
K2_OPS_PER_COEF = 96 + 8


def bytes_k1(C, P, H, W, halo=False):
    """Bytes of one K1 / K7 launch, whatever the kernel's grid: f, fista
    and the prob gradient in, grad and extrap out, the C + 2 sums out, and
    for a band (K7) its four halo arrays [C, 2, W] in."""
    return (4 * H * W * (2 * C + P) + 4 * H * W * 2 * C + 4 * (C + 2)
            + (4 * 4 * C * 2 * W if halo else 0))


def bytes_k2(C, P, H, W, samps, prob):
    """Bytes of one K2 / K6 launch: extrap and grad in, f out per pixel
    and channel; per coefficient the boxes (and dq, 1/q where the prob
    term is on) in; the next prob gradient out per prob channel."""
    coef = sum(4 * (H // sy) * (W // sx) * (4 if p else 2)
               for (sy, sx), p in zip(samps, prob))
    return 4 * H * W * 2 * C + coef + 4 * H * W * (C + P)


def bound_k3(C, H, W, samps, prob, nsteps, lite=False):
    """(bytes, operations) of one K3 launch: each input read once and
    each output written once (f in and out; fista, or the lite mode's
    bf16 d, in and out; int16 data and quant rasters in; devq in and out
    per prob channel, f32 or bf16; factors; the partial rows), and
    nsteps iterations of the two-kernel body's operations (K1 + K2, or
    the lite mode's K4 + K5)."""
    coefs = [(H // sy) * (W // sx) for sy, sx in samps]
    side = 2 if lite else 4
    nbytes = ((8 + 2 * side) * C * H * W + sum(6 * n for n in coefs)
              + sum(2 * side * n for n, p in zip(coefs, prob) if p)
              + 4 * nsteps + 4 * 8 * nsteps)
    if lite:
        per_iter = (bound_k4(C, H, W, samps, prob)[1]
                    + bound_k5(C, H, W, samps, prob)[1])
    else:
        per_iter = (K1_OPS_PER_CHANNEL_PIXEL * C * H * W
                    + K2_OPS_PER_COEF * sum(coefs))
    return nbytes, nsteps * per_iter


def bound_k4(C, L, W, samps, prob):
    """(bytes, operations) of one K4 launch: f (f32) and d (bf16) in, the
    bf16 gradient out, per prob channel the bf16 devq in, the C + 2 sums
    out; K1's stencil operations per pixel and channel plus two 8-term
    transform passes (32 operations) per prob coefficient and the add."""
    pc = sum((L // sy) * (W // sx) for (sy, sx), p in zip(samps, prob) if p)
    nbytes = 8 * C * L * W + 2 * pc + 4 * (C + 2)
    ops = (K1_OPS_PER_CHANNEL_PIXEL * C * L * W + 32 * pc
           + 2 * L * W * sum(prob))
    return nbytes, ops


def bound_k5(C, H, W, samps, prob):
    """(bytes, operations) of one K5 launch: f (f32), d and g (bf16) in,
    fnew (f32) and dnew (bf16) out per pixel and channel; int16 data and
    f32 quant in and, per prob channel, bf16 devq out per coefficient;
    the C distances out.  Operations: two 8x8 transform pairs (64) and
    the box, clamp and devq (8) per coefficient, 6 per pixel and
    channel (e, fmid, the reconstruction, dnew)."""
    coefs = [(H // sy) * (W // sx) for sy, sx in samps]
    nbytes = (14 * C * H * W + 6 * sum(coefs)
              + 2 * sum(n for n, p in zip(coefs, prob) if p) + 4 * C)
    return nbytes, 72 * sum(coefs) + 6 * C * H * W


def bound_ms(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for `nbytes` of
    device memory traffic and `ops` f32 operations, and which bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_cost_table(C, H, W, samps, prob=None, nsteps=50,
                      band_rows=None) -> dict:
    """{K: {"bytes", "ops", "bound_ms", "bound_by"}} for one launch of
    each kernel: K1, K2, K3 and K3 lite (`nsteps` iterations a launch),
    K4 and K5 on the [C, H, W] canvas at sampling `samps` (prob: per
    channel whether its prob term is on, default all); K7 on a band of
    `band_rows` rows (default H) of it, with halos, and K6 on channel 0's
    band of those rows (the one-channel -s solve)."""
    prob = [True] * C if prob is None else list(prob)
    P = sum(prob)
    L = H if band_rows is None else int(band_rows)
    coefs = sum((H // sy) * (W // sx) for sy, sx in samps)
    sy0, sx0 = samps[0]
    L0, W0 = L // sy0, W // sx0
    costs = {
        "K1": (bytes_k1(C, P, H, W), K1_OPS_PER_CHANNEL_PIXEL * C * H * W),
        "K2": (bytes_k2(C, P, H, W, samps, prob), K2_OPS_PER_COEF * coefs),
        "K3": bound_k3(C, H, W, samps, prob, nsteps),
        "K3 lite": bound_k3(C, H, W, samps, prob, nsteps, lite=True),
        "K4": bound_k4(C, H, W, samps, prob),
        "K5": bound_k5(C, H, W, samps, prob),
        "K6": (bytes_k2(1, int(prob[0]), L0, W0, [(1, 1)], prob[:1]),
               K2_OPS_PER_COEF * L0 * W0),
        "K7": (bytes_k1(C, P, L, W, halo=True),
               K1_OPS_PER_CHANNEL_PIXEL * C * L * W),
    }
    table = {}
    for k, (nbytes, ops) in costs.items():
        ms, by = bound_ms(nbytes, ops)
        table[k] = {"bytes": nbytes, "ops": ops, "bound_ms": ms,
                    "bound_by": by}
    return table


def format_cost_table(table: dict) -> str:
    return "\n".join(
        f"{k:>8}: {r['bytes']:.4e} B  {r['ops']:.4e} ops  bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})" for k, r in table.items())


# ------------------------------------------------------------------ spans

class Span:
    """One stretch of the port's work at a layer boundary: its name,
    start and end (time.perf_counter_ns), the thread it ran on
    (threading.get_ident(), pthread_self, whose low 32 bits a
    torch.profiler trace gives the thread of a CUDA call in some runs),
    its id, its parent's id and its request's id, and its attributes and
    counts.  Outside
    recording() only the name, the clock readings and the attributes are
    set."""

    __slots__ = ("name", "t0", "t1", "tid", "id", "parent", "request",
                 "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.t0 = self.t1 = 0
        self.tid = self.id = self.parent = self.request = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


# the list spans are appended to (recording()), or None
_sink: Optional[list] = None
_local = threading.local()      # .stack: this thread's open spans;
                                # .collect: collected()'s (name, list)s
_ids = itertools.count(1)       # next() holds the interpreter lock


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def recording():
    """Record every span that closes inside the block, on any thread;
    yields the list they are appended to, in the order they close.

        with recording() as spans:
            cli.main(argv)
    """
    global _sink
    outer, _sink = _sink, []
    try:
        yield _sink
    finally:
        _sink = outer


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time the block (or, as a decorator, each call) as a span named
    `name` with attributes `attrs`; yields the Span (its clock readings
    are set once the block ends, also when it raises).  Inside
    recording() its parent is the innermost span open on this thread
    (within() hands one to another thread); a span without one starts a
    request, whose id its descendants carry.  Outside recording() nothing
    is kept: the span costs its object, its two clock readings and one
    check."""
    sp = Span(name, attrs)
    sink = _sink
    if sink is None:
        sp.t0 = time.perf_counter_ns()
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter_ns()
            _collect(sp)
        return
    stack = _open()
    up = stack[-1] if stack else None
    sp.id = next(_ids)
    sp.parent, sp.request = (up.id, up.request) if up else (None, sp.id)
    sp.tid = threading.get_ident()
    stack.append(sp)
    sp.t0 = time.perf_counter_ns()
    try:
        yield sp
    finally:
        sp.t1 = time.perf_counter_ns()
        stack.pop()
        sink.append(sp)
        _collect(sp)


def _collect(sp: Span) -> None:
    for name, got in getattr(_local, "collect", ()):
        if name == sp.name:
            got.append(sp)


@contextlib.contextmanager
def collected(name: str):
    """Yield a list that receives every span named `name` that closes on
    this thread inside the block, inside recording() or not: the runner
    reads its stats from the spans of the callbacks it runs."""
    lists = getattr(_local, "collect", None)
    if lists is None:
        lists = _local.collect = []
    got = []
    lists.append((name, got))
    try:
        yield got
    finally:
        lists.pop()


def current() -> Optional[Span]:
    """The innermost span open on this thread inside recording(), or
    None: the parent to hand to work another thread runs (within())."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def within(parent: Optional[Span]):
    """Open the block's spans on this thread as children of `parent`, a
    span open on another thread (current() there): work handed to a pool
    names the span that handed it over."""
    if parent is None or _sink is None:
        yield
        return
    stack = _open()
    stack.append(parent)
    try:
        yield
    finally:
        stack.pop()


def count(sp: Span, name: str, n) -> None:
    """Add `n` to the count `name` of the open span `sp`."""
    sp.attrs[name] = sp.attrs.get(name, 0) + n


# ----------------------------------------------------------------- traces

# the span device_trace records around the traced block (the window that
# trace_breakdown divides)
WINDOW = "jpeg2png_tpu_torch.device_trace"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")

# CUDA kernel name (csrc/*.cu) -> the kernels (K-numbers) whose wrapper
# launches it; the first kernel of each wrapper counts its launches
KERNELS = {
    "grad_kernel": ("K1", "K7"),
    "reduce_columns": ("K1", "K7", "K4"),
    "project_kernel": ("K2",),
    "project_one_kernel": ("K6",),
    "reduce_dists": ("K2", "K6", "K5"),
    "solve_kernel": ("K3", "K3 lite"),
    "grad_lite_kernel": ("K4",),
    "project_lite_kernel": ("K5",),
}
LAUNCH_KERNELS = ("grad_kernel", "project_kernel", "project_one_kernel",
                  "solve_kernel", "grad_lite_kernel", "project_lite_kernel")
# kernel wrapper (its `launches` counter) -> K-number
WRAPPERS = {"fused_grad": "K1", "fused_project_multi": "K2",
            "fused_solve": "K3", "fused_solve_lite": "K3 lite",
            "fused_grad_striped_lite": "K4",
            "fused_project_multi_lite": "K5", "fused_project": "K6",
            "fused_grad_striped": "K7"}


def launch_counters() -> list:
    """The kernel wrappers, each with its `launches` count (WRAPPERS'
    order)."""
    from jpeg2png_tpu_torch.kernels import (grad_step, iter_step,
                                            project_step, stripe_grad)

    return [grad_step.fused_grad, project_step.fused_project_multi,
            iter_step.fused_solve, iter_step.fused_solve_lite,
            stripe_grad.fused_grad_striped_lite,
            project_step.fused_project_multi_lite, project_step.fused_project,
            stripe_grad.fused_grad_striped]


def zero_launch_counts() -> None:
    for fn in launch_counters():
        fn.launches = 0


def read_launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in launch_counters()}


# host activity during device idle, in the order a moment is claimed
HOST_CLASSES = ("sync", "memcpy/alloc", "launch", "other CUDA API",
                "torch ops", "python")


@contextlib.contextmanager
def device_trace(logdir, device="cuda", host=True):
    """Trace the block with torch.profiler (CUDA activity for a CUDA
    `device`: kernels, copies, memsets and the CUDA calls of every host
    thread; with `host`, the aten ops of the calling thread too, the block
    marked as one span), the device synchronised at its end; on exit write
    logdir/trace.json (Chrome / Perfetto).  Yields the profile
    (trace_breakdown reads it).  Recording aten ops costs host time (a few
    µs an op), which a host-bound loop shows as device idle: host=False
    keeps the profiler to the CUDA activity, whose split of the wall time
    is the one to hold against an untraced run.  On a CUDA device a trace
    with no device activity raises RuntimeError: never an empty breakdown.

        with device_trace("/tmp/trace") as prof:
            run_solve(...)
        trace_breakdown(prof, iterations)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device(device)
    if not host and dev.type != "cuda":
        raise ValueError("a trace without host activity needs a CUDA device")
    acts = [ProfilerActivity.CPU] if host else []
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        prof.trace_events = json.load(f)["traceEvents"]
    if dev.type == "cuda" and not any(
            e.get("cat") in DEVICE_CATS for e in prof.trace_events):
        raise RuntimeError(
            f"device_trace: no CUDA activity recorded on {dev} (the "
            f"profiler saw no kernel, copy or memset); trace in {path}")


def trace_events(prof) -> list:
    """The Chrome-trace events of a device_trace profile (or of any
    torch.profiler profile, exported to a temporary file)."""
    events = getattr(prof, "trace_events", None)
    if events is not None:
        return events
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersect(xs, ys):
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys):
    """xs minus ys, both sorted disjoint interval lists."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append([a, ys[k][0]])
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def _length(ivs) -> float:
    return sum(b - a for a, b in ivs)


def _kernel_base(name: str) -> str:
    """`void (anonymous namespace)::grad_kernel<3, true>(Params)` ->
    `grad_kernel`."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)", "anonymous")
    head = head.split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].strip()


# PyTorch's device ops, named by what they compute: (a piece of the CUDA
# kernel's or copy's name, the name given)
SMALL_OPS = (("CatArrayBatchedCopy", "cat"), ("where_kernel", "where"),
             ("CompareEqFunctor", "eq"), ("sqrt_kernel", "sqrt"),
             ("reciprocal_kernel", "reciprocal"), ("FillFunctor", "fill"),
             ("direct_copy_kernel", "copy"), ("MulFunctor", "mul"),
             ("_add", "add"), ("DivFunctor", "div"), ("div_", "div"),
             ("sum_functor", "sum"), ("gemm", "gemm"),
             ("scatter_gather", "scatter/gather"), ("gather", "gather"),
             ("Memcpy HtoD", "copy host to device"),
             ("Memcpy DtoH", "copy device to host"),
             ("Memcpy DtoD", "copy device to device"), ("Memset", "memset"))


def _small_op(name: str) -> str:
    for piece, short in SMALL_OPS:
        if piece in name:
            return short
    return _kernel_base(name)[:60]


def _host_class(name: str) -> str:
    if "Synchronize" in name or name in ("cudaStreamWaitEvent",
                                         "cudaEventQuery", "cudaStreamQuery"):
        return "sync"
    if name.startswith(("cudaMemcpy", "cuMemcpy", "cudaMalloc", "cuMemAlloc",
                        "cudaFree", "cuMemFree", "cudaMemset", "cuMemset",
                        "cudaHostAlloc", "cudaHostRegister")):
        return "memcpy/alloc"
    if "Launch" in name:
        return "launch"
    return "other CUDA API"


def _outermost_ops(cpu_ops) -> list:
    """The cpu_op events not inside another one on their host thread."""
    by_tid = {}
    for e in sorted(cpu_ops, key=lambda e: (e["ts"], -e.get("dur", 0))):
        top = by_tid.setdefault(e["tid"], [])
        if not top or e["ts"] >= top[-1]["ts"] + top[-1].get("dur", 0):
            top.append(e)
    return [e for t in by_tid.values() for e in t]


def trace_breakdown(prof, iterations: int, launched=None) -> dict:
    """Split a device_trace window into per-iteration microseconds.

    prof: the profile device_trace yielded (or its list of Chrome-trace
    events).  iterations: the divisor (solver iterations, or solves).
    launched: the kernel wrappers' launch counts over the window
    ({wrapper name: n}, as the `launches` counters give them): a CUDA
    kernel that several wrappers share (K1 and K7 run one kernel) is named
    by the one that launched; None names it by all of them ("K1/K7").

    Returns a dict, every time in us per iteration:
      wall_us: the traced window; device_busy_us: the union of device
        activity in it (kernels, copies, memsets on every stream);
      kernels: {K: {"us", "launches" (per iteration), "by_name": {CUDA
        kernel: us}}} for the hand-written kernels;
      small_ops: {what it computes: {"us", "launches"}} for every other
        device op (PyTorch's kernels and copies, SMALL_OPS' names: sqrt,
        where, eq, cat (torch.cat and torch.stack), copy, copy host to
        device ...);
      idle_us: the window minus device_busy_us; idle_by_stream_us: the
        window minus each stream's own activity;
      host_in_idle_us: what the host was doing while the device idled,
        each moment claimed once in HOST_CLASSES order: sync (waiting in
        a synchronise), memcpy/alloc, launch (cudaLaunchKernel and
        friends), other CUDA API, torch ops (host time inside aten ops
        outside the CUDA API), python (none of these: the interpreter
        between launches);
      launches: device ops per iteration;
      launch_to_start_us: median and max microseconds from a launch call's
        start on the host to its op's start on the device (small: the
        device waits for the host; large: the host runs ahead);
      by_device: {device index: {"busy_us", "idle_us"}} (several cards);
      host_threads_us: {host thread: time inside aten ops or CUDA calls}
        (the time a thread spends in Python is not in the trace);
      cuda_calls: {CUDA call: calls per iteration};
      timeline_us: the whole window's time (not per iteration) before the
        first hand-written kernel starts (and the device's busy time in
        it), from there to the last one's end (and the device's idle time
        in it), and after it: with one solve traced, its set-up, its loop
        and its tail;
      loop_us: the window from the first hand-written kernel's start to
        the last one's end split per iteration into "kernels" ({K: us}),
        "small_ops" (the other device ops' time inside it), "idle" (the
        device's gaps inside it), "sum" of the three and "wall" (the
        window itself; the sum exceeds it only where device ops overlap):
        with one solve traced, its iteration loop without the set-up
        before it and the fetch after it, the split to hold against an
        untraced marginal time per iteration.
    """
    events = prof if isinstance(prof, list) else trace_events(prof)
    n = float(iterations)
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    wins = [e for e in xs if e.get("name") == WINDOW]
    if wins:
        w0 = min(e["ts"] for e in wins)
        w1 = max(e["ts"] + e["dur"] for e in wins)
    else:
        timed_evs = [e for e in xs if e.get("cat") != "Trace"]
        w0 = min(e["ts"] for e in timed_evs)
        w1 = max(e["ts"] + e.get("dur", 0) for e in timed_evs)
    window = [[w0, w1]]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    api = [e for e in xs if e.get("cat") in HOST_API_CATS]
    cpu_ops = [e for e in xs if e.get("cat") == "cpu_op"]
    api_by_corr = {e["args"]["correlation"]: e for e in api
                   if "correlation" in e.get("args", {})}
    wrappers = {WRAPPERS[k] for k, v in (launched or {}).items()
                if v and k in WRAPPERS}

    kernels, small, lags, per_stream, per_device = {}, {}, [], {}, {}
    for e in dev:
        dur = e.get("dur", 0)
        args = e.get("args", {})
        per_stream.setdefault(args.get("stream"), []).append(
            [e["ts"], e["ts"] + dur])
        per_device.setdefault(args.get("device"), []).append(
            [e["ts"], e["ts"] + dur])
        call = api_by_corr.get(args.get("correlation"))
        if call is not None:
            lags.append(e["ts"] - call["ts"])
        base = _kernel_base(e["name"]) if e.get("cat") == "kernel" else None
        if base in KERNELS:
            cands = [k for k in KERNELS[base] if k in wrappers] or list(
                KERNELS[base])
            k = "/".join(cands)
            rec = kernels.setdefault(k, {"us": 0.0, "launches": 0.0,
                                         "by_name": {}})
            rec["us"] += dur / n
            rec["by_name"][base] = rec["by_name"].get(base, 0.0) + dur / n
            if base in LAUNCH_KERNELS:
                rec["launches"] += 1 / n
            continue
        rec = small.setdefault(_small_op(e["name"]), {"us": 0.0,
                                                      "launches": 0.0})
        rec["us"] += dur / n
        rec["launches"] += 1 / n

    busy = _intersect(_union([[e["ts"], e["ts"] + e.get("dur", 0)]
                              for e in dev]), window)
    gaps = _subtract(window, busy)
    host = {c: [] for c in HOST_CLASSES[:-1]}
    for e in api:
        host[_host_class(e["name"])].append(
            [e["ts"], e["ts"] + e.get("dur", 0)])
    host["torch ops"] = [[e["ts"], e["ts"] + e.get("dur", 0)]
                         for e in _outermost_ops(cpu_ops)]
    claimed, in_idle = [], {}
    for c in HOST_CLASSES[:-1]:
        mine = _subtract(_intersect(gaps, _union(host[c])), claimed)
        in_idle[c] = _length(mine) / n
        claimed = _union(claimed + mine)
    in_idle["python"] = _length(_subtract(gaps, claimed)) / n
    lags.sort()
    threads = {}
    for e in cpu_ops + api:
        threads.setdefault(e["tid"], []).append(
            [e["ts"], e["ts"] + e.get("dur", 0)])

    def busy_idle(ivs):
        b = _length(_intersect(_union(ivs), window))
        return {"busy_us": b / n, "idle_us": (w1 - w0 - b) / n}

    calls = {}
    for e in api:
        calls[e["name"]] = calls.get(e["name"], 0.0) + 1 / n
    hand = [[e["ts"], e["ts"] + e.get("dur", 0)] for e in dev
            if e.get("cat") == "kernel" and _kernel_base(e["name"]) in KERNELS]
    timeline = loop = None
    if hand:
        k0, k1 = min(a for a, _ in hand), max(b for _, b in hand)
        idle_within = _length(_intersect(gaps, [[k0, k1]]))
        timeline = {
            "before_first_kernel": k0 - w0,
            "device_busy_before": _length(_intersect(busy, [[w0, k0]])),
            "first_to_last_kernel": k1 - k0,
            "device_idle_within": idle_within,
            "after_last_kernel": w1 - k1}
        small_within = sum(
            _length(_intersect([[e["ts"], e["ts"] + e.get("dur", 0)]],
                               [[k0, k1]]))
            for e in dev if not (e.get("cat") == "kernel" and _kernel_base(
                e["name"]) in KERNELS)) / n
        loop_k = {k: r["us"] for k, r in kernels.items()}
        loop = {"kernels": loop_k, "small_ops": small_within,
                "idle": idle_within / n,
                "sum": sum(loop_k.values()) + small_within + idle_within / n,
                "wall": (k1 - k0) / n}

    return {
        "iterations": iterations,
        "wall_us": (w1 - w0) / n,
        "device_busy_us": _length(busy) / n,
        "kernels": kernels,
        "small_ops": small,
        "idle_us": _length(gaps) / n,
        "idle_by_stream_us": {str(s): busy_idle(iv)["idle_us"]
                              for s, iv in per_stream.items()},
        "host_in_idle_us": in_idle,
        "launches": len(dev) / n,
        "launch_to_start_us": ({"median": lags[len(lags) // 2],
                                "max": lags[-1]} if lags else None),
        "by_device": {str(d): busy_idle(iv) for d, iv in per_device.items()},
        "host_threads_us": {str(t): _length(_intersect(_union(iv), window))
                            / n for t, iv in threads.items()},
        "cuda_calls": calls,
        "timeline_us": timeline,
        "loop_us": loop,
    }


def host_op_totals(prof, iterations: int, top: int = 12) -> dict:
    """{outermost host op: us per iteration}, the largest `top`: what a
    CPU run spends its time in (the plain versions' aten ops)."""
    events = prof if isinstance(prof, list) else trace_events(prof)
    tot = {}
    for e in _outermost_ops([e for e in events if e.get("ph") == "X"
                             and e.get("cat") == "cpu_op"]):
        tot[e["name"]] = tot.get(e["name"], 0.0) + e.get("dur", 0) / iterations
    return dict(sorted(tot.items(), key=lambda kv: -kv[1])[:top])


def format_breakdown(bd: dict) -> list:
    """trace_breakdown as "us/iter" lines: the window, each kernel, each
    small op, idle and the host's activity in it."""
    lines = [f"{bd['wall_us']:10.1f} us/iter  wall (traced window)",
             f"{bd['device_busy_us']:10.1f} us/iter  device busy"]
    for k, r in sorted(bd["kernels"].items()):
        names = ", ".join(f"{n} {us:.1f}" for n, us in r["by_name"].items())
        lines.append(f"{r['us']:10.1f} us/iter  {k} ({names}); "
                     f"{r['launches']:.2f} launches/iter")
    for name, r in sorted(bd["small_ops"].items(),
                          key=lambda kv: -kv[1]["us"]):
        lines.append(f"{r['us']:10.1f} us/iter  small op {name} "
                     f"({r['launches']:.2f}/iter)")
    lines.append(f"{bd['idle_us']:10.1f} us/iter  device idle")
    for c, us in bd["host_in_idle_us"].items():
        lines.append(f"{us:10.1f} us/iter    host during idle: {c}")
    lag = bd["launch_to_start_us"]
    lines.append(f"{bd['launches']:10.2f} device ops/iter; launch -> start "
                 + (f"median {lag['median']:.1f} us, max {lag['max']:.1f} us"
                    if lag else "not measured (no device ops)"))
    t = bd["timeline_us"]
    if t is not None:
        lines.append(
            f"{'':10} window: {t['before_first_kernel']:.1f} us before the "
            f"first hand-written kernel (device busy "
            f"{t['device_busy_before']:.1f}), {t['first_to_last_kernel']:.1f}"
            f" us to the last one's end (device idle "
            f"{t['device_idle_within']:.1f}), {t['after_last_kernel']:.1f} "
            "us after")
        lp = bd["loop_us"]
        ks = " + ".join(f"{k} {us:.1f}" for k, us in sorted(
            lp["kernels"].items()))
        lines.append(f"{lp['sum']:10.1f} us/iter  loop (first to last "
                     f"hand-written kernel) = {ks} + small ops "
                     f"{lp['small_ops']:.1f} + idle {lp['idle']:.1f}; its "
                     f"window {lp['wall']:.1f}")
    return lines
