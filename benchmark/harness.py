"""The benchmark of jpeg2png_tpu_torch: one run of one cell.

A cell of BENCHMARK.json names a configuration (benchmark/configs/
<config>.json: the CLI flags, the sample the check compares and its
limits) and a traffic mix (benchmark/traffic/<mix>.json: the entry, the
files' sizes and qualities).  A run

  1. mints or loads the seed's JPEGs (benchmark/inputs/): the
     benchmark's own work, timed and left out of setup_s, so that
     setup_s does not depend on whether an earlier run cached the seed,
  2. imports the program, and warms it with one unit of the cell's own
     traffic (a call, or a cycle of per-file calls): set-up ends here,
  3. runs whole units back to back until --seconds have passed (the last
     unit started counts in full), traced with --trace 1,
  4. reads the device's memory peak, checks that neither JAX nor the JAX
     package was loaded, and reads the metrics: each metric is a reader
     of its own, benchmark/metrics/<name>.py, over the run's record,
  5. decides `correct` (benchmark/verify.py): every answer exists, and
     the sampled files' PNGs lie within the configuration's limits of the
     plain reference (benchmark/reference/),
  6. prints the numbers compared beside their limits, and last one JSON
     line.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg2png_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start on the wall clock (Linux /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_cell(name: str, spec: dict) -> dict:
    """The cell `name` of a BENCHMARK.json dict, with its configuration,
    its traffic and its metrics resolved."""
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(m):
        if "workloads" in m:
            return name in m["workloads"]
        return True

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    moves = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if mine(m) and ("workloads" in m or m["moves"] in moves)]
    return {"name": name, "chips": int(cell["chips"]), "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    """benchmark/metrics/<name>.py's read(record) -> a number or None."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def solve_settings(flags) -> dict:
    """weight, pweight, iterations of a configuration's CLI flags."""
    out = {"weight": 0.3, "pweight": 0.001, "iterations": 50}
    names = {"-w": "weight", "-p": "pweight", "-i": "iterations"}
    for flag, value in zip(flags, flags[1:]):
        if flag in names:
            out[names[flag]] = (int(value) if flag == "-i" else float(value))
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
        t_start=None) -> dict:
    """One run of a resolved cell; returns the result dict (the last line).
    device "cpu" runs the program's plain path (tests only)."""
    import numpy as np
    import torch

    from benchmark import verify
    from benchmark.inputs.corpus import corpus
    from benchmark.trace import capture
    from benchmark.trace.work import canvas, least_seconds

    t_start = time.time() if t_start is None else t_start
    config, traffic = cell["config"], cell["traffic"]
    cards = cell["chips"] if device == "cuda" else 1
    flags = list(config["flags"]) + (["--device", "cpu"] if device == "cpu"
                                     else [])
    settings = solve_settings(config["flags"])
    t_inputs = time.perf_counter()
    items = corpus(seed, traffic, log=log)
    inputs_s = time.perf_counter() - t_inputs
    entry_cls = importlib.import_module(
        f"benchmark.entries.{traffic['entry']}").Entry
    workdir = tempfile.mkdtemp(prefix="j2p-bench-")
    try:
        entry = entry_cls(items, flags, workdir, seed)
        warm, _ = entry.run(-1)
        for r in warm:
            if r.ok:
                os.remove(r.out)
        record = {"cards": cards, "requests": [], "stats": [], "trace": None}
        sink = {}
        tracing = (capture.traced(cards, sink) if trace
                   else contextlib.nullcontext())
        wall0 = time.time()
        record["setup_s"] = wall0 - t_start - inputs_s
        log(f"set-up {record['setup_s']:.3f} s (the inputs' "
            f"{inputs_s:.3f} s left out); window of {seconds} s")
        cpu0 = sum(os.times()[:2])
        with tracing:
            t0 = time.perf_counter()
            k = 0
            while k == 0 or time.perf_counter() - t0 < seconds:
                reqs, stats = entry.run(k)
                record["requests"] += reqs
                if stats is not None:
                    record["stats"].append(stats)
                k += 1
            t1 = time.perf_counter()
        record["window_s"] = t1 - t0
        # how many cores the program kept busy: a window that does less
        # work for the same CPU seconds ran on a slower host
        log(f"CPU seconds of this process over the window: "
            f"{sum(os.times()[:2]) - cpu0:.3f} of {record['window_s']:.3f} "
            f"s on {os.cpu_count()} cores")
        peak = (max(torch.cuda.max_memory_allocated(d) for d in range(cards))
                if device == "cuda" else 0)
        found = sorted({m.split(".")[0] for m in sys.modules}
                       & set(FORBIDDEN))
        if found:
            raise SystemExit(f"the window loaded {', '.join(found)}")
        by_index = {it.index: it for it in items}
        done = [r for r in record["requests"] if r.ok]
        record["mp"] = sum(by_index[r.index].megapixels for r in done)
        record["latencies_s"] = [r.t1 - r.t0 for r in done]
        if trace:
            t2 = time.perf_counter()
            record["trace"] = capture.summarize(sink.pop("events"), cards)
            log("trace seconds: " + ", ".join(
                f"{step} {v:.3f}" for step, v in sink["seconds"].items())
                + f", summary {time.perf_counter() - t2:.3f}")
            record["least_s"] = sum(
                least_seconds(*canvas(by_index[r.index].components),
                              settings["iterations"]) for r in done)
        metrics = {}
        for m in (cell["per_layer"] if trace else cell["end_to_end"]):
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        log(f"{len(record['requests'])} requests in {k} "
            f"{entry.unit_name}s over {record['window_s']:.3f} s")
        lat = {}
        for r in done:
            lat.setdefault(r.index, []).append(r.t1 - r.t0)
        log("median s by file (index WxH s): " + "; ".join(
            f"{i} {by_index[i].width}x{by_index[i].height} "
            f"{float(np.median(v)):.4f}" for i, v in sorted(lat.items())))
        # the program's state goes before the reference runs
        del entry
        if device == "cuda":
            torch.cuda.empty_cache()
        check = verify.check(record["requests"], items, config, settings,
                             seed, device, log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cards, "memory_peak_bytes": int(peak)}
    result = {"correct": check["correct"],
              "attempted": len(record["requests"]),
              "failed": sum(1 for r in record["requests"] if not r.ok),
              "metrics": metrics, "device": dev}
    if trace:
        t = record["trace"]
        dev["busy_s"] = float(np.mean(t["busy_s"]))
        dev["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              t["device_ops"]],
                               "idle_gaps": [list(x) for x in t["idle_gaps"]]}
    result["checks"] = check["checks"]
    return result


def main(argv=None) -> int:
    import argparse

    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(args.workload, spec)
    # the program's builds stay in this checkout, at fixed paths
    os.environ.pop("JPEG2PNG_TPU_NO_COMPILE_CACHE", None)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(BENCH / ".cache" / sub)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES",
                          ",".join(str(i) for i in range(cell["chips"])))
    import torch

    import jpeg2png_tpu_torch.cli  # noqa: F401  (the program, or fail here)

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
            f"machine shows {torch.cuda.device_count()}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 t_start=t_start)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0
