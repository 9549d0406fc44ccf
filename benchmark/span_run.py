"""Run one cell of the benchmark with the program's spans recorded, and
print the per-layer numbers they give (benchmark/trace/spans.py):

    python3 benchmark/span_run.py --workload <cell> --seed <n> \
        --seconds <s> [--trace 1] [--record 0|1]

--trace 1 (the default) runs the cell as `benchmark/run.py --trace 1`
does, with the spans recorded inside the traced window and laid on the
device trace by two clock pairs: the idle shares of the batch cells, the
fetch bytes per MP, the per-file stage means of the per-file cell, and
the checks on them (the pairs' offsets, the shares of fetch spans that
hold their copy, both residuals, the mean cli.main against the
requests' latencies).  --trace 0 --record 1 runs the untraced cell with
the spans recorded from set-up to the check (their cost); --record 0
runs it plain.  The harness's result line comes first, then one JSON
line of the spans' numbers, last.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.trace import capture, spans  # noqa: E402


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def analyse(seen: dict, cards: int) -> dict:
    """The spans' numbers from a traced run's sink, events and record."""
    events, sink, record = seen["events"], seen["sink"], seen["record"]
    w0, w1, a0, a1 = spans.mark_times(events, cards)
    p0, p1 = sink["clock"]
    to_us, off0, off1, rate = spans.clock_map(p0, a0, p1, a1)
    on_trace = spans.mapped(sink["spans"], to_us)
    busy = spans.card_busy(events, cards, w0, w1)
    out = {"metrics": spans.metrics(on_trace, busy, w0, w1, record["mp"],
                                    events),
           "pair_offsets_us": [off0, off1], "pair_drift_us": off1 - off0,
           "rate": rate, "start_mark_offset_us": w0 - p0 / 1e3 - off0,
           "spans": len(on_trace)}
    share, own = spans.fetch_in_copies(on_trace, events)
    out["fetch_in_copy_share"], out["fetch_in_copy_own_thread"] = share, own
    lengths = sorted(s["t1"] - s["t0"] for s in on_trace
                     if s["name"] == "fetch")
    log(f"clock pairs: offsets {off0:.1f} / {off1:.1f} us (trace less "
        f"clock), {off1 - off0:.1f} us apart over {(a1 - a0) / 1e6:.3f} s; "
        f"rate {rate:.9f}; the start mark {out['start_mark_offset_us']:.1f}"
        f" us off the first pair's map; {len(on_trace)} spans")
    log("fetch spans holding their device -> host copy: "
        + ("none recorded" if share is None else
           f"{100 * share:.2f}% of {len(lengths)} (median length "
           f"{lengths[len(lengths) // 2]:.1f} us), on their own thread "
           f"{100 * own:.2f}%"))
    if any(s["name"] == "item" for s in on_trace):
        sh = spans.idle_shares(on_trace, busy, w0, w1)
        out["idle"] = sh
        log(f"idle {sh['idle']:.2f}% = in items {sh['in_items']:.2f} + "
            f"before items {sh['before_items']:.2f} + png tail "
            f"{sh['png_tail']:.2f} + residual {sh['residual']:.2f}")
    else:
        ms = spans.per_file_ms(sink["spans"])
        lat = [1e3 * x for x in record["latencies_s"]]
        ms["latency_mean"] = statistics.fmean(lat) if lat else None
        out["per_file"] = ms
        log("per file (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items() if k != "calls")
            + f"; {ms.get('calls')} calls, {len(lat)} requests")
    return out


def record_traced(seen: dict) -> None:
    """Make the harness's traced run record the program's spans in its
    window (spans.traced), and keep its sink, its events and its record
    in `seen` for analyse()."""
    summarize, reader = capture.summarize, harness.reader

    def traced(cards, sink):
        seen["sink"] = sink
        return spans.traced(cards, sink)

    def summarize_kept(events, cards):
        seen["events"] = events
        return summarize(events, cards)

    def reader_seen(name):
        read = reader(name)

        def read_seen(record):
            seen["record"] = record
            return read(record)
        return read_seen

    capture.traced, capture.summarize = traced, summarize_kept
    harness.reader = reader_seen


def record_untraced(seen: dict) -> None:
    """Make the harness's run record the program's spans from set-up to
    the check; `seen["n"]` counts them."""
    from jpeg2png_tpu_torch.utils import profiling

    run = harness.run

    def run_recorded(*a, **kw):
        with profiling.recording() as kept:
            result = run(*a, **kw)
        seen["n"] = len(kept)
        return result

    harness.run = run_recorded


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    seen = {}
    if args.trace:
        record_traced(seen)
    elif args.record:
        record_untraced(seen)
    rc = harness.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", str(args.trace)])
    if rc:
        return rc
    out = {"workload": args.workload, "seed": args.seed,
           "trace": args.trace, "record": args.record}
    if args.trace:
        spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
        cards = harness.load_cell(args.workload, spec)["chips"]
        out.update(analyse(seen, cards))
    else:
        out["spans"] = seen.get("n", 0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
