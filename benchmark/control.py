"""The control of `correct`, and the program's readings beside it.

The configurations state float32; the reference computes in float32
with TF32 off.  The control is the same reference with TF32 on in its
matrix products (the 8x8 transforms), put where the program's answers
would be: for each seed, the files the configuration's check samples
are solved both ways and held against each other with the numbers the
check compares (benchmark/reference/compare.py).  A control reading
must exceed the configuration's limits, which sit between it and the
program's readings.

With --program, the same process also runs one unit of the traffic's
own entry (a whole --tpu-batch call, or a cycle of per-file calls) for
each seed, and holds the program's answers for the sampled files against
the same reference solve: the lower readings, a dozen seeds without a
set-up per seed.  --control-seeds limits the control to the first few.

    python3 benchmark/control.py --config defaults_i50 --traffic batch48 \
        --seeds 11 12 13 [--program] [--control-seeds 3]

One JSON line per seed, with the reference's seconds per file.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness, verify  # noqa: E402
from benchmark.inputs.corpus import corpus  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference.pngread import read_png_file  # noqa: E402
from benchmark.reference.solve import solve  # noqa: E402


def program_answers(config: dict, traffic: dict, items, seed: int,
                    picked, device: str) -> dict:
    """{file index: [pixels of each distinct answer]} of one unit of the
    traffic's entry, for the picked files."""
    entry_cls = importlib.import_module(
        f"benchmark.entries.{traffic['entry']}").Entry
    flags = list(config["flags"]) + (["--device", "cpu"]
                                     if device == "cpu" else [])
    workdir = tempfile.mkdtemp(prefix="j2p-control-")
    try:
        reqs, _ = entry_cls(items, flags, workdir, seed).run(0)
        out, seen = {}, set()
        for r in reqs:
            if r.index not in picked:
                continue
            if not r.ok:
                out.setdefault(r.index, []).append(None)
                continue
            data = pathlib.Path(r.out).read_bytes()
            if (r.index, data) in seen:
                continue
            seen.add((r.index, data))
            out.setdefault(r.index, []).append(read_png_file(r.out))
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def readings(config: dict, traffic: dict, seed: int, device="cuda",
             program=False, control=True, log=harness.log) -> dict:
    settings = harness.solve_settings(config["flags"])
    items = corpus(seed, traffic, log=log)
    by_index = {it.index: it for it in items}
    picked = verify.sample(items, config["check"], seed)
    answers = (program_answers(config, traffic, items, seed, set(picked),
                               device) if program else {})
    ctl_files, prog_files, seconds = [], [], []
    for index in picked:
        it = by_index[index]
        args = (it.components, it.height, it.width, settings["weight"],
                settings["pweight"], settings["iterations"])
        t0 = time.perf_counter()
        ref = solve(*args, device=device)
        seconds.append([index, it.megapixels, time.perf_counter() - t0])
        if control:
            ctl_files.append(compare.numbers(solve(*args, device=device,
                                                   tf32=True), ref))
        for pix in answers.get(index, []):
            prog_files.append({n: float("inf") for n in compare.NUMBERS}
                              if pix is None else compare.numbers(pix, ref))
    out = {"seed": seed, "files": picked}
    if control:
        out["control"] = compare.worst(ctl_files)
    if program:
        out["program"] = compare.worst(prog_files)
    out["reference_s"] = seconds
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control-seeds", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    config = json.loads((harness.BENCH / "configs" /
                         f"{args.config}.json").read_text())
    traffic = json.loads((harness.BENCH / "traffic" /
                          f"{args.traffic}.json").read_text())
    n_control = (len(args.seeds) if args.control_seeds is None
                 else args.control_seeds)
    for k, seed in enumerate(args.seeds):
        print(json.dumps(readings(config, traffic, seed, args.device,
                                  program=args.program,
                                  control=k < n_control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
