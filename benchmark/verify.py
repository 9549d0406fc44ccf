"""`correct`: the answers of the window held against the plain reference.

Every request of the window must have its PNG (a missing one fails the
run).  The configuration's "check" names groups of the traffic's files
by their pixels (width x height between min_pixels and max_pixels) and
how many files of each to compare, drawn from the seed, so that a group
the cell's work depends on is compared on every seed; every answer the
window gave for a sampled file is
read back (benchmark/reference/pngread.py, on a process pool, answers
with the same bytes read once) and held against the reference's pixels
for that file (benchmark/reference/solve.py, float32, TF32 off, on the
run's device, from the coefficients the writer recorded).  The largest
mean_abs and tile_mean_abs over those answers must stay within the
configuration's limits.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import multiprocessing
import time

import numpy as np

from benchmark.reference import compare
from benchmark.reference.pngread import read_png_file
from benchmark.reference.solve import solve


def sample(items, check: dict, seed: int):
    """The indices of the files the check compares: from each of the
    configuration's groups in turn, n files not picked before whose
    pixels lie in [min_pixels, max_pixels] (either end may be left out),
    drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    pick = []
    for group in check["groups"]:
        lo = group.get("min_pixels", 0)
        hi = group.get("max_pixels", float("inf"))
        part = sorted(it.index for it in items
                      if lo <= it.width * it.height <= hi
                      and it.index not in pick)
        n = min(int(group["n"]), len(part))
        pick += [part[j] for j in rng.choice(len(part), n, replace=False)]
    return sorted(pick)


def check(requests, items, config, settings, seed, device, log) -> dict:
    t0 = time.perf_counter()
    missing = sum(1 for r in requests if not r.ok)
    by_index = {it.index: it for it in items}
    picked = set(sample(items, config["check"], seed))
    answers = {}           # (index, sha256) -> a path with those bytes
    for r in requests:
        if r.ok and r.index in picked:
            with open(r.out, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            answers.setdefault((r.index, digest), r.out)
    keys = sorted(answers)
    ctx = multiprocessing.get_context("spawn")
    readings, ref_s = [], 0.0
    with concurrent.futures.ProcessPoolExecutor(8, mp_context=ctx) as pool:
        pixels = {k: pool.submit(read_png_file, answers[k]) for k in keys}
        for index in sorted({k[0] for k in keys}):
            it = by_index[index]
            t1 = time.perf_counter()
            ref = solve(it.components, it.height, it.width,
                        settings["weight"], settings["pweight"],
                        settings["iterations"], device=device)
            ref_s += time.perf_counter() - t1
            for k in keys:
                if k[0] == index:
                    readings.append(compare.numbers(pixels[k].result(), ref))
    worst = compare.worst(readings)
    limits = config["limits"]
    checks = {n: {"value": worst[n], "limit": limits[n]}
              for n in compare.NUMBERS}
    checks["missing"] = {"value": missing, "limit": 0}
    log(f"check: {len(picked)} files, {len(keys)} distinct answers of "
        f"{sum(1 for r in requests if r.index in picked)}, "
        f"{time.perf_counter() - t0:.3f} s (the reference {ref_s:.3f} s)")
    return {"correct": compare.verdict(worst, limits, missing),
            "checks": checks}
