#!/usr/bin/env python
"""Headline benchmark of the PyTorch port: solver throughput at 1000
iterations on one card, by bench.py's method and with its JSON keys.

Prints ONE JSON line:
    {"metric": "mp_iter_per_s", "value": N, "unit": "MP*iter/s",
     "vs_baseline": N, ..., "device": "<card>"}

Baseline: the reference C binary (victorvde/jpeg2png, SSE2+OpenMP build)
decodes the same 512x512 q10 4:2:0 fixture with -i 1000 in 12.52 s on
the host CPU the JAX package was developed on => 20.94 MP*iter/s
(BASELINE.md; a CPU figure, not a TPU one).  vs_baseline is the speedup
over that number.

Method (utils/timing.py, as bench.py): warm solves at two iteration
counts, differenced, so the fixed per-solve cost (set-up, the metrics
fetch) cancels; median over attempts of min-over-repetitions timings,
each solve ending in torch.cuda.synchronize.  Rows beside the headline
(skipped by --quick and --no-tiers): 6.29 MP synthetic through the tier
the rule picks and striped over one band, 25 MP and 50 MP, and the
mixed-size corpus through the batched runner (files/s, MP*iter/s,
library builds of the warm pass: 0).  A row that fails fails the tool:
no row turns into null.  --wall reports one 1000-iteration solve's wall
rate instead of the marginal.  Without a card it raises unless given
--device cpu (the plain versions: a CPU number, not a card's).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REFERENCE_MP_ITER_PER_S = 20.94  # 512x512 (0.262144 MP), -i 1000, 12.52 s
FIXTURE = ROOT / "tests" / "fixtures" / "photo512_q10_420.jpg"
# (n1, n2, repetitions) of the headline, and of --quick
HEADLINE = (1000, 3000, 5)
QUICK = (200, 1200, 3)
# secondary rows: (key, striped, nby, nbx, n1, n2, repetitions)
ROWS = (
    ("mp_iter_per_s_6mp", False, 256, 384, 30, 130, 3),
    ("mp_iter_per_s_striped_6mp", True, 256, 384, 30, 130, 3),
    ("mp_iter_per_s_25mp", False, 768, 512, 10, 40, 3),
    ("mp_iter_per_s_50mp", False, 768, 1024, 8, 28, 2),
)
# the batched row: files of the mixed-size corpus, iterations, corpus
# directory (minted once, gitignored)
BATCHED = (100, 50, ROOT / "jpeg2png_tpu_torch" / "_build" / "corpus")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="fast smoke test (fewer iterations, no rows)")
    ap.add_argument("--wall", action="store_true",
                    help="report the wall rate of one solve instead of the "
                         "marginal rate")
    ap.add_argument("--no-tiers", action="store_true",
                    help="the headline fixture only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from jpeg2png_tpu_torch import resolve_device
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.utils.timing import (
        joint_timer, marginal_rate, mixed_batch_bench, striped_timer,
        synth_coefs)

    dev = resolve_device(args.device)      # no card: RuntimeError
    img = read_jpeg(FIXTURE)
    datas = [p.data for p in img.planes]
    quants = [p.quant for p in img.planes]
    samps = [(p.h_samp, p.w_samp) for p in img.planes]
    mp = img.height * img.width / 1e6

    n1, n2, reps = QUICK if args.quick else HEADLINE
    timed = joint_timer(datas, quants, samps, reps, device=dev)
    value = mp * n1 / timed(n1) if args.wall else marginal_rate(
        timed, mp, n1, n2)
    out = {
        "metric": "mp_iter_per_s",
        "value": value,
        "unit": "MP*iter/s",
        "vs_baseline": value / REFERENCE_MP_ITER_PER_S,
    }

    if not args.quick and not args.no_tiers:
        for key, striped, nby, nbx, r1, r2, rr in ROWS:
            d, q, s = synth_coefs(nby, nbx)
            timer = striped_timer if striped else joint_timer
            out[key] = marginal_rate(timer(d, q, s, rr, device=dev),
                                     nby * 8 * nbx * 8 / 1e6, r1, r2)
        n_files, iters, workdir = BATCHED
        batched = mixed_batch_bench(n_files, iters, workdir=workdir,
                                    device=dev)
        out["batched_files_per_s"] = batched["files_per_s"]
        out["batched_mp_iter_per_s"] = batched["mp_iter_per_s"]
        out["batched_n_buckets"] = batched["n_buckets"]
        out["batched_bucket_classes"] = batched["bucket_classes"]
        out["batched_compiles_warm"] = batched["compiles_warm"]
        out["batched_mp_total"] = batched["mp_total"]
        out["batched_stage_breakdown"] = {
            k: batched[k] for k in ("warm_read_s", "warm_solve_s",
                                    "upload_mb", "fetch_mb")}
        if batched["compiles_warm"]:
            raise RuntimeError(f"the warm serving pass built "
                               f"{batched['compiles_warm']} libraries")
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu (plain versions)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
