#!/usr/bin/env python
"""Tier table of the PyTorch port: solver throughput across canvas sizes,
each size through every solver tier that takes its geometry.

The port's counterpart of tools/bench_tiers.py, over the same rows
(synthetic photo-class 4:2:0 coefficients, utils/timing.synth_coefs):
the marginal MP*iter/s of each (size, tier) by utils/timing's method
(median over attempts of min-over-repetitions, between two warm iteration
counts), the tier forced through solve_joint(tier=); then the 6.29 MP
striped row (one band, the body the rule picks).

Prints one JSON line per row ({"tier": size, "solver_tier": tier,
"rule": the rule's tier, "mp_iter_per_s": N}), then {"tiers": {size:
{tier: N}}, "device": card}.  --quick divides the iteration counts by 5.
Without a card it raises unless given --device cpu (the plain versions:
CPU numbers, not a card's).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# tools/bench_tiers.py's rows: (name, nby, nbx, n1, n2)
TIERS = [
    ("0.26MP 512x512", 64, 64, 1000, 3000),
    ("1.05MP 1024x1024", 128, 128, 200, 600),
    ("1.64MP 1280x1280", 160, 160, 100, 400),
    ("2.21MP 1536x1440", 192, 180, 60, 260),
    ("3.15MP 2048x1536", 256, 192, 50, 200),
    ("6.29MP 2048x3072", 256, 384, 30, 130),
    ("25.17MP 6144x4096", 768, 512, 10, 40),
    ("100.66MP 12288x8192", 1536, 1024, 5, 20),
]
# the striped row: (name, nby, nbx, n1, n2)
STRIPED = ("6.29MP striped n=1", 256, 384, 30, 130)
REPS = 4


def held_tiers(datas, samps):
    """The solver tiers whose kernels take this geometry (every prob
    term on), and the tier the rule picks."""
    from jpeg2png_tpu_torch.kernels import iter_step, stripe_grad
    from jpeg2png_tpu_torch.models import solver

    geoms = solver._geometry(datas, samps)
    H, W = solver.canvas_shape(geoms)
    C = len(geoms)
    ok = {"mega": iter_step.supports(C, H, W, samps, C),
          "two-lite": stripe_grad.supports(C, H, W, samps), "two": True}
    ok["mega-lite"] = ok["mega"]
    return [t for t in solver.TIERS if ok[t]], solver.active_tier(geoms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from jpeg2png_tpu_torch import resolve_device
    from jpeg2png_tpu_torch.utils.timing import (
        joint_timer, marginal_rate, striped_timer, synth_coefs)

    dev = resolve_device(args.device)      # no card: RuntimeError

    def counts(n1, n2):
        return (max(n1 // 5, 5), max(n2 // 5, 20)) if args.quick else (n1, n2)

    out = {}
    for name, nby, nbx, n1, n2 in TIERS:
        datas, quants, samps = synth_coefs(nby, nbx)
        mp = nby * 8 * nbx * 8 / 1e6
        tiers, rule = held_tiers(datas, samps)
        out[name] = {}
        for tier in tiers:
            rate = marginal_rate(joint_timer(datas, quants, samps, REPS,
                                             device=dev, tier=tier),
                                 mp, *counts(n1, n2))
            out[name][tier] = rate
            print(json.dumps({"tier": name, "solver_tier": tier,
                              "rule": rule, "mp_iter_per_s": rate}),
                  flush=True)
    name, nby, nbx, n1, n2 = STRIPED
    datas, quants, samps = synth_coefs(nby, nbx)
    rate = marginal_rate(striped_timer(datas, quants, samps, REPS - 1,
                                       device=dev),
                         nby * 8 * nbx * 8 / 1e6,
                         *((10, 40) if args.quick else (n1, n2)))
    out[name] = {"striped": rate}
    print(json.dumps({"tier": name, "solver_tier": "striped",
                      "mp_iter_per_s": rate}), flush=True)
    print(json.dumps({"tiers": out, "device": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu (plain versions)")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
