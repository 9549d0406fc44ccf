#!/usr/bin/env python
"""Batched-serving benchmark of the PyTorch port (BASELINE.json config 4).

The port's counterpart of tools/bench_batch.py.  Two modes:

  --mixed [N]   (default 100 files) a deterministic mixed-size corpus
                (utils/corpus.py: 24 pixel sizes, 8 quality levels,
                4:2:0/4:2:2/4:4:4; minted once into --workdir, which
                needs Pillow, else reused) through
                runner.decode_files_batched: files/s, aggregate
                MP*iter/s, bucket count, and the library builds of the
                cold and warm passes (`compiles_*`; warm must be 0).
                One JSON line (utils/timing.mixed_batch_bench).

  (no flag)     B copies of the 512x512 fixture through the runner's dyn
                class (runner.solve_bucket: K3, chunks of up to 8 images
                a launch), B = 1, 4, 16: aggregate MP*iter/s per B, the
                best of 3 runs, each ending in torch.cuda.synchronize.

Without a card it raises unless given --device cpu (the plain versions:
CPU numbers, not a card's).  Imports nothing of JAX.

Usage:  python tools/torch_bench_batch.py [--mixed [N]] [--iters N]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FIXTURE = ROOT / "tests" / "fixtures" / "photo512_q10_420.jpg"
BATCHES = (1, 4, 16)


def same_geometry_sweep(iters, device) -> list:
    """Rows {B, ms, mp_iter_per_s, us_per_image_iter} of B copies of the
    fixture through runner.solve_bucket, printed as they come."""
    import torch

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.runner import quantized_bucket_for, solve_bucket

    img = read_jpeg(FIXTURE)
    bucket = quantized_bucket_for(img)
    mp = img.height * img.width / 1e6

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rows = []
    for B in BATCHES:
        def run():
            solve_bucket([img] * B, bucket, 0.3, [0.001] * 3, iters,
                         device=device)
        run()                                       # warm
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            best = min(best, time.perf_counter() - t0)
        row = {"B": B, "ms": best * 1e3,
               "mp_iter_per_s": B * mp * iters / best,
               "us_per_image_iter": best / B / iters * 1e6}
        print(f"B={B:3d}: {row['ms']:8.1f} ms  {row['mp_iter_per_s']:8.1f} "
              f"MP*iter/s aggregate  ({row['us_per_image_iter']:6.1f} "
              f"us/image/iter)", flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--mixed", nargs="?", const=100, default=None,
                    type=int, metavar="N",
                    help="mixed-size corpus of N files (default 100) "
                         "through decode_files_batched")
    ap.add_argument("--workdir", default=str(
        ROOT / "jpeg2png_tpu_torch" / "_build" / "corpus"),
        help="corpus directory (reused across runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from jpeg2png_tpu_torch import resolve_device

    dev = resolve_device(args.device)      # no card: RuntimeError
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    if args.mixed is not None:
        from jpeg2png_tpu_torch.utils.timing import mixed_batch_bench

        res = mixed_batch_bench(args.mixed, args.iters or 50,
                                workdir=args.workdir, device=dev)
        res["device"] = card
        print(json.dumps(res))
        return 0
    rows = same_geometry_sweep(args.iters or 200, dev)
    print(json.dumps({"same_geometry": rows, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
