#!/usr/bin/env python
"""Time the row-striped solve's collectives across two processes.

The PyTorch port's counterpart of tools/measure_halo_rt.py.  Starts two
processes on localhost that join one process group through the port's
parallel/distributed.py (NCCL by default, one card each, so two cards on
one host: without two it raises; gloo on the CPU with --device cpu), and
times, with the
striped body's own communicator (distributed.DistributedComm):

  * the halo exchange of one iteration: shift_down then shift_up of the
    lite body's payload, [2C, HALO_ROWS, W] float32 per direction (f and
    the bf16 side state as f32, parallel/stripes.py::_Striped._exchange);
  * the all-reduce of the [C + 3] vector of partial sums: the
    communicator's, an all-gather of every band's vector added in band
    order (the same bits for any layout), and beside it one
    torch.distributed.all_reduce of the vector (`plain_all_reduce_s`),
    which the communicator does not use.

Each is the minimum over --reps repetitions, both ranks synchronised
before each (and the card synchronised after it on the cards).
Localhost TCP is not a data-centre network; the numbers anchor what is
not wire time (serialisation, the backend's per-collective path,
synchronisation).  Rank 0 prints one JSON line per payload width.

    python tools/torch_measure_halo_rt.py [W ...]       # default 3072
    python tools/torch_measure_halo_rt.py 3072 12288
    python tools/torch_measure_halo_rt.py --device cpu 3072   # gloo

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
C = 3        # channels: the payload of a colour image


def worker(widths, reps, device) -> None:
    """One rank: join the group, time the collectives, leave."""
    import torch

    from jpeg2png_tpu_torch.kernels.grad_step import HALO_ROWS
    from jpeg2png_tpu_torch.parallel import distributed

    rank, world = distributed.initialize(device=device)
    dev = distributed.home_device()
    comm = distributed.DistributedComm()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best(fn):
        fn()                                            # warm
        t = float("inf")
        for _ in range(reps):
            distributed.barrier()
            t0 = time.perf_counter()
            fn()
            sync()
            t = min(t, time.perf_counter() - t0)
        return t

    try:
        for w in widths:
            payload = torch.ones((2 * C, HALO_ROWS, w), device=dev)
            sums = torch.ones((C + 3,), device=dev)
            halo_s = best(lambda: (comm.shift_down([payload]),
                                   comm.shift_up([payload])))
            reduce_s = best(lambda: comm.all_reduce([sums]))
            plain_s = best(lambda: torch.distributed.all_reduce(sums.clone()))
            if rank == 0:
                print(json.dumps({
                    "W": w, "payload_bytes_per_dir": payload.numel() * 4,
                    "halo_round_trip_s": halo_s, "all_reduce_s": reduce_s,
                    "plain_all_reduce_s": plain_s,
                    "processes": world, "backend": (
                        "nccl" if dev.type == "cuda" else "gloo"),
                    "device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu")}),
                    flush=True)
    finally:
        distributed.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("widths", nargs="*", type=int, default=[3072],
                    help="payload widths W (columns of a band)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, a card per process) or cpu (gloo)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.widths, args.reps, args.device)
        return 0
    if args.device != "cpu":
        import torch

        if torch.cuda.device_count() < 2:
            raise RuntimeError(
                f"--device {args.device} needs two CUDA cards, found "
                f"{torch.cuda.device_count()} (--device cpu runs gloo)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, JPEG2PNG_COORDINATOR=f"localhost:{port}",
                   JPEG2PNG_NUM_PROCESSES="2", JPEG2PNG_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", "--reps", str(args.reps),
             "--device", args.device, *map(str, args.widths)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    rc = 0
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        finally:
            p.kill()
        if p.returncode != 0:
            print(out, file=sys.stderr)
            rc = 1
        for line in out.splitlines():
            if line.startswith("{"):
                print(line)
    return rc


if __name__ == "__main__":
    sys.exit(main())
