"""Per-file traffic: one `cli` call per file, one client, closed loop.

The files cycle in one order drawn from the seed; a unit of the window
is one whole cycle, so that every run's requests are the same files.
Each request hands jpeg2png_tpu_torch.cli.main the argv a user types
for one file under a fresh name:

    -q <config flags> -o out in

and its latency is main's wall time, from the call to the return with
the PNG on disk.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.entries.common import Request, call_dir


class Entry:
    unit_name = "cycle"

    def __init__(self, items, flags, workdir, seed):
        from jpeg2png_tpu_torch import cli

        self.cli, self.items, self.flags = cli, items, flags
        self.workdir = workdir
        self.order = np.random.default_rng([seed, 0]).permutation(len(items))

    def run(self, k: int):
        """Cycle number k (the warm cycle is -1): (requests, None)."""
        ins, outs = call_dir(self.workdir, k,
                             [self.items[i] for i in self.order])
        reqs = []
        for i, inp, out in zip(self.order, ins, outs):
            t0 = time.perf_counter()
            rc = self.cli.main(["-q", *self.flags, "-o", out, inp])
            t1 = time.perf_counter()
            reqs.append(Request(int(i), out, t0, t1,
                                rc == 0 and os.path.exists(out)))
        return reqs, None
