"""Batch traffic: one `cli --tpu-batch` call converts a whole folder.

Each call hands jpeg2png_tpu_torch.cli.main the argv a user types, every
input under a fresh name (a link to the minted file) in an order drawn
from the seed and the call's number, with one -o per input:

    --tpu-batch -q <config flags> -o out_1 ... -o out_n in_1 ... in_n

and the runner's stage breakdown (`stats=`) comes back with it.  A
request is a file; it is done when main returned 0 and its PNG exists.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.entries.common import Request, call_dir


class Entry:
    unit_name = "call"

    def __init__(self, items, flags, workdir, seed):
        from jpeg2png_tpu_torch import cli

        self.cli, self.items, self.flags = cli, items, flags
        self.workdir, self.seed = workdir, seed

    def run(self, k: int):
        """Call number k (the warm call is -1): (requests, stats)."""
        order = np.random.default_rng([self.seed, k + 1]).permutation(
            len(self.items))
        ins, outs = call_dir(self.workdir, k, [self.items[i] for i in order])
        argv = ["--tpu-batch", "-q", *self.flags]
        for o in outs:
            argv += ["-o", o]
        stats = {}
        t0 = time.perf_counter()
        rc = self.cli.main(argv + ins, stats=stats)
        t1 = time.perf_counter()
        reqs = [Request(int(i), o, t0, t1, rc == 0 and os.path.exists(o))
                for i, o in zip(order, outs)]
        return reqs, stats
