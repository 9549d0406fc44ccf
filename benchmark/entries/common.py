"""What the entries share: a request's record and a call's file names."""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Request:
    index: int          # the file (corpus.Item.index)
    out: str            # the PNG it should have written
    t0: float           # perf_counter at the call
    t1: float           # perf_counter at its return
    ok: bool            # main returned 0 and the PNG exists


def call_dir(workdir: str, k: int, items):
    """Fresh input names (links to the minted files) and output names for
    call k: ([inputs], [outputs])."""
    d = os.path.join(workdir, f"call{k + 1:04d}")
    os.makedirs(d)
    ins, outs = [], []
    for j, it in enumerate(items):
        inp = os.path.join(d, f"in{j:03d}_{k + 1}.jpg")
        os.symlink(it.path, inp)
        ins.append(inp)
        outs.append(os.path.join(d, f"out{j:03d}_{k + 1}.png"))
    return ins, outs
