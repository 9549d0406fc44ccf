#!/usr/bin/env python
"""Mutation fuzzing of the PyTorch port's JPEG reader (the AFL-recipe
analog, reference notes/afl.txt).

The port's counterpart of tools/fuzz_reader.py, with its mutations byte
for byte (`mutate`, the same bytes for the same generator state): every
fixture JPEG, bit flips, byte substitutions, truncations, duplications
and marker corruption, each mutant fed to jpeg2png_tpu_torch.io.read_jpeg
(markers in Python, the entropy decoder in C: csrc/jpeg_entropy.c).  A
clean parse (structurally sound planes) and a clean ValueError are the
only outcomes allowed; anything else raises, and a crash in the C decoder
kills this process with a signal: the run fails loudly either way.

    python tools/torch_fuzz_reader.py [--n 2000] [--seed 0]

Runs on the host only (no card).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def mutate(data: bytes, rng: np.random.Generator) -> bytes:
    buf = bytearray(data)
    kind = rng.integers(0, 5)
    if kind == 0 and len(buf) > 4:                 # bit flip(s)
        for _ in range(int(rng.integers(1, 8))):
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= 1 << int(rng.integers(0, 8))
    elif kind == 1 and len(buf) > 4:               # byte substitution
        for _ in range(int(rng.integers(1, 16))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
    elif kind == 2 and len(buf) > 8:               # truncation
        buf = buf[: int(rng.integers(2, len(buf)))]
    elif kind == 3 and len(buf) > 16:              # chunk duplication
        a = int(rng.integers(0, len(buf) - 8))
        b = int(rng.integers(a + 1, min(a + 64, len(buf))))
        at = int(rng.integers(0, len(buf)))
        buf = buf[:at] + buf[a:b] + buf[at:]
    else:                                          # marker corruption
        idxs = [i for i in range(len(buf) - 1) if buf[i] == 0xFF]
        if idxs:
            i = idxs[int(rng.integers(0, len(idxs)))]
            buf[i + 1] = int(rng.integers(0, 256))
    return bytes(buf)


def run(n: int, seed: int, corpus=None, verbose=True) -> dict:
    """Feed `n` mutants to read_jpeg -> {"parsed", "rejected"}."""
    from jpeg2png_tpu_torch.io import read_jpeg

    if corpus is None:
        corpus = sorted((ROOT / "tests" / "fixtures").glob("*.jpg"))
    datas = [p.read_bytes() for p in corpus]
    rng = np.random.default_rng(seed)
    parsed = rejected = 0
    for _ in range(n):
        mut = mutate(datas[int(rng.integers(0, len(datas)))], rng)
        try:
            img = read_jpeg(mut, print_warnings=False)
        except ValueError:
            rejected += 1
            continue
        # parsed mutants must still be structurally sound
        if not 1 <= img.nchannel <= 3:
            raise RuntimeError(f"{img.nchannel} channels parsed")
        for p in img.planes:
            if p.data.shape != (p.nby, p.nbx, 8, 8) or not (p.quant > 0).all():
                raise RuntimeError(f"unsound plane {p.data.shape}")
        parsed += 1
    if verbose:
        print(f"{n} mutants: {parsed} parsed, {rejected} rejected, "
              "0 crashes")
    return {"parsed": parsed, "rejected": rejected}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    run(args.n, args.seed)
