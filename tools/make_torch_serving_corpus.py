"""Mint the serving corpus the PyTorch port's chip_smoke.py decodes.

48 JPEGs from jpeg2png_tpu_torch.utils.corpus.mint_corpus (seed 0): 24
sizes from 160x120 to 3264x2448, qualities 20-90, 4:2:0 with one 4:2:2
and one 4:4:4 size, each size twice.

    python tools/make_torch_serving_corpus.py [outdir]

Needs Pillow.  The output is committed (tests/fixtures/torch_serving/),
so the machine that runs chip_smoke.py needs neither Pillow nor this
script.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures" / "torch_serving"
N_FILES = 48


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, str(ROOT))
    from jpeg2png_tpu_torch.utils.corpus import mint_corpus

    out = pathlib.Path(argv[0]) if argv else OUT
    files = mint_corpus(out, n=N_FILES, seed=0)
    total = sum(pathlib.Path(f).stat().st_size for f in files)
    print(f"{len(files)} files, {total / 1e6:.2f} MB in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
