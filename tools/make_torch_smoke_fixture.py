"""Make the full-size fixture the PyTorch port's chip_smoke.py decodes.

A deterministic 3072x2048 line-art image (seed 0): about 300 flat
ellipses and rectangles with dark outlines on a light background,
saved as a baseline JPEG at quality 30 with 4:2:0 chroma subsampling —
the default-flag decode at the size of a 6-megapixel photograph.

    python tools/make_torch_smoke_fixture.py [out.jpg]

Needs Pillow.  The output is committed, so the machine that runs
chip_smoke.py needs neither Pillow nor this script.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
from PIL import Image, ImageDraw

WIDTH, HEIGHT = 3072, 2048
SHAPES = 300
OUT = (pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures"
       / "torch_smoke_art3072x2048_q30_420.jpg")


def make_image(seed: int = 0) -> Image.Image:
    rng = np.random.default_rng(seed)
    img = Image.new("RGB", (WIDTH, HEIGHT), (236, 232, 220))
    draw = ImageDraw.Draw(img)
    for _ in range(SHAPES):
        w, h = rng.integers(40, 520, 2)
        x0 = int(rng.integers(-w // 2, WIDTH - w // 2))
        y0 = int(rng.integers(-h // 2, HEIGHT - h // 2))
        box = [x0, y0, x0 + int(w), y0 + int(h)]
        fill = tuple(int(v) for v in rng.integers(0, 256, 3))
        outline = tuple(int(v) for v in rng.integers(0, 60, 3))
        width = int(rng.integers(2, 9))
        if rng.random() < 0.5:
            draw.ellipse(box, fill=fill, outline=outline, width=width)
        else:
            draw.rectangle(box, fill=fill, outline=outline, width=width)
    return img


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = pathlib.Path(argv[0]) if argv else OUT
    make_image().save(out, "JPEG", quality=30, subsampling=2,
                      optimize=False, progressive=False)
    print(f"{out}: {out.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
