"""Deterministic mixed-size JPEG corpus minting (the port's own copy).

The serving path (runner.decode_files_batched, cli --tpu-batch) needs a
realistic corpus: many distinct pixel sizes, several quality levels (=
distinct quant tables), mixed subsampling.  This module mints one
deterministically (seeded numpy content, Pillow encoder); the same
sizes, qualities and content as the JAX package's utils/corpus.py.
Pillow is imported only when mint_corpus has a file to encode: the
machine that decodes an existing corpus (the committed one) needs none.
"""

from __future__ import annotations

import pathlib
from typing import List, Sequence, Tuple

import numpy as np

# 24 distinct pixel sizes (w, h, PIL subsampling id), thumbnails to
# ~8 MP.  Mostly 4:2:0 with one 4:2:2 and one 4:4:4 size (realistic
# corpora are overwhelmingly 4:2:0).  The sizes cluster onto a handful
# of bucket-ladder rungs, so each bucket serves several true sizes.
SIZES: Tuple[Tuple[int, int, int], ...] = (
    # rung (256, 256)
    (160, 120, 2), (200, 144, 2), (256, 176, 2), (240, 192, 2),
    # rung (384, 512)
    (400, 288, 2), (512, 320, 2), (448, 368, 2), (512, 384, 2),
    # rung (512, 768), one 4:4:4 member
    (640, 400, 2), (768, 432, 2), (720, 480, 0), (768, 512, 2),
    # rung (768, 1024), one 4:2:2 member
    (1024, 672, 2), (960, 720, 1), (1024, 768, 2), (896, 744, 2),
    # rungs (1024, 1280) / (1280, 1536): 1-2 MP
    (1280, 960, 2), (1280, 1024, 2), (1440, 1080, 2), (1536, 1024, 2),
    # rung (1536, 2048): ~3 MP
    (1920, 1440, 2), (2048, 1536, 2),
    # 4.4 / 8 MP photos
    (2560, 1728, 2), (3264, 2448, 2),
)
# distinct libjpeg quality levels -> distinct quant tables
QUALITIES: Tuple[int, ...] = (20, 30, 40, 50, 60, 75, 85, 90)


def synth_image(w: int, h: int, seed: int) -> np.ndarray:
    """Photo-class content with a few flat panels and hard edges —
    cheap to mint at any size, compresses like a real photograph."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    fx, fy = rng.uniform(0.3, 1.1, 2)
    img = np.stack([
        120 + 90 * np.sin(2 * np.pi * (xx / w * fx + yy / h * 0.3)),
        128 + 70 * np.cos(2 * np.pi * (yy / h * fy)),
        110 + 80 * np.sin(2 * np.pi * (xx / w * 0.4 - yy / h * fy)),
    ], axis=-1)
    # a flat panel and a disc: the line-art-class regions where the
    # smoother shines (reference README.md:43-44)
    img[yy > (0.6 + 0.2 * rng.random()) * h] = rng.uniform(40, 220, 3)
    cy, cx = rng.uniform(0.2, 0.6, 2)
    r = 0.18 * min(h, w)
    img[(yy - cy * h) ** 2 + (xx - cx * w) ** 2 < r * r] = (
        rng.uniform(30, 230, 3))
    noise = rng.normal(0, 12, (h, w, 3))
    for axis in (0, 1):
        noise = (np.roll(noise, 1, axis) + noise
                 + np.roll(noise, -1, axis)) / 3.0
    return np.clip(np.round(img + noise), 0, 255).astype(np.uint8)


def mint_corpus(outdir, n: int = 100, seed: int = 0,
                sizes: Sequence[Tuple[int, int]] = SIZES) -> List[str]:
    """Mint `n` JPEGs cycling through sizes/qualities/subsamplings.

    `sizes` entries are (w, h) or (w, h, PIL-subsampling-id); plain
    pairs default to 4:2:0.  Returns the file paths (existing files
    are reused, so repeated benchmark runs skip the encode)."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    files = []
    for i in range(n):
        entry = sizes[i % len(sizes)]
        w, h = entry[0], entry[1]
        sub = entry[2] if len(entry) > 2 else 2
        q = QUALITIES[i % len(QUALITIES)]
        path = outdir / f"img{i:03d}_{w}x{h}_q{q}_s{sub}.jpg"
        if not path.exists():
            from PIL import Image

            Image.fromarray(synth_image(w, h, seed * 100003 + i)).save(
                path, "JPEG", quality=q, subsampling=sub)
        files.append(str(path))
    return files
