"""The JPEGs of one seed, minted once and cached.

A traffic mix names its sizes (width, height, chroma layout), its
qualities and how many times the size list repeats; file i has size
sizes[i % len(sizes)] and quality qualities[i % len(qualities)], the
cycling of the port's utils/corpus.mint_corpus.  Content comes from
synth_image (a frozen copy of that module's generator), seeded from the
run's seed and the file's index, and the benchmark's own writer
(jpeg_writer.encode) encodes it.  Files are minted on a process pool
and cached under cache/<key>/ beside this module with the quantised
coefficients the writer recorded; a later run of the same seed and mix
loads them.  Only the newest few keys are kept.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import multiprocessing
import os
import pathlib
import shutil
import time

import numpy as np

from benchmark.inputs.jpeg_writer import encode

CACHE = pathlib.Path(__file__).resolve().parent / "cache"
KEEP = 4          # cached seeds kept; older ones are deleted


def synth_image(w: int, h: int, seed) -> np.ndarray:
    """Photo-class content: three smooth waves, a flat panel over the
    bottom 30% of the rows, a flat disc, and smoothed noise (the port's
    utils/corpus.synth_image).  The seed (any numpy seed) draws the waves'
    phases and near-fixed frequencies, the flat regions' colours and the
    noise, and leaves the layout alone, so that every seed's image of a
    size costs the program the same work (the PNG writer's deflate time
    follows how much of the image is flat)."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h, dtype=np.float32)[:, None] / h
    xx = np.arange(w, dtype=np.float32)[None, :] / w
    fx, fy = rng.uniform(0.65, 0.75, 2).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    tau = np.float32(2 * np.pi)
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 120 + 90 * np.sin(tau * (xx * fx + yy * 0.3) + ph[0])
    img[..., 1] = 128 + 70 * np.cos(tau * yy * fy + ph[1])
    img[..., 2] = 110 + 80 * np.sin(tau * (xx * 0.4 - yy * fy) + ph[2])
    img[(yy > 0.7)[:, 0]] = rng.uniform(40, 220, 3)
    r = 0.18 * min(h, w)
    img[((yy - 0.4) * h) ** 2 + ((xx - 0.4) * w) ** 2 < r * r] = (
        rng.uniform(30, 230, 3))
    noise = rng.standard_normal((h, w, 3), dtype=np.float32) * 12
    for axis in (0, 1):
        noise = (np.roll(noise, 1, axis) + noise
                 + np.roll(noise, -1, axis)) / 3
    return np.clip(np.round(img + noise), 0, 255).astype(np.uint8)


@dataclasses.dataclass
class Item:
    """One minted JPEG: its file, its true size, and the coefficients
    (per component: int16 blocks, quant, (sy, sx)) the writer recorded."""
    index: int
    path: str
    width: int
    height: int
    quality: int
    layout: str
    components: list

    @property
    def megapixels(self) -> float:
        return self.width * self.height / 1e6


def plan(traffic: dict):
    """[(index, width, height, layout, quality)] of a mix's files."""
    sizes, quals = traffic["sizes"], traffic["qualities"]
    n = len(sizes) * int(traffic.get("repeat", 1))
    return [(i, *sizes[i % len(sizes)], quals[i % len(quals)])
            for i in range(n)]


def _key(seed: int, files) -> str:
    text = json.dumps([seed, files])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _mint_one(args):
    folder, seed, (i, w, h, layout, q) = args
    rgb = synth_image(w, h, np.random.SeedSequence([seed, i]))
    data, comps = encode(rgb, q, layout)
    path = pathlib.Path(folder) / f"img{i:03d}_{w}x{h}_q{q}.jpg"
    path.write_bytes(data)
    arrays = {}
    for c, (coefs, quant, samp) in enumerate(comps):
        arrays[f"coefs{c}"], arrays[f"quant{c}"] = coefs, quant
        arrays[f"samp{c}"] = np.asarray(samp)
    np.savez_compressed(path.with_suffix(".npz"), **arrays)
    return path.name


def _load(path: str, entry) -> Item:
    i, w, h, layout, q = entry
    with np.load(pathlib.Path(path).with_suffix(".npz")) as z:
        comps = [(z[f"coefs{c}"], z[f"quant{c}"], tuple(int(v) for v in
                                                         z[f"samp{c}"]))
                 for c in range(3)]
    return Item(i, path, w, h, q, layout, comps)


def corpus(seed: int, traffic: dict, workers: int = 8, log=print):
    """The Items of `seed` under `traffic`, minted or loaded from the
    cache.  Prints the seconds it took."""
    t0 = time.perf_counter()
    files = plan(traffic)
    folder = CACHE / _key(seed, files)
    done = folder / "manifest.json"
    minted = not done.exists()
    if minted:
        shutil.rmtree(folder, ignore_errors=True)
        folder.mkdir(parents=True)
        jobs = [(str(folder), seed, f) for f in files]
        # largest first, so the pool's last jobs are the short ones
        jobs.sort(key=lambda j: -j[2][1] * j[2][2])
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers,
                                                    mp_context=ctx) as pool:
            paths = dict(zip((j[2][0] for j in jobs),
                             pool.map(_mint_one, jobs)))
        done.write_text(json.dumps([paths[f[0]] for f in files]))
        _prune()
    os.utime(folder)
    paths = json.loads(done.read_text())
    items = [_load(str(folder / p), f) for p, f in zip(paths, files)]
    log(f"inputs: {len(items)} files, "
        f"{sum(it.megapixels for it in items):.4f} MP, "
        f"{'minted' if minted else 'loaded'} in "
        f"{time.perf_counter() - t0:.3f} s")
    return items


def _prune():
    folders = sorted((p for p in CACHE.iterdir() if p.is_dir()),
                     key=lambda p: p.stat().st_mtime, reverse=True)
    for p in folders[KEEP:]:
        shutil.rmtree(p, ignore_errors=True)
