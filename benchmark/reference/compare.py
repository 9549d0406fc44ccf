"""The numbers that decide `correct`: how far an answer's pixels lie from
the reference's.

  mean_abs       the mean absolute difference over all pixels and
                 channels of one file, in 8-bit levels;
  tile_mean_abs  the same over the worst TILE x TILE tile of the file
                 (edge tiles over the pixels they hold), which a fault
                 confined to a corner or a strip of rows cannot hide in.

A check reads the largest of each over every answer it compares, and is
correct when each stays at or under its limit and no answer is missing.
"""

from __future__ import annotations

import numpy as np

TILE = 32
NUMBERS = ("mean_abs", "tile_mean_abs")


def numbers(answer: np.ndarray, reference: np.ndarray) -> dict:
    if answer.shape != reference.shape:
        return {n: float("inf") for n in NUMBERS}
    d = np.abs(answer.astype(np.int32) - reference.astype(np.int32))
    d = d.astype(np.float64)
    if d.ndim == 3:
        d = d.mean(axis=2)
    h, w = d.shape
    H, W = -(-h // TILE) * TILE, -(-w // TILE) * TILE
    s = np.zeros((H, W))
    n = np.zeros((H, W))
    s[:h, :w], n[:h, :w] = d, 1.0
    s = s.reshape(H // TILE, TILE, W // TILE, TILE).sum(axis=(1, 3))
    n = n.reshape(H // TILE, TILE, W // TILE, TILE).sum(axis=(1, 3))
    return {"mean_abs": float(d.mean()), "tile_mean_abs": float((s / n).max())}


def worst(readings) -> dict:
    """The largest of each number over a list of numbers() dicts."""
    return {n: max((r[n] for r in readings), default=0.0) for n in NUMBERS}


def verdict(worst_numbers: dict, limits: dict, missing: int) -> bool:
    return missing == 0 and all(worst_numbers[n] <= limits[n]
                                for n in NUMBERS)
