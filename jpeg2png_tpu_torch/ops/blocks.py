"""Raster <-> 8x8-block layout transforms (reference: box.c:5-36).

A 4-D block tensor [..., nby, nbx, 8, 8] whose leading two block dims
match the reference's block-major order.
"""

from __future__ import annotations

import torch


def blockify(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H//8, W//8, 8, 8].  H, W must be multiples of 8."""
    *lead, h, w = img.shape
    assert h % 8 == 0 and w % 8 == 0, (h, w)
    x = img.reshape(*lead, h // 8, 8, w // 8, 8)
    return x.movedim(-3, -2)


def deblockify(blocks: torch.Tensor) -> torch.Tensor:
    """[..., nby, nbx, 8, 8] -> [..., nby*8, nbx*8]."""
    *lead, nby, nbx, i, j = blocks.shape
    assert i == 8 and j == 8
    return blocks.movedim(-2, -3).reshape(*lead, nby * 8, nbx * 8)
