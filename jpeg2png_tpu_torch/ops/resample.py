"""Chroma-subsampling resample helpers.

The reference replicates each subsampled pixel over its h_samp x w_samp
footprint at init (compute.c:296-302, with edge clamping) and
decomposes each footprint into mean + residual during the projection
(compute.c:349-370).
"""

from __future__ import annotations

import numpy as np
import torch


def upsample_replicate(sub: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """[..., h, w] -> [..., h*sy, w*sx] by footprint replication."""
    if sy == 1 and sx == 1:
        return sub
    return sub.repeat_interleave(sy, dim=-2).repeat_interleave(sx, dim=-1)


def upsample_nearest_clamped(
    sub: torch.Tensor, sy: int, sx: int, h_out: int, w_out: int
) -> torch.Tensor:
    """Nearest upsample to an arbitrary (possibly larger) full-res canvas.

    Matches aux_init's index rule cy = MIN(y/h_samp, h-1) (compute.c:298-299):
    pixels past h*sy replicate the last source row/column.
    """
    h, w = sub.shape[-2:]
    yy = torch.as_tensor(np.minimum(np.arange(h_out) // sy, h - 1),
                         device=sub.device)
    xx = torch.as_tensor(np.minimum(np.arange(w_out) // sx, w - 1),
                         device=sub.device)
    return sub.index_select(-2, yy).index_select(-1, xx)


def footprint_mean(full: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """[..., h*sy, w*sx] -> [..., h, w] mean over each footprint."""
    if sy == 1 and sx == 1:
        return full
    *lead, hh, ww = full.shape
    x = full.reshape(*lead, hh // sy, sy, ww // sx, sx)
    return x.mean(dim=(-3, -1))
