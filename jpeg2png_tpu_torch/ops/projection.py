"""Projection onto the JPEG feasible set Q.

Q = { u : DCT(u)[j] in [(data[j]-0.5)*quant[j], (data[j]+0.5)*quant[j]] }
per 8x8 block — every image in Q re-encodes to exactly the source JPEG.
The block DCT is orthonormal, so projecting is clamping in DCT space
(reference: compute.c:323-331, README.md:113).  Subsampled channels
project the footprint mean and pass the residual through untouched
(compute.c:334-404).  The clamped coefficients are returned as well:
the next iteration's prob term uses them (compute.c:381).
"""

from __future__ import annotations

import torch

from jpeg2png_tpu_torch.ops.dct_raster import dct_raster, idct_raster
from jpeg2png_tpu_torch.ops.resample import footprint_mean, upsample_replicate


def project_channel_raster(
    region: torch.Tensor,    # [hc*sy, wc*sx] slice of full-res fdata
    lo_r: torch.Tensor,      # [hc, wc] rasterized (data-0.5)*quant
    hi_r: torch.Tensor,      # [hc, wc] rasterized (data+0.5)*quant
    sy: int,
    sx: int,
):
    """Returns (projected_region, clamped_dct_raster)."""
    sub = footprint_mean(region, sy, sx)
    coefs = dct_raster(sub)
    clamped = torch.minimum(torch.maximum(coefs, lo_r), hi_r)
    sub_proj = idct_raster(clamped)
    if sy == 1 and sx == 1:
        return sub_proj, clamped
    residual = region - upsample_replicate(sub, sy, sx)
    return residual + upsample_replicate(sub_proj, sy, sx), clamped
