"""DCT-coefficient-distance ("probability") term.

Matches compute_step_prob (reference: compute.c:38-70): the deviation
of the *saved clamped DCT coefficients from the last projection* from
the plain-decode coefficients data*quant, in quantization-step units.
The pixel-space gradient is the IDCT of dev/quant^2, replicated over the
subsampling footprint (compute.c:53-66).

The reference's SIMD build logs prob_dist *without* the alpha factor
while its scalar path logs alpha*prob_dist (compute_simd_step.c:61 vs
compute.c:69); `include_alpha_in_dist` picks which.
"""

from __future__ import annotations

import torch

from jpeg2png_tpu_torch.ops.dct_raster import idct_raster
from jpeg2png_tpu_torch.ops.resample import upsample_replicate


def prob_term_raster(
    cos_r: torch.Tensor,     # [hc, wc] clamped DCT coefficients (raster)
    dq_r: torch.Tensor,      # [hc, wc] rasterized data * quant
    inv_q_r: torch.Tensor,   # [hc, wc] rasterized 1/quant
    p_alpha: float,
    sy: int,
    sx: int,
    include_alpha_in_dist: bool = False,
):
    """Returns (prob_dist, grad_region [hc*sy, wc*sx])."""
    scaled = (cos_r - dq_r) * inv_q_r
    prob_dist = 0.5 * torch.sum(scaled * scaled)
    if include_alpha_in_dist:
        prob_dist = p_alpha * prob_dist
    pix = idct_raster(scaled * inv_q_r)
    return prob_dist, p_alpha * upsample_replicate(pix, sy, sx)
