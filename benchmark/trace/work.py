"""The least time an H100 could take to smooth-decode one image, counted
from the image alone, whatever kernel or tier the program runs.

Per image of C components on its own canvas H x W (the largest
component region, never a bucket's padded canvas), with coefficient
grids of (H / sy) x (W / sx) per component and `iterations` FISTA
steps:

  operations = iterations * (K1_OPS_PER_CHANNEL_PIXEL * C * H * W
                             + K2_OPS_PER_COEF * sum of coefficients)
  bytes      = every input read once and every output written once over
               the whole solve (the port's utils/profiling.bound_k3)
  least time = max(operations / PEAK_F32, bytes / PEAK_BYTES)

The constants are the port's (utils/profiling.py), frozen here: 60
operations per pixel and channel for the extrapolation and the TV and
TGV2 gather stencils, 104 per coefficient for three 8x8 transform pairs
in matrix form and the box.  Every component's prob term is on (the
configurations' -p is not 0).
"""

from __future__ import annotations

# H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bytes/s, f32 flop/s outside
# the tensor cores, the arithmetic the port does
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
K1_OPS_PER_CHANNEL_PIXEL = 60
K2_OPS_PER_COEF = 96 + 8


def canvas(components):
    """(H, W, [(sy, sx)]) of components [(coefs [nby, nbx, 8, 8], quant,
    (sy, sx))]."""
    samps = [tuple(s) for _, _, s in components]
    H = max(c.shape[0] * 8 * sy for (c, _, (sy, sx)) in components)
    W = max(c.shape[1] * 8 * sx for (c, _, (sy, sx)) in components)
    return H, W, samps


def work(H: int, W: int, samps, iterations: int):
    """(operations, bytes) of one image's solve."""
    C = len(samps)
    coefs = [(H // sy) * (W // sx) for sy, sx in samps]
    ops = iterations * (K1_OPS_PER_CHANNEL_PIXEL * C * H * W
                        + K2_OPS_PER_COEF * sum(coefs))
    # f in and out, the FISTA shadow in and out (f32), int16 coefficients
    # and f32 quant in, the prob state in and out (f32), the step factors
    # and the per-iteration partial rows
    nbytes = (16 * C * H * W + 6 * sum(coefs) + 8 * sum(coefs)
              + 4 * iterations + 32 * iterations)
    return ops, nbytes


def least_seconds(H: int, W: int, samps, iterations: int) -> float:
    ops, nbytes = work(H, W, samps, iterations)
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)
