"""TV and second-order TGV subgradient terms, in gather form.

The reference computes these with per-pixel *scatter*-adds into the
gradient buffer (reference: compute.c:73-125 for TV, compute.c:128-197
for TGV2).  Here every output pixel *gathers* the contributions its
neighbours would have scattered to it; the two forms are algebraically
identical and boundary guards become zero-padded shifts.

Conventions (x = fastest axis = last dim W, y = H; c = channel):
    gx[c,y,x] = f[c,y,x+1] - f[c,y,x]   (0 in the last column)
    gy[c,y,x] = f[c,y+1,x] - f[c,y,x]   (0 in the last row)
    g_norm[y,x] = sqrt(sum_c gx^2 + gy^2)     -- channels are coupled
with subgradient 0 wherever the norm vanishes (reference:
compute.c:97-105, README.md:109-110).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = a[..., y-dy, x-dx], zero where out of bounds."""
    h, w = a.shape[-2:]
    # F.pad order: (left, right, top, bottom)
    p = F.pad(a, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    y0 = max(-dy, 0)
    x0 = max(-dx, 0)
    return p[..., y0:y0 + h, x0:x0 + w]


def forward_diffs(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with zeroed last column/row (compute.c:79-81)."""
    gx = shift2d(f, 0, -1) - f
    gx[..., :, -1] = 0.0
    gy = shift2d(f, -1, 0) - f
    gy[..., -1, :] = 0.0
    return gx, gy


def tv_term(f: torch.Tensor):
    """First-order TV objective and gather-form gradient.

    Args:
        f: [C, H, W] current iterate (full resolution, all channels).
    Returns:
        (tv, grad, gx, gy): the objective contribution alpha*sum(g_norm)
        with alpha = 1/sqrt(C) (compute.c:90-91), the [C, H, W]
        gradient contribution and the forward differences (kept for
        the TGV2 term, compute.c:108-112).
    """
    gx, gy = forward_diffs(f)
    g_norm = torch.sqrt(torch.sum(gx * gx + gy * gy, dim=0))
    alpha = 1.0 / math.sqrt(f.shape[0])
    tv = alpha * torch.sum(g_norm)
    inv = torch.where(g_norm == 0.0, 0.0, 1.0 / g_norm)
    a = gx * inv
    b = gy * inv
    # gather of the 3-point scatter at compute.c:98-104:
    #   self: -(gx+gy)/n;  from left neighbour: +gx/n;  from above: +gy/n
    grad = alpha * (-(a + b) + shift2d(a, 0, 1) + shift2d(b, 1, 0))
    return tv, grad, gx, gy


def tv2_term(gx: torch.Tensor, gy: torch.Tensor, alpha: float):
    """Second-order TGV objective and gather-form gradient.

    Backward differences of the first differences, symmetrized cross
    term, Frobenius-style joint norm (compute.c:137-152), and the gather
    equivalent of the 7-point scatter at compute.c:158-185.

    Args:
        gx, gy: [C, H, W] forward differences from tv_term.
        alpha:  weight / sqrt(2) (compute.c:258), before the 1/sqrt(C)
                factor applied here (compute.c:154).
    Returns:
        (tv2, grad) objective contribution and [C, H, W] gradient.
    """
    g_xx = gx - shift2d(gx, 0, 1)
    g_xx[..., :, 0] = 0.0
    g_yx = gy - shift2d(gy, 0, 1)
    g_yx[..., :, 0] = 0.0
    g_xy = gx - shift2d(gx, 1, 0)
    g_xy[..., 0, :] = 0.0
    g_yy = gy - shift2d(gy, 1, 0)
    g_yy[..., 0, :] = 0.0
    sym = (g_xy + g_yx) * 0.5

    n2 = torch.sqrt(torch.sum(g_xx * g_xx + 2.0 * sym * sym + g_yy * g_yy,
                              dim=0))
    alpha_c = alpha / math.sqrt(gx.shape[0])
    tv2 = alpha_c * torch.sum(n2)

    inv = torch.where(n2 == 0.0, 0.0, 1.0 / n2)
    center = -(2.0 * g_xx + 2.0 * sym + 2.0 * g_yy) * inv
    p = (g_xx + sym) * inv   # scattered to x-1 and x+1 by the source
    q = (g_yy + sym) * inv   # scattered to y-1 and y+1 by the source
    r = -sym * inv           # scattered to (x+1,y-1) and (x-1,y+1)
    grad = alpha_c * (
        center
        + shift2d(p, 0, -1) + shift2d(p, 0, 1)
        + shift2d(q, -1, 0) + shift2d(q, 1, 0)
        + shift2d(r, -1, 1) + shift2d(r, 1, -1)
    )
    return tv2, grad
