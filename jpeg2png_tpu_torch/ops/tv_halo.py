"""TV/TGV2 gather gradient on a halo-extended row band.

The counterpart of jpeg2png_tpu/ops/tv_halo.py, for the row-striped
solver (parallel/stripes.py): given the extrapolated iterate of a band of
rows plus the 2 rows on each side that the stencil reaches (the
neighbouring bands' rows, or zeros at the canvas edge), the TV + TGV2
gather gradient of the band's own rows and the band's share of the
objective sums.

Edge semantics follow the reference (compute.c:73-197): forward
differences are zeroed on the last true row and column, backward ones on
the first, and contributions whose source pixel lies outside the image are
dropped.  Every row mask keys on the global row (row0 + band row), so the
function does not care which band it is given; the stencil itself is
kernels/grad_step.py::stencil, the one the whole-canvas kernels' plain
versions run.
"""

from __future__ import annotations

import math

import torch

from jpeg2png_tpu_torch.kernels.grad_step import HALO_ROWS, stencil, tgv_alpha


def band_stencil(e_ext: torch.Tensor, row0: int, h_true: int, w_true: int,
                 weight: float):
    """The gather stencil of a band: e_ext [C, L + 4, W] holds the band's
    extrapolated rows between HALO_ROWS halo rows on each side, its first
    own row global row `row0`.  Returns (grad [C, L, W] of the own rows,
    zeroed outside the true extent; the TV norm |g| [L, W]; the TGV2 norm
    [L, W], or None at weight 0)."""
    T, W = e_ext.shape[1:]
    L = T - 2 * HALO_ROWS
    rows = (int(row0) - HALO_ROWS
            + torch.arange(T, device=e_ext.device))[:, None]
    cols = torch.arange(W, device=e_ext.device)[None, :]
    grad, g_norm, n2 = stencil(e_ext, rows, cols, int(h_true), int(w_true),
                               weight)
    own = slice(HALO_ROWS, HALO_ROWS + L)
    # outside the true canvas the gradient is 0, so that padding stays
    # frozen and the global norm clean (the TGV2 gather reads boundary
    # values into the first pad row and column)
    grad = torch.where((rows[own] < h_true) & (cols < w_true),
                       grad[:, own], 0.0)
    return grad, g_norm[own], None if n2 is None else n2[own]


def grad_gather_halo(fl_ext: torch.Tensor, row0: int, H: int, weight: float,
                     w_true: int | None = None):
    """jpeg2png_tpu/ops/tv_halo.py::grad_gather_halo.

    Args:
        fl_ext: [C, L+4, W] extrapolated values; rows 0-1 are the halo
            from above (zeros if none), rows L+2..L+3 the halo below.
        row0: global row of fl_ext[:, 2, :], the band's first own row.
        H: the true canvas height; rows >= H are frozen padding.
        weight: TGV2 weight.
        w_true: the true width when W is a zero-padded canvas width.
    Returns:
        (grad [C, L, W], tv_partial, tv2_partial): the gradient of the own
        rows and the band's objective terms (own rows below H only).
    """
    C, T, W = fl_ext.shape
    L = T - 2 * HALO_ROWS
    WT = W if w_true is None else int(w_true)
    grad, g_norm, n2 = band_stencil(fl_ext, row0, H, WT, weight)
    own_row = (int(row0) + torch.arange(L, device=fl_ext.device)
               < min(int(row0) + L, H))[:, None]
    tv = (1.0 / math.sqrt(C)) * torch.sum(torch.where(own_row, g_norm, 0.0))
    if n2 is None:
        return grad, tv, torch.zeros((), device=fl_ext.device)
    tv2 = tgv_alpha(C, weight) * torch.sum(torch.where(own_row, n2, 0.0))
    return grad, tv, tv2
