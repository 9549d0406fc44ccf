"""Blocked 8x8 DCT applied in raster layout.

Coefficient (u, v) of block (by, bx) lives at raster position
(8*by+u, 8*bx+v), the convention of the JAX package's ops/dct_raster.py,
so quantization tables and clamp bounds rasterize to the same grid and
the projection (reference: compute.c:334-404) is elementwise in raster
space.

Sampled transforms fold the footprint mean into the DCT: for a channel
with footprint (sy, sx) (4:2:0 chroma has 2, 2), P = D @ M_s per axis
with M_s = I_8 (x) ones(s)/s, and

    coefs = P_r @ X @ P_c^T
    out   = X + (sy*sx) * P_r^T @ (clip(coefs, lo, hi) - coefs) @ P_c
    pgrad = p_alpha * (sy*sx) * P_r^T @ ((cos - dq) / q^2) @ P_c

(the reference's mean/residual decomposition, compute.c:349-403).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jpeg2png_tpu_torch.ops.dct import dct_matrix_f64, device_const


@functools.lru_cache(maxsize=None)
def _sampled_base(s: int) -> np.ndarray:
    """D @ (I_8 (x) ones(s)/s) as an [8, 8*s] float64 host constant."""
    m = np.kron(np.eye(8), np.full((1, s), 1.0 / s))
    return dct_matrix_f64() @ m


@functools.lru_cache(maxsize=None)
def _blockdiag_sampled(k: int, s: int, dtype: str = "float32") -> np.ndarray:
    """I_{k/8} (x) (D @ M_s): a [k, k*s] chunk of P."""
    assert k % 8 == 0
    return np.asarray(np.kron(np.eye(k // 8), _sampled_base(s)), dtype=dtype)


def sampled_dct(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """Footprint mean + per-8x8-block DCT: [..., H, W] -> [..., H/sy, W/sx]."""
    *lead, h, w = x.shape
    py = device_const(_sampled_base, sy, like=x)
    px = device_const(_sampled_base, sx, like=x)
    xr = x.reshape(*lead, h // (8 * sy), 8 * sy, w // (8 * sx), 8 * sx)
    y = torch.einsum("ui,...aibj,vj->...aubv", py, xr, px)
    return y.reshape(*lead, h // sy, w // sx)


def sampled_idct_up(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """P_r^T @ x @ P_c: [..., hc, wc] -> [..., hc*sy, wc*sx].  Returns
    upsample(idct(x)) / (sy*sx) — callers multiply by sy*sx."""
    *lead, hc, wc = x.shape
    py = device_const(_sampled_base, sy, like=x)
    px = device_const(_sampled_base, sx, like=x)
    xr = x.reshape(*lead, hc // 8, 8, wc // 8, 8)
    y = torch.einsum("ui,...aubv,vj->...aibj", py, xr, px)
    return y.reshape(*lead, hc * sy, wc * sx)


def dct_raster(x: torch.Tensor) -> torch.Tensor:
    """Forward per-8x8-block orthonormal DCT-II of a raster [..., H, W]."""
    return sampled_dct(x, 1, 1)


def idct_raster(x: torch.Tensor) -> torch.Tensor:
    """Inverse (DCT-III); exact inverse of dct_raster."""
    return sampled_idct_up(x, 1, 1)
