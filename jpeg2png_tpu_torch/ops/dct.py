"""The orthonormal 8x8 DCT matrix, and device constants.

The reference uses Takuya Ooura's scalar butterflies (reference:
ooura/dct.c:34-159) producing the *normalized* (orthonormal) 2-D
DCT-II; orthonormality is what makes the quantization-box projection
valid (reference: README.md:113).  Here the transform is Y = D X D^T
with the 8x8 matrix D (ops/dct_raster.py applies it in raster layout).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def dct_matrix_f64() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix D, float64.

    D[k, n] = s_k * cos(pi * (2n+1) * k / 16),  s_0 = sqrt(1/8), s_k = 1/2.
    Rows are orthonormal: D @ D.T == I (ooura/dct.c:98 dct8x8s).
    """
    k = np.arange(8).reshape(8, 1).astype(np.float64)
    n = np.arange(8).reshape(1, 8).astype(np.float64)
    d = np.cos(np.pi * (2 * n + 1) * k / 16.0) * np.sqrt(2.0 / 8.0)
    d[0, :] = np.sqrt(1.0 / 8.0)
    return d


@functools.lru_cache(maxsize=None)
def _cached(key, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    fn, args = key
    return torch.as_tensor(fn(*args), dtype=dtype, device=device)


def device_const(fn, *args, like: torch.Tensor) -> torch.Tensor:
    """Host constant fn(*args) on like's device and dtype, uploaded once
    (an upload inside the solve loop would stall on the stream)."""
    return _cached((fn, args), like.device, like.dtype)
