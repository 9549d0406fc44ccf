"""The plain reference solve: one JPEG's coefficients in, RGB pixels out.

A straightforward float32 PyTorch statement of jpeg2png's smoothing
decode (upstream compute.c, png.c), written for the benchmark alone: it
imports nothing of the program, and takes only what the benchmark's own
JPEG writer recorded (each component's quantised coefficients, its
quantisation table and its sampling).

    minimise  TV(u) + w/sqrt(2) TGV2(u) + p_alpha/2 |(DCT(u) - dq)/q|^2
    over u whose block DCT lies in the quantisation boxes

by FISTA on the projected subgradient, with a constant step
sqrt(H W) / 2 / sqrt(1 + iterations) normalised per channel by the
gradient's norm, the channels coupled in the TV and TGV2 norms, and the
projection a clamp of each channel's (footprint-mean) block DCT.  The
8x8 transforms are matrix products (`torch.einsum`), so that TF32
reaches them when it is switched on: the control of the comparison.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

GAP_BOX = 2.0 ** 39        # the box of a coefficient outside a channel's region


def dct_matrix(device, dtype=torch.float32) -> torch.Tensor:
    """The orthonormal 8-point DCT-II matrix D (D @ D.T == I)."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / 16.0) * 0.5
    d[0, :] = math.sqrt(1.0 / 8.0)
    return torch.as_tensor(d, dtype=dtype, device=device)


def block_dct(x, D):
    """Per-8x8-block D X D^T of a raster [h, w] (h, w multiples of 8)."""
    h, w = x.shape
    xr = x.reshape(h // 8, 8, w // 8, 8)
    return torch.einsum("ui,aibj,vj->aubv", D, xr, D).reshape(h, w)


def block_idct(c, D):
    h, w = c.shape
    cr = c.reshape(h // 8, 8, w // 8, 8)
    return torch.einsum("ui,aubv,vj->aibj", D, cr, D).reshape(h, w)


def shift(a, dy: int, dx: int):
    """out[..., y, x] = a[..., y - dy, x - dx], zero outside."""
    h, w = a.shape[-2:]
    p = F.pad(a, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[..., y0:y0 + h, x0:x0 + w]


def up(x, sy: int, sx: int):
    if sy == 1 and sx == 1:
        return x
    return x.repeat_interleave(sy, 0).repeat_interleave(sx, 1)


def footprint_mean(x, sy: int, sx: int):
    if sy == 1 and sx == 1:
        return x
    h, w = x.shape
    return x.reshape(h // sy, sy, w // sx, sx).mean(dim=(1, 3))


def tv_tgv_gradient(e, weight: float):
    """The subgradient of TV + weight/sqrt(2) TGV2 at e [C, H, W]: forward
    differences zero on the last column and row, backward differences of
    them zero on the first, the norms over all channels, 0 where a norm
    is 0, each term scaled by 1/sqrt(C)."""
    C = e.shape[0]
    gx = shift(e, 0, -1) - e
    gx[:, :, -1] = 0.0
    gy = shift(e, -1, 0) - e
    gy[:, -1, :] = 0.0
    n1 = torch.sqrt(torch.sum(gx * gx + gy * gy, dim=0))
    inv1 = torch.where(n1 == 0.0, 0.0, 1.0 / n1)
    a, b = gx * inv1, gy * inv1
    grad = (-(a + b) + shift(a, 0, 1) + shift(b, 1, 0)) / math.sqrt(C)
    if weight == 0.0:
        return grad
    gxx = gx - shift(gx, 0, 1)
    gxx[:, :, 0] = 0.0
    gyx = gy - shift(gy, 0, 1)
    gyx[:, :, 0] = 0.0
    gxy = gx - shift(gx, 1, 0)
    gxy[:, 0, :] = 0.0
    gyy = gy - shift(gy, 1, 0)
    gyy[:, 0, :] = 0.0
    sym = (gxy + gyx) * 0.5
    n2 = torch.sqrt(torch.sum(gxx * gxx + 2.0 * sym * sym + gyy * gyy, dim=0))
    inv2 = torch.where(n2 == 0.0, 0.0, 1.0 / n2)
    center = -(2.0 * gxx + 2.0 * sym + 2.0 * gyy) * inv2
    p = (gxx + sym) * inv2
    q = (gyy + sym) * inv2
    r = -sym * inv2
    g2 = (center + shift(p, 0, -1) + shift(p, 0, 1) + shift(q, -1, 0)
          + shift(q, 1, 0) + shift(r, -1, 1) + shift(r, 1, -1))
    return grad + (weight / math.sqrt(2.0)) / math.sqrt(C) * g2


def fista_factors(iterations: int) -> np.ndarray:
    t, out = 1.0, np.empty((iterations,), np.float32)
    for i in range(iterations):
        tnext = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        out[i] = (t - 1.0) / tnext
        t = tnext
    return out


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in the matrix products on (the control) or off (the
    reference), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _deblock(blocks):
    nby, nbx = blocks.shape[:2]
    return blocks.permute(0, 2, 1, 3).reshape(nby * 8, nbx * 8)


def solve(components, height: int, width: int, weight: float,
          pweight: float, iterations: int, device="cpu", tf32=False):
    """Smooth-decode one JPEG.

    components: per component (coefs int16 [nby, nbx, 8, 8] in natural
    order, quant [8, 8], (sy, sx) how many canvas rows and columns one of
    its samples covers).  Returns [height, width, 3] uint8 RGB (or
    [height, width] for one component)."""
    with matmul_precision(tf32), torch.no_grad():
        return _solve(components, height, width, weight, pweight,
                      iterations, torch.device(device))


def _solve(components, height, width, weight, pweight, iterations, device):
    D = dct_matrix(device)
    H = max(c.shape[0] * 8 * sy for c, _, (sy, sx) in components)
    W = max(c.shape[1] * 8 * sx for c, _, (sy, sx) in components)
    C = len(components)
    p_alpha = pweight * 2.0 * 255.0 * math.sqrt(2.0)
    step = math.sqrt(float(H) * float(W)) / 2.0 / math.sqrt(1.0 + iterations)
    chans = []
    for coefs, quant, (sy, sx) in components:
        data = _deblock(torch.as_tensor(np.asarray(coefs, np.float32),
                                        device=device))
        nby, nbx = coefs.shape[:2]
        q = torch.as_tensor(np.asarray(quant, np.float32),
                            device=device).repeat(nby, nbx)
        dq = data * q
        plain = block_idct(dq, D)
        ys = torch.clamp(torch.arange(H, device=device) // sy, max=nby * 8 - 1)
        xs = torch.clamp(torch.arange(W, device=device) // sx, max=nbx * 8 - 1)
        f0 = plain[ys][:, xs]
        pad = (0, W // sx - nbx * 8, 0, H // sy - nby * 8)
        lo = F.pad(dq - 0.5 * q, pad, value=-GAP_BOX)
        hi = F.pad(dq + 0.5 * q, pad, value=GAP_BOX)
        chans.append(dict(f0=f0, lo=lo, hi=hi, dq=F.pad(dq, pad),
                          iq=F.pad(1.0 / q, pad), sy=sy, sx=sx))
    f = torch.stack([c["f0"] for c in chans])
    fista = f
    pgrad = torch.zeros_like(f)
    for factor in fista_factors(iterations):
        e = f + float(factor) * (f - fista)
        grad = tv_tgv_gradient(e, weight) + pgrad
        norms = torch.sqrt(torch.sum(grad * grad, dim=(1, 2)))
        scale = torch.where(norms == 0.0, 0.0, step / norms)
        fnew, pgs = [], []
        for k, c in enumerate(chans):
            sy, sx = c["sy"], c["sx"]
            fmid = e[k] - scale[k] * grad[k]
            sub = footprint_mean(fmid, sy, sx)
            clamped = torch.minimum(torch.maximum(block_dct(sub, D), c["lo"]),
                                    c["hi"])
            proj = up(block_idct(clamped, D), sy, sx)
            fnew.append(proj if sy == sx == 1 else fmid - up(sub, sy, sx) + proj)
            dev = (clamped - c["dq"]) * c["iq"] * c["iq"]
            pgs.append(p_alpha * up(block_idct(dev, D), sy, sx))
        fista, f = f, torch.stack(fnew)
        pgrad = torch.stack(pgs) if p_alpha != 0.0 else pgrad
    return to_pixels(f, height, width)


def to_pixels(f, height: int, width: int) -> np.ndarray:
    """The solved canvas [C, H, W] (luma centred at 0) -> 8-bit pixels:
    luma + 128, JFIF YCbCr -> RGB, clamp to [0, 255], truncate."""
    y = f[0, :height, :width] + 128.0
    if f.shape[0] == 1:
        return y.clamp(0.0, 255.0).to(torch.int32).cpu().numpy().astype(
            np.uint8)
    cb, cr = f[1, :height, :width], f[2, :height, :width]
    rgb = torch.stack([y + 1.402 * cr, y - 0.34414 * cb - 0.71414 * cr,
                       y + 1.772 * cb], dim=-1).clamp(0.0, 255.0)
    return rgb.to(torch.int32).cpu().numpy().astype(np.uint8)
