"""Whole-solve kernel (K3): every iteration of a chunk in one launch.

Replaces the Pallas kernel jpeg2png_tpu/kernels/iter_step.py::fused_solve
(`_kernel`).  One launch runs `nsteps` iterations of the two-kernel body
(K1 + K2, models/solver.py) for a batch of B images padded into one
bucket canvas [H, W]:

    e      = f + factor_i * (f - fista)
    grad   = TV + TGV2 gather of e (zero outside each image's true
             extent) + p_alpha * up(idct(devq))          (gradient phase)
    -- global barrier: per image and channel sumsq = sum grad^2 --
    scale  = step / sqrt(sumsq)   (0 at zero norm)
    fmid   = e - scale * grad
    clamp  = clip(D mean(fmid) D^T, lo, hi)              (projection phase)
    fnew   = fmid - up(mean) + up(idct(clamp))
    devq   = (clamp - dq) * iq * iq,  dist = 0.5 * sum((clamp - dq) * iq)^2
    fista, f = f, fnew                                   (FISTA swap)
    -- global barrier --

lo, hi, dq and iq come from the int16 coefficient raster and the f32
quant raster: lo, hi = data*q -+ q/2, dq = data*q; q == 0 marks frozen
canvas padding (lo == hi == 0, iq = 0) and q >= FREE_Q_MIN a region gap
(unconstrained box, iq = 0).  One partials row per image and iteration:
[sumsq_0..C-1, tv, tv2, dist_p0, ...] (zeros up to 8 columns).

The projection is the reference's reconstruction (ops/projection.py),
as in the port's K2, not the TPU kernel's correction form
fmid + ss * P^T (clamp - coefs) P; the step scale is step / sqrt(sumsq)
like the two-kernel body, not step * rsqrt(sumsq); everything is f32.
So the plain version below runs exactly the two-kernel body's
arithmetic, with the prob term carried at coefficient resolution.

CUDA version: csrc/iter_step.cu, one persistent cooperative launch per
(image chunk, iteration chunk).  What bounds it on an H100: memory.  Per
iteration it reads f, fista (gradient phase, with halos from the
caches) and writes grad, then reads f, fista, grad and writes f, fista:
32 B per pixel and channel, plus the int16 and quant rasters and devq
read and write at coefficient resolution.  A bucket whose state fits in
the 50 MB L2 cache can beat that device-memory bound.  What the design
does about it: nothing beyond K1 + K2 yet (the state goes through
device memory every iteration); it removes the per-iteration launches
and host work, which bound small images.

On a CPU tensor the wrapper runs the plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from jpeg2png_tpu_torch.kernels import _build
from jpeg2png_tpu_torch.kernels.grad_step import (
    MAX_CHANNELS, fused_grad_plain, stack_channels)
from jpeg2png_tpu_torch.kernels.project_step import FREE_Q_MIN
from jpeg2png_tpu_torch.ops.dct_raster import idct_raster
from jpeg2png_tpu_torch.ops.projection import project_channel_raster
from jpeg2png_tpu_torch.ops.resample import upsample_replicate

PARTIAL_COLS = 8     # [sumsq_0..C-1, tv, tv2, dist_p...] per row
MAX_BATCH = 8        # images per launch (one bucket chunk)
LEGAL_SAMPS = (1, 2, 4)


def supports(C: int, H: int, W: int, samps, n_prob: int | None = None) -> bool:
    """Geometry gate of the whole-solve kernel on Hopper: the partials
    row holds C + 2 + P columns (P = prob channels, default all C), the
    footprints are 1, 2 or 4 pixels per axis and the canvas is whole
    8x8 coefficient blocks of every channel.  No memory budget: the
    state lives in device memory."""
    P = C if n_prob is None else n_prob
    if not 1 <= C <= MAX_CHANNELS or C + 2 + P > PARTIAL_COLS:
        return False
    return all(sy in LEGAL_SAMPS and sx in LEGAL_SAMPS
               and H % (8 * sy) == 0 and W % (8 * sx) == 0
               for sy, sx in samps)


def fista_factors(t0: float, nsteps: int):
    """[nsteps] f32 extrapolation factors from FISTA momentum t0
    (compute.c:427-440: factor 0 on the first iteration when t0 == 1).
    Returns (factors numpy [nsteps], t_final)."""
    t = float(t0)
    out = np.empty((nsteps,), np.float32)
    for i in range(nsteps):
        tnext = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        out[i] = (t - 1.0) / tnext
        t = tnext
    return out, t


def _boxes(data_i16, q):
    """(lo, hi, dq, iq) from an int16 coefficient raster and its f32
    quant raster (jpeg.c:86, compute.c:323-331), with the frozen (q == 0)
    and FREE (q >= FREE_Q_MIN) rules of project_step.py."""
    dq = data_i16.to(torch.float32) * q
    lo = dq - 0.5 * q
    hi = dq + 0.5 * q
    iq = torch.where((q > 0.0) & (q < FREE_Q_MIN), 1.0 / q,
                     torch.zeros((), dtype=q.dtype, device=q.device))
    return lo, hi, dq, iq


def _solve_one(f, fi, devqs, factors, step, datas, qs, p_alpha_sss, samps,
               weight, h_true, w_true):
    """nsteps iterations for one image: f, fi [C, H, W]; devqs list per
    prob channel; datas, qs per channel.  Returns (f, fi, devqs, rows)."""
    C = f.shape[0]
    prob = [pa != 0.0 for pa in p_alpha_sss]
    boxes = [_boxes(d, q) for d, q in zip(datas, qs)]
    rows = []
    for factor in factors:
        it = iter(devqs)
        pgrads = []
        for c, (sy, sx) in enumerate(samps):
            if not prob[c]:
                pgrads.append(None)
                continue
            pa = p_alpha_sss[c] / (sy * sx)
            pgrads.append(pa * upsample_replicate(idct_raster(next(it)),
                                                  sy, sx))
        grad, e, sumsq, tv, tv2 = fused_grad_plain(
            f, fi, pgrads, float(factor), weight, h_true, w_true)
        norms = torch.sqrt(sumsq)
        scale = torch.where(norms == 0.0, 0.0, step / norms)
        fnews, new_devqs, dists = [], [], []
        for c, (sy, sx) in enumerate(samps):
            lo, hi, dq, iq = boxes[c]
            fmid = e[c] - scale[c] * grad[c]
            fnew, clamped = project_channel_raster(fmid, lo, hi, sy, sx)
            fnews.append(fnew)
            if prob[c]:
                devp = (clamped - dq) * iq
                dists.append(0.5 * torch.sum(devp * devp))
                new_devqs.append(devp * iq)
        fi, f = f, torch.stack(fnews)
        devqs = new_devqs
        row = torch.zeros((PARTIAL_COLS,), device=f.device)
        vals = torch.cat([sumsq, tv.reshape(1), tv2.reshape(1)]
                         + [d.reshape(1) for d in dists])
        row[:C + 2 + len(dists)] = vals
        rows.append(row)
    return f, fi, devqs, rows


def _as_batch(f0s, fista0s, devq0s, datas_i16, q_rs, extents):
    """Normalize static (one image) and dynamic (leading batch dim)
    arguments to the batched layout."""
    f = stack_channels(f0s)
    fi = stack_channels(fista0s)
    if extents is None:
        return (f[None], fi[None], [d[None] for d in devq0s],
                [d[None] for d in datas_i16], [q[None] for q in q_rs])
    return f, fi, list(devq0s), list(datas_i16), list(q_rs)


def fused_solve_plain(f0s, fista0s, devq0s, factors, step_size, datas_i16,
                      q_rs, p_alpha_sss, samps, weight, extents=None):
    """Plain PyTorch version of fused_solve (same signature)."""
    f, fi, devqs, datas, qs = _as_batch(f0s, fista0s, devq0s, datas_i16,
                                        q_rs, extents)
    B, C, H, W = f.shape
    factors = np.asarray(torch.as_tensor(factors).cpu(), np.float32)
    if extents is None:
        exts = [(H, W)]
        steps = [float(step_size)]
    else:
        exts = [tuple(int(v) for v in e) for e in
                torch.as_tensor(extents).cpu().tolist()]
        steps = [float(s) for s in torch.as_tensor(step_size).cpu().tolist()]
    outs = []
    for b in range(B):
        # the step scale is an f32 quantity like the kernel's
        step = float(np.float32(steps[b]))
        outs.append(_solve_one(
            f[b], fi[b], [d[b] for d in devqs], factors, step,
            [d[b] for d in datas], [q[b] for q in qs], p_alpha_sss, samps,
            weight, exts[b][0], exts[b][1]))
    fo = torch.stack([o[0] for o in outs])
    fio = torch.stack([o[1] for o in outs])
    P = len(devqs)
    dqo = [torch.stack([o[2][p] for o in outs]) for p in range(P)]
    part = torch.stack([torch.stack(o[3]) if o[3] else
                        torch.zeros((0, PARTIAL_COLS), device=f.device)
                        for o in outs])
    if extents is None:
        return fo[0], fio[0], [d[0] for d in dqo], part[0]
    return fo, fio, dqo, part


def fused_iteration(fdatas, fistas, devqs, factor, step_size, datas_i16,
                    q_rs, p_alpha_sss, samps, weight):
    """One iteration through fused_solve (the parity tests' shape).

    Returns (fnews [C, H, W], devqs_out list, tv, tv2, dists [P], sumsq [C])
    """
    C = len(samps)
    fnews, _, devqs_out, partials = fused_solve(
        fdatas, fistas, devqs, np.asarray([factor], np.float32), step_size,
        datas_i16, q_rs, p_alpha_sss, samps, weight)
    row = partials[0]
    P = len(devqs_out)
    return (fnews, devqs_out, row[C], row[C + 1],
            [row[C + 2 + p] for p in range(P)], row[:C])


_ARGTYPES = (
    [ctypes.c_void_p] * 6          # f, fista, grad, factors, extents, steps
    + [ctypes.c_void_p] * 3        # partials out, gpart, dpart
    + [ctypes.POINTER(ctypes.c_uint64),   # per channel data, q, devq
       ctypes.POINTER(ctypes.c_int),      # per channel sy, sx, devq index
       ctypes.POINTER(ctypes.c_float)]    # per channel p_alpha
    + [ctypes.c_int] * 6           # B, C, H, W, nsteps, grid blocks
    + [ctypes.c_float] * 2         # alpha, alpha2
    + [ctypes.c_int]               # tgv
    + [ctypes.c_void_p]            # stream
)


def _launcher():
    lib = _build.library("iter_step")
    fn = lib.j2p_fused_solve
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        grid = lib.j2p_fused_solve_grid
        grid.argtypes = [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int)]
        grid.restype = ctypes.c_int
    return lib, fn


def grid_blocks(C: int, weight: float) -> int:
    """Blocks of the cooperative launch (co-resident blocks per SM times
    the SMs) for this channel count and TGV2 setting."""
    lib, _ = _launcher()
    n = ctypes.c_int(0)
    _build.check(lib, lib.j2p_fused_solve_grid(C, int(weight != 0.0),
                                               ctypes.byref(n)),
                 "fused_solve grid")
    return n.value


def _check(t, name, shape, dtype, device):
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"fused_solve: {name} must be contiguous {dtype} {list(shape)} "
            f"on {device}, got {t.dtype} {list(t.shape)} on {t.device}")


def fused_solve(f0s, fista0s, devq0s, factors, step_size, datas_i16, q_rs,
                p_alpha_sss, samps, weight, extents=None):
    """Run `nsteps = len(factors)` solver iterations in one launch (K3).

    Args:
        f0s, fista0s: [C, H, W] float32 (or per-channel lists of [H, W]);
            with `extents`, [B, C, H, W] (B images of one bucket canvas).
        devq0s: per prob channel [hc, wc] float32 (clamp - dq)/q^2 carry
            ([B, hc, wc] with `extents`); zeros at a fresh start.
        factors: [nsteps] FISTA extrapolation factors (host array or
            tensor).
        step_size: float (static); [B] float32 tensor with `extents`.
        datas_i16: per channel [hc, wc] int16 coefficient rasters
            ([B, hc, wc] with `extents`), hc, wc = H/sy, W/sx.
        q_rs: per channel f32 quant rasters of the same shape (0: frozen
            padding, >= FREE_Q_MIN: region gap).
        p_alpha_sss: per channel host float p_alpha * sy * sx (0: off).
        samps: per channel (sy, sx).
        weight: TGV2 weight.
        extents: None (static: the true extent is the canvas) or [B, 2]
            int32 true (h, w) per image (dynamic-extent bucket mode).
    Returns:
        (fdatas, fistas, devqs_out list, partials [nsteps, 8]) — with
        `extents`, fdatas/fistas [B, C, H, W], devqs [B, hc, wc] and
        partials [B, nsteps, 8].
    """
    f = stack_channels(f0s)
    if f.device.type == "cpu":
        return fused_solve_plain(f0s, fista0s, devq0s, factors, step_size,
                                 datas_i16, q_rs, p_alpha_sss, samps,
                                 weight, extents)
    if f.device.type != "cuda":
        raise ValueError(f"fused_solve: unsupported device {f.device}")
    dev = f.device
    fb, fib, devqs, datas, qs = _as_batch(f0s, fista0s, devq0s, datas_i16,
                                          q_rs, extents)
    B, C, H, W = fb.shape
    P = sum(1 for p in p_alpha_sss if p != 0.0)
    if (len(samps) != C or len(datas) != C or len(qs) != C
            or len(p_alpha_sss) != C or len(devqs) != P):
        raise ValueError("fused_solve: per-channel argument counts differ")
    if not supports(C, H, W, samps, P):
        raise ValueError(f"fused_solve: geometry C={C} {H}x{W} samps={samps} "
                         f"P={P} is outside the kernel's gate")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"fused_solve: batch {B} outside 1..{MAX_BATCH}")
    _check(fb, "fdatas", (B, C, H, W), torch.float32, dev)
    _check(fib, "fistas", (B, C, H, W), torch.float32, dev)
    factors = torch.as_tensor(np.asarray(torch.as_tensor(factors).cpu(),
                                         np.float32), device=dev)
    nsteps = int(factors.shape[0])
    if extents is None:
        ext = torch.tensor([[H, W]], dtype=torch.int32, device=dev)
        steps = torch.tensor([float(step_size)], dtype=torch.float32,
                             device=dev)
    else:
        ext, steps = extents, step_size
        _check(ext, "extents", (B, 2), torch.int32, dev)
        _check(steps, "step_size", (B,), torch.float32, dev)
        lim = ext.cpu()
        if bool(((lim < 1) | (lim > torch.tensor([H, W]))).any()):
            raise ValueError(f"fused_solve: extents {lim.tolist()} outside "
                             f"the {H}x{W} canvas")

    # the kernel updates its state in place: work on copies
    f_out = fb.clone()
    fi_out = fib.clone()
    ptrs = (ctypes.c_uint64 * (3 * C))()
    ints = (ctypes.c_int * (3 * C))()
    pas = (ctypes.c_float * C)()
    dq_out = []
    k = 0
    for c, (sy, sx) in enumerate(samps):
        shp = (B, H // sy, W // sx)
        _check(datas[c], f"datas_i16[{c}]", shp, torch.int16, dev)
        _check(qs[c], f"q_rs[{c}]", shp, torch.float32, dev)
        ptrs[3 * c] = datas[c].data_ptr()
        ptrs[3 * c + 1] = qs[c].data_ptr()
        if p_alpha_sss[c] != 0.0:
            _check(devqs[k], f"devq0s[{k}]", shp, torch.float32, dev)
            d = devqs[k].clone()
            dq_out.append(d)
            ptrs[3 * c + 2] = d.data_ptr()
            ints[3 * c:3 * c + 3] = [sy, sx, k]
            k += 1
        else:
            ints[3 * c:3 * c + 3] = [sy, sx, -1]
        pas[c] = p_alpha_sss[c] / (sy * sx)
    partials = torch.zeros((B, nsteps, PARTIAL_COLS), device=dev)
    if nsteps:
        G = grid_blocks(C, weight)
        grad = torch.empty_like(f_out)
        gpart = torch.empty((G, B, C + 2), device=dev)
        dpart = torch.empty((G, B, max(P, 1)), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib, fn = _launcher()
        err = fn(f_out.data_ptr(), fi_out.data_ptr(), grad.data_ptr(),
                 factors.data_ptr(), ext.data_ptr(), steps.data_ptr(),
                 partials.data_ptr(), gpart.data_ptr(), dpart.data_ptr(),
                 ptrs, ints, pas, B, C, H, W, nsteps, G,
                 1.0 / math.sqrt(C), (weight / math.sqrt(2.0)) / math.sqrt(C),
                 int(weight != 0.0), stream)
        _build.check(lib, err, "fused_solve")
        fused_solve.launches += 1
    if extents is None:
        return f_out[0], fi_out[0], [d[0] for d in dq_out], partials[0]
    return f_out, fi_out, dq_out, partials


fused_solve.launches = 0
