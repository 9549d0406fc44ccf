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
(image chunk, iteration chunk).  What bounds it on an H100: memory for
buckets larger than the 50 MB L2, latency below that.  Per iteration
the state streams f and fista through the gradient phase (read) and the
projection (read and write): 24 B per pixel and channel, plus the
gradient written and read (8 B) unless it stays on chip.  What the
design does about it: each image is cut into cells of CELL_W = 128
columns and a run of rows aligned to the coefficient blocks; a block
owns its cells for the whole launch, marches their rows with K1's
row-marching stencil, keeps their gradient and the prob window
p_alpha * idct(devq) at coefficient resolution in its own scratch
(shared memory when the cells fit there at one wave of blocks, else a
global array only that block reads), and projects the same cells, one
thread per coefficient column with the 8x8 transforms in registers and
warp shuffles.  The grid, the rows per cell and the scratch come from
the library (`launch_plan`, j2p_fused_solve_plan); `plan` mirrors them.

Lite mode (fused_solve(..., lite=True), and fused_solve_lite on the
bf16 state itself) replaces the TPU kernel's `lite=True`
(jpeg2png_tpu/kernels/iter_step.py:664-670, 758-761): the FISTA state is
carried as the bf16 difference d = f - fista, the gradient and the devq
carry are bf16, the iterate stays f32:

    e      = f + factor_i * d
    grad   = bf16(TV + TGV2 gather + prob gradient), sumsq from the f32 value
    fnew   = the projection of e - scale * grad, as above
    d      = bf16(fnew - f),  devq = bf16((clamp - dq) * iq * iq),  f = fnew

one iteration is exactly K4 (kernels/stripe_grad.py) then K5
(kernels/project_step.py::fused_project_multi_lite) on the whole canvas,
which is what the plain version runs.  The kernel is the same source,
templated on the storage type of its side buffers: 10 B less per pixel
and channel move each iteration.

On a CPU tensor the wrappers run the plain PyTorch versions below; on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from jpeg2png_tpu_torch.kernels import _build
from jpeg2png_tpu_torch.kernels.grad_step import (
    MAX_CHANNELS, fused_grad_plain, stack_channels)
from jpeg2png_tpu_torch.kernels.project_step import (
    boxes, fused_project_multi_lite_plain)
from jpeg2png_tpu_torch.kernels.stripe_grad import (
    fused_grad_striped_lite_plain)
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


def _solve_one(f, side, devqs, factors, step, datas, qs, p_alpha_sss, samps,
               weight, h_true, w_true, lite):
    """nsteps iterations for one image: f [C, H, W] f32, side the FISTA
    shadow (f32) or, `lite`, the bf16 difference d; devqs list per prob
    channel (bf16 when lite); datas, qs per channel.  Returns (f, side,
    devqs, rows)."""
    C, H, W = f.shape
    prob = [pa != 0.0 for pa in p_alpha_sss]
    bx = None if lite else [boxes(d, q) for d, q in zip(datas, qs)]
    rows = []
    for factor in factors:
        if lite:
            # one iteration of the lite body: K4 then K5, whole canvas
            grad, sumsq, tv, tv2 = fused_grad_striped_lite_plain(
                f, side, devqs, None, float(factor), 0, weight, samps,
                p_alpha_sss, H, h_true, w_true)
        else:
            it = iter(devqs)
            pgrads = []
            for c, (sy, sx) in enumerate(samps):
                if not prob[c]:
                    pgrads.append(None)
                    continue
                pa = p_alpha_sss[c] / (sy * sx)
                pgrads.append(pa * upsample_replicate(
                    idct_raster(next(it)), sy, sx))
            grad, e, sumsq, tv, tv2 = fused_grad_plain(
                f, side, pgrads, float(factor), weight, h_true, w_true)
        norms = torch.sqrt(sumsq)
        scale = torch.where(norms == 0.0, 0.0, step / norms)
        if lite:
            f, side, new_devqs, dists = fused_project_multi_lite_plain(
                f, side, grad, float(factor), scale, datas, qs,
                p_alpha_sss, samps)
            devqs = [d for d in new_devqs if d is not None]
            dists = [d for d, p in zip(dists, prob) if p]
        else:
            fnews, devqs, dists = [], [], []
            for c, (sy, sx) in enumerate(samps):
                lo, hi, dq, iq = bx[c]
                fmid = e[c] - scale[c] * grad[c]
                fnew, clamped = project_channel_raster(fmid, lo, hi, sy, sx)
                fnews.append(fnew)
                if prob[c]:
                    devp = (clamped - dq) * iq
                    dists.append(0.5 * torch.sum(devp * devp))
                    devqs.append(devp * iq)
            side, f = f, torch.stack(fnews)
        row = torch.zeros((PARTIAL_COLS,), device=f.device)
        vals = torch.cat([sumsq, tv.reshape(1), tv2.reshape(1)]
                         + [d.reshape(1) for d in dists])
        row[:C + 2 + len(dists)] = vals
        rows.append(row)
    return f, side, devqs, rows


def _as_batch(f0s, side0s, devq0s, datas_i16, q_rs, extents):
    """Normalize static (one image) and dynamic (leading batch dim)
    arguments to the batched layout."""
    f = stack_channels(f0s)
    side = stack_channels(side0s)
    if extents is None:
        return (f[None], side[None], [d[None] for d in devq0s],
                [d[None] for d in datas_i16], [q[None] for q in q_rs])
    return f, side, list(devq0s), list(datas_i16), list(q_rs)


def _to_lite(f0s, fista0s, devq0s):
    """The f32 (f, fista, devq) interface -> the lite state (f, d, devq
    bf16), as the TPU kernel converts it (iter_step.py:664-670)."""
    f = stack_channels(f0s)
    d = (f - stack_channels(fista0s)).to(torch.bfloat16)
    return f, d, [x.to(torch.bfloat16) for x in devq0s]


def _from_lite(out):
    """The lite state back to the f32 interface: fista = f - d
    (iter_step.py:758-761)."""
    f, d, devqs, partials = out
    return (f, f - d.to(torch.float32),
            [x.to(torch.float32) for x in devqs], partials)


def _plain(f0s, side0s, devq0s, factors, step_size, datas_i16, q_rs,
           p_alpha_sss, samps, weight, extents, lite):
    f, side, devqs, datas, qs = _as_batch(f0s, side0s, devq0s, datas_i16,
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
            f[b], side[b], [d[b] for d in devqs], factors, step,
            [d[b] for d in datas], [q[b] for q in qs], p_alpha_sss, samps,
            weight, exts[b][0], exts[b][1], lite))
    fo = torch.stack([o[0] for o in outs])
    so = torch.stack([o[1] for o in outs])
    P = len(devqs)
    dqo = [torch.stack([o[2][p] for o in outs]) for p in range(P)]
    part = torch.stack([torch.stack(o[3]) if o[3] else
                        torch.zeros((0, PARTIAL_COLS), device=f.device)
                        for o in outs])
    if extents is None:
        return fo[0], so[0], [d[0] for d in dqo], part[0]
    return fo, so, dqo, part


def fused_solve_plain(f0s, fista0s, devq0s, factors, step_size, datas_i16,
                      q_rs, p_alpha_sss, samps, weight, extents=None,
                      lite=False):
    """Plain PyTorch version of fused_solve (same signature)."""
    if lite:
        f, d, devqs = _to_lite(f0s, fista0s, devq0s)
        return _from_lite(fused_solve_lite_plain(
            f, d, devqs, factors, step_size, datas_i16, q_rs, p_alpha_sss,
            samps, weight, extents))
    return _plain(f0s, fista0s, devq0s, factors, step_size, datas_i16, q_rs,
                  p_alpha_sss, samps, weight, extents, False)


def fused_solve_lite_plain(f0s, d0s, devq0s, factors, step_size, datas_i16,
                           q_rs, p_alpha_sss, samps, weight, extents=None):
    """Plain PyTorch version of fused_solve_lite (same signature)."""
    return _plain(f0s, d0s, devq0s, factors, step_size, datas_i16, q_rs,
                  p_alpha_sss, samps, weight, extents, True)


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
    [ctypes.c_void_p] * 6          # f, fista (lite: d), scratch, factors,
                                   # extents, steps
    + [ctypes.c_void_p] * 3        # partials out, gpart, dpart
    + [ctypes.POINTER(ctypes.c_uint64),   # per channel data, q, devq
       ctypes.POINTER(ctypes.c_int),      # per channel sy, sx, devq index
       ctypes.POINTER(ctypes.c_float)]    # per channel p_alpha
    + [ctypes.c_int] * 6           # B, C, H, W, nsteps, grid blocks
    + [ctypes.c_float] * 2         # alpha, alpha2
    + [ctypes.c_int] * 2           # tgv, lite
    + [ctypes.c_void_p]            # stream
)

# csrc/iter_step.cu: output columns of a cell, threads of a block (a
# thread per column and a helper warp), the shortest cell, the dynamic
# shared memory a block may take
CELL_W = 128
BLOCK_THREADS = CELL_W + 32
MIN_CELL_ROWS = 16
MAX_SMEM = 226 * 1024
PLAN_KEYS = ("G", "k", "rows", "resident", "scratch_bytes", "cells",
             "phase_bytes", "cell_bytes")


def _launcher():
    lib = _build.library("iter_step")
    fn = lib.j2p_fused_solve
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        pl = lib.j2p_fused_solve_plan
        pl.argtypes = ([ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 2
                       + [ctypes.POINTER(ctypes.c_longlong)])
        pl.restype = ctypes.c_int
        for name, n in (("j2p_fused_solve_occupancy", 4),
                        ("j2p_fused_solve_ring_bytes", 3)):
            getattr(lib, name).argtypes = [ctypes.c_int] * n
            getattr(lib, name).restype = ctypes.c_int
    return lib, fn


def _channel_ints(samps, prob):
    """(sy, sx, prob index) per channel, as the C interface takes them."""
    ints = (ctypes.c_int * (3 * len(samps)))()
    k = 0
    for c, ((sy, sx), p) in enumerate(zip(samps, prob)):
        ints[3 * c:3 * c + 3] = [sy, sx, k if p else -1]
        k += bool(p)
    return ints


def proj_bytes(C: int, samps) -> int:
    """Shared memory of the projection's band of 8 * max(sy) rows: tiles
    [C, rows, CELL_W] of the old f, the side values, the gradient and (in
    lite mode) fmid, 12 bytes a pixel and channel in both modes."""
    return 12 * C * max(8 * sy for sy, _ in samps) * CELL_W


def plan(B, C, H, W, samps, prob, lite, ring_bytes, occupancy, sms):
    """The decomposition of a K3 launch, as csrc/iter_step.cu make_plan
    chooses it: cells of CELL_W columns and `rows` rows (a multiple of 8 *
    max(sy), at least MIN_CELL_ROWS) sized so that the cells are about one
    wave of co-resident blocks; block g owns cells [g k, g k + k).  The
    scratch (each cell's gradient [C, rows, CELL_W] in the side type and
    its prob windows [rows/sy, CELL_W/sx] f32) is resident in shared
    memory when a block with one cell's scratch still lets every cell's
    block be co-resident.  `ring_bytes`: the gradient phase's shared
    memory (the library's, j2p_fused_solve_ring_bytes); `occupancy(bytes)`:
    co-resident blocks per SM with that much dynamic shared memory; `sms`:
    the card's SMs.  Returns a dict with PLAN_KEYS."""
    ay = max(8 * sy for sy, _ in samps)
    phase = max(ring_bytes, proj_bytes(C, samps))
    slots = occupancy(phase) * sms
    strips = -(-W // CELL_W)
    target = max(1, slots // (B * strips))
    rows = max(MIN_CELL_ROWS, -(-H // target))
    rows = -(-rows // ay) * ay
    cells = B * strips * -(-H // rows)
    grad = C * rows * CELL_W * (2 if lite else 4)
    cell = grad + 4 * sum((rows // sy) * (CELL_W // sx)
                          for (sy, sx), p in zip(samps, prob) if p)
    k, resident = -(-cells // slots), False
    if phase + cell <= MAX_SMEM and occupancy(phase + cell) * sms >= cells:
        k, resident = 1, True
    G = -(-cells // k)
    return {"G": G, "k": k, "rows": rows, "resident": resident,
            "scratch_bytes": 0 if resident else G * k * cell,
            "cells": cells, "phase_bytes": phase, "cell_bytes": cell}


def launch_plan(B, C, H, W, samps, prob, weight, lite=False,
                lib=None) -> dict:
    """The library's decomposition of a launch on the current card (the
    grid, the scratch; PLAN_KEYS).  `lib`: the loaded library (default:
    the package's)."""
    lib = _launcher()[0] if lib is None else lib
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(lib, lib.j2p_fused_solve_plan(
        B, C, H, W, _channel_ints(samps, prob), int(weight != 0.0),
        int(lite), out), "fused_solve plan")
    vals = dict(zip(PLAN_KEYS, (int(v) for v in out)))
    vals["resident"] = bool(vals["resident"])
    return vals


def launch_buffers(pl, B, C, P, device):
    """The scratch of a launch as its plan sizes it: (the blocks' global
    scratch, uint8 [scratch_bytes] or None when it is resident in shared
    memory; per-block gradient sums [B, G, C + 2]; per-block distance sums
    [2, B, G, max(P, 1)], two iterations' worth)."""
    G = pl["G"]
    scratch = (torch.empty((pl["scratch_bytes"],), dtype=torch.uint8,
                           device=device) if pl["scratch_bytes"] else None)
    return (scratch, torch.empty((B, G, C + 2), device=device),
            torch.empty((2, B, G, max(P, 1)), device=device))


def library_plan_inputs(C, weight, lite):
    """(ring_bytes, occupancy(bytes), sms) of `plan` from the library and
    the current card: what make_plan itself uses."""
    lib, _ = _launcher()
    tgv = int(weight != 0.0)
    ring = lib.j2p_fused_solve_ring_bytes(C, tgv, int(lite))

    def occupancy(nbytes):
        n = lib.j2p_fused_solve_occupancy(C, tgv, int(lite), int(nbytes))
        if n < 0:
            _build.check(lib, -n, "fused_solve occupancy")
        return n
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return ring, occupancy, sms


def _check(t, name, shape, dtype, device):
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"fused_solve: {name} must be contiguous {dtype} {list(shape)} "
            f"on {device}, got {t.dtype} {list(t.shape)} on {t.device}")


def _launch(f0s, side0s, devq0s, factors, step_size, datas_i16, q_rs,
            p_alpha_sss, samps, weight, extents, lite):
    """Check the arguments and launch K3 on copies of the state.  Returns
    (f, side, devqs, partials) in the callers' layout, and whether the
    kernel launched (nsteps > 0)."""
    dev = stack_channels(f0s).device
    fb, sideb, devqs, datas, qs = _as_batch(f0s, side0s, devq0s, datas_i16,
                                            q_rs, extents)
    B, C, H, W = fb.shape
    side_t = torch.bfloat16 if lite else torch.float32
    prob = [p != 0.0 for p in p_alpha_sss]
    P = sum(prob)
    if (len(samps) != C or len(datas) != C or len(qs) != C
            or len(p_alpha_sss) != C or len(devqs) != P):
        raise ValueError("fused_solve: per-channel argument counts differ")
    if not supports(C, H, W, samps, P):
        raise ValueError(f"fused_solve: geometry C={C} {H}x{W} samps={samps} "
                         f"P={P} is outside the kernel's gate")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"fused_solve: batch {B} outside 1..{MAX_BATCH}")
    _check(fb, "fdatas", (B, C, H, W), torch.float32, dev)
    _check(sideb, "fistas" if not lite else "ds", (B, C, H, W), side_t, dev)
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
    side_out = sideb.clone()
    ptrs = (ctypes.c_uint64 * (3 * C))()
    pas = (ctypes.c_float * C)()
    dq_out = []
    k = 0
    for c, (sy, sx) in enumerate(samps):
        shp = (B, H // sy, W // sx)
        _check(datas[c], f"datas_i16[{c}]", shp, torch.int16, dev)
        _check(qs[c], f"q_rs[{c}]", shp, torch.float32, dev)
        ptrs[3 * c] = datas[c].data_ptr()
        ptrs[3 * c + 1] = qs[c].data_ptr()
        if prob[c]:
            _check(devqs[k], f"devq0s[{k}]", shp, side_t, dev)
            d = devqs[k].clone()
            dq_out.append(d)
            ptrs[3 * c + 2] = d.data_ptr()
            k += 1
        pas[c] = p_alpha_sss[c] / (sy * sx)
    partials = torch.zeros((B, nsteps, PARTIAL_COLS), device=dev)
    if nsteps:
        # grid and scratch as the library plans them for this card
        lib, fn = _launcher()
        pl = launch_plan(B, C, H, W, samps, prob, weight, lite, lib)
        scratch, gpart, dpart = launch_buffers(pl, B, C, P, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(f_out.data_ptr(), side_out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 factors.data_ptr(), ext.data_ptr(), steps.data_ptr(),
                 partials.data_ptr(), gpart.data_ptr(), dpart.data_ptr(),
                 ptrs, _channel_ints(samps, prob), pas, B, C, H, W, nsteps,
                 pl["G"], 1.0 / math.sqrt(C),
                 (weight / math.sqrt(2.0)) / math.sqrt(C),
                 int(weight != 0.0), int(lite), stream)
        _build.check(lib, err, "fused_solve")
    if extents is None:
        out = f_out[0], side_out[0], [d[0] for d in dq_out], partials[0]
    else:
        out = f_out, side_out, dq_out, partials
    return out, nsteps > 0


def fused_solve(f0s, fista0s, devq0s, factors, step_size, datas_i16, q_rs,
                p_alpha_sss, samps, weight, extents=None, lite=False):
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
        lite: run the lite mode (fused_solve_lite) behind this f32
            interface, converting at the edges like the TPU kernel.
    Returns:
        (fdatas, fistas, devqs_out list, partials [nsteps, 8]) — with
        `extents`, fdatas/fistas [B, C, H, W], devqs [B, hc, wc] and
        partials [B, nsteps, 8].
    """
    if stack_channels(f0s).device.type == "cpu":
        return _build.check_finite("fused_solve", fused_solve_plain(
            f0s, fista0s, devq0s, factors, step_size, datas_i16, q_rs,
            p_alpha_sss, samps, weight, extents, lite))
    if stack_channels(f0s).device.type != "cuda":
        raise ValueError(
            f"fused_solve: unsupported device {stack_channels(f0s).device}")
    if lite:
        f, d, devqs = _to_lite(f0s, fista0s, devq0s)
        return _from_lite(fused_solve_lite(
            f, d, devqs, factors, step_size, datas_i16, q_rs, p_alpha_sss,
            samps, weight, extents))
    out, launched = _launch(f0s, fista0s, devq0s, factors, step_size,
                            datas_i16, q_rs, p_alpha_sss, samps, weight,
                            extents, False)
    _build.count_launch(fused_solve, launched)
    return _build.check_finite("fused_solve", out)


def fused_solve_lite(f0s, d0s, devq0s, factors, step_size, datas_i16, q_rs,
                     p_alpha_sss, samps, weight, extents=None):
    """K3's lite mode on the lite state itself: fused_solve's arguments
    and results with d = f - fista ([C, H, W] or [B, C, H, W] bfloat16)
    in place of fista and bfloat16 devq carries.  The solver's mega-lite
    tier and the dyn serving class carry this state across chunks."""
    if stack_channels(f0s).device.type == "cpu":
        return _build.check_finite("fused_solve_lite", fused_solve_lite_plain(
            f0s, d0s, devq0s, factors, step_size, datas_i16, q_rs,
            p_alpha_sss, samps, weight, extents))
    if stack_channels(f0s).device.type != "cuda":
        raise ValueError("fused_solve_lite: unsupported device "
                         f"{stack_channels(f0s).device}")
    out, launched = _launch(f0s, d0s, devq0s, factors, step_size, datas_i16,
                            q_rs, p_alpha_sss, samps, weight, extents, True)
    _build.count_launch(fused_solve_lite, launched)
    return _build.check_finite("fused_solve_lite", out)


fused_solve.launches = 0
fused_solve_lite.launches = 0
