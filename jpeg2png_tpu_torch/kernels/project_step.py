"""Fused normalized step + box projection: K2, its one-channel form K6 and
its lite form K5.

Replaces the Pallas kernel
jpeg2png_tpu/kernels/project_step.py::fused_project_multi
(`_kernel_multi`, `_stripe_math`).  For every channel c, in one launch:

    fmid   = extrap - scale_c * grad                (normalized step)
    coefs  = P_r @ fmid @ P_c^T                     (footprint mean + DCT)
    clamp  = clip(coefs, lo, hi)                    (box projection)
    fnew   = fmid - up(mean) + up(idct(clamp))      (mean/residual form)
    devp   = (clamp - dq) * inv_q
    dist_c = 0.5 * sum(devp^2)                      (next prob_dist)
    pgrad  = p_alpha * ss * P_r^T (devp * inv_q) P_c  (next prob grad)

with ss = sy * sx and P = D @ M_s per axis (ops/dct_raster.py).  fnew is
the reference's reconstruction (compute.c:349-403), as ops/projection.py
computes it; the TPU kernel's correction form fmid + ss * P_r^T (clamp -
coefs) P_c equals it up to rounding, but keeps flat regions exactly
flat where the reconstruction leaves round-off, and the TV subgradient
(1/|g| at |g| ~ 0) makes the two trajectories part after ~2 iterations.
The reconstruction tracks the reference binary's CSV logs like the JAX
package's XLA path (tests/test_torch_e2e.py).

CUDA version: csrc/project_step.cu.  What bounds it on an H100: memory.
It reads extrap and grad for all channels and lo, hi, dq, iq at
coefficient resolution, and writes fnew and pgrad (~453 MB at
3072x2048 4:2:0), against three 8x8 transform pairs per coefficient
block.  What the design does about it: each (8*sy x 8*sx) pixel
footprint maps to exactly one 8x8 coefficient block and depends on
nothing else, so a block of 256 threads takes four neighbouring
coefficient blocks of one channel, one thread per coefficient, reads
each input from device memory once (the footprint's second read, for
the residual, hits the caches), keeps the 8x8 transforms in shared
memory, and writes each output once.  The DCT
matrix lives in __constant__ memory; the per-channel step scales are
read from a device array (no host round trip).  The distance partials
take the two-pass fixed-order reduction of K1.  Arithmetic is plain f32
throughout: the bf16x3 MXU split and the single-pass bf16 backward
transform of the TPU kernel were devices of the TPU's matrix unit.

Region gaps (a channel whose own region is smaller than the canvas)
carry unconstrained boxes lo = -2^39, hi = +2^39 with dq = iq = 0, so
the clamp is a no-op there and the prob term is exactly zero
(jpeg2png_tpu/models/solver.py:655-680).

K6, fused_project, replaces the Pallas kernel
jpeg2png_tpu/kernels/project_step.py::fused_project (`_kernel`,
`_kernel_adapter`): K2's function for one channel, with the same
reconstruction form.  The JAX package launches it where its multi-channel
VMEM gate fails; the port's K2 has no such gate, so K6 takes the
row-striped solve's one-channel bands instead (-s with --tpu-stripes,
grayscale).  CUDA version: a kernel of its own in csrc/project_step.cu on
K2's device functions, with no per-channel table and the footprint a
compile-time constant; bound by memory like K2.

K5, fused_project_multi_lite, replaces the Pallas kernel
jpeg2png_tpu/kernels/project_step.py::fused_project_multi_lite
(`_kernel_multi_lite`, `_stripe_math_lite`): the lite tiers' projection.
It takes f (f32), d = f - fista and the gradient (bf16), rebuilds
e = f + factor * d, builds the boxes from the int16 coefficient raster
and the f32 quant raster (q == 0 frozen padding, q >= FREE_Q_MIN a
region gap), and writes fnew (f32), dnew = fnew - f (bf16), devq =
(clamp - dq) / q^2 (bf16, the next gradient's prob carry) and the
distances; no pixel-space prob gradient.  The projection is the same
mean/residual reconstruction in f32 as K2's, not the TPU kernel's
correction form with a single-pass bf16 backward transform.  CUDA
version: csrc/project_lite.cu, K2's design; bound by memory (12 B per
pixel and channel, 8 B per coefficient).
"""

from __future__ import annotations

import ctypes

import torch

from jpeg2png_tpu_torch.kernels import _build
from jpeg2png_tpu_torch.kernels.grad_step import MAX_CHANNELS, stack_channels
from jpeg2png_tpu_torch.ops.prob import prob_term_raster
from jpeg2png_tpu_torch.ops.projection import project_channel_raster

# FREE-sentinel quant pair shared with the JAX package's kernels: writers
# mark region-gap coefficients with FREE_Q; kernels that rebuild boxes
# from int16 + quant rasters treat q >= FREE_Q_MIN as unconstrained and
# q == 0 as frozen canvas padding.
FREE_Q = 2.0 ** 40
FREE_Q_MIN = 2.0 ** 39
# half-width of the unconstrained box of a region gap (solver.py:655)
GAP_BOX = 2.0 ** 39


def fused_project_plain(extrap, grad, scale, lo, hi, dq, inv_q, p_alpha_ss,
                        sy: int, sx: int):
    """Plain PyTorch version of fused_project, from ops/: K2's arithmetic
    for one channel."""
    fmid = extrap - scale * grad
    fnew, clamped = project_channel_raster(fmid, lo, hi, sy, sx)
    if p_alpha_ss == 0.0:
        return fnew, None, torch.zeros((), device=fmid.device)
    dist, pgrad = prob_term_raster(clamped, dq, inv_q, p_alpha_ss / (sy * sx),
                                   sy, sx)
    return fnew, pgrad, dist


def fused_project_multi_plain(extraps, grads, scales, los, his, dqs, iqs,
                              pa_sss, samps, out=None):
    """Plain PyTorch version of fused_project_multi: fused_project_plain
    per channel."""
    e_all = stack_channels(extraps)
    g_all = stack_channels(grads)
    outs = [fused_project_plain(e_all[c], g_all[c], scales[c], los[c], his[c],
                                dqs[c], iqs[c], pa_sss[c], sy, sx)
            for c, (sy, sx) in enumerate(samps)]
    pgrads = [o[1] for o in outs]
    pg = [p for p in pgrads if p is not None]
    fnew, pgrad, _, dists = (None,) * 4 if out is None else out
    if pg:
        # one [P, H, W] tensor, handed out as per-channel views
        it = iter(torch.stack(pg, out=pgrad))
        pgrads = [None if p is None else next(it) for p in pgrads]
    return (torch.stack([o[0] for o in outs], out=fnew), pgrads,
            torch.stack([o[2] for o in outs], out=dists))


_ARGTYPES = (
    [ctypes.c_void_p] * 7            # e, g, scales, fnew, pgrad, part, dists
    + [ctypes.POINTER(ctypes.c_uint64),   # per channel lo, hi, dq, iq
       ctypes.POINTER(ctypes.c_int),      # per channel sy, sx, pgrad index
       ctypes.POINTER(ctypes.c_float)]    # per channel p_alpha
    + [ctypes.c_int] * 3             # C, H, W
    + [ctypes.c_void_p]              # stream
)


def _launcher():
    lib = _build.library("project_step")
    fn = lib.j2p_fused_project_multi
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def fused_project_multi(extraps, grads, scales, los, his, dqs, iqs,
                        pa_sss, samps, out=None):
    """All channels' normalized step + projection (+ prob) in one launch.

    Args:
        extraps, grads: [C, H, W] float32 tensors (or per-channel lists).
        scales: [C] device tensor of step_size / norm.
        los, his: per-channel clamp bounds [H/sy, W/sx].
        dqs, iqs: per-channel data*quant and 1/quant rasters, None for
            channels with the prob term off.
        pa_sss: per-channel host floats p_alpha * sy * sx (0 = prob off).
        samps: per-channel (sy, sx).
        out: None, or the buffers (fnews [C, H, W], pgrads [P, H, W] for
            the P channels with the prob term on, part, dists [C]) to
            write instead of new tensors; part is the kernel's scratch
            (project_scratch(); unused on the CPU).  fnews may be a
            buffer the caller no longer needs as input: the kernel reads
            only extraps and grads of the iterate.
    Returns:
        (fnews [C, H, W], pgrads list with None for prob-off channels,
         dists [C] — per-channel prob distances, 0 where off).
    """
    e = stack_channels(extraps)
    if e.device.type == "cpu":
        return _build.check_finite(
            "fused_project_multi", fused_project_multi_plain(
                extraps, grads, scales, los, his, dqs, iqs, pa_sss, samps,
                out))
    if e.device.type != "cuda":
        raise ValueError(f"fused_project_multi: unsupported device {e.device}")
    g = stack_channels(grads)
    C, H, W = e.shape
    if not 1 <= C <= MAX_CHANNELS or len(samps) != C or g.shape != e.shape:
        raise ValueError("fused_project_multi: channel/shape mismatch")
    for t in (e, g, scales):
        if (t.device != e.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("fused_project_multi: inputs must be contiguous "
                             f"float32 on {e.device}")
    if scales.shape != (C,):
        raise ValueError(f"fused_project_multi: scales must be [{C}]")

    P = sum(1 for p in pa_sss if p != 0.0)
    if out is None:
        out = (torch.empty_like(e),
               torch.empty((P, H, W), device=e.device, dtype=torch.float32),
               project_scratch(H, W, samps, e.device),
               torch.empty((C,), device=e.device, dtype=torch.float32))
    fnew, pgrad, part, dists = out
    for name, t, shape in (("fnews", fnew, e.shape),
                           ("pgrads", pgrad, (P, H, W)),
                           ("part", part, (_project_blocks(H, W, samps),)),
                           ("dists", dists, (C,))):
        if (t.device != e.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != shape):
            raise ValueError(f"fused_project_multi: output {name} must be "
                             f"contiguous float32 {list(shape)} on {e.device}")
    ptrs = (ctypes.c_uint64 * (4 * C))()
    ints = (ctypes.c_int * (3 * C))()
    pas = (ctypes.c_float * C)()
    k = 0
    for c, (sy, sx) in enumerate(samps):
        if H % (8 * sy) or W % (8 * sx) or sy > 4 or sx > 4:
            raise ValueError(
                f"fused_project_multi: canvas {H}x{W} is not whole 8x8 "
                f"blocks at sampling ({sy}, {sx}) (1..4 supported)")
        hc, wc = H // sy, W // sx
        prob = pa_sss[c] != 0.0
        planes = (los[c], his[c]) + ((dqs[c], iqs[c]) if prob else ())
        for t in planes:
            if (t.device != e.device or t.dtype != torch.float32
                    or not t.is_contiguous() or t.shape != (hc, wc)):
                raise ValueError(
                    f"fused_project_multi: channel {c} coefficient rasters "
                    f"must be contiguous float32 [{hc}, {wc}] on {e.device}")
        for j, t in enumerate(planes):
            ptrs[4 * c + j] = t.data_ptr()
        ints[3 * c:3 * c + 3] = [sy, sx, k if prob else -1]
        pas[c] = pa_sss[c] / (sy * sx)
        k += prob
    stream = torch.cuda.current_stream(e.device).cuda_stream
    lib, fn = _launcher()
    err = fn(e.data_ptr(), g.data_ptr(), scales.data_ptr(), fnew.data_ptr(),
             pgrad.data_ptr(), part.data_ptr(), dists.data_ptr(),
             ptrs, ints, pas, C, H, W, stream)
    _build.check(lib, err, "fused_project_multi")
    _build.count_launch(fused_project_multi)
    it = iter(pgrad)
    pgrads = [next(it) if p != 0.0 else None for p in pa_sss]
    return _build.check_finite("fused_project_multi", (fnew, pgrads, dists))


fused_project_multi.launches = 0


def _project_blocks(H: int, W: int, samps) -> int:
    """Thread blocks of one K2 launch, a distance partial each: four
    coefficient blocks of one row of one channel per block."""
    return sum((H // (8 * sy)) * -(-(W // (8 * sx)) // 4) for sy, sx in samps)


def project_scratch(H: int, W: int, samps, device) -> torch.Tensor:
    """K2's distance partials [one per thread block] for an [H, W] canvas
    at sampling `samps`."""
    return torch.empty((_project_blocks(H, W, samps),), device=device,
                       dtype=torch.float32)


# ---------------------------------------------------------------------------
# K6: one channel (the row-striped solve's one-channel bands)
# ---------------------------------------------------------------------------

_ONE_ARGTYPES = (
    [ctypes.c_void_p] * 11           # e, g, scale, fnew, pgrad, part, dist,
                                     # lo, hi, dq, iq
    + [ctypes.c_float]               # p_alpha
    + [ctypes.c_int] * 4             # sy, sx, H, W
    + [ctypes.c_void_p]              # stream
)


def _one_launcher():
    lib = _build.library("project_step")
    fn = lib.j2p_fused_project
    if fn.argtypes is None:
        fn.argtypes = _ONE_ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def fused_project(extrap, grad, scale, lo, hi, dq, inv_q, p_alpha_ss,
                  sy: int, sx: int):
    """One channel's normalized step + projection (+ prob) (K6).

    Args:
        extrap, grad: [H, W] float32.
        scale: step_size / norm, a one-element float32 tensor on the
            device (a host float on the CPU path).
        lo, hi: [H/sy, W/sx] float32 clamp bounds.
        dq, inv_q: [H/sy, W/sx] data*quant and 1/quant, or None when the
            prob term is off.
        p_alpha_ss: host float p_alpha * sy * sx (0 = prob off).
        sy, sx: footprint.
    Returns:
        (fnew [H, W], pgrad [H, W] or None, dist — a 0-d tensor, 0 when
         the prob term is off)
    """
    if extrap.device.type == "cpu":
        return _build.check_finite("fused_project", fused_project_plain(
            extrap, grad, scale, lo, hi, dq, inv_q, p_alpha_ss, sy, sx))
    if extrap.device.type != "cuda":
        raise ValueError(f"fused_project: unsupported device {extrap.device}")
    H, W = extrap.shape
    if H % (8 * sy) or W % (8 * sx) or not (1 <= sy <= 4 and 1 <= sx <= 4):
        raise ValueError(
            f"fused_project: canvas {H}x{W} is not whole 8x8 blocks at "
            f"sampling ({sy}, {sx}) (1..4 supported)")
    prob = p_alpha_ss != 0.0
    planes = ((extrap, (H, W)), (grad, (H, W)), (scale, None),
              (lo, (H // sy, W // sx)), (hi, (H // sy, W // sx)))
    if prob:
        planes += ((dq, (H // sy, W // sx)), (inv_q, (H // sy, W // sx)))
    for t, shape in planes:
        if (t.device != extrap.device or t.dtype != torch.float32
                or not t.is_contiguous()
                or (t.numel() != 1 if shape is None else t.shape != shape)):
            raise ValueError(
                "fused_project: inputs must be contiguous float32 on "
                f"{extrap.device}: [{H}, {W}] pixels, [{H // sy}, {W // sx}] "
                "coefficient rasters, a one-element scale")
    fnew = torch.empty_like(extrap)
    pgrad = torch.empty_like(extrap) if prob else None
    nblocks = (H // (8 * sy)) * -(-(W // (8 * sx)) // 4)
    part = torch.empty((nblocks,), device=extrap.device, dtype=torch.float32)
    dist = torch.empty((1,), device=extrap.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(extrap.device).cuda_stream
    lib, fn = _one_launcher()
    err = fn(extrap.data_ptr(), grad.data_ptr(), scale.data_ptr(),
             fnew.data_ptr(), None if pgrad is None else pgrad.data_ptr(),
             part.data_ptr(), dist.data_ptr(), lo.data_ptr(), hi.data_ptr(),
             dq.data_ptr() if prob else None,
             inv_q.data_ptr() if prob else None,
             p_alpha_ss / (sy * sx), sy, sx, H, W, stream)
    _build.check(lib, err, "fused_project")
    _build.count_launch(fused_project)
    return _build.check_finite("fused_project", (fnew, pgrad, dist[0]))


fused_project.launches = 0


def boxes(data_i16, q):
    """(lo, hi, dq, iq) from an int16 coefficient raster and its f32
    quant raster (jpeg.c:86, compute.c:323-331): q == 0 is frozen canvas
    padding (box [0, 0], iq = 0), q >= FREE_Q_MIN a region gap (box
    +-2^39 around 0, iq = 0)."""
    dq = data_i16.to(torch.float32) * q
    lo = dq - 0.5 * q
    hi = dq + 0.5 * q
    iq = torch.where((q > 0.0) & (q < FREE_Q_MIN), 1.0 / q,
                     torch.zeros((), dtype=q.dtype, device=q.device))
    return lo, hi, dq, iq


# ---------------------------------------------------------------------------
# K5: the lite projection (the two-lite tier's second kernel)
# ---------------------------------------------------------------------------

def fused_project_multi_lite_plain(fdatas, ds, grads, factor, scales,
                                   datas_i16, q_rs, pa_sss, samps):
    """Plain PyTorch version of fused_project_multi_lite, from ops/ (the
    same mean/residual reconstruction as fused_project_multi_plain)."""
    f = stack_channels(fdatas)
    d = stack_channels(ds).to(torch.float32)
    g = stack_channels(grads).to(torch.float32)
    fnews, devqs, dists = [], [], []
    for c, (sy, sx) in enumerate(samps):
        fmid = (f[c] + float(factor) * d[c]) - scales[c] * g[c]
        lo, hi, dq, iq = boxes(datas_i16[c], q_rs[c])
        fnew, clamped = project_channel_raster(fmid, lo, hi, sy, sx)
        fnews.append(fnew)
        if pa_sss[c] == 0.0:
            devqs.append(None)
            dists.append(torch.zeros((), device=f.device))
            continue
        devp = (clamped - dq) * iq
        dists.append(0.5 * torch.sum(devp * devp))
        devqs.append((devp * iq).to(torch.bfloat16))
    fnew = torch.stack(fnews)
    return fnew, (fnew - f).to(torch.bfloat16), devqs, torch.stack(dists)


_LITE_ARGTYPES = (
    [ctypes.c_void_p] * 8            # f, d, g, scales, fnew, dnew, part, dists
    + [ctypes.POINTER(ctypes.c_uint64),   # per channel data, q, devq out
       ctypes.POINTER(ctypes.c_int)]      # per channel sy, sx
    + [ctypes.c_float]               # factor
    + [ctypes.c_int] * 3             # C, H, W
    + [ctypes.c_void_p]              # stream
)


def _lite_launcher():
    lib = _build.library("project_lite")
    fn = lib.j2p_fused_project_lite
    if fn.argtypes is None:
        fn.argtypes = _LITE_ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def fused_project_multi_lite(fdatas, ds, grads, factor, scales, datas_i16,
                             q_rs, pa_sss, samps):
    """All channels' lite normalized step + projection in one launch (K5).

    Args:
        fdatas: [C, H, W] float32 iterates (or per-channel lists).
        ds: [C, H, W] bfloat16 FISTA differences d = f - fista.
        grads: [C, H, W] bfloat16 gradients (K4).
        factor: host float FISTA extrapolation factor.
        scales: [C] float32 device tensor of step_size / norm.
        datas_i16: per channel [H/sy, W/sx] int16 coefficient rasters.
        q_rs: per channel float32 quant rasters of the same shape (0:
            frozen padding, >= FREE_Q_MIN: region gap).
        pa_sss: per channel host floats p_alpha * sy * sx (0 = prob off).
        samps: per channel (sy, sx).
    Returns:
        (fnews [C, H, W] float32, dnews [C, H, W] bfloat16 = fnew - f,
         devqs list of bfloat16 [H/sy, W/sx] with None where prob is off,
         dists [C] — per-channel prob distances, 0 where off).
    """
    f = stack_channels(fdatas)
    if f.device.type == "cpu":
        return _build.check_finite(
            "fused_project_multi_lite", fused_project_multi_lite_plain(
                fdatas, ds, grads, factor, scales, datas_i16, q_rs, pa_sss,
                samps))
    if f.device.type != "cuda":
        raise ValueError(
            f"fused_project_multi_lite: unsupported device {f.device}")
    d = stack_channels(ds)
    g = stack_channels(grads)
    C, H, W = f.shape
    if not 1 <= C <= MAX_CHANNELS or len(samps) != C or len(pa_sss) != C:
        raise ValueError("fused_project_multi_lite: channel counts differ")
    for name, t, dt in (("fdatas", f, torch.float32),
                        ("ds", d, torch.bfloat16),
                        ("grads", g, torch.bfloat16)):
        if (t.device != f.device or t.dtype != dt or not t.is_contiguous()
                or t.shape != f.shape):
            raise ValueError(
                f"fused_project_multi_lite: {name} must be contiguous {dt} "
                f"{list(f.shape)} on {f.device}, got {t.dtype} "
                f"{list(t.shape)} on {t.device}")
    if (scales.device != f.device or scales.dtype != torch.float32
            or scales.shape != (C,) or not scales.is_contiguous()):
        raise ValueError(f"fused_project_multi_lite: scales must be float32 "
                         f"[{C}] on {f.device}")
    ptrs = (ctypes.c_uint64 * (3 * C))()
    ints = (ctypes.c_int * (2 * C))()
    devqs = []
    nblocks = 0
    for c, (sy, sx) in enumerate(samps):
        if H % (8 * sy) or W % (8 * sx) or sy > 4 or sx > 4:
            raise ValueError(
                f"fused_project_multi_lite: canvas {H}x{W} is not whole 8x8 "
                f"blocks at sampling ({sy}, {sx}) (1..4 supported)")
        hc, wc = H // sy, W // sx
        for t, dt in ((datas_i16[c], torch.int16), (q_rs[c], torch.float32)):
            if (t.device != f.device or t.dtype != dt
                    or not t.is_contiguous() or t.shape != (hc, wc)):
                raise ValueError(
                    f"fused_project_multi_lite: channel {c} rasters must be "
                    f"contiguous int16 / float32 [{hc}, {wc}] on {f.device}")
        dq = (torch.empty((hc, wc), device=f.device, dtype=torch.bfloat16)
              if pa_sss[c] != 0.0 else None)
        devqs.append(dq)
        ptrs[3 * c:3 * c + 3] = [datas_i16[c].data_ptr(), q_rs[c].data_ptr(),
                                 0 if dq is None else dq.data_ptr()]
        ints[2 * c:2 * c + 2] = [sy, sx]
        nblocks += (hc // 8) * -(-(wc // 8) // 4)
    fnew = torch.empty_like(f)
    dnew = torch.empty_like(d)
    part = torch.empty((nblocks,), device=f.device, dtype=torch.float32)
    dists = torch.empty((C,), device=f.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    lib, fn = _lite_launcher()
    err = fn(f.data_ptr(), d.data_ptr(), g.data_ptr(), scales.data_ptr(),
             fnew.data_ptr(), dnew.data_ptr(), part.data_ptr(),
             dists.data_ptr(), ptrs, ints, float(factor), C, H, W, stream)
    _build.check(lib, err, "fused_project_multi_lite")
    _build.count_launch(fused_project_multi_lite)
    return _build.check_finite("fused_project_multi_lite",
                               (fnew, dnew, devqs, dists))


fused_project_multi_lite.launches = 0
