"""Band gradients of the row-striped solve: K7 (f32) and K4 (lite).

K7, fused_grad_striped, replaces the Pallas kernel
jpeg2png_tpu/kernels/stripe_grad.py::fused_grad_striped (`_kernel`): K1's
function (kernels/grad_step.py) on a band of L rows of every channel
whose first row is global row `row0`,

    e      = f + factor * (f - fista)       (f32, halo rows included)
    grad   = TV + TGV2 gather of e, zeroed outside the true extent,
             + the prob pixel gradient
    extrap = e on the band's rows
    partials: per-channel sum(grad^2), tv, tv2 of the band

with the two rows the stencil reaches past either band edge taken from
halo arrays of f and fista [C, HALO_ROWS, W] (the neighbouring bands'
rows; zeros at the canvas edge), not from the TPU's 8-row DMA tiles.
CUDA version: K1's kernel (csrc/grad_step.cu, a row-marching stencil),
which copies the halo rows into its row ring and keys every row mask on
row0 + band row; K1 is the same kernel on the whole canvas (row0 0, no
halos).  What bounds it on an H100: memory, 4 *
(4C + P) bytes per pixel as K1.  The f32 striped body
(parallel/stripes.py) runs it on every band in every iteration.

K4, fused_grad_striped_lite, replaces the Pallas kernel
jpeg2png_tpu/kernels/stripe_grad.py::fused_grad_striped_lite
(`_kernel_lite`).  For a band of L rows of every channel, whose first row
is global row `row0` of the canvas:

    e      = f + factor * d                 (d = f - fista, bf16)
    grad   = TV + TGV2 gather of e, zeroed outside the true extent
             + p_alpha * up(idct(devq))     (devq: bf16 prob carry at
                                             coefficient resolution)
    partials: per-channel sum(grad^2) of the f32 gradient, tv, tv2
    out    grad in bf16 (round to nearest even)

The stencil reaches two rows past the band: they come from halo arrays of
HALO_ROWS = 2 rows per side (the neighbouring bands' rows; zeros, or
None, at the canvas edges), not from the TPU's 16-row DMA tiles.  The
edge masks key on the global row (row0 + band row) and on the true extent,
static (h_true, w_true) or a [2] int32 device array (`extents`, the
dynamic-extent mode of bucketed serving).  The two-lite solver tier and
the dyn2 serving class run it on the whole canvas as one band, row0 = 0,
halos None.

CUDA version: csrc/stripe_grad.cu.  What bounds it on an H100: memory.
It reads f (f32) and d (bf16) and writes the gradient in bf16: 8 B per
pixel and channel, plus 2 B per prob coefficient (devq, bf16), against
~150 flops per pixel and channel.  What the design does about it: K1's
row-marching stencil (kernels/grad_step.py): blocks of 256 threads on
strips of LITE_OUTW = 254 output columns and segments of rows walk down
one row per step, f and d rows arriving by cp.async ahead of their use
and every per-pixel term computed once.  The prob term is expanded inside
the march: the devq block rows under a strip are copied ahead into shared
memory and transformed once per 8 sy rows into a window of
p_alpha * idct(devq) at coefficient resolution, which each gathered row
reads; nothing but the inputs and outputs touches device memory.  Partial
sums go to one row per block (strips x segments, about one wave of
resident blocks: `lite_partial_rows`), reduced in a fixed order by a
second kernel (no float atomics).  The library reports the number of
rows (j2p_grad_lite_partial_rows) and the wrapper sizes its scratch from
it.

On a CPU tensor the wrapper runs the plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from jpeg2png_tpu_torch.kernels import _build, grad_step
from jpeg2png_tpu_torch.kernels.grad_step import (
    HALO_ROWS, MAX_CHANNELS, stack_channels, tgv_alpha)
from jpeg2png_tpu_torch.ops.dct_raster import idct_raster
from jpeg2png_tpu_torch.ops.resample import upsample_replicate
from jpeg2png_tpu_torch.ops.tv_halo import band_stencil

LEGAL_SAMPS = (1, 2, 4)
LITE_OUTW, LITE_MIN_SEG = 254, 16   # csrc/stripe_grad.cu: output columns
                                    # per strip, the shortest segment


def _halo_rows(halos, C, W, device):
    """The four halo arrays [C, HALO_ROWS, W] as float32 (zeros for None)."""
    if halos is None:
        z = torch.zeros((C, HALO_ROWS, W), device=device)
        return z, z, z, z
    return tuple(stack_channels(h).to(torch.float32) for h in halos)


def _band_sums(grad, g_norm, n2, C, weight):
    tv = (1.0 / math.sqrt(C)) * torch.sum(g_norm)
    tv2 = (torch.zeros((), device=grad.device) if n2 is None
           else tgv_alpha(C, weight) * torch.sum(n2))
    return torch.sum(grad * grad, dim=(1, 2)), tv, tv2


def fused_grad_striped_plain(fdatas, fistas, pgrads, halos, factor, row0,
                             weight: float, h_true: int, w_true: int):
    """Plain PyTorch version of fused_grad_striped (same signature): the
    band stencil of ops/tv_halo.py on the band and its halo rows.  The
    sums cover all of the band's rows, as the TPU kernel's do (rows past
    the true extent add 0 on a frozen canvas)."""
    f = stack_channels(fdatas)
    fi = stack_channels(fistas)
    C, L, W = f.shape
    f_top, f_bot, fi_top, fi_bot = _halo_rows(halos, C, W, f.device)
    f_ext = torch.cat([f_top, f, f_bot], dim=1)
    fi_ext = torch.cat([fi_top, fi, fi_bot], dim=1)
    e = f_ext + float(factor) * (f_ext - fi_ext)
    grad, g_norm, n2 = band_stencil(e, row0, h_true, w_true, weight)
    for c, p in enumerate(pgrads):
        if p is not None:
            grad[c] = grad[c] + p
    sumsq, tv, tv2 = _band_sums(grad, g_norm, n2, C, weight)
    extrap = e[:, HALO_ROWS:HALO_ROWS + L].contiguous()
    return grad, extrap, sumsq, tv, tv2


def fused_grad_striped(fdatas, fistas, pgrads, halos, factor, row0,
                       weight: float, h_true: int, w_true: int):
    """Fused extrapolation + TV/TGV2 gradient of one band (K7).

    Args:
        fdatas, fistas: [C, L, W] float32 band iterates (or per-channel
            lists of [L, W]).
        pgrads: per-channel list of [L, W] prob pixel gradients, None for
            channels whose prob term is off.
        halos: (f_tops, f_bots, fi_tops, fi_bots), each [C, HALO_ROWS, W]
            float32: the rows of f and fista just above and below the
            band (zeros at the canvas edge); None for zeros.
        factor: host float FISTA extrapolation factor.
        row0: global canvas row of the band's first row.
        weight: TGV2 weight.
        h_true, w_true: the true canvas extent (global).
    Returns:
        (grads [C, L, W], extraps [C, L, W], sumsq [C], tv, tv2): the
        band's own partial sums; the caller all-reduces them.
    """
    f = stack_channels(fdatas)
    if f.device.type == "cpu":
        return _build.check_finite(
            "fused_grad_striped", fused_grad_striped_plain(
                fdatas, fistas, pgrads, halos, factor, row0, weight, h_true,
                w_true))
    grad, extrap, out = grad_step.launch(
        "fused_grad_striped", f, fistas, pgrads, halos, factor, weight,
        int(row0), int(h_true), int(w_true))
    _build.count_launch(fused_grad_striped)
    C = f.shape[0]
    return _build.check_finite(
        "fused_grad_striped", (grad, extrap, out[:C], out[C], out[C + 1]))


fused_grad_striped.launches = 0


def supports(C: int, L: int, W: int, samps) -> bool:
    """Geometry gate: 1..4 channels, footprints of 1, 2 or 4 pixels per
    axis, and a band of whole 8x8 coefficient blocks of every channel."""
    return (1 <= C <= MAX_CHANNELS and len(samps) == C
            and all(sy in LEGAL_SAMPS and sx in LEGAL_SAMPS
                    and L % (8 * sy) == 0 and W % (8 * sx) == 0
                    for sy, sx in samps))


def _extent(extents, h_true, w_true):
    if extents is None:
        return int(h_true), int(w_true)
    h, w = (int(v) for v in torch.as_tensor(extents).cpu().tolist())
    return h, w


def fused_grad_striped_lite_plain(fdatas, ds, devqs, halos, factor, row0,
                                  weight: float, samps, p_alpha_sss,
                                  h_pad: int, h_true: int, w_true: int,
                                  extents=None):
    """Plain PyTorch version of fused_grad_striped_lite (same
    signature): the stencil of grad_step.py on the band plus its halo
    rows, with global-row masks."""
    f = stack_channels(fdatas)
    d = stack_channels(ds).to(torch.float32)
    C, L, W = f.shape
    HT, WT = _extent(extents, h_true, w_true)
    f_top, f_bot, d_top, d_bot = _halo_rows(halos, C, W, f.device)
    e = (torch.cat([f_top, f, f_bot], dim=1)
         + float(factor) * torch.cat([d_top, d, d_bot], dim=1))
    grad, g_norm, n2 = band_stencil(e, row0, HT, WT, weight)
    it = iter(devqs)
    for c, (sy, sx) in enumerate(samps):
        if p_alpha_sss[c] != 0.0:
            pa = p_alpha_sss[c] / (sy * sx)
            grad[c] = grad[c] + pa * upsample_replicate(
                idct_raster(next(it).to(torch.float32)), sy, sx)
    sumsq, tv, tv2 = _band_sums(grad, g_norm, n2, C, weight)
    return grad.to(torch.bfloat16), sumsq, tv, tv2


_ARGTYPES = (
    [ctypes.c_void_p] * 8            # f, d, f_top, f_bot, d_top, d_bot, grad, part
    + [ctypes.c_void_p] * 2          # out, extents (null: static)
    + [ctypes.POINTER(ctypes.c_uint64),   # per channel devq plane (0: off)
       ctypes.POINTER(ctypes.c_int),      # per channel sy, sx
       ctypes.POINTER(ctypes.c_float)]    # per channel p_alpha
    + [ctypes.c_int] * 6             # C, L, W, row0, h_true, w_true
    + [ctypes.c_float] * 3           # factor, alpha, alpha2
    + [ctypes.c_int]                 # tgv
    + [ctypes.c_void_p]              # stream
)


def lite_partial_rows(L: int, W: int, slots: int) -> int:
    """Rows of K4's partial sums on a band of L x W when `slots` blocks
    are resident on the card (occupancy x SMs): strips of LITE_OUTW
    columns times segments of rows, the segments sized so that the grid
    is about one wave (at least LITE_MIN_SEG rows each).  Mirrors
    csrc/stripe_grad.cu make_grid; the wrapper asks the library
    (j2p_grad_lite_partial_rows), which knows the occupancy."""
    strips = -(-W // LITE_OUTW)
    target = max(1, slots // strips)
    seg = max(LITE_MIN_SEG, -(-L // target))
    return strips * -(-L // seg)


def _launcher():
    lib = _build.library("stripe_grad")
    fn = lib.j2p_fused_grad_lite
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        for name in ("j2p_grad_lite_partial_rows",
                     "j2p_grad_lite_segment_rows"):
            rows = getattr(lib, name)
            rows.argtypes = [ctypes.c_int] * 4
            rows.restype = ctypes.c_int
    return lib, fn


def lite_scratch(lib, C: int, tgv: bool, L: int, W: int,
                 device) -> torch.Tensor:
    """K4's partial-sum rows [n, C + 2], n as the library reports it for
    this band on the current card."""
    n = grad_step._ask(lib, "j2p_grad_lite_partial_rows", C, tgv, L, W)
    return torch.empty((n, C + 2), device=device, dtype=torch.float32)


def lite_segment_rows(C: int, tgv: bool, L: int, W: int) -> int:
    """Rows per segment of K4's grid for a band of L x W on the current
    card (the last segment may be shorter)."""
    return grad_step._ask(_launcher()[0], "j2p_grad_lite_segment_rows", C,
                          tgv, L, W)


def _check(t, name, shape, dtype, device):
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"fused_grad_striped_lite: {name} must be contiguous {dtype} "
            f"{list(shape)} on {device}, got {t.dtype} {list(t.shape)} on "
            f"{t.device}")


def fused_grad_striped_lite(fdatas, ds, devqs, halos, factor, row0,
                            weight: float, samps, p_alpha_sss,
                            h_pad: int, h_true: int, w_true: int,
                            extents=None):
    """Lite extrapolation + TV/TGV2 gradient of one band (K4).

    Args:
        fdatas: [C, L, W] float32 band iterates (or per-channel [L, W]).
        ds: [C, L, W] bfloat16 FISTA differences d = f - fista.
        devqs: per PROB channel [L/sy, W/sx] bfloat16 (clamp - dq)/q^2
            carries of the previous projection.
        halos: (f_tops, f_bots, d_tops, d_bots), each [C, HALO_ROWS, W]
            (f float32, d bfloat16): the rows just above and below the
            band; None for zeros (a band that is the whole canvas).
        factor: host float FISTA extrapolation factor.
        row0: global canvas row of the band's first row.
        weight: TGV2 weight.  samps: per channel (sy, sx).
        p_alpha_sss: per channel host float p_alpha * sy * sx (0: off).
        h_pad: canvas height the band belongs to (row0 + L <= h_pad).
        h_true, w_true: the true extent (ignored with `extents`).
        extents: None, or a [2] int32 tensor (h_true, w_true) on the
            band's device (dynamic-extent bucket mode).
    Returns:
        (grads [C, L, W] bfloat16, sumsq [C], tv, tv2): the band's own
        partial sums (sumsq from the float32 gradient).
    """
    f = stack_channels(fdatas)
    if f.device.type == "cpu":
        return _build.check_finite(
            "fused_grad_striped_lite", fused_grad_striped_lite_plain(
                fdatas, ds, devqs, halos, factor, row0, weight, samps,
                p_alpha_sss, h_pad, h_true, w_true, extents))
    if f.device.type != "cuda":
        raise ValueError(
            f"fused_grad_striped_lite: unsupported device {f.device}")
    dev = f.device
    d = stack_channels(ds)
    C, L, W = f.shape
    if (len(p_alpha_sss) != C or not supports(C, L, W, samps)
            or not 0 <= int(row0) <= int(h_pad) - L):
        raise ValueError(
            f"fused_grad_striped_lite: band {C}x{L}x{W} at row {row0} of "
            f"{h_pad}, samps={samps} is outside the kernel's gate")
    _check(f, "fdatas", (C, L, W), torch.float32, dev)
    _check(d, "ds", (C, L, W), torch.bfloat16, dev)
    aligned = [("fdatas", f), ("ds", d)]
    halo_ptrs = [None] * 4
    if halos is not None:
        for j, (h, dt) in enumerate(zip(halos, (torch.float32,) * 2
                                        + (torch.bfloat16,) * 2)):
            h = stack_channels(h)
            _check(h, "halos", (C, HALO_ROWS, W), dt, dev)
            aligned.append(("halos", h))
            halo_ptrs[j] = h.data_ptr()
    if extents is None:
        ext_ptr = None
        HT, WT = int(h_true), int(w_true)
        if not (1 <= HT <= h_pad and 1 <= WT <= W):
            raise ValueError(f"fused_grad_striped_lite: true extent {HT}x"
                             f"{WT} outside the {h_pad}x{W} canvas")
    else:
        _check(extents, "extents", (2,), torch.int32, dev)
        ext_ptr, HT, WT = extents.data_ptr(), 0, 0
    ptrs = (ctypes.c_uint64 * C)()
    ints = (ctypes.c_int * (2 * C))()
    pas = (ctypes.c_float * C)()
    it = iter(devqs)
    for c, (sy, sx) in enumerate(samps):
        ints[2 * c:2 * c + 2] = [sy, sx]
        if p_alpha_sss[c] != 0.0:
            dq = next(it)
            _check(dq, f"devqs[{c}]", (L // sy, W // sx), torch.bfloat16, dev)
            aligned.append((f"devqs[{c}]", dq))
            ptrs[c] = dq.data_ptr()
            pas[c] = p_alpha_sss[c] / (sy * sx)
    # the kernel copies rows and devq blocks in 16-byte chunks
    for name, t in aligned:
        if t.data_ptr() % 16 != 0:
            raise ValueError(
                f"fused_grad_striped_lite: {name} is not 16-byte aligned")
    lib, fn = _launcher()
    grad = torch.empty((C, L, W), device=dev, dtype=torch.bfloat16)
    # sized for the current card, as the launch's grid is
    part = lite_scratch(lib, C, weight != 0.0, L, W, dev)
    out = torch.empty((C + 2,), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(f.data_ptr(), d.data_ptr(), *halo_ptrs, grad.data_ptr(),
             part.data_ptr(), out.data_ptr(), ext_ptr, ptrs, ints, pas,
             C, L, W, int(row0), HT, WT, float(factor), 1.0 / math.sqrt(C),
             tgv_alpha(C, weight), int(weight != 0.0), stream)
    _build.check(lib, err, "fused_grad_striped_lite")
    _build.count_launch(fused_grad_striped_lite)
    return _build.check_finite("fused_grad_striped_lite",
                               (grad, out[:C], out[C], out[C + 1]))


fused_grad_striped_lite.launches = 0
