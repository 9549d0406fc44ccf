"""Fused FISTA extrapolation + TV/TGV2 gradient (K1).

Replaces the Pallas kernel jpeg2png_tpu/kernels/grad_step.py::fused_grad
(`_kernel`, `_stencil_terms`).  Per iteration, for all C channels:

    extrap = f + factor * (f - fista)
    gx, gy = forward diffs of extrap        (zero last col/row)
    grad   = TV gather + TGV2 gather + pgrad
    partials: per-channel sum(grad^2), tv objective, tv2 objective

CUDA version: csrc/grad_step.cu, whose kernel also runs K7 (a band of
the row-striped solve with its halo rows, kernels/stripe_grad.py;
`launch` below serves both).  What bounds it on an H100: memory.  It
reads f, fista and the prob gradient and writes grad and extrap, 15 f32
canvases at C = P = 3 (~377 MB at 3072x2048), against ~150 flops per
pixel.  What the design does about it: a row-marching stencil.  Each
block of 256 threads owns a strip of OUTW = 254 output columns (plus
one term column on each side) and a segment of rows, and walks down it
one row per step: f, fista and prob-gradient rows arrive by cp.async
two steps ahead of their use, the per-pixel terms of the gather are
computed once per row and kept in registers or, where a neighbouring
column reads them, in small row rings in shared memory, and grad and
extrap are written once; nothing but the inputs and outputs touches
device memory.  The partial sums go to one row per block (strips x
segments, about one wave of resident blocks: `partial_rows`) and a
second kernel reduces them in a fixed order -- no float atomics, so two
runs give the same bits.  The library reports the number of rows
(j2p_grad_partial_rows) and the wrapper sizes its scratch from it.

On a CPU tensor the wrapper runs the plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from jpeg2png_tpu_torch.kernels import _build
from jpeg2png_tpu_torch.ops.tv import shift2d

MAX_CHANNELS = 4
HALO_ROWS = 2                # rows of a band's halo arrays: the stencil's reach
OUTW, MIN_SEG = 254, 16      # csrc/grad_step.cu: output columns per strip,
                             # the shortest segment of rows


def stack_channels(seq) -> torch.Tensor:
    """[n, H, W] tensor holding the [H, W] planes of `seq`, without a
    copy when they are consecutive views of one contiguous tensor (as
    iterating or unbinding a [n, H, W] tensor gives)."""
    if isinstance(seq, torch.Tensor):
        return seq
    seq = list(seq)
    base = seq[0]._base
    if (base is not None and base.dim() == 3 and base.shape[0] == len(seq)
            and base.is_contiguous()
            and all(s.data_ptr() == base[i].data_ptr()
                    and s.shape == base.shape[1:]
                    for i, s in enumerate(seq))):
        return base
    return torch.stack(seq)


def _shift_y(a, d, rows, ht):
    """out[y] = a[y - d], zero where the source row is outside [0, ht)."""
    src = rows - d
    return torch.where((src >= 0) & (src < ht), shift2d(a, d, 0), 0.0)


def stencil(e, rows, cols, HT: int, WT: int, weight: float):
    """The joint TV + TGV2 gather of the extrapolated iterate e [C, T, W]
    (compute.c:73-197), with the JAX kernels' edge masks
    (jpeg2png_tpu/kernels/grad_step.py:77-158).  rows [T, 1] holds the
    global row of each row of e (a band and its halos), cols [1, W];
    HT, WT the true extent.  Returns (grad [C, T, W], not yet zeroed
    outside the extent; the TV norm |g| [T, W]; the TGV2 norm [T, W], or
    None at weight 0).  The objective terms are alpha and tgv_alpha times
    their sums."""
    C = e.shape[0]
    gx = torch.where(cols < WT - 1, shift2d(e, 0, -1) - e, 0.0)
    gy = torch.where(rows < HT - 1, shift2d(e, -1, 0) - e, 0.0)

    # ---- TV term (compute.c:73-125 in gather form) ----
    g_norm = torch.sqrt(torch.sum(gx * gx + gy * gy, dim=0))
    alpha = 1.0 / math.sqrt(C)
    inv = torch.where(g_norm == 0.0, 0.0, 1.0 / g_norm)
    a = gx * inv
    b = gy * inv
    grad = (-(a + b) + shift2d(a, 0, 1) + _shift_y(b, 1, rows, HT)) * alpha
    n2 = None

    # ---- TGV2 term (compute.c:128-197 in gather form) ----
    if weight != 0.0:
        alpha2 = tgv_alpha(C, weight)
        g_xx = torch.where(cols >= 1, gx - shift2d(gx, 0, 1), 0.0)
        # the x-diff of gy at pad column WT and the y-diffs at pad row HT
        # would read a spurious boundary value (JAX grad_step.py:127-138)
        g_yx = torch.where((cols >= 1) & (cols < WT),
                           gy - shift2d(gy, 0, 1), 0.0)
        g_xy = torch.where((rows >= 1) & (rows < HT),
                           gx - shift2d(gx, 1, 0), 0.0)
        g_yy = torch.where((rows >= 1) & (rows < HT),
                           gy - shift2d(gy, 1, 0), 0.0)
        sym = (g_xy + g_yx) * 0.5
        n2 = torch.sqrt(torch.sum(
            g_xx * g_xx + 2.0 * sym * sym + g_yy * g_yy, dim=0))
        inv2 = torch.where(n2 == 0.0, 0.0, 1.0 / n2)
        center = -(2.0 * g_xx + 2.0 * sym + 2.0 * g_yy) * inv2
        p = (g_xx + sym) * inv2
        q = (g_yy + sym) * inv2
        r = -sym * inv2
        g2 = (center
              + shift2d(p, 0, -1) + shift2d(p, 0, 1)
              + _shift_y(q, -1, rows, HT) + _shift_y(q, 1, rows, HT)
              + shift2d(_shift_y(r, -1, rows, HT), 0, 1)
              + shift2d(_shift_y(r, 1, rows, HT), 0, -1))
        grad = grad + alpha2 * g2
    return grad, g_norm, n2


def tgv_alpha(C: int, weight: float) -> float:
    return (weight / math.sqrt(2.0)) / math.sqrt(C)


def fused_grad_plain(fdatas, fistas, pgrads, factor: float, weight: float,
                     h_true: int | None = None, w_true: int | None = None):
    """Plain PyTorch version of fused_grad: the gather-form stencils of
    ops/tv.py with the Pallas kernel's edge masks for a zero-padded
    canvas (grad_step.py:96-138 of the JAX package)."""
    f = stack_channels(fdatas)
    fi = stack_channels(fistas)
    C, H, W = f.shape
    HT = H if h_true is None else int(h_true)
    WT = W if w_true is None else int(w_true)
    rows = torch.arange(H, device=f.device)[:, None]
    cols = torch.arange(W, device=f.device)[None, :]

    e = f + factor * (f - fi)
    grad, g_norm, n2 = stencil(e, rows, cols, HT, WT, weight)
    tv = (1.0 / math.sqrt(C)) * torch.sum(g_norm)
    tv2 = (torch.zeros((), device=f.device) if n2 is None
           else tgv_alpha(C, weight) * torch.sum(n2))
    if HT < H or WT < W:
        grad = torch.where((rows < HT) & (cols < WT), grad, 0.0)
    pg = [p for p in pgrads if p is not None]
    if pg:
        idx = [c for c, p in enumerate(pgrads) if p is not None]
        grad[idx] = grad[idx] + stack_channels(pg)
    sumsq = torch.sum(grad * grad, dim=(1, 2))
    return grad, e, sumsq, tv, tv2


def partial_rows(L: int, W: int, slots: int) -> int:
    """Rows of partial sums of the CUDA kernel on a band of L x W when
    `slots` blocks are resident on the card (occupancy x SMs): strips of
    OUTW columns times segments of rows, the segments sized so that the
    grid is about one wave (at least MIN_SEG rows each).  Mirrors
    csrc/grad_step.cu make_grid; the wrapper asks the library
    (j2p_grad_partial_rows), which knows the occupancy."""
    strips = -(-W // OUTW)
    target = max(1, slots // strips)
    seg = max(MIN_SEG, -(-L // target))
    return strips * -(-L // seg)


_ARGTYPES = (
    [ctypes.c_void_p] * 11           # f, fista, f/fista halos (4), pgrad,
                                     # grad, extrap, part, out
    + [ctypes.c_int] * 6             # C, L, W, row0, h_true, w_true
    + [ctypes.c_float] * 3           # factor, alpha, alpha2
    + [ctypes.c_int]                 # tgv (second-order term on)
    + [ctypes.c_int] * MAX_CHANNELS  # pgrad plane index per channel (-1: none)
    + [ctypes.c_void_p]              # stream
)


def _launcher():
    lib = _build.library("grad_step")
    fn = lib.j2p_fused_grad_striped
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        for name in ("j2p_grad_partial_rows", "j2p_grad_segment_rows"):
            rows = getattr(lib, name)
            rows.argtypes = [ctypes.c_int] * 4
            rows.restype = ctypes.c_int
    return lib, fn


def _ask(lib, name: str, C: int, tgv: bool, L: int, W: int) -> int:
    n = getattr(lib, name)(C, int(tgv), L, W)
    if n < 1:
        _build.check(lib, -n, name)
        raise RuntimeError(f"{name} returned {n}")
    return n


def scratch(lib, C: int, tgv: bool, L: int, W: int, device) -> torch.Tensor:
    """The kernel's partial-sum rows [n, C + 2], n as the library reports
    it for this band on the current card."""
    n = _ask(lib, "j2p_grad_partial_rows", C, tgv, L, W)
    return torch.empty((n, C + 2), device=device, dtype=torch.float32)


def segment_rows(C: int, tgv: bool, L: int, W: int) -> int:
    """Rows per segment of the kernel's grid for a band of L x W on the
    current card (the last segment may be shorter)."""
    return _ask(_launcher()[0], "j2p_grad_segment_rows", C, tgv, L, W)


def launch(what: str, fdatas, fistas, pgrads, halos, factor: float,
           weight: float, row0: int, h_true: int, w_true: int):
    """Check the inputs and launch the gradient kernel of csrc/grad_step.cu
    on CUDA tensors: K1 (the whole canvas: row0 0, halos None) or K7 (a
    band with its halo rows).  Returns (grad, extrap, sums [C + 2])."""
    f = stack_channels(fdatas)
    if f.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {f.device}")
    fi = stack_channels(fistas)
    C, L, W = f.shape
    pg_list = [p for p in pgrads if p is not None]
    pg = stack_channels(pg_list) if pg_list else None
    hl = [None] * 4 if halos is None else [stack_channels(h) for h in halos]
    checks = [("fdatas", f, L), ("fistas", fi, L), ("pgrads", pg, L)]
    checks += [("halos", h, HALO_ROWS) for h in hl]
    for name, t, rows in checks:
        if t is None:
            continue
        if (t.device != f.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape[1:] != (rows, W)):
            raise ValueError(
                f"{what}: {name} must be contiguous float32 [n, {rows}, {W}] "
                f"on {f.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (fi.shape[0] != C or len(pgrads) != C or not 1 <= C <= MAX_CHANNELS
            or any(h is not None and h.shape[0] != C for h in hl)):
        raise ValueError(f"{what}: channel counts {C}, {fi.shape[0]}, "
                         f"{len(pgrads)} (1..{MAX_CHANNELS} supported)")
    if not (row0 >= 0 and h_true >= 1 and 1 <= w_true <= W):
        raise ValueError(f"{what}: true extent {h_true}x{w_true} of a {W} "
                         f"wide canvas at row {row0}")
    # the kernel copies rows in 16-byte chunks: every canvas is whole 8x8
    # blocks, so W % 8 == 0 on every path, and the planes start aligned
    if W % 8 != 0:
        raise ValueError(f"{what}: width {W} is not a multiple of 8")
    for name, t, _ in checks:
        if t is not None and t.data_ptr() % 16 != 0:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")

    pidx = [-1] * MAX_CHANNELS
    k = 0
    for c, p in enumerate(pgrads):
        if p is not None:
            pidx[c] = k
            k += 1
    lib, fn = _launcher()
    grad = torch.empty_like(f)
    extrap = torch.empty_like(f)
    # sized for the current card, as the launch's grid is
    part = scratch(lib, C, weight != 0.0, L, W, f.device)
    out = torch.empty((C + 2,), device=f.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = fn(f.data_ptr(), fi.data_ptr(),
             *(None if h is None else h.data_ptr() for h in hl),
             None if pg is None else pg.data_ptr(), grad.data_ptr(),
             extrap.data_ptr(), part.data_ptr(), out.data_ptr(), C, L, W,
             int(row0), int(h_true), int(w_true), float(factor),
             1.0 / math.sqrt(C), tgv_alpha(C, weight), int(weight != 0.0),
             *pidx, stream)
    _build.check(lib, err, what)
    return grad, extrap, out


def fused_grad(fdatas, fistas, pgrads, factor: float, weight: float,
               h_true: int | None = None, w_true: int | None = None):
    """Run the fused gradient kernel (K1).

    Args:
        fdatas, fistas: [C, H, W] float32 tensors (or per-channel lists
            of [H, W]) on one device.
        pgrads: per-channel list of [H, W] prob pixel gradients, with
            None for channels whose prob term is off.
        factor: host float FISTA extrapolation factor.
        weight: TGV2 weight (0 disables the second-order term).
        h_true, w_true: true image extent when [H, W] is a zero-padded
            canvas (edge masks key to these).
    Returns:
        (grads [C, H, W], extraps [C, H, W], sumsq [C], tv, tv2)
    """
    f = stack_channels(fdatas)
    if f.device.type == "cpu":
        return _build.check_finite("fused_grad", fused_grad_plain(
            fdatas, fistas, pgrads, factor, weight, h_true, w_true))
    C, H, W = f.shape
    HT = H if h_true is None else int(h_true)
    WT = W if w_true is None else int(w_true)
    if HT > H:
        raise ValueError(f"fused_grad: true extent {HT}x{WT} outside {H}x{W}")
    grad, extrap, out = launch("fused_grad", f, fistas, pgrads, None, factor,
                               weight, 0, HT, WT)
    _build.count_launch(fused_grad)
    return _build.check_finite(
        "fused_grad", (grad, extrap, out[:C], out[C], out[C + 1]))


fused_grad.launches = 0
