"""FISTA-accelerated projected subgradient solver.

The iterate loop of the reference (compute.c:406-465) in one of four
tiers, the counterparts of the JAX package's (jpeg2png_tpu/models/
solver.py:329-524, 766-804):

  "two"  a host loop of two fused kernels per iteration:
     K1 kernels/grad_step.py::fused_grad            FISTA extrapolation,
        TV + TGV2 gather stencils, prob gradient, partial sums;
     K2 kernels/project_step.py::fused_project_multi  normalized step, box
        projection in the sampled DCT domain, next prob gradient, distance;
  "mega" one launch of K3 kernels/iter_step.py::fused_solve per chunk of
     iterations (the same arithmetic, with the prob term carried at
     coefficient resolution as devq = (clamp - dq) / q^2);
  "two-lite"  a host loop of the lite pair per iteration, on bf16 side
     state (the FISTA difference d = f - fista, the gradient, devq; the
     iterate stays f32) and boxes built in-kernel from int16 + quant:
     K4 kernels/stripe_grad.py::fused_grad_striped_lite (the whole canvas
        as one band), K5 kernels/project_step.py::fused_project_multi_lite;
  "mega-lite" one launch of K3 in lite mode (iter_step.fused_solve_lite)
     per chunk: the same state and arithmetic as two-lite.

tier_rule picks one by canvas size, in the JAX package's order mega ->
mega-lite -> two-lite -> two, with thresholds from the card's tier sweep
(the same on the CPU, where every tier runs the kernels' plain PyTorch
versions); `tier=` forces one.  The canvas is exactly canvas_shape (no
lane or band padding: the port's kernels take any canvas of whole 8x8
coefficient blocks).  Channels whose region is smaller than
the canvas project on unconstrained boxes (lo = -2^39, hi = +2^39,
dq = iq = 0) outside their region, so those pixels evolve freely like
the reference's loop bounds (compute.c:349-403).  The serving runner's
buckets run the same tiers on a shared canvas (solve_canvas): each image
zero-padded into it with its true extent and step size as device values.

Inside the loop nothing waits for the device: the per-channel step
scale is computed on the device from K1's sum of squares, and each
iteration's partial sums stay on the device until the chunk ends, when
one fetch turns them into metric rows (mega_metrics).  The step size is
a host float (a bucket's: a device value per image).  The two tier's iteration reads its FISTA factor from a
device table (factors[it], the f32 values of iter_step.fista_factors, as
K3 reads its own) and writes into buffers fixed for the solve
(_TwoLoop), so on a card it is captured once per solve as a CUDA graph
of GRAPH_ITERS iterations and replayed; the other loops pass their
factors as host floats.

Semantics replicated (validated against the JAX package and the
reference binary's CSV logs / PNG output):
  * canvas H, W = max over channels of coef dims x sampling
    (compute.c:410-418);
  * FISTA extrapolation with factor (t-1)/t_next, factor 0 at i=0, and
    buffer swap (compute.c:427-440);
  * constant step radius/sqrt(1+iterations), radius = sqrt(h*w)/2
    (compute.c:425,443), normalized by the per-channel gradient norm
    (compute.c:200-216);
  * the prob term reads the clamped DCT saved by the *previous*
    projection (compute.c:381, :37), so each metric row logs the
    previous projection's distance;
  * objective = (tv + tv2 + prob_dist) / total_alpha (compute.c:223-275).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from jpeg2png_tpu_torch import resolve_device
from jpeg2png_tpu_torch.kernels import (
    _build, grad_step, iter_step, stripe_grad)
from jpeg2png_tpu_torch.kernels.grad_step import fused_grad, stack_channels
from jpeg2png_tpu_torch.kernels.iter_step import fused_solve, fused_solve_lite
from jpeg2png_tpu_torch.kernels.project_step import (
    FREE_Q, GAP_BOX, fused_project_multi, fused_project_multi_lite,
    project_scratch)
from jpeg2png_tpu_torch.kernels.stripe_grad import fused_grad_striped_lite
from jpeg2png_tpu_torch.ops.blocks import deblockify
from jpeg2png_tpu_torch.ops.dct_raster import idct_raster
from jpeg2png_tpu_torch.ops.resample import (
    upsample_nearest_clamped, upsample_replicate)
from jpeg2png_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class ChannelGeometry:
    """Static per-channel shape info (jpeg.c:50-67).

    nby/nbx: 8x8 block grid; h_samp/w_samp: vertical/horizontal pixel
    replication factors (max_samp / this channel's samp).
    """
    nby: int
    nbx: int
    h_samp: int = 1
    w_samp: int = 1

    @property
    def ph(self) -> int:  # pixel rows at coef resolution
        return self.nby * 8

    @property
    def pw(self) -> int:
        return self.nbx * 8

    @property
    def region_h(self) -> int:  # full-res rows this channel covers
        return self.ph * self.h_samp

    @property
    def region_w(self) -> int:
        return self.pw * self.w_samp


def canvas_shape(geoms: Sequence[ChannelGeometry]) -> Tuple[int, int]:
    """Full-res canvas = max over channels (compute.c:410-418)."""
    return (max(g.region_h for g in geoms), max(g.region_w for g in geoms))


TIERS = ("mega", "mega-lite", "two-lite", "two")
MAX_IMAGES = iter_step.MAX_BATCH   # images of one K3 launch (solve_canvas)

# The tier gates: the largest canvas (pixels) each tier takes, tried in
# the order mega -> mega-lite -> two-lite, else two.  Set from the card's
# tier sweep (chip_smoke.py phase 6: 50-iteration solves of 0.26, 1.23,
# 3.15, 6.29 and 8.0 MP photos through every tier on an H100), moved only
# where two calls on the same kernels agree (PERF.md).  With K3 on cells
# (two calls, ms per iteration, set-up included): mega beat two at 0.26
# MP (0.120 / 0.118 vs 0.452 / 0.546) and 1.23 MP (0.245 / 0.240 vs
# 0.629 / 0.477); at 3.15 MP the calls disagree (mega 0.432 vs two 0.389,
# mega 0.410 vs two 0.488: the two tier's host floor moves between
# calls); two won at 6.29 MP (0.543 / 0.573 vs mega 0.722 / 0.718) and
# 8.0 MP (0.664 / 0.666 vs 0.885 / 0.899).  So the mega gate stays at the
# last size both calls give it, rounded to 1280x1024.  A lite tier takes
# a size only where it beats every f32 tier by at least LITE_MIN_GAIN in
# every call: its bf16 side state costs 0.05-0.9 dB of agreement with the
# reference's goldens.  None did: mega-lite beat the fastest f32 tier by
# at most 8% (1.23-3.15 MP) and lost at the other sizes, two-lite (K4
# on its first, tiled design) never led: both lite gates closed (0).
# With K4 as a row-marching
# stencil (0.44 -> 0.20 ms at 3072x2048) two-lite leads the two tier
# above the mega gate, but by less than LITE_MIN_GAIN where it counts
# (two calls, ms per iteration, two-lite vs two): 3.15 MP 0.327 / 0.324
# vs 0.342 / 0.338 (4.4%, 3.9%), 6.29 MP 0.534 / 0.523 vs 0.548 / 0.547
# (2.6%, 4.4%), 8.0 MP 0.643 / 0.629 vs 0.681 / 0.707 (5.6%, 11.0%).
# The gate moves only where both calls clear 10% at every size above
# the mega gate up to it, and 3.15 MP fails in both: it stays 0.
LITE_MIN_GAIN = 0.10
MEGA_MAX_PIXELS = 1280 * 1024
MEGA_LITE_MAX_PIXELS = 0
TWO_LITE_MAX_PIXELS = 0


def takes(tier: str, nchannel: int, H: int, W: int, samps,
          n_prob: int) -> bool:
    """Whether `tier`'s kernels take an [H, W] canvas (the two tier takes
    any canvas of whole 8x8 coefficient blocks)."""
    if tier in ("mega", "mega-lite"):
        return iter_step.supports(nchannel, H, W, samps, n_prob)
    if tier == "two-lite":
        return stripe_grad.supports(nchannel, H, W, samps)
    return True


def tier_rule(nchannel: int, H: int, W: int, samps, n_prob: int) -> str:
    """The tier that solves an [H, W] canvas: the first of mega ->
    mega-lite -> two-lite whose size gate and kernel geometry gate hold,
    else two.  The one rule for the single-image tier (active_tier) and
    the serving runner's buckets (runner.plan_buckets)."""
    px = H * W
    for tier, limit in (("mega", MEGA_MAX_PIXELS),
                        ("mega-lite", MEGA_LITE_MAX_PIXELS),
                        ("two-lite", TWO_LITE_MAX_PIXELS)):
        if px <= limit and takes(tier, nchannel, H, W, samps, n_prob):
            return tier
    return "two"


def active_tier(geoms: Sequence[ChannelGeometry],
                pweights: Sequence[float] | None = None) -> str:
    """The tier a solve of this geometry takes: tier_rule on its canvas.
    `pweights` gives the prob channels (None: all on, the CLI default);
    the tier fixes the carry's format."""
    H, W = canvas_shape(geoms)
    n_prob = (len(geoms) if pweights is None
              else sum(1 for p in pweights if p != 0.0))
    samps = [(g.h_samp, g.w_samp) for g in geoms]
    return tier_rule(len(geoms), H, W, samps, n_prob)


def objective_alphas(
    weight: float, pweights: Sequence[float], nchannel: int,
) -> Tuple[list, float]:
    """(p_alphas, total_alpha) — the objective-term scale factors
    (compute.c:223-275: p_alpha = pweight*2*255*sqrt(2) per channel,
    total_alpha = sum of active p_alphas + C [TV] + C*w/sqrt(2) [TGV2])."""
    p_alphas = [pw * 2.0 * 255.0 * math.sqrt(2.0) for pw in pweights]
    total_alpha = sum(pa for pa in p_alphas if pa != 0.0) + nchannel
    if weight != 0.0:
        total_alpha += (weight / math.sqrt(2.0)) * nchannel
    return p_alphas, total_alpha


def mega_metrics(partials: np.ndarray, prob_dist_prev, p_alphas,
                 total_alpha, simd_compat_logging: bool):
    """CSV metrics from per-iteration partial sums.

    partials: [nsteps, >= C+2+P] rows [sumsq_0..C-1, tv, tv2, dist_p0,
    ...] with one dist column per channel whose prob term is on.  The
    reference logs the prob distance computed from the PREVIOUS
    projection's clamped coefs (compute.c:381, :37), hence the one-row
    shift seeded with `prob_dist_prev`.  Returns (metrics [nsteps, 4]
    with columns (objective, prob_dist, tv, tv2) — logger.c:13 — and
    the final prob_dist to carry).
    """
    nchannel = len(p_alphas)
    tv = partials[:, nchannel]
    tv2 = partials[:, nchannel + 1]
    dist_total = np.zeros_like(tv)
    for pi, c in enumerate(
            c for c in range(nchannel) if p_alphas[c] != 0.0):
        d = partials[:, nchannel + 2 + pi]
        if not simd_compat_logging:
            d = np.float32(p_alphas[c]) * d
        dist_total = dist_total + d
    prob_col = np.concatenate(
        [np.asarray([prob_dist_prev], dtype=tv.dtype), dist_total[:-1]])
    objective = (tv + tv2 + prob_col) / np.float32(total_alpha)
    metrics = np.stack([objective, prob_col, tv, tv2], axis=1)
    return metrics, dist_total[-1]


@dataclasses.dataclass
class _Problem:
    """Device constants of one solve (everything but the iterate): one
    image on its own canvas, or a bucket's images zero-padded into one
    canvas, each with its true extent and step size (solve_canvas)."""
    geoms: Tuple[ChannelGeometry, ...]   # a bucket's: the canvas's
    H: int
    W: int
    weight: float
    # radius/sqrt(1 + iterations): a host float; a bucket's [n] f32 tensor
    # (K3), or [] for its one image (the lite pair)
    step_size: "float | torch.Tensor"
    p_alphas: list
    total_alpha: float
    simd_compat_logging: bool
    dats_c: list   # int16 coefficients / f32 quant on the canvas grid
    qs_c: list     # (region gaps: data 0, quant FREE_Q) — K3's inputs
    f0: torch.Tensor   # [C, H, W]; K3's bucket [n, C, H, W]
    extents: "torch.Tensor | None" = None   # a bucket's int32 (h, w): [n, 2]
    # the two tier's and carry_from_numpy's constants (single images only)
    dqs: list = None      # per channel [ph, pw] data*quant (own region)
    inv_qs: list = None   # per channel [ph, pw] 1/quant (own region)
    los: list = None      # per channel [H/sy, W/sx], region gaps unconstrained
    his: list = None
    dqs_c: list = None    # dq / 1/q on the canvas grid, 0 in region gaps
    iqs_c: list = None
    two: "_TwoLoop | None" = None   # the two tier's buffers, made by _run

    @property
    def samps(self):
        return [(g.h_samp, g.w_samp) for g in self.geoms]

    @property
    def pa_sss(self):
        return [pa * g.h_samp * g.w_samp
                for pa, g in zip(self.p_alphas, self.geoms)]

    @property
    def batch(self):
        """The images of a batched (K3 bucket) problem, else None."""
        return self.f0.shape[0] if self.f0.dim() == 4 else None


def _geometry(datas, samps):
    return tuple(ChannelGeometry(d.shape[0], d.shape[1], sy, sx)
                 for d, (sy, sx) in zip(datas, samps))


def _upload(x, span, **kw) -> torch.Tensor:
    """torch.as_tensor(x, **kw); where x is not already a tensor on that
    device, counts its bytes on the device into `span`'s "bytes"."""
    t = torch.as_tensor(x, **kw)
    if span is not None and not (isinstance(x, torch.Tensor)
                                 and x.device == t.device):
        profiling.count(span, "bytes", t.nbytes)
    return t


def _pad(x: torch.Tensor, h: int, w: int, value: float = 0.0):
    """x [..., rows, cols] padded at the bottom and right to [..., h, w]."""
    pad = (0, w - x.shape[-1], 0, h - x.shape[-2])
    if not (pad[1] or pad[3]):
        return x
    return torch.nn.functional.pad(x, pad, value=value)


def step_size(H: int, W: int, iterations: int) -> float:
    """The constant step radius/sqrt(1 + iterations), radius = sqrt(h*w)/2
    of the image's own canvas (compute.c:425, 443)."""
    return math.sqrt(float(H) * float(W)) / 2.0 / math.sqrt(1.0 + iterations)


def canvas_inputs(datas, quants, samps, canvas, device, span=None):
    """K3's and the lite tiers' inputs for n >= 1 images of one sampling
    on one [H, W] canvas, each image at the top left of it.

    datas, quants: per image, per channel int16 [nby, nbx, 8, 8] DCT
    coefficients and [8, 8] quantization tables (numpy arrays, or tensors
    already on the device: utils/timing.py uploads once for its timed
    solves).  `span` (the "solve.setup" span) counts the bytes uploaded
    from the host.  Per image and channel, on the coefficient grid of the
    canvas (coefficient (u,v) of block (by,bx) at (8by+u, 8bx+v)):
      * the int16 coefficients, 0 beyond the channel's region;
      * the quant raster: the table over the region, FREE_Q over the gap
        between the region and the image's canvas (unconstrained, no prob
        term, like the reference's loop bounds, compute.c:349-403), 0
        beyond the image's canvas (frozen bucket padding);
      * f0: the plain decode (dequantize + IDCT, jpeg.c:83-92),
        nearest-upsampled with edge clamping to the image's canvas
        (compute.c:296-302), 0 beyond it.
    Returns (f0 [n, C, H, W] f32, per channel [n, H/sy, W/sx] int16
    rasters, per channel [n, H/sy, W/sx] f32 quant rasters, each image's
    canvas (h, w))."""
    H, W = canvas
    C = len(samps)
    f0, dats, qs, extents = [], [[] for _ in samps], [[] for _ in samps], []
    for ds, qts in zip(datas, quants):
        geoms = _geometry(ds, samps)
        eh, ew = canvas_shape(geoms)
        if eh > H or ew > W:
            raise ValueError(f"image canvas {eh}x{ew} does not fit the "
                             f"{H}x{W} canvas")
        extents.append((eh, ew))
        for c, (d, q, g) in enumerate(zip(ds, qts, geoms)):
            q_r = _upload(q, span, dtype=torch.float32, device=device)
            q_r = q_r.tile(g.nby, g.nbx)
            data_i16 = deblockify(_upload(d, span, device=device))
            dq = data_i16.to(torch.float32) * q_r
            f0.append(_pad(upsample_nearest_clamped(
                idct_raster(dq), g.h_samp, g.w_samp, eh, ew), H, W))
            hc, wc = H // g.h_samp, W // g.w_samp
            dats[c].append(_pad(data_i16, hc, wc))
            qs[c].append(_pad(_pad(q_r, eh // g.h_samp, ew // g.w_samp,
                                   FREE_Q), hc, wc))

    def stack(xs):
        return xs[0][None] if len(xs) == 1 else torch.stack(xs)

    return (torch.stack(f0).view(len(datas), C, H, W),
            [stack(x) for x in dats], [stack(x) for x in qs], extents)


def bucket_inputs(datas, quants, samps, canvas, iterations, device):
    """canvas_inputs of a bucket's images, with each image's canvas and
    step size (step_size of its own canvas) as device values: (f0 [n, C,
    H, W], int16 rasters, quant rasters, extents [n, 2] int32, step sizes
    [n] f32), K3's dynamic-extent inputs."""
    f0, dats, qs, extents = canvas_inputs(datas, quants, samps, canvas,
                                          device)
    steps = [step_size(h, w, iterations) for h, w in extents]
    return (f0, dats, qs,
            torch.as_tensor(np.asarray(extents, np.int32), device=device),
            torch.as_tensor(np.asarray(steps, np.float32), device=device))


def _build_problem(datas, quants, samps, weight, pweights, iterations,
                   simd_compat_logging, device, span=None) -> _Problem:
    """The device constants of a solve of one image on its own canvas.
    `span` (the "solve.setup" span) counts the bytes of the coefficients
    and quantisation tables uploaded from the host; the upsampling's index
    vectors (8 (H + W) bytes a channel) and the cached transform matrices
    are left out."""
    geoms = _geometry(datas, samps)
    H, W = canvas_shape(geoms)
    for g in geoms:
        if H % (8 * g.h_samp) or W % (8 * g.w_samp):
            raise ValueError(
                f"canvas {H}x{W} is not whole 8x8 coefficient blocks at "
                f"sampling ({g.h_samp}, {g.w_samp})")
    p_alphas, total_alpha = objective_alphas(weight, pweights, len(geoms))
    f0, dats_c, qs_c, _ = canvas_inputs([datas], [quants], samps, (H, W),
                                        device, span)
    dats_c = [x[0] for x in dats_c]
    qs_c = [x[0] for x in qs_c]
    dqs, inv_qs, los, his, dqs_c, iqs_c = [], [], [], [], [], []
    for data_i16, q_r, g in zip(dats_c, qs_c, geoms):
        q_r = q_r[:g.ph, :g.pw]
        dq = data_i16[:g.ph, :g.pw].to(torch.float32) * q_r
        iq = 1.0 / q_r
        dqs.append(dq)
        inv_qs.append(iq)
        # region gap: unconstrained boxes, no prob term
        hc, wc = H // g.h_samp, W // g.w_samp
        los.append(_pad(dq - 0.5 * q_r, hc, wc, -GAP_BOX))
        his.append(_pad(dq + 0.5 * q_r, hc, wc, GAP_BOX))
        dqs_c.append(_pad(dq, hc, wc))
        iqs_c.append(_pad(iq, hc, wc))
    return _Problem(
        geoms=geoms, H=H, W=W, weight=float(weight),
        step_size=step_size(H, W, iterations),
        p_alphas=p_alphas, total_alpha=total_alpha,
        simd_compat_logging=bool(simd_compat_logging),
        dats_c=dats_c, qs_c=qs_c, f0=f0[0],
        dqs=dqs, inv_qs=inv_qs, los=los, his=his, dqs_c=dqs_c, iqs_c=iqs_c)


def _initial_carry(prob: _Problem, tier: str):
    """The carry at iteration 0: the prob term is zero because the saved
    coefficients start at data*quant (compute.c:279-286).

    "two":  (fdatas, fistas, pgrads [P, H, W], prob_dist, t);
    "mega": (fdatas, fistas, devqs tuple of [H/sy, W/sx] per prob
            channel, prob_dist, t) — the JAX mega carry (solver.py:563-570);
    "two-lite", "mega-lite": (fdatas f32, ds = fdatas - fistas bf16,
            devqs tuple bf16, prob_dist, t) — the JAX two-lite carry
            (solver.py:478-480), one format for both lite tiers.
    A K3 bucket's state has a leading image axis, and prob_dist is [n].
    """
    fmt = _CARRY_FORMAT[tier]
    side = torch.bfloat16 if fmt == "lite" else torch.float32
    if fmt != "two":
        devqs = tuple(torch.zeros_like(q, dtype=side) for q, pa in
                      zip(prob.qs_c, prob.p_alphas) if pa != 0.0)
        fista = (torch.zeros_like(prob.f0, dtype=side) if fmt == "lite"
                 else prob.f0)
        dist = (0.0 if prob.batch is None
                else np.zeros((prob.batch,), np.float32))
        return (prob.f0, fista, devqs, dist, 1.0)
    n_prob = sum(1 for pa in prob.p_alphas if pa != 0.0)
    pg0 = torch.zeros((n_prob, prob.H, prob.W), device=prob.f0.device)
    return (prob.f0, prob.f0, pg0, 0.0, 1.0)


# the carry format of each tier: the lite tiers share one state
_CARRY_FORMAT = {"two": "two", "mega": "mega", "two-lite": "lite",
                 "mega-lite": "lite"}


def _carry_format(carry) -> str:
    if not isinstance(carry[2], tuple):
        return "two"
    return "lite" if carry[1].dtype == torch.bfloat16 else "mega"


def _metrics(prob: _Problem, rows: torch.Tensor, prob_dist):
    """Metric rows from per-iteration [sumsq C, tv, tv2, dists C] rows
    (the two-kernel tiers' layout, [n, 2C + 2] on the device), fetched
    once -> (metrics, the final prob_dist)."""
    partials = rows.cpu().numpy()
    C = len(prob.geoms)
    cols = list(range(C + 2)) + [C + 2 + c for c in range(C)
                                 if prob.p_alphas[c] != 0.0]
    metrics, dist_final = mega_metrics(
        partials[:, cols], prob_dist, prob.p_alphas, prob.total_alpha,
        prob.simd_compat_logging)
    return metrics, float(dist_final)


# Iterations of the two tier in one captured CUDA graph: even, so the
# iterate's two planes come back to their places after a replay.  Chosen
# on the card among 2, 4, 6, 8 and 10 (PERF.md §6): a capture costs about
# 1.5 ms + 0.5 ms an iteration of host time while the card waits, and a
# replay a few microseconds, so 2 was fastest or tied at every size
# (1536x1024 to 3264x2448, 50 and 1000 iterations).
GRAPH_ITERS = 2


def _count_launches(n: int) -> None:
    """Add n to K1's and K2's launch counts: the kernels a graph's replays
    ran, less those its capture counted without running them."""
    for wrapper in (fused_grad, fused_project_multi):
        _build.count_launch(wrapper, n)


def _replays(device: torch.device) -> bool:
    """Whether the two tier captures and replays its iteration: on a card,
    unless fp_exceptions is on (its per-iteration checks synchronise)."""
    return device.type == "cuda" and not _build.fp_traps


class _TwoLoop:
    """The two tier's iteration on buffers fixed for one solve.

    The iterate and its FISTA shadow are two [C, H, W] planes that trade
    places every iteration (`cur` holds f): K1 reads f, fista, pgrad and
    its factor factors[it]; the step scale step / |g| is computed on the
    device; K2 writes the new iterate into the plane whose fista K1 has
    just consumed, and the next prob gradient over pgrad; the iteration's
    row [sumsq C, tv, tv2, dists C] goes to rows[it]; it += 1.  Nothing
    there allocates (every op writes a buffer of the solve, so a capture
    takes no memory of its own) or reads a host value that changes, so on
    a card GRAPH_ITERS iterations are captured once per solve (a graph per
    parity of `cur`) and replayed; the CPU, fp_exceptions and the
    remainders run the same `step` eagerly.  The carry a chunk returns
    holds the planes and pgrad themselves: it is current until the next
    chunk of the same solve, which continues from it."""

    def __init__(self, prob: _Problem):
        dev = prob.f0.device
        C, H, W = prob.f0.shape
        mask = [pa != 0.0 for pa in prob.p_alphas]
        self.planes = [torch.empty_like(prob.f0), torch.empty_like(prob.f0)]
        self.pgrad = torch.empty((sum(mask), H, W), device=dev)
        it = iter(self.pgrad)
        self.pg_in = [next(it) if m else None for m in mask]
        self.dqs = [d if m else None for d, m in zip(prob.dqs_c, mask)]
        self.iqs = [q if m else None for q, m in zip(prob.iqs_c, mask)]
        self.grads = torch.empty_like(prob.f0)
        self.extraps = torch.empty_like(prob.f0)
        # an iteration's metric row: K1's sums, then K2's distances
        self.row = torch.empty((2 * C + 2,), device=dev)
        self.sums, self.dists = self.row[:C + 2], self.row[C + 2:]
        self.norms = torch.empty((C,), device=dev)
        self.flat = torch.empty((C,), device=dev, dtype=torch.bool)
        self.scale = torch.empty((C,), device=dev)
        self.k1_part = (grad_step.scratch(grad_step._launcher()[0], C,
                                          prob.weight != 0.0, H, W, dev)
                        if dev.type == "cuda" else None)
        self.k2_part = project_scratch(H, W, prob.samps, dev)
        self.it = torch.zeros((1,), device=dev, dtype=torch.int64)
        self.factors = self.rows = None
        self.cur = 0
        self.handed = None       # (f, fista, pgrad) of the carry handed out
        self.graphs = {}         # cur at the start -> CUDAGraph

    def load(self, carry) -> None:
        """Put a carry's iterate, shadow and prob gradient in the planes,
        unless it is the one the last chunk handed out (already there)."""
        f, fi, pg = carry[:3]
        if self.handed is not None and all(
                a is b for a, b in zip((f, fi, pg), self.handed)):
            return
        mine = {b.untyped_storage().data_ptr()
                for b in (*self.planes, self.pgrad) if b.numel()}
        if any(isinstance(x, torch.Tensor) and x.numel()
               and x.untyped_storage().data_ptr() in mine
               for x in (f, fi, pg)):
            raise ValueError("this carry was handed out before the solve's "
                             "last chunk, whose iterations overwrote it")
        self.planes[0].copy_(stack_channels(f))
        self.planes[1].copy_(stack_channels(fi))
        self.pgrad.copy_(pg)
        self.cur = 0

    def step(self, prob: _Problem, i) -> None:
        """One iteration (i: its number in the chunk, for fp_exceptions;
        None while capturing)."""
        f, fi = self.planes[self.cur], self.planes[1 - self.cur]
        _, _, sumsq, _, _ = fused_grad(
            f, fi, self.pg_in, (self.factors, self.it), prob.weight,
            h_true=prob.H, w_true=prob.W,
            out=(self.grads, self.extraps, self.sums, self.k1_part))
        # where(|g| == 0, 0, step / |g|), op for op as PyTorch computes
        # it (step / t is t.reciprocal() * step), into the buffers
        torch.sqrt(sumsq, out=self.norms)
        torch.eq(self.norms, 0.0, out=self.flat)
        torch.reciprocal(self.norms, out=self.scale)
        self.scale.mul_(prob.step_size).masked_fill_(self.flat, 0.0)
        fused_project_multi(
            self.extraps, self.grads, self.scale, prob.los, prob.his,
            self.dqs, self.iqs, prob.pa_sss, prob.samps,
            out=(fi, self.pgrad, self.k2_part, self.dists))
        self.rows.index_copy_(0, self.it, self.row[None])
        self.it.add_(1)
        self.cur = 1 - self.cur
        _build.check_finite("two tier", (fi, self.pgrad), i)

    def _graph(self, prob: _Problem):
        """The graph of GRAPH_ITERS iterations from the current parity,
        captured on a side stream ordered after the current one (not
        torch.cuda.graph, which synchronises the device and empties the
        allocator's cache on entry) in thread-local mode, so the other
        cards' threads launch meanwhile.  Capturing runs nothing: the
        launch counts it added are taken back."""
        g = self.graphs.get(self.cur)
        if g is None:
            dev = self.planes[0].device
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    for _ in range(GRAPH_ITERS):
                        self.step(prob, None)
                finally:
                    g.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)
            _count_launches(-GRAPH_ITERS)
            self.graphs[self.cur] = g
        return g

    def run(self, prob: _Problem, factors: np.ndarray, span) -> torch.Tensor:
        """The chunk's iterations, factors [n] f32 -> their rows [n, 2C + 2]
        on the device.  `span` (the "solve.loop" span, or None) counts
        the iterations run inside replays (graph_iters) and eagerly
        (eager_iters)."""
        n = len(factors)
        dev = self.it.device
        if self.rows is None or self.rows.shape[0] < n:
            # the graphs read the tables' addresses: new tables, new graphs
            self.factors = torch.empty((n,), device=dev)
            self.rows = torch.empty((n, self.row.shape[0]), device=dev)
            self.graphs.clear()
        # from pageable memory a non-blocking copy is staged before it
        # returns, and waits for no earlier work on the stream
        self.factors[:n].copy_(torch.from_numpy(factors), non_blocking=True)
        self.it.zero_()
        reps = n // GRAPH_ITERS if _replays(dev) else 0
        if reps:
            g = self._graph(prob)
            for _ in range(reps):
                g.replay()
            _count_launches(reps * GRAPH_ITERS)
        eager = n - reps * GRAPH_ITERS
        for k in range(reps * GRAPH_ITERS, n):
            self.step(prob, k)
        if span is not None:
            profiling.count(span, "graph_iters", reps * GRAPH_ITERS)
            profiling.count(span, "eager_iters", eager)
        return self.rows[:n]

    def carry(self, prob_dist, t):
        """The chunk's carry: new views of the buffers each chunk, so that
        load() tells the last one handed out from an earlier one."""
        self.handed = tuple(x[...] for x in (
            self.planes[self.cur], self.planes[1 - self.cur], self.pgrad))
        return (*self.handed, prob_dist, t)


def _run(prob: _Problem, carry, nsteps: int, tier: str, span=None):
    """nsteps iterations of `tier` from `carry` (that tier's format) ->
    (carry, metrics [nsteps, 4]).  `span`: the "solve.loop" span, which
    the two tier's counts go to."""
    if tier in ("mega", "mega-lite"):
        return _run_mega(prob, carry, nsteps, tier == "mega-lite")
    if tier == "two-lite":
        return _run_two_lite(prob, carry, nsteps)
    if nsteps == 0:
        return carry, np.zeros((0, 4), np.float32)
    prob_dist, t = carry[3:]
    if prob.two is None:
        prob.two = _TwoLoop(prob)
    prob.two.load(carry)
    factors, t_final = iter_step.fista_factors(t, nsteps)
    rows = prob.two.run(prob, factors, span)
    # the chunk's one device -> host fetch
    metrics, dist_final = _metrics(prob, rows, prob_dist)
    return prob.two.carry(dist_final, t_final), metrics


def _run_two_lite(prob: _Problem, carry, nsteps: int):
    """The two-lite tier: K4 on the whole canvas as one band (row0 0, no
    halos, the true extent the canvas or the problem's `extents`), then K5,
    per iteration."""
    fdatas, ds, devqs, prob_dist, t = carry
    if nsteps == 0:
        return carry, np.zeros((0, 4), np.float32)
    factors, t_final = iter_step.fista_factors(t, nsteps)
    devqs = list(devqs)
    rows = []
    for i in range(nsteps):
        factor = float(factors[i])
        grads, sumsq, tv, tv2 = fused_grad_striped_lite(
            fdatas, ds, devqs, None, factor, 0, prob.weight, prob.samps,
            prob.pa_sss, prob.H, prob.H, prob.W, extents=prob.extents)
        norms = torch.sqrt(sumsq)
        scale = torch.where(norms == 0.0, 0.0, prob.step_size / norms)
        fdatas, ds, dq_out, dists = fused_project_multi_lite(
            fdatas, ds, grads, factor, scale, prob.dats_c, prob.qs_c,
            prob.pa_sss, prob.samps)
        devqs = [d for d in dq_out if d is not None]
        rows.append(torch.cat([sumsq, tv.reshape(1), tv2.reshape(1), dists]))
        _build.check_finite("two-lite tier", (fdatas, ds, devqs), i)
    metrics, dist_final = _metrics(prob, torch.stack(rows), prob_dist)
    return (fdatas, ds, tuple(devqs), dist_final, t_final), metrics


def _run_mega(prob: _Problem, carry, nsteps: int, lite: bool):
    """The mega tiers: all nsteps iterations in one K3 launch (lite: on
    the lite carry, K3's lite mode); a bucket's images in one launch in
    dynamic-extent mode, with metrics [n, nsteps, 4]."""
    fdatas, side, devqs, prob_dist, t = carry
    if nsteps == 0:
        return carry, np.zeros((0, 4), np.float32)
    factors, t_final = iter_step.fista_factors(t, nsteps)
    solve = fused_solve_lite if lite else fused_solve
    fdatas, side, devqs, partials = solve(
        fdatas, side, list(devqs), factors, prob.step_size, prob.dats_c,
        prob.qs_c, prob.pa_sss, prob.samps, prob.weight,
        extents=prob.extents)
    _build.check_finite("mega tier", (fdatas, side, devqs), nsteps - 1)
    # the chunk's one device -> host fetch
    partials = partials.cpu().numpy()
    state = (fdatas, side, tuple(devqs))
    if prob.batch is None:
        metrics, dist_final = mega_metrics(
            partials, prob_dist, prob.p_alphas, prob.total_alpha,
            prob.simd_compat_logging)
        return (*state, float(dist_final), t_final), metrics
    rows = [mega_metrics(p, d, prob.p_alphas, prob.total_alpha,
                         prob.simd_compat_logging)
            for p, d in zip(partials, prob_dist)]
    return ((*state, np.asarray([d for _, d in rows], np.float32), t_final),
            np.stack([m for m, _ in rows]))


def _resolve_tier(prob: _Problem, tier, pweights) -> str:
    if tier is None:
        return active_tier(prob.geoms, pweights)
    if tier not in TIERS:
        raise ValueError(f"unknown solver tier {tier!r} (one of {TIERS})")
    if not takes(tier, len(prob.geoms), prob.H, prob.W, prob.samps,
                 sum(1 for p in pweights if p != 0.0)):
        raise ValueError(f"the {tier} tier does not take geometry "
                         f"{prob.H}x{prob.W} samps={prob.samps}")
    return tier


def carry_from_numpy(carry, datas, quants, samps, weight, pweights,
                     simd_compat_logging: bool = True, device="cuda",
                     tier=None, source=None):
    """A JAX package carry -> this solver's carry for `tier` (default:
    active_tier of the geometry).

    carry, as numpy arrays, is one of (`source` names it; None infers it
    from the carry's length and the dtype of its second entry)
      * "xla": the XLA-tier carry (fdata [C,H,W], fista [C,H,W], cos
        tuple of per-channel clamped coefficient rasters, t) from
        jpeg2png_tpu.models.solver._build_solver_impl(..., use_pallas=
        False);
      * "mega": the mega-tier carry (fdata tuple, fista tuple, devq tuple
        per prob channel [H/sy, W/sx], prob_dist, t) from its fused
        solve — also the mega-lite tier's, which keeps K3's f32
        interface (jpeg2png_tpu/kernels/iter_step.py:758-761);
      * "two-lite": the two-lite carry (fdata tuple, d = fdata - fista
        tuple, devq tuple, prob_dist, t; d and devq bfloat16, which
        numpy holds as ml_dtypes.bfloat16, or float32 if the caller cast
        them), on the JAX tier's padded [H2, W2] canvas: the padding is
        frozen at 0 and cropped here.
    The prob state becomes devq = (cos - dq) / q^2 on the canvas
    coefficient grid (mega, lite: rounded to bf16) or the pixel gradient
    p_alpha * up(idct(devq)) (two), with the distance the JAX body
    computes at its next step (jpeg2png_tpu/models/solver.py:263).
    `weight` is accepted for signature parity; the carry does not depend
    on it.
    """
    del weight
    device = resolve_device(device)
    prob = _build_problem(datas, quants, samps, 0.0, pweights, 0,
                          simd_compat_logging, device)
    tier = _resolve_tier(prob, tier, pweights)
    if source is None:
        source = ("xla" if len(carry) == 4 else
                  "two-lite" if np.asarray(carry[1][0]).dtype.name
                  == "bfloat16" else "mega")

    def tensor(x, rows=None, cols=None):
        return torch.as_tensor(np.array(x, np.float32)[:rows, :cols],
                               device=device)

    prob_cs = [c for c, pa in enumerate(prob.p_alphas) if pa != 0.0]
    lite_d = None
    if source == "two-lite":
        fdata, ds, devqs_j, dist, t = carry
        fdata = torch.stack([tensor(x, prob.H, prob.W) for x in fdata])
        lite_d = torch.stack([tensor(x, prob.H, prob.W) for x in ds])
        fista = fdata - lite_d
        devqs = [tensor(d, prob.H // prob.samps[c][0],
                        prob.W // prob.samps[c][1])
                 for d, c in zip(devqs_j, prob_cs)]
        dist = float(dist)
    elif source == "mega":
        fdata, fista, devqs_j, dist, t = carry
        fdata = torch.stack([tensor(x) for x in fdata])
        fista = torch.stack([tensor(x) for x in fista])
        devqs = [tensor(d) for d in devqs_j]
        dist = float(dist)
    elif source == "xla":
        fdata, fista, cos, t = carry
        fdata, fista = tensor(fdata), tensor(fista)
        devqs = []
        dist = torch.zeros((), device=device)
        for c in prob_cs:
            g = prob.geoms[c]
            scaled = (tensor(cos[c]) - prob.dqs[c]) * prob.inv_qs[c]
            d = 0.5 * torch.sum(scaled * scaled)
            dist = dist + (d if simd_compat_logging else prob.p_alphas[c] * d)
            pad = (0, prob.W // g.w_samp - g.pw, 0, prob.H // g.h_samp - g.ph)
            devqs.append(torch.nn.functional.pad(scaled * prob.inv_qs[c], pad))
        dist = float(dist)
    else:
        raise ValueError(f"unknown carry source {source!r}")
    if tier == "mega":
        return (fdata, fista, tuple(devqs), dist, float(t))
    if _CARRY_FORMAT[tier] == "lite":
        d = (lite_d if lite_d is not None else fdata - fista)
        return (fdata, d.to(torch.bfloat16),
                tuple(x.to(torch.bfloat16) for x in devqs), dist, float(t))
    pgrads = [prob.p_alphas[c] * upsample_replicate(
        idct_raster(d), *prob.samps[c]) for c, d in zip(prob_cs, devqs)]
    pg = (torch.stack(pgrads) if pgrads
          else torch.zeros((0, prob.H, prob.W), device=device))
    return (fdata, fista, pg, dist, float(t))


def solve_steps(datas, quants, samps, weight, pweights, iterations,
                carry=None, nsteps=None, simd_compat_logging: bool = True,
                device="cuda", tier=None):
    """The resumable primitive: `nsteps` (default `iterations`)
    iterations from `carry` (None: the plain decode).  `iterations` is
    the TOTAL planned count and fixes the step size
    radius/sqrt(1+iterations) (compute.c:443) however the run is split.
    `tier` (default active_tier) must match the carry's format (the two
    lite tiers share theirs, so either resumes the other's carry).

    Returns (fdata [C, H, W] tensor, metrics [nsteps, 4] numpy, carry).
    The set-up and the loop are the "solve.setup" and "solve.loop" spans:
    the set-up counts the host -> device "bytes" of _build_problem's
    uploads (_initial_carry uploads nothing: its state is made on the
    device), the loop carries the solve's "tier" and, in the two tier,
    counts the iterations run inside graph replays ("graph_iters") and
    eagerly ("eager_iters").
    """
    device = resolve_device(device)
    with profiling.span("solve.setup") as sp:
        prob = _build_problem(datas, quants, samps, weight, pweights,
                              iterations, simd_compat_logging, device, sp)
        tier = _resolve_tier(prob, tier, pweights)
        if carry is None:
            carry = _initial_carry(prob, tier)
        elif _carry_format(carry) != _CARRY_FORMAT[tier]:
            raise ValueError(f"a {_carry_format(carry)!r}-format carry "
                             f"cannot resume a {tier!r}-tier solve")
    with profiling.span("solve.loop", tier=tier) as sp:
        carry, metrics = _run(prob, carry, iterations if nsteps is None
                              else nsteps, tier, sp)
    return carry[0], metrics, carry


def solve_joint(
    datas: Sequence[np.ndarray],
    quants: Sequence[np.ndarray],
    samps: Sequence[Tuple[int, int]],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    simd_compat_logging: bool = True,
    device="cuda",
    tier=None,
):
    """Joint multi-channel solve (the default mode, jpeg2png.c:142-144).

    Args:
        datas: per channel int16 [nby, nbx, 8, 8] DCT coefficients.
        quants: per channel [8, 8] quantization tables.
        samps: per channel (h_samp, w_samp) replication factors.
        device: "cuda" (default; raises RuntimeError without a card) or
            "cpu" for the plain PyTorch versions of the kernels.
        tier: None (active_tier) or one of TIERS.
    Returns:
        (fdata [C, H, W] tensor on `device`, metrics [iterations, 4]
        numpy) where metrics columns are (objective, prob_dist, tv, tv2)
        per iteration — exactly the reference CSV columns (logger.c:13).
    """
    fdata, metrics, _ = solve_steps(
        datas, quants, samps, weight, pweights, iterations,
        simd_compat_logging=simd_compat_logging, device=device, tier=tier)
    return fdata, metrics


def iter_chunk(iterations: int, listening: bool = True) -> int:
    """Iterations per host-visible chunk of a solve: all of them when
    nothing listens; while a progress bar or a CSV log does, one at a time
    for solves of <= 16 iterations (the reference's bar ticks every
    iteration, progressbar.c:37-47), else a twentieth of them within 8-50.
    The one rule of the per-file pipeline, the striped solver and the
    serving runner's buckets."""
    if not listening:
        return iterations
    if iterations <= 16:
        return 1
    return max(8, min(50, iterations // 20 or iterations))


def run_chunks(run, carry, nsteps: int, chunk: int, on_chunk=None):
    """nsteps iterations as chunks of `chunk`: run(carry, n) -> (carry,
    metrics [..., n, 4]) per chunk, then on_chunk(done_iterations,
    metrics) on the host.  Returns (carry, the chunks' metrics joined on
    the iteration axis, [0, 4] for none)."""
    done, parts = 0, []
    while done < nsteps:
        n = min(chunk, nsteps - done)
        carry, metrics = run(carry, n)
        done += n
        parts.append(metrics)
        if on_chunk is not None:
            on_chunk(done, metrics)
    return carry, (np.concatenate(parts, axis=-2) if parts
                   else np.zeros((0, 4), np.float32))


def solve_joint_chunked(
    datas, quants, samps, weight, pweights, iterations,
    on_chunk=None, chunk: int | None = None,
    simd_compat_logging: bool = True, device="cuda", tier=None,
):
    """solve_joint split into host-visible chunks.

    The reference ticks its progress bar and CSV log every iteration
    (compute.c:449-452, logger.c:20); here the loop runs as a sequence
    of resumable chunks of the same iterations (`chunk` each, default
    iter_chunk) — identical to one uninterrupted solve (the step size keys
    on the TOTAL iteration count and the carry resumes exactly).  After
    each chunk, `on_chunk(done_iterations, metrics_chunk)` fires on the
    host.
    """
    device = resolve_device(device)
    if chunk is None:
        chunk = iter_chunk(iterations, on_chunk is not None)
    with profiling.span("solve.setup") as sp:
        prob = _build_problem(datas, quants, samps, weight, pweights,
                              iterations, simd_compat_logging, device, sp)
        tier = _resolve_tier(prob, tier, pweights)
        carry = _initial_carry(prob, tier)
    with profiling.span("solve.loop", tier=tier) as sp:
        carry, metrics = run_chunks(
            lambda c, n: _run(prob, c, n, tier, sp), carry, iterations,
            chunk, on_chunk)
    return carry[0], metrics


def solve_canvas(datas, quants, samps, canvas, weight, pweights, iterations,
                 simd_compat_logging: bool = True, device="cuda",
                 tier: str = "mega", chunk: int | None = None, on_chunk=None):
    """n images of one sampling, each zero-padded into one [H, W] canvas
    with its own true extent and step size as device values
    (bucket_inputs), solved in dynamic-extent mode: together through K3
    (tier "mega" or "mega-lite": up to MAX_IMAGES), or one image through
    the lite pair ("two-lite").  The serving runner's dyn and dyn2
    buckets.

    The iterations run as chunks of `chunk` (default iter_chunk),
    bit-identical to one shot; on_chunk(done_iterations, metrics [n, k,
    4]) fires after each.  Returns (fdata [n, C, H, W] on `device`,
    metrics [n, iterations, 4])."""
    C, n = len(samps), len(datas)
    if tier not in ("mega", "mega-lite", "two-lite") or not takes(
            tier, C, *canvas, samps,
            sum(1 for p in pweights[:C] if p != 0.0)):
        raise ValueError(f"the {tier} tier does not take a {canvas[0]}x"
                         f"{canvas[1]} bucket canvas at samps={samps}")
    if tier == "two-lite" and n != 1:
        raise ValueError("the lite pair solves one image at a time")
    f0, dats, qs, extents, steps = bucket_inputs(
        datas, quants, samps, canvas, iterations, resolve_device(device))
    if tier == "two-lite":
        # the lite pair's one image: no batch axis
        f0, extents, steps = f0[0], extents[0], steps[0]
        dats, qs = [x[0] for x in dats], [x[0] for x in qs]
    p_alphas, total_alpha = objective_alphas(float(weight), pweights, C)
    prob = _Problem(
        geoms=tuple(ChannelGeometry(canvas[0] // (8 * sy),
                                    canvas[1] // (8 * sx), sy, sx)
                    for sy, sx in samps),
        H=canvas[0], W=canvas[1], weight=float(weight), step_size=steps,
        p_alphas=p_alphas, total_alpha=total_alpha,
        simd_compat_logging=bool(simd_compat_logging), dats_c=dats,
        qs_c=qs, f0=f0, extents=extents)
    if chunk is None:
        chunk = iter_chunk(iterations, on_chunk is not None)
    each = None
    if on_chunk is not None:
        def each(done, metrics):
            on_chunk(done, metrics.reshape(n, -1, 4))
    carry, metrics = run_chunks(lambda c, k: _run(prob, c, k, tier),
                                _initial_carry(prob, tier), iterations,
                                chunk, each)
    return (carry[0].reshape(n, C, *canvas),
            metrics.reshape(n, iterations, 4))


def solve_separate(
    datas, quants, samps, weights, pweights, iterations_per_channel,
    simd_compat_logging: bool = True, device="cuda", tier=None,
):
    """Per-channel independent solves (-s mode, jpeg2png.c:146-153).

    Each channel's canvas is that channel's own region, like the
    reference's per-channel compute() calls.
    Returns list of ([1, Hc, Wc] fdata, metrics) per channel.
    """
    return [
        solve_joint([datas[c]], [quants[c]], [samps[c]], weights[c],
                    [pweights[c]], iterations_per_channel[c],
                    simd_compat_logging, device, tier)
        for c in range(len(datas))
    ]
