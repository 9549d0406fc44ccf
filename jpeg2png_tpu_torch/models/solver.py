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
the reference's loop bounds (compute.c:349-403).

Inside the loop nothing waits for the device: the FISTA factors and the
step size are host floats, the per-channel step scale is computed on
the device from K1's sum of squares, and each iteration's partial sums
stay on the device until the chunk ends, when one fetch turns them into
metric rows (mega_metrics).

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
from jpeg2png_tpu_torch.kernels import _build, iter_step, stripe_grad
from jpeg2png_tpu_torch.kernels.grad_step import fused_grad, stack_channels
from jpeg2png_tpu_torch.kernels.iter_step import fused_solve, fused_solve_lite
from jpeg2png_tpu_torch.kernels.project_step import (
    FREE_Q, GAP_BOX, fused_project_multi, fused_project_multi_lite)
from jpeg2png_tpu_torch.kernels.stripe_grad import fused_grad_striped_lite
from jpeg2png_tpu_torch.ops.blocks import deblockify
from jpeg2png_tpu_torch.ops.dct_raster import idct_raster
from jpeg2png_tpu_torch.ops.resample import (
    upsample_nearest_clamped, upsample_replicate)


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


def tier_rule(nchannel: int, H: int, W: int, samps, n_prob: int) -> str:
    """The tier that solves an [H, W] canvas: the first of mega ->
    mega-lite -> two-lite whose size gate and kernel geometry gate hold,
    else two.  The one rule for the single-image tier (active_tier) and
    the serving runner's buckets (runner.plan_buckets)."""
    px = H * W
    whole = iter_step.supports(nchannel, H, W, samps, n_prob)
    if whole and px <= MEGA_MAX_PIXELS:
        return "mega"
    if whole and px <= MEGA_LITE_MAX_PIXELS:
        return "mega-lite"
    if px <= TWO_LITE_MAX_PIXELS and stripe_grad.supports(nchannel, H, W,
                                                          samps):
        return "two-lite"
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


def initial_decode(data: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """Plain JPEG decode of one channel: dequantize + IDCT (jpeg.c:83-92).

    data: [nby, nbx, 8, 8] int16; quant: [8, 8] float. Returns [ph, pw].
    """
    nby, nbx = data.shape[:2]
    return idct_raster(deblockify(data.to(quant.dtype)) * quant.tile(nby, nbx))


@dataclasses.dataclass
class _Problem:
    """Device constants of one solve (everything but the iterate)."""
    geoms: Tuple[ChannelGeometry, ...]
    H: int
    W: int
    weight: float
    step_size: float
    p_alphas: list
    total_alpha: float
    simd_compat_logging: bool
    dqs: list      # per channel [ph, pw] data*quant (own region)
    inv_qs: list   # per channel [ph, pw] 1/quant (own region)
    los: list      # per channel [H/sy, W/sx], region gaps unconstrained
    his: list
    dqs_c: list    # dq / 1/q on the canvas grid, 0 in region gaps
    iqs_c: list
    dats_c: list   # int16 coefficients / f32 quant on the canvas grid
    qs_c: list     # (region gaps: data 0, quant FREE_Q) — K3's inputs
    f0: torch.Tensor

    @property
    def samps(self):
        return [(g.h_samp, g.w_samp) for g in self.geoms]

    @property
    def pa_sss(self):
        return [pa * g.h_samp * g.w_samp
                for pa, g in zip(self.p_alphas, self.geoms)]


def _geometry(datas, samps):
    return tuple(ChannelGeometry(d.shape[0], d.shape[1], sy, sx)
                 for d, (sy, sx) in zip(datas, samps))


def _build_problem(datas, quants, samps, weight, pweights, iterations,
                   simd_compat_logging, device) -> _Problem:
    geoms = _geometry(datas, samps)
    H, W = canvas_shape(geoms)
    for g in geoms:
        if H % (8 * g.h_samp) or W % (8 * g.w_samp):
            raise ValueError(
                f"canvas {H}x{W} is not whole 8x8 coefficient blocks at "
                f"sampling ({g.h_samp}, {g.w_samp})")
    radius = math.sqrt(float(H) * float(W)) / 2.0
    p_alphas, total_alpha = objective_alphas(weight, pweights, len(geoms))
    dqs, inv_qs, los, his, dqs_c, iqs_c, f0 = [], [], [], [], [], [], []
    dats_c, qs_c = [], []
    for d, q, g in zip(datas, quants, geoms):
        # coefficient (u,v) of block (by,bx) lives at (8by+u, 8bx+v)
        # numpy arrays, or tensors already on the device (utils/timing.py
        # uploads once for its timed solves)
        q_r = torch.as_tensor(q, dtype=torch.float32, device=device)
        q_r = q_r.tile(g.nby, g.nbx)
        data_i16 = deblockify(torch.as_tensor(d, device=device))
        data_r = data_i16.to(torch.float32)
        dq = data_r * q_r
        iq = 1.0 / q_r
        dqs.append(dq)
        inv_qs.append(iq)
        # initial iterate: plain decode, nearest-upsampled to the canvas
        # with edge clamping (compute.c:296-302)
        f0.append(upsample_nearest_clamped(
            idct_raster(dq), g.h_samp, g.w_samp, H, W))
        lo, hi = dq - 0.5 * q_r, dq + 0.5 * q_r
        pad = (0, W // g.w_samp - g.pw, 0, H // g.h_samp - g.ph)
        if pad[1] or pad[3]:
            # region gap: unconstrained boxes, no prob term
            lo = torch.nn.functional.pad(lo, pad, value=-GAP_BOX)
            hi = torch.nn.functional.pad(hi, pad, value=GAP_BOX)
            dq = torch.nn.functional.pad(dq, pad)
            iq = torch.nn.functional.pad(iq, pad)
            data_i16 = torch.nn.functional.pad(data_i16, pad)
            q_r = torch.nn.functional.pad(q_r, pad, value=FREE_Q)
        dats_c.append(data_i16.contiguous())
        qs_c.append(q_r.contiguous())
        los.append(lo)
        his.append(hi)
        dqs_c.append(dq)
        iqs_c.append(iq)
    return _Problem(
        geoms=geoms, H=H, W=W, weight=float(weight),
        step_size=radius / math.sqrt(1.0 + iterations),
        p_alphas=p_alphas, total_alpha=total_alpha,
        simd_compat_logging=bool(simd_compat_logging),
        dqs=dqs, inv_qs=inv_qs, los=los, his=his, dqs_c=dqs_c, iqs_c=iqs_c,
        dats_c=dats_c, qs_c=qs_c, f0=torch.stack(f0))


def _initial_carry(prob: _Problem, tier: str):
    """The carry at iteration 0: the prob term is zero because the saved
    coefficients start at data*quant (compute.c:279-286).

    "two":  (fdatas, fistas, pgrads [P, H, W], prob_dist, t);
    "mega": (fdatas, fistas, devqs tuple of [H/sy, W/sx] per prob
            channel, prob_dist, t) — the JAX mega carry (solver.py:563-570);
    "two-lite", "mega-lite": (fdatas f32, ds = fdatas - fistas bf16,
            devqs tuple bf16, prob_dist, t) — the JAX two-lite carry
            (solver.py:478-480), one format for both lite tiers.
    """
    fmt = _CARRY_FORMAT[tier]
    side = torch.bfloat16 if fmt == "lite" else torch.float32
    if fmt != "two":
        devqs = tuple(torch.zeros_like(q, dtype=side) for q, pa in
                      zip(prob.qs_c, prob.p_alphas) if pa != 0.0)
        fista = (torch.zeros_like(prob.f0, dtype=side) if fmt == "lite"
                 else prob.f0)
        return (prob.f0, fista, devqs, 0.0, 1.0)
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


def _metrics(prob: _Problem, rows, prob_dist):
    """Metric rows from per-iteration [sumsq C, tv, tv2, dists C] rows
    (the two-kernel tiers' layout), fetched once -> (metrics, the final
    prob_dist)."""
    partials = torch.stack(rows).cpu().numpy()
    C = len(prob.geoms)
    cols = list(range(C + 2)) + [C + 2 + c for c in range(C)
                                 if prob.p_alphas[c] != 0.0]
    metrics, dist_final = mega_metrics(
        partials[:, cols], prob_dist, prob.p_alphas, prob.total_alpha,
        prob.simd_compat_logging)
    return metrics, float(dist_final)


def _run(prob: _Problem, carry, nsteps: int, tier: str):
    """nsteps iterations of `tier` from `carry` (that tier's format) ->
    (carry, metrics [nsteps, 4])."""
    if tier in ("mega", "mega-lite"):
        return _run_mega(prob, carry, nsteps, tier == "mega-lite")
    if tier == "two-lite":
        return _run_two_lite(prob, carry, nsteps)
    fdatas, fistas, pgrads, prob_dist, t = carry
    factors, t_final = iter_step.fista_factors(t, nsteps)
    prob_mask = [pa != 0.0 for pa in prob.p_alphas]
    samps, pa_sss = prob.samps, prob.pa_sss
    dqs = [d if m else None for d, m in zip(prob.dqs_c, prob_mask)]
    iqs = [q if m else None for q, m in zip(prob.iqs_c, prob_mask)]
    rows = []
    for i in range(nsteps):
        it = iter(pgrads)
        pg_in = [next(it) if m else None for m in prob_mask]
        grads, extraps, sumsq, tv, tv2 = fused_grad(
            fdatas, fistas, pg_in, float(factors[i]), prob.weight,
            h_true=prob.H, w_true=prob.W)
        norms = torch.sqrt(sumsq)
        scale = torch.where(norms == 0.0, 0.0, prob.step_size / norms)
        fnews, pgs, dists = fused_project_multi(
            extraps, grads, scale, prob.los, prob.his, dqs, iqs, pa_sss,
            samps)
        rows.append(torch.cat([sumsq, tv.reshape(1), tv2.reshape(1), dists]))
        pg_list = [p for p in pgs if p is not None]
        fistas, fdatas = fdatas, fnews
        pgrads = stack_channels(pg_list) if pg_list else pgrads
        _build.check_finite("two tier", (fdatas, pgrads), i)
    if not rows:
        return carry, np.zeros((0, 4), np.float32)
    # the chunk's one device -> host fetch
    metrics, dist_final = _metrics(prob, rows, prob_dist)
    return (fdatas, fistas, pgrads, dist_final, t_final), metrics


def _run_two_lite(prob: _Problem, carry, nsteps: int):
    """The two-lite tier: K4 on the whole canvas as one band (row0 0, no
    halos, the canvas its own true extent), then K5, per iteration."""
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
            prob.pa_sss, prob.H, prob.H, prob.W)
        norms = torch.sqrt(sumsq)
        scale = torch.where(norms == 0.0, 0.0, prob.step_size / norms)
        fdatas, ds, dq_out, dists = fused_project_multi_lite(
            fdatas, ds, grads, factor, scale, prob.dats_c, prob.qs_c,
            prob.pa_sss, prob.samps)
        devqs = [d for d in dq_out if d is not None]
        rows.append(torch.cat([sumsq, tv.reshape(1), tv2.reshape(1), dists]))
        _build.check_finite("two-lite tier", (fdatas, ds, devqs), i)
    metrics, dist_final = _metrics(prob, rows, prob_dist)
    return (fdatas, ds, tuple(devqs), dist_final, t_final), metrics


def _run_mega(prob: _Problem, carry, nsteps: int, lite: bool):
    """The mega tiers: all nsteps iterations in one K3 launch (lite: on
    the lite carry, K3's lite mode)."""
    fdatas, side, devqs, prob_dist, t = carry
    if nsteps == 0:
        return carry, np.zeros((0, 4), np.float32)
    factors, t_final = iter_step.fista_factors(t, nsteps)
    solve = fused_solve_lite if lite else fused_solve
    fdatas, side, devqs, partials = solve(
        fdatas, side, list(devqs), factors, prob.step_size, prob.dats_c,
        prob.qs_c, prob.pa_sss, prob.samps, prob.weight)
    _build.check_finite("mega tier", (fdatas, side, devqs), nsteps - 1)
    # the chunk's one device -> host fetch
    metrics, dist_final = mega_metrics(
        partials.cpu().numpy(), prob_dist, prob.p_alphas, prob.total_alpha,
        prob.simd_compat_logging)
    return (fdatas, side, tuple(devqs), float(dist_final),
            t_final), metrics


def _resolve_tier(prob: _Problem, tier, pweights) -> str:
    if tier is None:
        return active_tier(prob.geoms, pweights)
    if tier not in TIERS:
        raise ValueError(f"unknown solver tier {tier!r} (one of {TIERS})")
    C = len(prob.geoms)
    ok = {"mega": iter_step.supports(C, prob.H, prob.W, prob.samps,
                                     sum(1 for p in pweights if p != 0.0)),
          "two-lite": stripe_grad.supports(C, prob.H, prob.W, prob.samps)}
    ok["mega-lite"] = ok["mega"]
    if not ok.get(tier, True):
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
    """
    device = resolve_device(device)
    prob = _build_problem(datas, quants, samps, weight, pweights,
                          iterations, simd_compat_logging, device)
    tier = _resolve_tier(prob, tier, pweights)
    if carry is None:
        carry = _initial_carry(prob, tier)
    elif _carry_format(carry) != _CARRY_FORMAT[tier]:
        raise ValueError(f"a {_carry_format(carry)!r}-format carry cannot "
                         f"resume a {tier!r}-tier solve")
    carry, metrics = _run(prob, carry, iterations if nsteps is None
                          else nsteps, tier)
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


def solve_joint_chunked(
    datas, quants, samps, weight, pweights, iterations,
    on_chunk=None, chunk: int | None = None,
    simd_compat_logging: bool = True, device="cuda", tier=None,
):
    """solve_joint split into host-visible chunks.

    The reference ticks its progress bar and CSV log every iteration
    (compute.c:449-452, logger.c:20); here the loop runs as a sequence
    of resumable chunks of the same iterations — identical to one
    uninterrupted solve (the step size keys on the TOTAL iteration count
    and the carry resumes exactly).  After each chunk,
    `on_chunk(done_iterations, metrics_chunk)` fires on the host.
    """
    device = resolve_device(device)
    if chunk is None:
        chunk = max(8, min(50, iterations // 20 or iterations))
    prob = _build_problem(datas, quants, samps, weight, pweights,
                          iterations, simd_compat_logging, device)
    tier = _resolve_tier(prob, tier, pweights)
    carry = _initial_carry(prob, tier)
    all_metrics = []
    done = 0
    while done < iterations:
        n = min(chunk, iterations - done)
        carry, metrics = _run(prob, carry, n, tier)
        done += n
        all_metrics.append(metrics)
        if on_chunk is not None:
            on_chunk(done, metrics)
    metrics = (np.concatenate(all_metrics) if all_metrics
               else np.zeros((0, 4), np.float32))
    return carry[0], metrics


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
