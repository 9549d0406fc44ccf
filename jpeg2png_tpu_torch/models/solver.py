"""FISTA-accelerated projected subgradient solver.

The iterate loop of the reference (compute.c:406-465) as a host loop of
two fused kernels per iteration — the two-kernel body of the JAX
package (jpeg2png_tpu/models/solver.py:365-468):

  K1 kernels/grad_step.py::fused_grad            FISTA extrapolation,
     TV + TGV2 gather stencils, prob gradient, partial sums;
  K2 kernels/project_step.py::fused_project_multi  normalized step, box
     projection in the sampled DCT domain, next prob gradient, distance.

On CUDA every geometry takes this body; on the CPU the same body runs
the kernels' plain PyTorch versions.  The canvas is exactly
canvas_shape (no lane padding).  Channels whose region is smaller than
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
from jpeg2png_tpu_torch.kernels.grad_step import fused_grad, stack_channels
from jpeg2png_tpu_torch.kernels.project_step import (
    GAP_BOX, fused_project_multi)
from jpeg2png_tpu_torch.ops.blocks import deblockify
from jpeg2png_tpu_torch.ops.dct_raster import idct_raster
from jpeg2png_tpu_torch.ops.prob import prob_term_raster
from jpeg2png_tpu_torch.ops.resample import upsample_nearest_clamped


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


def _fista_factors_np(nsteps: int, t: float = 1.0) -> Tuple[np.ndarray, float]:
    """Host-side FISTA factor sequence from t (compute.c:427-440)."""
    out = np.empty((nsteps,), np.float32)
    for i in range(nsteps):
        tnext = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        out[i] = (t - 1.0) / tnext
        t = tnext
    return out, t


def canvas_shape(geoms: Sequence[ChannelGeometry]) -> Tuple[int, int]:
    """Full-res canvas = max over channels (compute.c:410-418)."""
    return (max(g.region_h for g in geoms), max(g.region_w for g in geoms))


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
    for d, q, g in zip(datas, quants, geoms):
        # coefficient (u,v) of block (by,bx) lives at (8by+u, 8bx+v)
        q_r = torch.as_tensor(np.asarray(q, np.float32), device=device)
        q_r = q_r.tile(g.nby, g.nbx)
        data_r = deblockify(torch.as_tensor(np.asarray(d), device=device)
                            .to(torch.float32))
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
        f0=torch.stack(f0))


def _initial_carry(prob: _Problem):
    """(fdatas, fistas, pgrads [P, H, W], prob_dist, t) at iteration 0:
    the prob gradient is zero because the saved coefficients start at
    data*quant (compute.c:279-286)."""
    n_prob = sum(1 for pa in prob.p_alphas if pa != 0.0)
    pg0 = torch.zeros((n_prob, prob.H, prob.W), device=prob.f0.device)
    return (prob.f0, prob.f0, pg0, 0.0, 1.0)


def _run(prob: _Problem, carry, nsteps: int):
    """nsteps iterations from `carry` -> (carry, metrics [nsteps, 4])."""
    fdatas, fistas, pgrads, prob_dist, t = carry
    factors, t_final = _fista_factors_np(nsteps, t)
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
    if not rows:
        return carry, np.zeros((0, 4), np.float32)
    # the chunk's one device -> host fetch
    partials = torch.stack(rows).cpu().numpy()
    C = len(prob.geoms)
    cols = list(range(C + 2)) + [C + 2 + c for c in range(C) if prob_mask[c]]
    metrics, dist_final = mega_metrics(
        partials[:, cols], prob_dist, prob.p_alphas, prob.total_alpha,
        prob.simd_compat_logging)
    return (fdatas, fistas, pgrads, float(dist_final), t_final), metrics


def carry_from_numpy(carry, datas, quants, samps, weight, pweights,
                     simd_compat_logging: bool = True, device="cuda"):
    """The JAX package's XLA-tier carry -> this solver's carry.

    carry: (fdata [C,H,W], fista [C,H,W], cos tuple of per-channel
    clamped coefficient rasters, t) as numpy arrays, from
    jpeg2png_tpu.models.solver._build_solver_impl(..., use_pallas=False).
    Returns (fdatas, fistas, pgrads [P, H, W], prob_dist, t): the prob
    gradient and distance come from `cos` through this package's prob
    term, which is what the JAX body computes at its next step
    (jpeg2png_tpu/models/solver.py:263).  `weight` is accepted for
    signature parity; the carry does not depend on it.
    """
    del weight
    device = resolve_device(device)
    fdata, fista, cos, t = carry
    prob = _build_problem(datas, quants, samps, 0.0, pweights, 0,
                          simd_compat_logging, device)
    dist = torch.zeros((), device=device)
    pgrads = []
    for c, g in enumerate(prob.geoms):
        pa = prob.p_alphas[c]
        if pa == 0.0:
            continue
        d, region = prob_term_raster(
            torch.as_tensor(np.array(cos[c], np.float32), device=device),
            prob.dqs[c], prob.inv_qs[c], pa, g.h_samp, g.w_samp,
            include_alpha_in_dist=not simd_compat_logging)
        dist = dist + d
        pgrads.append(torch.nn.functional.pad(
            region, (0, prob.W - g.region_w, 0, prob.H - g.region_h)))
    pg = (torch.stack(pgrads) if pgrads
          else torch.zeros((0, prob.H, prob.W), device=device))
    return (torch.as_tensor(np.array(fdata, np.float32), device=device),
            torch.as_tensor(np.array(fista, np.float32), device=device),
            pg, float(dist), float(t))


def solve_steps(datas, quants, samps, weight, pweights, iterations,
                carry=None, nsteps=None, simd_compat_logging: bool = True,
                device="cuda"):
    """The resumable primitive: `nsteps` (default `iterations`)
    iterations from `carry` (None: the plain decode).  `iterations` is
    the TOTAL planned count and fixes the step size
    radius/sqrt(1+iterations) (compute.c:443) however the run is split.

    Returns (fdata [C, H, W] tensor, metrics [nsteps, 4] numpy, carry).
    """
    device = resolve_device(device)
    prob = _build_problem(datas, quants, samps, weight, pweights,
                          iterations, simd_compat_logging, device)
    if carry is None:
        carry = _initial_carry(prob)
    carry, metrics = _run(prob, carry, iterations if nsteps is None
                          else nsteps)
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
):
    """Joint multi-channel solve (the default mode, jpeg2png.c:142-144).

    Args:
        datas: per channel int16 [nby, nbx, 8, 8] DCT coefficients.
        quants: per channel [8, 8] quantization tables.
        samps: per channel (h_samp, w_samp) replication factors.
        device: "cuda" (default; raises RuntimeError without a card) or
            "cpu" for the plain PyTorch versions of the kernels.
    Returns:
        (fdata [C, H, W] tensor on `device`, metrics [iterations, 4]
        numpy) where metrics columns are (objective, prob_dist, tv, tv2)
        per iteration — exactly the reference CSV columns (logger.c:13).
    """
    fdata, metrics, _ = solve_steps(
        datas, quants, samps, weight, pweights, iterations,
        simd_compat_logging=simd_compat_logging, device=device)
    return fdata, metrics


def solve_joint_chunked(
    datas, quants, samps, weight, pweights, iterations,
    on_chunk=None, chunk: int | None = None,
    simd_compat_logging: bool = True, device="cuda",
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
    carry = _initial_carry(prob)
    all_metrics = []
    done = 0
    while done < iterations:
        n = min(chunk, iterations - done)
        carry, metrics = _run(prob, carry, n)
        done += n
        all_metrics.append(metrics)
        if on_chunk is not None:
            on_chunk(done, metrics)
    metrics = (np.concatenate(all_metrics) if all_metrics
               else np.zeros((0, 4), np.float32))
    return carry[0], metrics


def solve_separate(
    datas, quants, samps, weights, pweights, iterations_per_channel,
    simd_compat_logging: bool = True, device="cuda",
):
    """Per-channel independent solves (-s mode, jpeg2png.c:146-153).

    Each channel's canvas is that channel's own region, like the
    reference's per-channel compute() calls.
    Returns list of ([1, Hc, Wc] fdata, metrics) per channel.
    """
    return [
        solve_joint([datas[c]], [quants[c]], [samps[c]], weights[c],
                    [pweights[c]], iterations_per_channel[c],
                    simd_compat_logging, device)
        for c in range(len(datas))
    ]
