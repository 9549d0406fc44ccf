"""Row-striped solver: one image's rows in bands over a mesh.

The counterpart of jpeg2png_tpu/parallel/stripes.py, the path for giant
images (the fifth published configuration: a 100 MP image striped over
N >= 2 devices with halo collectives); solve_striped_batched solves
several images of one geometry at once, each over its own group of bands.
Each band holds L consecutive rows of every channel; per iteration every
band takes part in exactly THREE collectives (parallel/mesh.py,
parallel/distributed.py):

  * two halo exchanges, one stacked payload per direction: every channel's
    2 boundary rows of the iterate and of its FISTA companion (the lite
    body: of f and of the bf16 difference d), zeros at the canvas edges;
  * one [C + 3] all-reduce of the per-channel gradient sums of squares
    (the step normalization is global over the image, compute.c:200-216),
    tv, tv2 and the PREVIOUS iteration's prob distance: the prob term reads
    the previous projection (compute.c:381), so its sum rides the next
    iteration's vector, and the carry holds each band's local distance.

Between them each band runs two kernels:

  * f32 body (the default): K7 kernels/stripe_grad.py::fused_grad_striped
    (the band gradient from the halo rows, masks keyed on the global row),
    then the projection, K2 kernels/project_step.py::fused_project_multi
    for C >= 2 or K6 ::fused_project for one channel (-s with
    --tpu-stripes, grayscale);
  * lite body (`body="lite"`, or the two-lite tier's gate): K4
    ::fused_grad_striped_lite and K5 ::fused_project_multi_lite on the
    two-lite tier's bf16 state.

Any geometry of whole 8x8 blocks stripes: the canvas is padded at the
bottom to n bands of L rows, L a multiple of 8 * lcm(h_samp), so no 8x8
block or subsampling footprint straddles two bands.  The coefficient
rasters carry three zones (models/solver.py): real boxes, unconstrained
+-2^39 boxes over region gaps, and lo = hi = 0 (lite: q = 0) over the
canvas padding, which stays frozen at exactly 0; the gradient kernels zero
everything outside the true canvas.  The width is not padded: the port's
kernels take any width of whole blocks.  The step size keys on the true
H x W (compute.c:425).

Nothing in the iteration loop waits for the device: the FISTA factors are
host floats, the step scales are computed on the device from the
all-reduced vector, and the per-iteration vectors are fetched once per
chunk to make the metric rows.
"""

from __future__ import annotations

import concurrent.futures
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg2png_tpu_torch import on_device, resolve_device
from jpeg2png_tpu_torch.kernels import _build, iter_step, stripe_grad
from jpeg2png_tpu_torch.kernels.grad_step import (
    HALO_ROWS, MAX_CHANNELS, stack_channels)
from jpeg2png_tpu_torch.kernels.project_step import (
    fused_project, fused_project_multi, fused_project_multi_lite)
from jpeg2png_tpu_torch.kernels.stripe_grad import (
    fused_grad_striped, fused_grad_striped_lite)
from jpeg2png_tpu_torch.models import solver
from jpeg2png_tpu_torch.models.solver import ChannelGeometry, canvas_shape

BODIES = ("f32", "lite")


def _lcm(vals) -> int:
    out = 1
    for v in vals:
        out = math.lcm(out, int(v))
    return out


def padded_striped_shape(
    geoms: Tuple[ChannelGeometry, ...], n: int,
) -> Tuple[int, int, int, int, int]:
    """(H, W, H2, W2, L): the true canvas, the striped canvas and the band
    height.  H2 = n * L with L a multiple of 8 * lcm(h_samp), so every
    channel's 8x8 block rows and footprints stay inside one band; W2 = W
    (the TPU's 128-lane width padding is not needed here)."""
    H, W = canvas_shape(geoms)
    unit = 8 * _lcm(g.h_samp for g in geoms)
    H2 = -(-H // (n * unit)) * (n * unit)
    return H, W, H2, W, H2 // n


def stripes_supported(geoms: Tuple[ChannelGeometry, ...], n: int) -> bool:
    """Whether this geometry stripes over n bands: a canvas of whole 8x8
    blocks of every channel (the solver's own rule) and 1..4 channels."""
    H, W = canvas_shape(geoms)
    return (n >= 1 and 1 <= len(geoms) <= MAX_CHANNELS
            and all(H % (8 * g.h_samp) == 0 and W % (8 * g.w_samp) == 0
                    for g in geoms))


def striped_carry_kind(geoms: Tuple[ChannelGeometry, ...], n: int) -> str:
    """The body, and so the carry format, a striped solve of this geometry
    takes: "lite" where the two-lite tier's gate takes the canvas
    (solver.TWO_LITE_MAX_PIXELS, closed after the card's tier sweep) and
    K4 takes the band, else "f32"."""
    H, W, _, _, L = padded_striped_shape(geoms, n)
    samps = [(g.h_samp, g.w_samp) for g in geoms]
    if (H * W <= solver.TWO_LITE_MAX_PIXELS
            and stripe_grad.supports(len(geoms), L, W, samps)):
        return "lite"
    return "f32"


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x with zero rows appended along dim -2 up to `rows` (x itself when
    it has them already)."""
    extra = rows - x.shape[-2]
    return x if extra == 0 else torch.nn.functional.pad(x, (0, 0, 0, extra))


def _padded_consts(prob, H2: int):
    """Per channel (lo, hi, dq, iq) at the striped canvas's coefficient
    resolution: the problem's real boxes and region-gap boxes, then
    lo = hi = dq = iq = 0 over the canvas padding (frozen at 0)."""
    return [[_pad_rows(x[c], H2 // g.h_samp)
             for c, g in enumerate(prob.geoms)]
            for x in (prob.los, prob.his, prob.dqs_c, prob.iqs_c)]


def _padded_consts_lite(prob, H2: int):
    """Per channel (int16 coefficients, f32 quant) at the striped canvas's
    coefficient resolution: q real in the image, FREE over region gaps,
    q = 0 (frozen) over the canvas padding."""
    return [[_pad_rows(x[c], H2 // g.h_samp)
             for c, g in enumerate(prob.geoms)]
            for x in (prob.dats_c, prob.qs_c)]


class _Striped:
    """One striped problem on this process's bands: the band constants
    and the iteration bodies."""

    def __init__(self, datas, quants, samps, weight, pweights, iterations,
                 simd_compat_logging, mesh, body):
        for d in mesh.devices:
            resolve_device(d)             # a CUDA band without a card raises
        geoms = solver._geometry(datas, samps)
        n = mesh.n
        if not stripes_supported(geoms, n):
            raise ValueError(
                f"geometry {geoms} cannot be striped over {n} bands")
        H, W, H2, _, L = padded_striped_shape(geoms, n)
        C = len(geoms)
        self.samps = [(g.h_samp, g.w_samp) for g in geoms]
        if body is None:
            body = striped_carry_kind(geoms, n)
        if body not in BODIES:
            raise ValueError(f"unknown striped body {body!r} (one of {BODIES})")
        if body == "lite" and not stripe_grad.supports(C, L, W, self.samps):
            raise ValueError(f"the lite body does not take bands {L}x{W} at "
                             f"samps={self.samps}")
        prob = solver._build_problem(datas, quants, samps, weight, pweights,
                                     iterations, simd_compat_logging,
                                     mesh.devices[0])
        self.body, self.comm = body, mesh.comm
        self.C, self.H, self.W, self.H2, self.L = C, H, W, H2, L
        self.weight, self.step = prob.weight, prob.step_size
        self.total_alpha, self.pa_sss = prob.total_alpha, prob.pa_sss
        self.prob_on = [pa != 0.0 for pa in prob.p_alphas]
        self.devices = mesh.devices
        self.row0s = [(mesh.first + i) * L for i in range(len(mesh.devices))]

        def band(x, i, sy=1):
            r0 = self.row0s[i] // sy
            return x[..., r0:r0 + L // sy, :].to(self.devices[i]).contiguous()

        consts = (_padded_consts(prob, H2) if body == "f32"
                  else _padded_consts_lite(prob, H2))
        # per band, per kind, per channel: band rows of the constants
        self.consts = [[[band(x, i, g.h_samp) for x, g in zip(kind, geoms)]
                        for kind in consts]
                       for i in range(len(self.devices))]
        f0 = _pad_rows(prob.f0, H2)
        self.f0 = [band(f0, i) for i in range(len(self.devices))]
        # the distance each band adds to the all-reduced vector: the raw
        # distance (the reference SIMD build's log) or p_alpha times it
        w = [(1.0 if simd_compat_logging else pa) if on else 0.0
             for pa, on in zip(prob.p_alphas, self.prob_on)]
        self.dist_w = [torch.tensor(w, device=d) for d in self.devices]

    def initial_carry(self):
        """(f, side, prob state, local distances, t) per band: side is
        fista (f32 body) or d = f - fista in bf16 (lite); the prob state is
        the [P, L, W] pixel gradient (f32) or the bf16 devq rasters (lite);
        all start at zero (compute.c:279-286)."""
        pds = [torch.zeros((1,), device=d) for d in self.devices]
        if self.body == "f32":
            P = sum(self.prob_on)
            pg = [torch.zeros((P, self.L, self.W), device=d)
                  for d in self.devices]
            return (self.f0, self.f0, pg, pds, 1.0)
        ds = [torch.zeros_like(f, dtype=torch.bfloat16) for f in self.f0]
        dq = [tuple(torch.zeros_like(q, dtype=torch.bfloat16)
                    for q, on in zip(qs, self.prob_on) if on)
              for _, qs in self.consts]
        return (self.f0, ds, dq, pds, 1.0)

    def _exchange(self, fs, sides):
        """The two halo exchanges: every channel's HALO_ROWS boundary rows
        of f and of the side state (as f32), one payload per direction.
        Returns per band (rows above, rows below), each [2C, HALO_ROWS, W]."""
        def payload(f, s, rows):
            return torch.cat([f[:, rows], s[:, rows].to(torch.float32)])
        above = self.comm.shift_down(
            [payload(f, s, slice(-HALO_ROWS, None)) for f, s in zip(fs, sides)])
        below = self.comm.shift_up(
            [payload(f, s, slice(0, HALO_ROWS)) for f, s in zip(fs, sides)])
        return above, below

    def _scale(self, total):
        norms = torch.sqrt(total[:self.C])
        return torch.where(norms == 0.0, 0.0, self.step / norms)

    def run(self, carry, nsteps: int):
        """nsteps iterations from `carry` -> (carry, metrics [nsteps, 4])."""
        if nsteps == 0:
            return carry, np.zeros((0, 4), np.float32)
        fs, sides, probs, pds, t = carry
        factors, t_final = iter_step.fista_factors(t, nsteps)
        nb, rows = len(self.devices), []
        for i in range(nsteps):
            factor = float(factors[i])
            above, below = self._exchange(fs, sides)
            grads = []
            for b in range(nb):
                with on_device(self.devices[b]):
                    grads.append(self._gradient(b, fs[b], sides[b], probs[b],
                                                above[b], below[b], factor))
            totals = self.comm.all_reduce(
                [torch.cat([s, tv.reshape(1), tv2.reshape(1), pd])
                 for (_, s, tv, tv2), pd in zip(grads, pds)])
            rows.append(totals[0])
            out = []
            for b in range(nb):
                with on_device(self.devices[b]):
                    out.append(self._project(b, fs[b], sides[b], grads[b][0],
                                             factor, self._scale(totals[b])))
            fs, sides, probs, dists = (list(x) for x in zip(*out))
            pds = [(d * w).sum().reshape(1)
                   for d, w in zip(dists, self.dist_w)]
            _build.check_finite("striped solve",
                                (fs, sides, probs, pds, totals, above, below),
                                i)
        # the chunk's one device -> host fetch
        parts = torch.stack(rows).cpu().numpy()
        C = self.C
        tv, tv2, pd = parts[:, C], parts[:, C + 1], parts[:, C + 2]
        objective = (tv + tv2 + pd) / np.float32(self.total_alpha)
        metrics = np.stack([objective, pd, tv, tv2], axis=1)
        return (fs, sides, probs, pds, t_final), metrics

    def _gradient(self, b, f, side, prob, above, below, factor):
        """Band b's gradient from its halo rows -> (the gradient state the
        projection takes, sumsq [C], tv, tv2)."""
        C = self.C
        if self.body == "lite":
            halos = (above[:C], below[:C], above[C:].to(torch.bfloat16),
                     below[C:].to(torch.bfloat16))
            g, sumsq, tv, tv2 = fused_grad_striped_lite(
                f, side, list(prob), halos, factor, self.row0s[b],
                self.weight, self.samps, self.pa_sss, self.H2, self.H,
                self.W)
            return g, sumsq, tv, tv2
        it = iter(prob)
        pg_in = [next(it) if on else None for on in self.prob_on]
        g, e, sumsq, tv, tv2 = fused_grad_striped(
            f, side, pg_in, (above[:C], below[:C], above[C:], below[C:]),
            factor, self.row0s[b], self.weight, self.H, self.W)
        return (g, e), sumsq, tv, tv2

    def _project(self, b, f, side, g, factor, scale):
        """Band b's projection -> (fnew, new side state, new prob state,
        dists [C]): the side state is fista = f (f32 body) or dnew = fnew -
        f in bf16 (lite)."""
        if self.body == "lite":
            dats, qs = self.consts[b]
            fnew, dnew, devqs, dists = fused_project_multi_lite(
                f, side, g, factor, scale, dats, qs, self.pa_sss, self.samps)
            return fnew, dnew, tuple(d for d in devqs if d is not None), dists
        grads, extraps = g
        los, his, dqs, iqs = self.consts[b]
        dqs = [d if on else None for d, on in zip(dqs, self.prob_on)]
        iqs = [d if on else None for d, on in zip(iqs, self.prob_on)]
        if self.C == 1:
            (sy, sx), = self.samps
            fnew, pg, dist = fused_project(
                extraps[0], grads[0], scale, los[0], his[0], dqs[0], iqs[0],
                self.pa_sss[0], sy, sx)
            pgs = (pg[None] if pg is not None
                   else torch.zeros((0,) + fnew.shape, device=fnew.device))
            return fnew[None], f, pgs, dist.reshape(1)
        fnew, pg_list, dists = fused_project_multi(
            extraps, grads, scale, los, his, dqs, iqs, self.pa_sss,
            self.samps)
        pg = [p for p in pg_list if p is not None]
        pgs = (stack_channels(pg) if pg
               else torch.zeros((0,) + fnew.shape[1:], device=fnew.device))
        return fnew, f, pgs, dists

    def output(self, fs) -> torch.Tensor:
        """This process's rows of the true canvas, [C, rows, W] on its
        first band's device (all of [C, H, W] in a single process)."""
        dev = self.devices[0]
        rows = max(0, min(len(fs) * self.L, self.H - self.row0s[0]))
        return torch.cat([f.to(dev) for f in fs], dim=1)[:, :rows]


def striped_steps(
    datas: Sequence[np.ndarray],
    quants: Sequence[np.ndarray],
    samps: Sequence[Tuple[int, int]],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    mesh,
    carry=None,
    nsteps: Optional[int] = None,
    simd_compat_logging: bool = True,
    body: Optional[str] = None,
    on_chunk=None,
    chunk: Optional[int] = None,
):
    """The striped twin of models/solver.py::solve_steps: `nsteps`
    (default `iterations`) iterations from `carry` (None: the plain
    decode), this process's bands of a carry of the same body.
    `iterations` is the TOTAL planned count (it fixes the step size).

    on_chunk(done_iterations, metrics_chunk), when given, runs the steps
    as chunks of `chunk` iterations (default 8-50), called on every
    process after each one: the carry, local distances included, resumes
    exactly, so the result equals the one-shot run's.

    Returns (fdata, metrics [nsteps, 4] numpy, carry): fdata is this
    process's rows of the [C, H, W] canvas (all of it in a single
    process), the carry this process's bands."""
    problem = _Striped(datas, quants, samps, weight, pweights, iterations,
                       simd_compat_logging, mesh, body)
    nsteps = iterations if nsteps is None else nsteps
    if on_chunk is None:
        chunk = nsteps
    elif chunk is None:
        chunk = max(8, min(50, nsteps // 20 or nsteps))
    if carry is None:
        carry = problem.initial_carry()
    elif isinstance(carry[2][0], tuple) != (problem.body == "lite"):
        raise ValueError(f"the carry is not the {problem.body} body's")
    done = 0
    all_metrics = [np.zeros((0, 4), np.float32)]
    while done < nsteps:
        nn = min(chunk, nsteps - done)
        carry, metrics = problem.run(carry, nn)
        done += nn
        all_metrics.append(metrics)
        if on_chunk is not None:
            on_chunk(done, metrics)
    return problem.output(carry[0]), np.concatenate(all_metrics), carry


def solve_striped(
    datas: Sequence[np.ndarray],
    quants: Sequence[np.ndarray],
    samps: Sequence[Tuple[int, int]],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    mesh,
    simd_compat_logging: bool = True,
    body: Optional[str] = None,
    on_chunk=None,
    chunk: Optional[int] = None,
):
    """Striped solve over `mesh` (parallel/mesh.py::stripe_mesh).  The
    contract of models/solver.py::solve_joint.

    body: None (striped_carry_kind: the f32 body under the committed
    gates) or one of BODIES, forced.  on_chunk and chunk as for
    striped_steps.

    Returns (fdata, metrics [iterations, 4] numpy): fdata is this
    process's rows of the [C, H, W] canvas, all of it in a single process
    (distributed.gather_output collects them across processes)."""
    fdata, metrics, _ = striped_steps(
        datas, quants, samps, weight, pweights, iterations, mesh,
        simd_compat_logging=simd_compat_logging, body=body,
        on_chunk=on_chunk, chunk=chunk)
    return fdata, metrics


def solve_striped_batched(
    datas: Sequence[Sequence[np.ndarray]],   # [B][C]
    quants: Sequence[Sequence[np.ndarray]],  # [B][C]
    samps: Sequence[Tuple[int, int]],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    mesh,
    simd_compat_logging: bool = True,
    body: Optional[str] = None,
):
    """B images of one geometry, image b striped over mesh[b]
    (mesh.batch_stripe_mesh: B groups of bands), the groups solved at once
    on one host thread each.  Each image's result is the one solve_striped
    gives on its group alone, bit for bit.  body as for solve_striped.

    Returns (fdata [B, C, H, W] on the first group's first device,
    metrics [B, iterations, 4] numpy)."""
    if len(datas) != len(mesh) or len(quants) != len(datas):
        raise ValueError(f"batch size {len(datas)} != mesh batch size "
                         f"{len(mesh)}")
    geoms = [solver._geometry(d, samps) for d in datas]
    if any(g != geoms[0] for g in geoms):
        raise ValueError(f"images of different geometries {geoms}")

    def one(b):
        return solve_striped(datas[b], quants[b], samps, weight, pweights,
                             iterations, mesh[b], simd_compat_logging, body)

    with concurrent.futures.ThreadPoolExecutor(
            len(mesh), thread_name_prefix="j2p-stripe-group") as pool:
        futures = [pool.submit(one, b) for b in range(len(mesh))]
        results = [f.result() for f in futures]
    dev = mesh[0].devices[0]
    return (torch.stack([fd.to(dev) for fd, _ in results]),
            np.stack([m for _, m in results]))
