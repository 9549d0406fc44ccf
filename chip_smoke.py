#!/usr/bin/env python3
"""Proof that the PyTorch port runs its main paths on an NVIDIA GPU.

    python3 chip_smoke.py            # one CUDA card, from the repo root

Phases (each raises on failure; the traceback then ends the run with a
non-zero exit and no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from jpeg2png_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build seconds and ptxas report;
  3. TF32 off for the plain PyTorch versions;
  4. each kernel against its plain version on the card: K1 and K2 at the
     3072x2048 4:2:0 geometry and small odd ones (region gap, h_true < H,
     4:2:2, 4:4:0, 4:1:1, prob on and off); K3 on one real bucket chunk
     of 4 serving-corpus images (dynamic extents, 1 and 3 iterations), on
     the 3072x2048 canvas (static, 1 and 2 iterations) and on small odd
     geometries, each elementwise after one iteration, and on random data
     at the same shapes over 3 iterations, elementwise in every iteration
     row, with the bucket padding held at exactly 0;
  5. goldens: three fixtures through the port's cli.main at -i 50 must
     reach PSNR > 45 dB against the reference binary's PNGs, and the
     photo512 -i 5 CSV must agree with the reference on iterations 0-1,
     each through both solver tiers (mega: K3; two: K1 + K2);
  6. the single-image path: the default-flag CLI decode of a 3072x2048
     4:2:0 q30 JPEG (the tier active_tier picks) with the launch counters
     read around it, the same solve forced through the other tier, both
     timed with CUDA events, PSNR between the tiers and against the plain
     path; the per-iteration cost of both tiers at photo512, ~1 MP, ~3 MP
     and 3072x2048 (the numbers that set solver.MEGA_MAX_PIXELS); per-kernel
     times beside their bounds and the plain versions' times;
  7. serving: cli.main --tpu-batch on the 48-file corpus
     (tests/fixtures/torch_serving), 48 PNGs, the K3 and K1/K2 launch
     counts against the runner's bucket plan (buckets above the tier
     threshold go to the two-kernel tier), every PNG > 45 dB against
     the same file decoded alone on the two-kernel tier, and the serving
     numbers;
  8. a JSON line of end-to-end numbers, one JSON line of kernel records,
     then the device line last.

Imports nothing of JAX or of the JAX package jpeg2png_tpu.  Writes only
under jpeg2png_tpu_torch/_build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
OUT_DIR = ROOT / "jpeg2png_tpu_torch" / "_build" / "chip_smoke"
SMOKE_JPEG = FIXTURES / "torch_smoke_art3072x2048_q30_420.jpg"
SERVING = FIXTURES / "torch_serving"
N_SERVING = 48
# the ~1 MP and ~3 MP points of the tier sweep: 4:2:0 corpus images
MID_JPEGS = (SERVING / "img016_1280x960_q20_s2.jpg",
             SERVING / "img021_2048x1536_q75_s2.jpg")

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, f32 flop/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# operations per pixel and channel of K1 (extrapolation 3, differences
# 2, TV norm and gather 12, TGV2 differences, norm and 7-point gather
# 43) and per coefficient of K2 (three 8x8 transform pairs: 3 * 2 * 16
# flops) — counted from the kernels' formulas
K1_OPS_PER_CHANNEL_PIXEL = 60
K2_OPS_PER_COEF = 96 + 8

GOLDENS = ("photo512_q10_420", "photo600x400_q20_420", "art440x320_q30_422")
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------- helpers

def read_own_png(path: pathlib.Path):
    """Pixels of a PNG this package wrote (filter 0 on every row)."""
    import struct
    import zlib

    import numpy as np

    data = path.read_bytes()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    nchan = 3 if ctype == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    require((rows[:, 0] == 0).all(), f"{path}: unexpected PNG filter")
    pix = rows[:, 1:]
    if depth == 16:
        pix = pix.copy().view(">u2").astype(np.uint16)
    return pix.reshape(h, w, nchan) if nchan == 3 else pix.reshape(h, w)


def psnr(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = ((a - b) ** 2).mean()
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn()` over `reps` back-to-back launches:
    CUDA events between consecutive launches, one synchronise at the end.
    The host enqueues ahead of the device, so each interval is the
    device's time for one call (timing each call alone would add the
    wrapper's host latency to an idle device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    times = sorted(events[i].elapsed_time(events[i + 1])
                   for i in range(reps))
    return times[reps // 2]


def max_err(a, b) -> float:
    return float((a - b).abs().max())


# --------------------------------------------------------------- phases

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from jpeg2png_tpu_torch.kernels import _build

    seconds = _build.build()
    log(f"build: {seconds:.1f} s for {', '.join(_build.LIBRARIES)}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return seconds


def _k1_case(rng, C, H, W, weight, prob, h_true=None, w_true=None):
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.kernels import grad_step

    dev = DEVICE
    f = torch.as_tensor(rng.normal(0, 50, (C, H, W)).astype(np.float32),
                        device=dev)
    fi = torch.as_tensor(rng.normal(0, 50, (C, H, W)).astype(np.float32),
                         device=dev)
    P = sum(prob)
    pg = torch.as_tensor(rng.normal(0, 1, (P, H, W)).astype(np.float32),
                         device=dev)
    it = iter(pg)
    pgs = [next(it) if p else None for p in prob]
    args = (f, fi, pgs, 0.37, weight, h_true, w_true)
    got = grad_step.fused_grad(*args)
    ref = grad_step.fused_grad_plain(*args)
    torch.cuda.synchronize()
    # grids: 1e-5 of the data's magnitude (the kernel rounds op for op
    # like the plain version; only the norms' channel sums may associate
    # differently).  Sums: rtol 1e-5, because the summation order differs
    # (block tree + fixed-order second pass vs PyTorch's reduction).
    g_err = max_err(got[0], ref[0])
    g_tol = 1e-5 * max(1.0, float(ref[0].abs().max()))
    e_err = max_err(got[1], ref[1])
    e_tol = 1e-6 * float(ref[1].abs().max())
    require(g_err <= g_tol, f"K1 grad {C}x{H}x{W}: {g_err} > {g_tol}")
    require(e_err <= e_tol, f"K1 extrap {C}x{H}x{W}: {e_err} > {e_tol}")
    for name, a, b in (("sumsq", got[2], ref[2]), ("tv", got[3], ref[3]),
                       ("tv2", got[4], ref[4])):
        rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
        require(rel <= 1e-5 or float((a - b).abs().max()) == 0.0,
                f"K1 {name} {C}x{H}x{W}: rel err {rel} > 1e-5")
    log(f"  K1 {C}x{H}x{W} w={weight} prob={prob} true="
        f"{h_true or H}x{w_true or W}: grad err {g_err:.3g} (tol "
        f"{g_tol:.3g}), extrap err {e_err:.3g}, sums ok")
    return g_err


def _k2_case(rng, H, W, samps, prob, gap_rows=0):
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.kernels import project_step
    from jpeg2png_tpu_torch.ops.dct_raster import sampled_dct

    dev = DEVICE
    C = len(samps)
    e = torch.as_tensor(rng.normal(0, 50, (C, H, W)).astype(np.float32),
                        device=dev)
    g = torch.as_tensor(rng.normal(0, 1, (C, H, W)).astype(np.float32),
                        device=dev)
    scales = torch.as_tensor(rng.uniform(0.01, 0.05, C).astype(np.float32),
                             device=dev)
    los, his, dqs, iqs, pa_sss = [], [], [], [], []
    for c, (sy, sx) in enumerate(samps):
        hc, wc = H // sy, W // sx
        q = torch.as_tensor(np.tile(
            rng.integers(1, 60, (8, 8)).astype(np.float32),
            (hc // 8, wc // 8)), device=dev)
        # boxes centered on the state's own coefficients plus a +-2-step
        # jitter so that some of them bind (the solver's regime)
        fmid = e[c] - scales[c] * g[c]
        jitter = torch.as_tensor(rng.integers(-2, 3, (hc, wc)),
                                 device=dev, dtype=torch.float32)
        dq = (torch.round(sampled_dct(fmid, sy, sx) / q) + jitter) * q
        lo, hi, iq = dq - 0.5 * q, dq + 0.5 * q, 1.0 / q
        if c == 0 and gap_rows:
            # region gap: unconstrained boxes and no prob term there
            lo[-gap_rows:] = -project_step.GAP_BOX
            hi[-gap_rows:] = project_step.GAP_BOX
            dq[-gap_rows:] = 0.0
            iq[-gap_rows:] = 0.0
        los.append(lo)
        his.append(hi)
        dqs.append(dq if prob[c] else None)
        iqs.append(iq if prob[c] else None)
        pa_sss.append(0.36 * sy * sx if prob[c] else 0.0)
    args = (e, g, scales, los, his, dqs, iqs, pa_sss, samps)
    got = project_step.fused_project_multi(*args)
    ref = project_step.fused_project_multi_plain(*args)
    torch.cuda.synchronize()
    # grids: 1e-5 of the data's magnitude (the two sides run the same
    # f32 transforms with different summation orders and fused
    # multiply-adds); distances: rtol 1e-5 (summation order)
    f_err = max_err(got[0], ref[0])
    f_tol = 1e-5 * float(ref[0].abs().max())
    require(f_err <= f_tol, f"K2 fnew {samps}: {f_err} > {f_tol}")
    for c in range(C):
        if not prob[c]:
            require(got[1][c] is None and float(got[2][c]) == 0.0,
                    f"K2 channel {c}: prob off but pgrad/dist set")
            continue
        p_err = max_err(got[1][c], ref[1][c])
        p_tol = 1e-5 * max(1e-3, float(ref[1][c].abs().max()))
        require(p_err <= p_tol, f"K2 pgrad {samps} c{c}: {p_err} > {p_tol}")
        d_rel = abs(float(got[2][c]) - float(ref[2][c])) / max(
            1e-30, abs(float(ref[2][c])))
        require(d_rel <= 1e-5, f"K2 dist {samps} c{c}: rel {d_rel} > 1e-5")
    log(f"  K2 {H}x{W} samps={samps} prob={prob} gap_rows={gap_rows}: "
        f"fnew err {f_err:.3g} (tol {f_tol:.3g}), pgrad/dist ok")
    return f_err


def _k3_compare(label, args, nsteps, extents=None, chaotic=False):
    """K3 against its plain version on the same inputs.

    Exact cases (every random-data case, and real images after one
    iteration): the two sides round differently only where they sum in
    another order (the transforms' fused multiply-adds, the norms' block
    trees; the stencil rounds op for op, -fmad=false).  Per iteration run
    they must agree to: f and fista 1e-5 of the iterates' magnitude;
    devq = (clamp - dq)/q^2 2e-6 of the coefficients' magnitude (q >= 1,
    so a coefficient's rounding reaches devq at most 1:1); in every
    partials row sumsq, tv and tv2 rtol 1e-5, the distances rtol 1e-4
    (clamp - dq cancels values up to |data| * q, which magnifies each
    term's rounding).  With more than one iteration the plain version is
    also run for one, and the iterates must have moved 100x their
    tolerance since: a kernel that stopped after its first iteration
    cannot pass.

    Chaotic cases (real images over more than one iteration): in a real
    image's flat regions the TV subgradient's 1/|g| at |g| ~ 0 turns
    rounding into O(1) differences of the gradient from iteration 2 on,
    and two f32 implementations part (the two-kernel tier's kernels part
    from their plain versions the same way).  There, as in the repo's
    other gates, the CSV's rows 0-1 (row 0, row 1's tv and tv2) keep the
    one-iteration tolerances and the iterates must agree to PSNR > 45 dB;
    the random-data cases hold the later iterations.

    Bucket padding (beyond each image's extent) must be exactly 0 in f,
    fista and devq.  Returns the iterates' max abs error."""
    import torch

    from jpeg2png_tpu_torch.kernels import iter_step

    kw = {} if extents is None else {"extents": extents}
    got = iter_step.fused_solve(*args, **kw)
    ref = iter_step.fused_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    samps = args[8]
    C = len(samps)
    for t in (got[0], got[1], got[3], *got[2]):
        require(bool(torch.isfinite(t).all()), f"K3 {label}: non-finite")
    f_err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
    rows_got, rows_ref = got[3], ref[3]
    if chaotic:
        # row 0 whole; of row 1 the columns CSV row 1 reads (tv, tv2: its
        # distance is logged a row later)
        rows_got = torch.cat([rows_got[..., 0, :], rows_got[..., 1, C:C + 2]],
                             -1)
        rows_ref = torch.cat([rows_ref[..., 0, :], rows_ref[..., 1, C:C + 2]],
                             -1)
        sums = list(range(C + 2)) + [8, 9]
        dists = list(range(C + 2, 8))
    else:
        sums, dists = list(range(C + 2)), list(range(C + 2, 8))
    zero = rows_ref == 0
    require(bool((rows_got[zero] == 0).all()), f"K3 {label}: zero columns")
    rel = torch.where(zero, 0.0, (rows_got - rows_ref).abs()
                      / rows_ref.abs().clamp_min(1e-30))
    rel_sums = float(rel[..., sums].max())
    rel_dist = float(rel[..., dists].max())
    grow = 1 if chaotic else nsteps
    require(rel_sums <= 1e-5 * grow,
            f"K3 {label}: sumsq/tv/tv2 rel {rel_sums} > {1e-5 * grow}")
    require(rel_dist <= 1e-4 * grow,
            f"K3 {label}: distance rel {rel_dist} > {1e-4 * grow}")
    if chaotic:
        p = psnr(got[0].cpu().numpy(), ref[0].cpu().numpy())
        require(p > 45.0, f"K3 {label}: iterates PSNR {p:.2f} <= 45 dB")
        detail = (f"iterate err {f_err:.3g}, PSNR {p:.2f} dB, CSV rows 0-1 "
                  f"rel {max(rel_sums, rel_dist):.3g}")
    else:
        f_tol = 1e-5 * nsteps * float(ref[0].abs().max())
        require(f_err <= f_tol, f"K3 {label}: iterate err {f_err} > {f_tol}")
        coef_mag = max(float((d.to(torch.float32) * q).abs().max()
                             + q[q < 2.0 ** 39].max())
                       for d, q in zip(args[5], args[6]))
        d_tol = 2e-6 * nsteps * coef_mag
        d_err = max([max_err(a, b) for a, b in zip(got[2], ref[2])] + [0.0])
        require(d_err <= d_tol, f"K3 {label}: devq err {d_err} > {d_tol}")
        detail = (f"iterate err {f_err:.3g} (tol {f_tol:.3g}), devq err "
                  f"{d_err:.3g} (tol {d_tol:.3g}), rows 0-{nsteps - 1} rel "
                  f"{rel_sums:.3g} / {rel_dist:.3g}")
        if nsteps > 1:
            one = iter_step.fused_solve_plain(
                *args[:3], args[3][:1], *args[4:], **kw)
            moved = min(max_err(ref[0], one[0]), max_err(ref[1], one[1]))
            d_moved = min([max_err(a, b) for a, b in zip(ref[2], one[2])]
                          + [math.inf])
            require(moved > 100 * f_tol,
                    f"K3 {label}: iterations 2-{nsteps} moved f/fista "
                    f"{moved:.3g}, under 100x the tolerance")
            detail += (f"; since iteration 1 f/fista moved {moved:.3g}, "
                       f"devq {d_moved:.3g}")
    if extents is not None:
        prob_cs = [c for c, pa in enumerate(args[7]) if pa != 0.0]
        for b, (h, w) in enumerate(extents.cpu().tolist()):
            for t in (got[0][b], got[1][b]):
                require(not t[:, h:].any() and not t[:, :, w:].any(),
                        f"K3 {label}: image {b} padding is not 0")
            for d, c in zip(got[2], prob_cs):
                sy, sx = samps[c]
                require(not d[b, h // sy:].any() and not d[b, :, w // sx:]
                        .any(), f"K3 {label}: image {b} devq padding")
    log(f"  K3 {label}: {detail}")
    return f_err


def _k3_random_case(rng, label, B, H, W, samps, prob, weight, nsteps,
                    exts=None, gap_rows=0):
    """K3 on random data (an exact case at every iteration count): f
    ~ N(0, 50) and fista within N(0, 2) of it, so no gradient is near 0;
    boxes centred on f's own coefficients with a +-2-step jitter, so
    some bind; a random devq carry and a prob weight (10 * sy * sx) that
    makes the prob gradient as large as the TV terms; a step of half the
    state's root size, so every iteration moves each pixel by ~0.5.  With
    `exts` the images are a dynamic-extent bucket (padding 0, quant 0
    there); `gap_rows` coefficient rows of channel 0 are a region gap
    (FREE quant, data 0)."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.kernels import iter_step
    from jpeg2png_tpu_torch.kernels.project_step import FREE_Q
    from jpeg2png_tpu_torch.ops.dct_raster import sampled_dct

    dev = DEVICE
    C = len(samps)
    ext_l = exts or [(H, W)] * B
    f = rng.normal(0, 50, (B, C, H, W)).astype(np.float32)
    fi = f + rng.normal(0, 2, f.shape).astype(np.float32)
    for b, (h, w) in enumerate(ext_l):
        for a in (f, fi):
            a[b, :, h:] = 0.0
            a[b, :, :, w:] = 0.0
    datas, qs, devqs = [], [], []
    for c, (sy, sx) in enumerate(samps):
        hc, wc = H // sy, W // sx
        q = np.tile(rng.integers(1, 60, (B, 8, 8)).astype(np.float32),
                    (1, hc // 8, wc // 8))
        coefs = sampled_dct(torch.as_tensor(f[:, c], device=dev), sy,
                            sx).cpu().numpy()
        data = np.clip(np.round(coefs / q) + rng.integers(-2, 3, q.shape),
                       -2000, 2000).astype(np.int16)
        devq = rng.normal(0, 0.1, q.shape).astype(np.float32)
        for b, (h, w) in enumerate(ext_l):
            for a in (q, data, devq):
                a[b, h // sy:] = 0
                a[b, :, w // sx:] = 0
        if c == 0 and gap_rows:
            q[:, -gap_rows:] = FREE_Q
            data[:, -gap_rows:] = 0
            devq[:, -gap_rows:] = 0.0
        datas.append(torch.as_tensor(data, device=dev))
        qs.append(torch.as_tensor(q, device=dev))
        if prob[c]:
            devqs.append(torch.as_tensor(devq, device=dev))
    pa_ss = [10.0 * sy * sx if p else 0.0 for (sy, sx), p in zip(samps, prob)]
    steps = [0.5 * math.sqrt(C * h * w) * (1 + 0.1 * b)
             for b, (h, w) in enumerate(ext_l)]
    factors, _ = iter_step.fista_factors(1.0, nsteps)
    f_t = torch.as_tensor(f, device=dev)
    fi_t = torch.as_tensor(fi, device=dev)
    if exts is None and B == 1:
        args = (f_t[0], fi_t[0], [d[0] for d in devqs], factors, steps[0],
                [d[0] for d in datas], [q[0] for q in qs], pa_ss, samps,
                weight)
        ext = None
    else:
        args = (f_t, fi_t, devqs, factors,
                torch.tensor(steps, dtype=torch.float32, device=dev), datas,
                qs, pa_ss, samps, weight)
        ext = torch.tensor(ext_l, dtype=torch.int32, device=dev)
    where = (f"static {H}x{W}" if ext is None
             else f"bucket {H}x{W} extents {ext_l}")
    return _k3_compare(f"random {label} {where} n={nsteps}", args, nsteps,
                       extents=ext)


def _k3_static_case(label, img, weight, pweights, nsteps):
    """K3 from the plain decode of `img` (static extents), as the mega
    tier calls it."""
    import torch

    from jpeg2png_tpu_torch.kernels import iter_step
    from jpeg2png_tpu_torch.models import solver

    prob = solver._build_problem(
        [p.data for p in img.planes], [p.quant for p in img.planes],
        [(p.h_samp, p.w_samp) for p in img.planes], weight, pweights[:len(
            img.planes)], 50, True, torch.device(DEVICE))
    devqs = [torch.zeros_like(q) for q, pa in zip(prob.qs_c, prob.p_alphas)
             if pa != 0.0]
    factors, _ = iter_step.fista_factors(1.0, nsteps)
    args = (prob.f0, prob.f0, devqs, factors, prob.step_size, prob.dats_c,
            prob.qs_c, prob.pa_sss, prob.samps, weight)
    return _k3_compare(f"{label} {prob.H}x{prob.W} static n={nsteps}", args,
                       nsteps, chaotic=nsteps > 1)


def _k3_bucket_case(imgs, bucket, nsteps):
    """K3 on one real bucket chunk (dynamic extents), as solve_bucket
    calls it."""
    import torch

    from jpeg2png_tpu_torch import runner
    from jpeg2png_tpu_torch.kernels import iter_step
    from jpeg2png_tpu_torch.models.solver import objective_alphas

    f, dats, q_rs, ext, step = runner.prepare_chunk(imgs, bucket, 50, DEVICE)
    samps = [(p.h_samp, p.w_samp) for p in imgs[0].planes]
    pa, _ = objective_alphas(0.3, [0.001] * 3, 3)
    pa_ss = [pa[c] * sy * sx for c, (sy, sx) in enumerate(samps)]
    devqs = [torch.zeros_like(q) for q in q_rs]
    factors, _ = iter_step.fista_factors(1.0, nsteps)
    args = (f, f, devqs, factors, step, dats, q_rs, pa_ss, samps, 0.3)
    exts = [tuple(e) for e in ext.cpu().tolist()]
    return _k3_compare(f"bucket {bucket[0]}x{bucket[1]} extents {exts} "
                       f"n={nsteps}", args, nsteps, extents=ext,
                       chaotic=nsteps > 1)


def phase_kernels(corpus):
    import numpy as np
    import torch

    from jpeg2png_tpu_torch import runner
    from jpeg2png_tpu_torch.io import read_jpeg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    k1 = [
        _k1_case(rng, 3, 2048, 3072, 0.3, [True] * 3),
        _k1_case(rng, 3, 2048, 3072, 0.0, [False] * 3),
        _k1_case(rng, 3, 72, 104, 0.3, [True, False, True],
                 h_true=67, w_true=99),
        _k1_case(rng, 1, 40, 56, 0.3, [True], h_true=37),
        _k1_case(rng, 2, 24, 40, 0.5, [False, True]),
        _k1_case(rng, 4, 24, 40, 0.3, [True] * 4),
    ]
    k2 = [
        _k2_case(rng, 2048, 3072, [(1, 1), (2, 2), (2, 2)], [True] * 3),
        _k2_case(rng, 2048, 3072, [(1, 1), (2, 2), (2, 2)], [False] * 3),
        _k2_case(rng, 64, 112, [(1, 1), (2, 2), (2, 2)],
                 [True, True, False], gap_rows=8),
        _k2_case(rng, 48, 96, [(1, 1), (1, 2), (1, 2)], [True] * 3),
        _k2_case(rng, 48, 80, [(1, 1), (2, 1), (2, 1)], [True, False, True]),
        _k2_case(rng, 40, 128, [(1, 1), (1, 4), (1, 4)], [True] * 3,
                 gap_rows=16),
        _k2_case(rng, 40, 64, [(1, 1)], [True]),
    ]
    # K3: a real bucket chunk of 4 corpus images of different sizes
    plan = runner.plan_buckets(corpus, [0.001] * 3)
    key, members = max(((k, v) for k, v in plan.items() if k[0] == "dyn"),
                       key=lambda kv: (len(kv[1]), -kv[0][1] * kv[0][2]))
    sizes = {}
    for i in members:
        sizes.setdefault((corpus[i].height, corpus[i].width), i)
    chunk = [corpus[i] for i in list(sizes.values())[:4]]
    require(len(chunk) == 4, f"bucket {key[:3]} has < 4 distinct sizes")
    # max abs errors of the exact cases
    k3 = [_k3_bucket_case(chunk, key[1:3], 1)]
    _k3_bucket_case(chunk, key[1:3], 3)
    smoke = read_jpeg(SMOKE_JPEG)
    k3.append(_k3_static_case("smoke", smoke, 0.3, [0.001] * 3, 1))
    _k3_static_case("smoke", smoke, 0.3, [0.001] * 3, 2)
    for name, weight, pweights in (
            ("odd100x52_q25_420", 0.3, [0.001] * 3),       # region gap
            ("photo80_q30_422", 0.3, [0.001] * 3),         # 4:2:2
            ("art120x88_q40_440", 0.3, [0.001] * 3),       # 4:4:0
            ("art128x96_q35_411", 0.3, [0.001, 0.0, 0.001]),  # 4:1:1
            ("gray64_q30", 0.0, [0.001]),                  # C = 1, weight 0
            ("lineart64_q20_420", 0.0, [0.001, 0.0, 0.0])):  # prob off
        for n in (1, 3):
            err = _k3_static_case(name, read_jpeg(FIXTURES / f"{name}.jpg"),
                                  weight, pweights, n)
            if n == 1:
                k3.append(err)
    k3 += k3_random_cases(rng, key[1:3],
                          [runner.bucket_shape_for(im) for im in chunk])
    return k1[0], k2[0], max(k3)


def k3_random_cases(rng, bucket, exts):
    """The exact multi-iteration cases of K3: the real bucket chunk's
    canvas and extents, the 3072x2048 canvas, and the odd geometries, on
    random data over 3 iterations."""
    s420 = [(1, 1), (2, 2), (2, 2)]
    return [
        _k3_random_case(rng, "4:2:0", len(exts), *bucket, s420, [True] * 3,
                        0.3, 3, exts=exts),
        _k3_random_case(rng, "4:2:0", 1, 2048, 3072, s420, [True] * 3, 0.3,
                        3),
        _k3_random_case(rng, "4:2:0 gap", 1, 64, 96, s420, [True] * 3, 0.3,
                        3, gap_rows=16),
        _k3_random_case(rng, "4:1:1 prob off", 1, 48, 128,
                        [(1, 1), (1, 4), (1, 4)], [True, False, True], 0.5,
                        3),
        _k3_random_case(rng, "4:2:0", 2, 128, 128, s420, [True] * 3, 0.3, 3,
                        exts=[(96, 112), (128, 80)]),
        _k3_random_case(rng, "4:2:2", 1, 80, 96, [(1, 1), (1, 2), (1, 2)],
                        [True] * 3, 0.3, 3),
        _k3_random_case(rng, "4:4:0", 1, 96, 120, [(1, 1), (2, 1), (2, 1)],
                        [True] * 3, 0.3, 3),
        _k3_random_case(rng, "C=1 weight 0", 1, 40, 56, [(1, 1)], [True],
                        0.0, 3),
    ]


def _csv_rows(path: pathlib.Path, channel: int = 3):
    import numpy as np

    with open(path) as f:
        rows = [r for r in csv.DictReader(f) if int(r["channel"]) == channel]
    return np.array([[float(r[k]) for k in
                      ("objective", "prob_dist", "tv", "tv2")] for r in rows])


@contextlib.contextmanager
def forced_tier(tier: str):
    """Make active_tier pick `tier` for every geometry the tier takes
    (the solver's size threshold; the CLI has no tier flag)."""
    from jpeg2png_tpu_torch.models import solver

    saved = solver.MEGA_MAX_PIXELS
    solver.MEGA_MAX_PIXELS = 1 << 62 if tier == "mega" else 0
    try:
        yield
    finally:
        solver.MEGA_MAX_PIXELS = saved


def _counters():
    from jpeg2png_tpu_torch.kernels import grad_step, iter_step, project_step

    return (grad_step.fused_grad, project_step.fused_project_multi,
            iter_step.fused_solve)


def zero_counts() -> None:
    for fn in _counters():
        fn.launches = 0


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _counters()}


def _expect(counts: dict, tier: str, n_two: int, n_mega: int, what: str):
    want = ({"fused_grad": n_two, "fused_project_multi": n_two,
             "fused_solve": 0} if tier == "two" else
            {"fused_grad": 0, "fused_project_multi": 0, "fused_solve": n_mega})
    require(counts == want, f"{what} ({tier} tier): launches {counts}, "
                            f"expected {want}")


def phase_goldens():
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from pngdec import decode_png

    from jpeg2png_tpu_torch.cli import main as cli_main

    for tier in ("mega", "two"):
        zero_counts()
        with forced_tier(tier):
            for name in GOLDENS:
                out = OUT_DIR / f"{name}_i50_{tier}.png"
                rc = cli_main([str(FIXTURES / f"{name}.jpg"), "-o", str(out),
                               "-f", "-q", "-i", "50", "--device", DEVICE])
                require(rc == 0, f"cli.main on {name} returned {rc}")
                gold = decode_png((FIXTURES / "golden" / f"{name}_i50.png")
                                  .read_bytes())
                p = psnr(read_own_png(out), gold)
                log(f"  golden {name} i50 ({tier} tier): PSNR {p:.2f} dB")
                require(p > 45.0, f"golden {name} ({tier}): PSNR {p:.2f} dB")

            name = "photo512_q10_420"
            log_path = OUT_DIR / f"{name}_i5_{tier}.csv"
            rc = cli_main([str(FIXTURES / f"{name}.jpg"), "-o",
                           str(OUT_DIR / f"{name}_i5_{tier}.png"), "-f", "-q",
                           "-i", "5", "-c", str(log_path), "--device",
                           DEVICE])
            require(rc == 0, f"cli.main -i 5 on {name} returned {rc}")
        ours = _csv_rows(log_path)[:2]
        gold = _csv_rows(FIXTURES / "golden" / f"{name}_i5.csv")[:2]
        # the reference CSV gate of tests/test_e2e.py before the chaos point
        for col, rtol, atol in ((0, 6e-3, 0.0), (2, 6e-3, 0.0),
                                (3, 6e-3, 1e-3), (1, 5e-2, 1e-3)):
            ok = np.allclose(ours[:, col], gold[:, col], rtol=rtol, atol=atol)
            require(ok, f"{name} CSV column {col} ({tier}): {ours[:, col]} "
                        f"vs {gold[:, col]}")
        log(f"  golden {name} i5 CSV rows 0-1 agree (rtol 6e-3, {tier} tier)")
        # 3 one-shot decodes, then -i 5 with a CSV: 5 one-iteration chunks
        _expect(read_counts(), tier, 3 * 50 + 5, 3 + 5, "goldens")


def _bytes_k1(C, P, H, W, nblocks):
    return 4 * H * W * (2 * C + P) + 4 * H * W * 2 * C + 4 * nblocks * (C + 2)


def _bytes_k2(C, P, H, W, samps, prob):
    coef = sum(4 * (H // sy) * (W // sx) * (4 if p else 2)
               for (sy, sx), p in zip(samps, prob))
    return 4 * H * W * 2 * C + coef + 4 * H * W * (C + P)


def _bound_k3(C, H, W, samps, prob, nsteps):
    """(bytes, operations) of one K3 launch: each input read once and
    each output written once (f, fista in and out; int16 data and quant
    rasters in; devq in and out per prob channel; factors; the partial
    rows), and nsteps iterations of K1's and K2's operations."""
    coefs = [(H // sy) * (W // sx) for sy, sx in samps]
    nbytes = (4 * 4 * C * H * W + sum(6 * n for n in coefs)
              + sum(8 * n for n, p in zip(coefs, prob) if p)
              + 4 * nsteps + 4 * 8 * nsteps)
    ops = nsteps * (K1_OPS_PER_CHANNEL_PIXEL * C * H * W
                    + K2_OPS_PER_COEF * sum(coefs))
    return nbytes, ops


def _record(name, src, replaces, launches, err, ms, plain_ms, nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # no single PyTorch call computes any of these fused functions
            "library_ms": None}


def _args(img):
    return ([p.data for p in img.planes], [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes])


def _solve_ms(img, tier) -> float:
    """CUDA-event milliseconds of one warm 50-iteration default solve."""
    import torch

    from jpeg2png_tpu_torch.models import solver

    args = _args(img) + (0.3, [0.001] * len(img.planes), 50)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    solver.solve_joint(*args, device=DEVICE, tier=tier)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_tier_sweep(card: str):
    """Per-iteration cost of both tiers at photo512, ~1 MP, ~3 MP and 3072x2048
    (50-iteration solves, warm; order two, mega, mega, two; the better of
    each tier's two runs): the numbers behind solver.MEGA_MAX_PIXELS."""
    from jpeg2png_tpu_torch.io import read_jpeg

    sweep = []
    for path in (FIXTURES / "photo512_q10_420.jpg", *MID_JPEGS, SMOKE_JPEG):
        img = read_jpeg(path)
        for tier in ("two", "mega"):
            _solve_ms(img, tier)                      # warm
        runs = {"two": [], "mega": []}
        for tier in ("two", "mega", "mega", "two"):
            runs[tier].append(_solve_ms(img, tier))
        mp = img.height * img.width / 1e6
        row = {"image": path.name, "mp": mp,
               "two_ms_per_iter": min(runs["two"]) / 50,
               "mega_ms_per_iter": min(runs["mega"]) / 50,
               "runs_ms": runs}
        sweep.append(row)
        log(f"  tiers at {path.name} ({mp:.2f} MP): two "
            f"{row['two_ms_per_iter']:.4f} ms/iter, mega "
            f"{row['mega_ms_per_iter']:.4f} ms/iter  [{card}]")
    return sweep


def phase_main_path(card: str, errs):
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.cli import main as cli_main
    from jpeg2png_tpu_torch.io import encode_png, read_jpeg
    from jpeg2png_tpu_torch.kernels import grad_step, iter_step, project_step
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.ops.color import ycbcr_to_rgb_packed

    img = read_jpeg(SMOKE_JPEG)
    datas, quants, samps = _args(img)
    geoms = solver._geometry(datas, samps)
    tier0 = solver.active_tier(geoms)
    other = "two" if tier0 == "mega" else "mega"
    out = OUT_DIR / "torch_smoke_art3072x2048.png"
    zero_counts()
    t0 = time.perf_counter()
    rc = cli_main([str(SMOKE_JPEG), "-o", str(out), "-f", "-q",
                   "--device", DEVICE])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    require(rc == 0, f"cli.main on the smoke JPEG returned {rc}")
    log(f"  single image: cli.main default flags ({tier0} tier), "
        f"{total_s:.3f} s total; launches {launches}")
    _expect(launches, tier0, 50, 1, "3072x2048 CLI decode")
    t0 = time.perf_counter()
    read_jpeg(SMOKE_JPEG)
    read_s = time.perf_counter() - t0
    pix = read_own_png(out)
    require(pix.shape == (img.height, img.width, 3),
            f"output shape {pix.shape}")
    t0 = time.perf_counter()
    encode_png(pix)
    png_s = time.perf_counter() - t0
    log(f"  host: JPEG read {read_s:.3f} s, PNG encode {png_s:.3f} s")

    args = (datas, quants, samps, 0.3, [0.001] * 3, 50)
    zero_counts()
    fd_other, _ = solver.solve_joint(*args, device=DEVICE, tier=other)
    torch.cuda.synchronize()
    counts = {tier0: launches, other: read_counts()}
    _expect(counts[other], other, 50, 1, "3072x2048 forced solve")
    log(f"  forced {other} tier: launches {counts[other]}")

    fdata = {other: fd_other}
    solve_ms = {}
    for tier in (tier0, other, other, tier0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fd, metrics = solver.solve_joint(*args, device=DEVICE, tier=tier)
        end.record()
        torch.cuda.synchronize()
        solve_ms.setdefault(tier, []).append(start.elapsed_time(end))
        fdata[tier] = fd
        require(bool(torch.isfinite(fd).all()) and np.isfinite(metrics).all(),
                f"non-finite solver output ({tier})")
    H, W = fdata[tier0].shape[1:]
    rate = {t: H * W / 1e6 * 50 / (min(v) / 1e3) for t, v in solve_ms.items()}
    for t, v in solve_ms.items():
        log(f"  solve ({t} tier, CUDA events): {v[0]:.3f}, {v[1]:.3f} ms, "
            f"{rate[t]:.1f} MP*iter/s at {H}x{W}, 50 iterations  [{card}]")

    def pack(f):
        h, w = img.height, img.width
        return ycbcr_to_rgb_packed(f[0][:h, :w] + 128.0, f[1][:h, :w],
                                   f[2][:h, :w])
    p_tiers = psnr(pack(fdata["mega"]), pack(fdata["two"]))
    log(f"  mega vs two tier (50 iterations): PSNR {p_tiers:.2f} dB")
    require(p_tiers > 45.0, f"mega vs two tier PSNR {p_tiers:.2f} <= 45 dB")

    # kernel path vs plain path on the card, whole solve, each tier
    p_plain = {}
    saved = (solver.fused_grad, solver.fused_project_multi,
             solver.fused_solve)
    solver.fused_grad = grad_step.fused_grad_plain
    solver.fused_project_multi = project_step.fused_project_multi_plain
    solver.fused_solve = iter_step.fused_solve_plain
    try:
        for tier in ("two", "mega"):
            fd_plain, _ = solver.solve_joint(*args, device=DEVICE, tier=tier)
            p_plain[tier] = psnr(pack(fdata[tier]), pack(fd_plain))
    finally:
        (solver.fused_grad, solver.fused_project_multi,
         solver.fused_solve) = saved
    for tier, p in p_plain.items():
        log(f"  {tier} tier, kernel path vs plain path: PSNR {p:.2f} dB")
        require(p > 45.0, f"{tier} kernel vs plain path PSNR {p:.2f} <= 45")

    # per-kernel times at the single-image path's shapes, on a real state
    _, _, carry = solver.solve_steps(*args, nsteps=3, device=DEVICE,
                                     tier="two")
    fd, fi, pgrads = carry[0], carry[1], carry[2]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    prob = solver._build_problem(datas, quants, samps, 0.3, [0.001] * 3,
                                 50, True, torch.device(DEVICE))
    end.record()
    torch.cuda.synchronize()
    setup_ms = start.elapsed_time(end)
    log(f"  solver set-up (upload, initial decode, boxes): {setup_ms:.3f} ms")
    k1_args = (fd, fi, list(pgrads), 0.5, 0.3, H, W)
    grads, extraps, sumsq, _, _ = grad_step.fused_grad(*k1_args)
    scale = torch.where(sumsq == 0, 0.0, prob.step_size / torch.sqrt(sumsq))
    k2_args = (extraps, grads, scale, prob.los, prob.his, prob.dqs_c,
               prob.iqs_c, prob.pa_sss, prob.samps)
    _, _, mcarry = solver.solve_steps(*args, nsteps=3, device=DEVICE,
                                      tier="mega")
    factors, _ = iter_step.fista_factors(mcarry[4], 50)
    k3_args = (mcarry[0], mcarry[1], list(mcarry[2]), factors,
               prob.step_size, prob.dats_c, prob.qs_c, prob.pa_sss,
               prob.samps, 0.3)
    C, P = 3, 3
    nblocks = -(-H // grad_step.TILE_H) * -(-W // grad_step.TILE_W)
    b1 = _bytes_k1(C, P, H, W, nblocks)
    b2 = _bytes_k2(C, P, H, W, prob.samps, [True] * 3)
    b3, ops3 = _bound_k3(C, H, W, prob.samps, [True] * 3, 50)
    ops1 = K1_OPS_PER_CHANNEL_PIXEL * C * H * W
    ops2 = K2_OPS_PER_COEF * sum(H // sy * (W // sx) for sy, sx in prob.samps)
    timed = {}
    for name, fn, plain, a, reps, plain_reps in (
            ("fused_grad", grad_step.fused_grad, grad_step.fused_grad_plain,
             k1_args, 20, 5),
            ("fused_project_multi", project_step.fused_project_multi,
             project_step.fused_project_multi_plain, k2_args, 20, 5),
            ("fused_solve", iter_step.fused_solve,
             iter_step.fused_solve_plain, k3_args, 5, 1)):
        saved_n = fn.launches
        ms = cuda_ms(lambda: fn(*a), reps)
        fn.launches = saved_n         # timing launches are not path ones
        timed[name] = (ms, cuda_ms(lambda: plain(*a), plain_reps))
    records = [
        _record("fused_grad", "jpeg2png_tpu_torch/csrc/grad_step.cu",
                "jpeg2png_tpu/kernels/grad_step.py:388",
                counts["two"]["fused_grad"], errs[0],
                *timed["fused_grad"], b1, ops1),
        _record("fused_project_multi",
                "jpeg2png_tpu_torch/csrc/project_step.cu",
                "jpeg2png_tpu/kernels/project_step.py:528",
                counts["two"]["fused_project_multi"], errs[1],
                *timed["fused_project_multi"], b2, ops2),
        _record("fused_solve", "jpeg2png_tpu_torch/csrc/iter_step.cu",
                "jpeg2png_tpu/kernels/iter_step.py:602", None, errs[2],
                *timed["fused_solve"], b3, ops3),
    ]
    for r in records:
        log(f"  {r['name']}: {r['ms']:.4f} ms median (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms  [{card}]")
    stream_bytes = 32 * C * H * W + 14 * sum(H // sy * (W // sx)
                                             for sy, sx in prob.samps)
    log(f"  fused_solve: {records[2]['ms'] / 50:.4f} ms per iteration "
        f"(50 per launch at {H}x{W}); streaming the state through device "
        f"memory each iteration would take "
        f"{stream_bytes / PEAK_BYTES * 1e3:.4f} ms per iteration")
    return records, {"tier": tier0, "launches": counts,
                     "total_s": total_s,
                     "solve_ms": solve_ms, "mp_iter_per_s": rate,
                     "setup_ms": setup_ms, "jpeg_read_s": read_s,
                     "png_encode_s": png_s,
                     "psnr_mega_vs_two": p_tiers if math.isfinite(p_tiers)
                     else None,
                     "psnr_kernel_vs_plain": {
                         t: p if math.isfinite(p) else None
                         for t, p in p_plain.items()}}


def phase_serving(card: str, files, images):
    import numpy as np
    import torch

    from jpeg2png_tpu_torch import runner
    from jpeg2png_tpu_torch.cli import main as cli_main
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.pipeline import _pack

    out_dir = OUT_DIR / "serving"
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = [out_dir / (pathlib.Path(f).stem + ".png") for f in files]
    for o in outs:
        o.unlink(missing_ok=True)
    plan = runner.plan_buckets(images, [0.001] * 3)
    predicted = sum(runner.bucket_dispatches(len(v), 50, False)
                    for k, v in plan.items() if k[0] == "dyn")
    # the exact class (buckets the mega gate refuses): 50 K1 + K2 each
    n_two = sum(len(v) for k, v in plan.items() if k[0] == "exact")
    argv = [str(f) for f in files] + [a for o in outs for a in ("-o", str(o))]
    stats = {}
    zero_counts()
    t0 = time.perf_counter()
    rc = cli_main(argv + ["--tpu-batch", "-q", "--device", DEVICE],
                  stats=stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    require(rc == 0, f"cli.main --tpu-batch returned {rc}")
    require(all(o.exists() for o in outs), "missing serving PNGs")
    log(f"  serving: {len(files)} files, rc {rc}, {wall_s:.3f} s wall; "
        f"launches {launches}; predicted K3 dispatches {predicted}, "
        f"{n_two} images on the two-kernel tier")
    require(launches["fused_solve"] == predicted == stats["k3_dispatches"],
            f"K3 launches {launches['fused_solve']}, plan {predicted}, "
            f"stats {stats['k3_dispatches']}")
    require(launches["fused_grad"] == launches["fused_project_multi"]
            == 50 * n_two, f"K1/K2 launches {launches}, expected "
                           f"{50 * n_two} each")

    # every PNG against the same file decoded alone on the two-kernel tier
    worst = math.inf
    for img, o in zip(images, outs):
        fd, _ = solver.solve_joint(*_args(img), 0.3, [0.001] * 3, 50,
                                   device=DEVICE, tier="two")
        p = psnr(read_own_png(o), _pack(list(fd), img, 8))
        require(p > 45.0, f"serving {o.name}: PSNR {p:.2f} <= 45 dB")
        worst = min(worst, p)
    mp = sum(im.height * im.width for im in images) / 1e6
    summary = {
        "files": len(files), "wall_s": wall_s,
        "files_per_s": len(files) / wall_s,
        "mp_iter_per_s": mp * 50 / stats["solve_s"],
        "true_mp": mp, "k3_launches": launches["fused_solve"],
        "two_tier_images": n_two, "n_buckets": stats["n_buckets"],
        "bucket_classes": stats["bucket_classes"],
        "bucket_shapes": stats["bucket_shapes"],
        "read_s": stats["read_s"], "solve_s": stats["solve_s"],
        "png_thread_s": stats["on_pixels_s"],
        "min_psnr_vs_two_tier": worst if math.isfinite(worst) else None}
    log(f"  serving: {summary['files_per_s']:.2f} files/s, "
        f"{summary['mp_iter_per_s']:.1f} MP*iter/s ({mp:.2f} true MP x 50 / "
        f"solve {stats['solve_s']:.3f} s), read {stats['read_s']:.3f} s, PNG "
        f"{stats['on_pixels_s']:.3f} thread-s, {stats['n_buckets']} buckets "
        f"{stats['bucket_shapes']}; min PSNR vs two tier {worst:.2f} dB  "
        f"[{card}]")
    return launches["fused_solve"], summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from jpeg2png_tpu_torch.io import read_jpeg

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    # every phase raises on failure: the traceback ends the run, exit 1
    card = phase_device()
    log("phase 2: build")
    build_s = phase_build()
    files = sorted(SERVING.glob("*.jpg"))
    require(len(files) == N_SERVING, f"serving corpus: {len(files)} files")
    t0 = time.perf_counter()
    images = [read_jpeg(f) for f in files]
    log(f"serving corpus read (one thread): {time.perf_counter() - t0:.3f} s")
    log("phase 3-4: kernels against their plain versions")
    errs = phase_kernels(images)
    log("phase 5: goldens, both tiers")
    phase_goldens()
    log("phase 6: single image, 3072x2048 4:2:0 default flags, both tiers")
    records, single = phase_main_path(card, errs)
    sweep = phase_tier_sweep(card)
    log("phase 7: serving, cli --tpu-batch on the 48-file corpus")
    k3_launches, serving = phase_serving(card, files, images)
    records[2]["launches"] = k3_launches
    require(k3_launches > 0, "K3 never launched on the serving path")
    log(json.dumps({"card": card, "build_s": build_s, "single": single,
                    "tier_sweep": sweep, "serving": serving}))
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
