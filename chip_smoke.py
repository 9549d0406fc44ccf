#!/usr/bin/env python3
"""Proof that the PyTorch port runs its main paths on an NVIDIA GPU.

    python3 chip_smoke.py            # one CUDA card, from the repo root

Phases (each raises on failure; the traceback then ends the run with a
non-zero exit and no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the host JPEG entropy decoder (cc) and the CUDA kernels from
     jpeg2png_tpu_torch/csrc (one nvcc per source, in parallel) and print
     the build seconds and ptxas report;
  3. TF32 off for the plain PyTorch versions;
  4. each kernel against its plain version on the card: K1 and K2 at the
     3072x2048 4:2:0 geometry and small odd ones (region gap, h_true < H,
     4:2:2, 4:4:0, 4:1:1, prob on and off); K3 on one real bucket chunk
     of 4 serving-corpus images (dynamic extents, 1 and 3 iterations), on
     the 3072x2048 canvas (static, 1 and 2 iterations) and on small odd
     geometries, each elementwise after one iteration, and on random data
     at the same shapes over 3 iterations, elementwise in every iteration
     row, with the bucket padding held at exactly 0; K4 and K5 on random
     data (zero and nonzero halos, row0 > 0, static and dynamic extents,
     prob on and off, 4:2:0 to 4:4:4 and C = 1, region gaps, frozen
     padding, the 3072x2048 canvas), bf16 outputs within one bf16 step;
     K3's lite mode on K3's random-data cases, every iteration of a
     3-iteration launch against the plain version's step from the
     kernel's own state; K1 and K7 where their row-marching grid has
     edges (bands of 8 and 16 rows, 8 and 328 columns, heights off the
     segment, C = 4, a segment boundary on h_true - 1), and the Python
     mirror of that grid against the library's; K3 and K3 lite where their
     cells have edges (k3_cell_cases: a canvas narrower than a cell, W =
     512, a ragged last strip, heights off the cell rows, extents on and
     past a cell boundary, B = 8, C = 1 and 4, 4:1:1, 4:4:0, a region gap
     with its prob term off) and the Python mirror of K3's plan;
  5. goldens: three fixtures decoded at -i 50 through the pipeline must
     reach PSNR > 45 dB against the reference binary's PNGs, and the
     photo512 -i 5 CSV must agree with the reference on iterations 0-1,
     each through all four solver tiers (forced with tier=); photo512 at
     -i 1000 through the mega and mega-lite tiers against the reference's
     converged golden (> 55 dB, as tests/tpu_checks.py holds the JAX
     package); lineart64 with -s and per-channel triples (-w 0.5,0.2,0.1
     -p 0.002,0.001,0.0005 -i 5,4,3) through every tier, each channel's
     CSV rows and the PNG (> 45 dB) against the reference's;
  6. the single-image path: the default-flag CLI decode of a 3072x2048
     4:2:0 q30 JPEG (the tier solver.tier_rule picks) with the launch
     counters read around it, the same decode forced to two-lite (50
     launches each of K4 and K5, nothing else), the solve forced through
     every tier (launch counts, PSNR against the two tier and against the
     plain path); per-kernel times beside their bounds (the bytes each
     launch must move, whatever its grid) and the plain versions' times,
     K1's split between its gradient kernel and its reduction
     (torch.profiler); K3 and K3 lite alone where K3 runs (photo512, the
     1.23 MP sweep image, the dyn 1024x1280 serving chunk, 3072x2048; real
     states, beside the bound and the per-iteration streaming figure) and
     the solver's set-up at photo512; the tier sweep: every tier at 0.26,
     1.23, 3.15, 6.29 and 8.0 MP (the numbers that set the rule's gates);
  7. serving: cli.main --tpu-batch on the 48-file corpus
     (tests/fixtures/torch_serving), with the committed gates and with
     gates that give every class work: the launch count of each kernel
     against the runner's bucket plan (dyn buckets on K3 or K3 lite, dyn2
     images on K4 + K5, exact images on K1 + K2), every PNG > 45 dB
     against the same file decoded alone on the two-kernel tier;
  8. the row-striped path (parallel/stripes.py), 4 bands on the one card
     (K7 and K6 were held against their plain versions in phase 4: bands
     first, middle, last and in the padding, null, zero and random halos,
     the 100.7 MP band; K6 at five footprints, a region gap, frozen
     padding, and against K2 on the same band): the smoke JPEG striped
     (K7 = K2 = 200 launches, K1 = 0, 3 collectives per iteration, rows
     0-1 and 50 iterations against the two tier and the striped plain
     path, the lite body forced: K4 = K5 = 200), three goldens through
     the pipeline striped, -s striped (K7 = K6 = 600), the 100.7 MP
     problem (the smoke JPEG's blocks tiled 4 x 4, 12288 x 8192) against
     the two tier with times and peak memory, -s on it (K7 = K6 = 600),
     K7's, K6's and K2's times at its band shapes (K7's split as K1's),
     and cli --tpu-stripes 4 on one card (the clamp warning);
  9. checkpoint/resume (models/checkpoint.py), each run bit-equal with
     the one-shot run: the smoke JPEG at -i 50 through every tier
     (solve_checkpointed every 20 iterations against solve_joint, launch
     counts: K1 = K2 = 50, K4 = K5 = 50, 3 K3 launches), a run cut at 20
     and resumed from its snapshot; the 100.7 MP problem over 4 bands, f32
     body (K7 = K2 = 200, 3 collectives per iteration), and the smoke JPEG
     over 4 bands, lite body (K4 = K5 = 200), each checkpointed every 20
     and cut at 40; the snapshot bytes, the seconds of the host gather,
     save_state and load_state (free disk checked first), and the wall
     time of each checkpointed solve against the one-shot's;
 10. the reader (io/jpeg_reader.py on the C entropy decoder
     csrc/jpeg_entropy.c, built in phase 2 with cc): every progressive
     twin under tests/fixtures/torch_progressive/ read bit-equal to its
     sequential original; the progressive golden (lineart64 q20 4:2:0
     SOF2) through all four tiers, CSV rows 0-1 and PSNR > 45 dB at -i 5
     and PSNR > 45 dB at -i 50; the smoke JPEG's progressive twin through
     the default CLI, the same pixels and launch counts as the original;
     read times: the smoke JPEG and its twin, the parent tree's reader
     where jpeg2png_tpu_torch/_build/parent/jpeg_reader.py holds one, the
     48 files on one thread and on 8;
 11. the reader on arithmetic-coded input (SOF9, SOF10; the QM decoder
     in csrc/jpeg_entropy.c): every arithmetic twin under
     tests/fixtures/torch_arith/ (and lineart64's) read bit-equal to its
     Huffman original; lineart64's arithmetic twin through all four tiers
     against the original's goldens (-i 5 CSV rows 0-1 and PSNR > 45 dB,
     -i 50 PSNR > 45 dB); the smoke JPEG's sequential and progressive
     arithmetic twins through the default CLI, the original's pixels and
     launch counts (K1 = K2 = 50) and their wall seconds; read times of
     the smoke JPEG, its Huffman progressive twin and its two arithmetic
     twins;
 12. the quality fixtures (tests/fixtures/quality/: tests/test_quality.py's
     seven cases and photo512x384_q25_420_i1000) through every tier, each
     with tests/test_quality.py's gates (PSNR against the ground truth >=
     the reference's - 0.05 dB, > 0.5 dB above the plain decode, > 45 dB
     against the reference's PNG), and six more i50 goldens (4:4:4,
     4:1:1, 4:4:0, an odd size, 4:2:2) through every tier, > 45 dB;
 13. several workers on the one card: phase 7's serving run through
     runner.decode_files_batched over devices=["cuda:0"] * 2 (one host
     thread each), committed and every-class gates, every image equal to
     phase 7's one-worker PNG, the launches the plan's, both workers used;
     stripes.solve_striped_batched on the smoke JPEG and its blocks
     reordered, 2 images x 2 bands on ["cuda:0"] * 4, each equal to its
     own solve_striped over 2 bands (f32 body: K7 = K2 = 200; lite body:
     K4 = K5 = 200), ms per iteration and peak memory;
 14. the measurement layer (utils/profiling.py, timing.py, debug.py):
     device_trace around a 50-iteration two-tier solve of the smoke JPEG,
     trace_breakdown naming K1 and K2 with 50 launches each (the
     counters') and idle >= 0, its per-iteration split printed;
     marginal_rate(joint_timer) at photo512 (200 -> 600 iterations); the
     build counter over a warm repeat of phase 7's serving run (0); under
     fp_exceptions the default CLI decode traps nothing and a NaN planted
     in K1's input raises FloatingPointError from the wrapper's check after
     its launch; kernel_cost_table gives the bounds phases 6 and 8 print;
 15. a JSON line of end-to-end numbers (with each phase's seconds), one
     JSON line of kernel records, then the device line last.

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
# the port's bounds (bytes and operations per kernel, H100 peaks): one
# source for every bound this script and PERF.md give
from jpeg2png_tpu_torch.utils.profiling import (  # noqa: E402
    PEAK_BYTES, bound_k3, bound_ms, bytes_k2, kernel_cost_table)
# the kernel wrappers' launch counters
from jpeg2png_tpu_torch.utils.profiling import (  # noqa: E402
    launch_counters as _counters, read_launch_counts as read_counts,
    zero_launch_counts as zero_counts)
FIXTURES = ROOT / "tests" / "fixtures"
OUT_DIR = ROOT / "jpeg2png_tpu_torch" / "_build" / "chip_smoke"
SMOKE_JPEG = FIXTURES / "torch_smoke_art3072x2048_q30_420.jpg"
SERVING = FIXTURES / "torch_serving"
N_SERVING = 48
# the ~1 MP and ~3 MP points of the tier sweep: 4:2:0 corpus images
MID_JPEGS = (SERVING / "img016_1280x960_q20_s2.jpg",
             SERVING / "img021_2048x1536_q75_s2.jpg")
# the 8.0 MP point of the tier sweep
BIG_JPEG = SERVING / "img023_3264x2448_q90_s2.jpg"

GOLDENS = ("photo512_q10_420", "photo600x400_q20_420", "art440x320_q30_422")
# tests/test_e2e.py's assert_metrics_close: (column, rtol, atol)
METRIC_GATES = ((0, 6e-3, 0.0), (2, 6e-3, 0.0), (3, 6e-3, 1e-3),
                (1, 5e-2, 1e-3))
# the -s golden with per-channel triples (tests/test_e2e.py:135-152)
STRIPLE = "lineart64_q20_420"
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

    host_s = _build.build(list(_build.HOST_LIBRARIES))
    log(f"build: {host_s:.2f} s for the host library "
        f"{', '.join(_build.HOST_LIBRARIES)} (cc)")
    seconds = _build.build(list(_build.LIBRARIES))
    log(f"build: {seconds:.1f} s for {', '.join(_build.LIBRARIES)}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return seconds + host_s


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


def k1_edge_cases(rng):
    """The CPU mirror of K1's grid (grad_step.partial_rows) against the
    library's, then K1 where the row-marching grid has edges: canvases of
    8 and 16 rows (shorter than or one segment), 8 columns, a width that is no multiple
    of the strip and a height that is no multiple of the segment, C = 4
    over several segments and strips, a true extent ending inside the
    first segment, and the segment boundary on h_true - 1 (as the last row
    of a segment and as the first)."""
    from jpeg2png_tpu_torch.kernels import grad_step

    seg = grad_step.segment_rows(3, True, 64, 96)
    require(seg < 64, f"K1 edge cases: 64 rows make one segment ({seg})")
    # the CPU mirror of the grid against the library: one strip of 2^24
    # rows splits into as many segments as blocks are resident
    lib, _ = grad_step._launcher()
    slots = lib.j2p_grad_partial_rows(3, 1, 1 << 24, 8)
    for L, W in ((2048, 3072), (2048, 12288), (100, 300), (8, 8)):
        rows = lib.j2p_grad_partial_rows(3, 1, L, W)
        require(rows == grad_step.partial_rows(L, W, slots),
                f"grid of {L}x{W}: the library's {rows} partial rows, the "
                f"mirror's {grad_step.partial_rows(L, W, slots)}")
    return [
        _k1_case(rng, 3, 8, 64, 0.3, [True] * 3),
        _k1_case(rng, 3, 16, 128, 0.3, [True, False, True]),
        _k1_case(rng, 2, 40, 8, 0.3, [True, False]),
        _k1_case(rng, 3, 104, 328, 0.3, [True] * 3, h_true=99, w_true=325),
        _k1_case(rng, 4, 72, 264, 0.3, [True] * 4, h_true=70),
        _k1_case(rng, 3, 64, 96, 0.3, [True] * 3, h_true=5),
        _k1_case(rng, 3, 64, 96, 0.3, [True] * 3, h_true=seg),
        _k1_case(rng, 3, 64, 96, 0.3, [False] * 3, h_true=seg + 1),
    ]


def _pgrad_tol(ref_pg, pa, dqs) -> float:
    """The gate of a projection kernel's prob gradient against its plain
    version: 1e-5 of its magnitude, plus the coefficients' rounding that
    reaches it.  The two sides compute the coefficients in another
    summation order (with fused multiply-adds), up to 8 ulps (2^-21
    relative) of the coefficients' magnitude apart; devp * iq = (clamp -
    dq) * iq^2 cancels that magnitude down to the deviation and passes the
    difference on times iq^2 <= 1 (q >= 1), and p_alpha times the inverse
    transform, at most 1 per coefficient, carries it to the pixels."""
    coef_mag = max(float(d.abs().max()) for d in dqs)
    return (1e-5 * max(1e-3, float(ref_pg.abs().max()))
            + pa * 2.0 ** -21 * coef_mag)


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
    # multiply-adds), pgrad also the coefficients' rounding (_pgrad_tol);
    # distances: rtol 1e-5 (summation order)
    f_err = max_err(got[0], ref[0])
    f_tol = 1e-5 * float(ref[0].abs().max())
    require(f_err <= f_tol, f"K2 fnew {samps}: {f_err} > {f_tol}")
    for c in range(C):
        if not prob[c]:
            require(got[1][c] is None and float(got[2][c]) == 0.0,
                    f"K2 channel {c}: prob off but pgrad/dist set")
            continue
        p_err = max_err(got[1][c], ref[1][c])
        p_tol = _pgrad_tol(ref[1][c], pa_sss[c] / (samps[c][0] * samps[c][1]),
                           [dqs[c]])
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
    """K3 on random data (_k3_random_args), an exact case at every
    iteration count."""
    args, ext, where = _k3_random_args(rng, B, H, W, samps, prob, weight,
                                       nsteps, exts, gap_rows)
    return _k3_compare(f"random {label} {where} n={nsteps}", args, nsteps,
                       extents=ext)


def _k3_random_args(rng, B, H, W, samps, prob, weight, nsteps, exts=None,
                    gap_rows=0):
    """K3's arguments on random data: f
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
    return args, ext, where


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
    k1 += k1_edge_cases(rng)
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
    exts = [runner.bucket_shape_for(im) for im in chunk]
    k3 += k3_random_cases(rng, key[1:3], exts)
    k4, k5, k3_lite = lite_kernel_cases(rng, key[1:3], exts)
    cell_f32, cell_lite = k3_cell_cases(rng)
    k3 += cell_f32
    k3_lite = max([k3_lite] + cell_lite)
    # max abs errors: K1 and K2 at 3072x2048, the others over their cases
    return {"fused_grad": k1[0], "fused_project_multi": k2[0],
            "fused_solve": max(k3), "fused_solve_lite": k3_lite,
            "fused_grad_striped_lite": k4, "fused_project_multi_lite": k5}


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


def k3_cell_cases(rng):
    """K3 where its cell decomposition has edges, f32 and lite, on random
    data over 3 iterations at the exact gates (_k3_compare,
    _k3_lite_compare): a canvas narrower than one cell, W = 512, a ragged
    last strip, a height off the cell rows, the cell boundary on h_true - 1
    (and a block past it), B = 8 with extents ending in
    the first cells, C = 1 and C = 4, 4:1:1, 4:4:0, a region gap with its
    prob term off.  First the Python mirror of the plan
    (iter_step.plan) against the library's.  Returns the max abs errors
    (f32, lite)."""
    from jpeg2png_tpu_torch.kernels import iter_step

    s420 = S420
    for B, C, H, W, samps, prob, lite in (
            (1, 3, 512, 512, s420, [True] * 3, False),
            (1, 3, 960, 1280, s420, [True] * 3, True),
            (4, 3, 1024, 1280, s420, [True] * 3, False),
            (1, 3, 2048, 3072, s420, [True] * 3, False),
            (8, 3, 256, 384, s420, [True] * 3, True),
            (1, 4, 64, 64, [(1, 1)] * 4, [True, False, True, False], False),
            (1, 3, 48, 128, LITE_GEOMETRIES["4:1:1"], [True] * 3, False)):
        want = iter_step.plan(B, C, H, W, samps, prob, lite,
                              *iter_step.library_plan_inputs(C, 0.3, lite))
        got = iter_step.launch_plan(B, C, H, W, samps, prob, 0.3, lite)
        require(got == want, f"K3 plan B={B} C={C} {H}x{W} lite={lite}: "
                             f"library {got}, mirror {want}")
    # cell rows of a 1040 x 1280 canvas (not a multiple of them, unless
    # the card's grid makes it one) and of a 2-image 192 x 256 bucket.
    # Extents stay whole coefficient blocks (multiples of 16 at 4:2:0, as
    # the runner's canvases are): frozen padding is exactly 0 only then
    rows = iter_step.launch_plan(1, 3, 1040, 1280, s420, [True] * 3,
                                 0.3)["rows"]
    brow = iter_step.launch_plan(2, 3, 192, 256, s420, [True] * 3,
                                 0.3)["rows"]
    log(f"  K3 cell rows: {rows} at 1040x1280, {brow} in a 2-image "
        f"192x256 bucket")
    require(2 * brow + 16 <= 192, f"192x256 bucket cells of {brow} rows")
    cases = [
        ("narrow", 1, 80, 48, s420, [True] * 3, 0.3, None, 0),
        ("W=512", 1, 64, 512, s420, [True] * 3, 0.3, None, 0),
        ("ragged strip", 1, 48, 336, s420, [True] * 3, 0.3, None, 0),
        ("rows off the cell", 1, 1040, 1280, s420, [True] * 3, 0.3, None, 0),
        ("h_true - 1 a cell's last row", 2, 192, 256, s420, [True] * 3, 0.3,
         [(brow, 256), (2 * brow, 240)], 0),
        ("h_true a block past a cell", 2, 192, 256, s420, [True] * 3, 0.3,
         [(brow + 16, 256), (2 * brow + 16, 224)], 0),
        ("B=8 first cells", 8, 192, 256, s420, [True] * 3, 0.3,
         [(16 + 16 * (b % 2), 64 + 16 * b) for b in range(8)], 0),
        ("C=1", 1, 72, 200, [(1, 1)], [True], 0.3, None, 0),
        ("C=4", 1, 64, 136, [(1, 1)] * 4, [True, False, True, False], 0.3,
         None, 0),
        ("4:1:1", 1, 48, 256, LITE_GEOMETRIES["4:1:1"], [True] * 3, 0.3,
         None, 0),
        ("4:4:0", 1, 96, 160, LITE_GEOMETRIES["4:4:0"], [True] * 3, 0.3,
         None, 0),
        ("gap, prob off", 1, 64, 160, s420, [False, True, True], 0.3, None,
         16),
    ]
    f32, lite = [], []
    for label, B, H, W, samps, prob, weight, exts, gap in cases:
        f32.append(_k3_random_case(rng, f"cells {label}", B, H, W, samps,
                                   prob, weight, 3, exts=exts,
                                   gap_rows=gap))
        lite.append(_k3_lite_random_case(rng, f"cells {label}", B, H, W,
                                         samps, prob, weight, 3, exts=exts,
                                         gap_rows=gap))
    return f32, lite


# ------------------------------------------------ K3 where it runs

K3_POINTS = ("photo512", "1.23MP", "dyn1024x1280", "3072x2048")
# the converged golden's gate per whole-solve tier: tests/tpu_checks.py
# holds the JAX package's mega and mega-lite tiers to > 55 dB
GOLDEN_I1000_DB = {"mega": 55.0, "mega-lite": 55.0}


def golden_i1000(tier: str) -> float:
    """PSNR of photo512 decoded at -i 1000 (default weights) through `tier`
    against the reference binary's converged golden."""
    sys.path.insert(0, str(ROOT / "tests"))
    from pngdec import decode_png

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.pipeline import _pack

    img = read_jpeg(FIXTURES / "photo512_q10_420.jpg")
    fd, _ = solver.solve_joint(*_args(img), 0.3, [0.001] * 3, 1000,
                               device=DEVICE, tier=tier)
    gold = decode_png((FIXTURES / "golden" / "photo512_q10_420_i1000.png")
                      .read_bytes())
    return psnr(_pack(list(fd), img, 8), gold)


def bucket_chunk(images):
    """The serving corpus's dyn 1024x1280 chunk (up to 8 images) and its
    bucket, as runner.plan_buckets forms it."""
    from jpeg2png_tpu_torch import runner

    plan = runner.plan_buckets(images, [0.001] * 3)
    for key, members in plan.items():
        if key[0] == "dyn" and tuple(key[1:3]) == (1024, 1280):
            return ([images[i] for i in members][:runner.CHUNK_IMAGES],
                    (1024, 1280))
    raise SmokeFailure("no dyn 1024x1280 bucket in the serving corpus")


def k3_point_args(point, chunk):
    """K3's f32 arguments (50 iterations) and extents on a real solver
    state at `point`: the mega tier after 3 iterations (photo512, the 1.23
    MP sweep image, the 3072x2048 smoke JPEG; static extents), the dyn
    1024x1280 serving chunk after 3 iterations of K3 (dynamic extents)."""
    import torch

    from jpeg2png_tpu_torch import runner
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.kernels import iter_step
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.models.solver import objective_alphas

    if point == "dyn1024x1280":
        imgs, bucket = chunk
        f, dats, q_rs, ext, step = runner.prepare_chunk(imgs, bucket, 50,
                                                        DEVICE)
        samps = [(p.h_samp, p.w_samp) for p in imgs[0].planes]
        pa, _ = objective_alphas(0.3, [0.001] * 3, 3)
        pa_ss = [pa[c] * sy * sx for c, (sy, sx) in enumerate(samps)]
        factors, _ = iter_step.fista_factors(1.0, 53)
        saved = iter_step.fused_solve.launches
        f, fi, devqs, _ = iter_step.fused_solve(
            f, f, [torch.zeros_like(q) for q in q_rs], factors[:3], step,
            dats, q_rs, pa_ss, samps, 0.3, extents=ext)
        iter_step.fused_solve.launches = saved     # not a path launch
        return (f, fi, list(devqs), factors[3:], step, dats, q_rs, pa_ss,
                samps, 0.3), ext
    path = {"photo512": FIXTURES / "photo512_q10_420.jpg",
            "1.23MP": MID_JPEGS[0], "3072x2048": SMOKE_JPEG}[point]
    img = read_jpeg(path)
    datas, quants, samps = _args(img)
    args = (datas, quants, samps, 0.3, [0.001] * 3, 50)
    saved = iter_step.fused_solve.launches
    _, _, carry = solver.solve_steps(*args, nsteps=3, device=DEVICE,
                                     tier="mega")
    iter_step.fused_solve.launches = saved
    prob = solver._build_problem(datas, quants, samps, 0.3, [0.001] * 3, 50,
                                 True, torch.device(DEVICE))
    factors, _ = iter_step.fista_factors(carry[4], 50)
    return (carry[0], carry[1], list(carry[2]), factors, prob.step_size,
            prob.dats_c, prob.qs_c, prob.pa_sss, prob.samps, 0.3), None


def lite_state(args):
    """K3's f32 arguments in the lite state: d = bf16(f - fista), devq
    bf16."""
    import torch

    return ((args[0], (args[0] - args[1]).to(torch.bfloat16),
             [x.to(torch.bfloat16) for x in args[2]]) + tuple(args[3:]))


def k3_bounds(args, ext, lite):
    """(bound ms of the launch, streaming ms per iteration) of K3 on these
    arguments: bound_k3 per image, and the state through device memory
    every iteration (32 B per pixel and channel in f32, 22 lite, plus 14 /
    10 B per coefficient)."""
    f = args[0]
    B = f.shape[0] if ext is not None else 1
    H, W = f.shape[-2:]
    samps, prob = args[8], [p != 0.0 for p in args[7]]
    C = len(samps)
    nb, ops = bound_k3(C, H, W, samps, prob, len(args[3]), lite)
    bound = bound_ms(nb * B, ops * B)[0]
    coefs = sum(H // sy * (W // sx) for sy, sx in samps)
    stream = B * ((22 if lite else 32) * C * H * W + (10 if lite else 14)
                  * coefs)
    return bound, stream / PEAK_BYTES * 1e3


def phase_k3_points(card, images):
    """K3 and K3 lite alone at the four points where K3 runs, on real
    solver states: 50-iteration launches between CUDA events (median of
    20; 5 at 3072x2048), beside the design-independent bound and the
    per-iteration streaming figure; the solver's set-up at photo512 (what
    the tier sweep's per-iteration figure includes besides the kernel)."""
    import torch

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.kernels import iter_step
    from jpeg2png_tpu_torch.models import solver

    img = read_jpeg(FIXTURES / "photo512_q10_420.jpg")
    datas, quants, samps = _args(img)
    solver._build_problem(datas, quants, samps, 0.3, [0.001] * 3, 50, True,
                          torch.device(DEVICE))                  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    solver._build_problem(datas, quants, samps, 0.3, [0.001] * 3, 50, True,
                          torch.device(DEVICE))
    end.record()
    torch.cuda.synchronize()
    setup = start.elapsed_time(end)
    log(f"  photo512 solver set-up (upload, initial decode, boxes): "
        f"{setup:.4f} ms  [{card}]")
    chunk = bucket_chunk(images)
    points = {"photo512_setup_ms": setup}
    for point in K3_POINTS:
        a32, ext = k3_point_args(point, chunk)
        kw = {} if ext is None else {"extents": ext}
        for lite in (False, True):
            fn = iter_step.fused_solve_lite if lite else iter_step.fused_solve
            a = lite_state(a32) if lite else a32
            saved = fn.launches
            ms = cuda_ms(lambda: fn(*a, **kw),
                         5 if point == "3072x2048" else 20)
            fn.launches = saved            # timing launches are not path ones
            bound, stream = k3_bounds(a, ext, lite)
            H, W = a[0].shape[-2:]
            B = a[0].shape[0] if ext is not None else 1
            pl = iter_step.launch_plan(B, 3, H, W, a[8],
                                       [p != 0.0 for p in a[7]], 0.3, lite)
            name = f"{point} {'lite' if lite else 'f32'}"
            points[name] = {"ms": ms, "ms_per_iter": ms / len(a[3]),
                            "bound_ms": bound, "stream_ms_per_iter": stream,
                            "plan": pl}
            log(f"  K3 {name} [B={B}, {H}x{W}]: {ms:.4f} ms per 50-iteration "
                f"launch = {ms / len(a[3]):.4f} ms per iteration (bound "
                f"{bound:.4f} ms per launch; streaming {stream:.4f} ms per "
                f"iteration; grid {pl['G']} x {pl['k']} cell(s) of "
                f"{pl['rows']} rows, scratch "
                f"{'in shared memory' if pl['resident'] else 'global'})  "
                f"[{card}]")
        del a32, a
        torch.cuda.empty_cache()
    return points


# ------------------------------------------------ the lite family (K4, K5)

S420 = [(1, 1), (2, 2), (2, 2)]
LITE_GEOMETRIES = {          # name -> samps
    "4:2:0": S420, "4:2:2": [(1, 1), (1, 2), (1, 2)],
    "4:4:0": [(1, 1), (2, 1), (2, 1)], "4:1:1": [(1, 1), (1, 4), (1, 4)],
    "4:4:4": [(1, 1)] * 3, "C=1": [(1, 1)]}


def bf16_step(t):
    """One bf16 step (unit in the last place) at the magnitude of each
    element of t: 2^(floor(log2|t|) - 7), 0 where t is 0."""
    import torch

    t = t.to(torch.float32)
    _, e = torch.frexp(t)
    return torch.where(t == 0, 0.0, torch.ldexp(torch.ones_like(t), e - 8))


def bf16_gate(label, what, got, ref, extra: float) -> float:
    """|got - ref| <= one bf16 step of the reference element + `extra`
    (the error the value carried before it was rounded to bf16).
    Returns the max abs error."""
    import torch

    got = got.to(torch.float32)
    ref = ref.to(torch.float32)
    err = (got - ref).abs()
    bad = err > bf16_step(ref) + extra
    require(not bool(bad.any()),
            f"{label} {what}: {int(bad.sum())} elements beyond one bf16 step "
            f"+ {extra:.3g} (max err {float(err.max()):.3g})")
    return float(err.max())


def _rel_gate(label, what, got, ref, rtol):
    import torch

    got = torch.as_tensor(got, dtype=torch.float32).reshape(-1)
    ref = torch.as_tensor(ref, dtype=torch.float32).reshape(-1).to(got.device)
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    require(rel <= rtol or float((got - ref).abs().max()) == 0.0,
            f"{label} {what}: rel err {rel} > {rtol}")
    return rel


def _rand_state(rng, shape):
    """f32 iterates ~ N(0, 50) and a bf16 FISTA difference ~ N(0, 2)."""
    import numpy as np
    import torch

    f = torch.as_tensor(rng.normal(0, 50, shape).astype(np.float32),
                        device=DEVICE)
    d = torch.as_tensor(rng.normal(0, 2, shape).astype(np.float32),
                        device=DEVICE).to(torch.bfloat16)
    return f, d


def _k4_case(rng, geom, prob, weight, L, W, row0=0, h_pad=None, ext=None,
             halo=False, dynamic=False):
    """K4 against its plain version: the bf16 gradient within one bf16
    step of each element plus K1's f32 gate (1e-5 of the gradient's
    magnitude, the rounding of the f32 value before it is stored: the
    prob expansion sums in another order); sumsq, tv, tv2 rtol 1e-5
    (summation order).  Without a prob term the f32 gradients round op
    for op alike (-fmad=false), so the bf16 outputs are equal."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.kernels import stripe_grad

    samps = LITE_GEOMETRIES[geom]
    C = len(samps)
    h_pad = L + row0 if h_pad is None else h_pad
    h_true, w_true = ext or (h_pad, W)
    f, d = _rand_state(rng, (C, L, W))
    devqs = [torch.as_tensor(rng.normal(0, 0.1, (L // sy, W // sx)).astype(
        np.float32), device=DEVICE).to(torch.bfloat16)
        for (sy, sx), p in zip(samps, prob) if p]
    halos = None
    if halo:
        (ft, dt), (fb, db) = (_rand_state(rng, (C, 2, W)) for _ in range(2))
        halos = (ft, fb, dt, db)
    pa_ss = [10.0 * sy * sx if p else 0.0 for (sy, sx), p in zip(samps, prob)]
    extents = (torch.tensor([h_true, w_true], dtype=torch.int32,
                            device=DEVICE) if dynamic else None)
    args = (f, d, devqs, halos, 0.37, row0, weight, samps, pa_ss, h_pad,
            h_true, w_true, extents)
    got = stripe_grad.fused_grad_striped_lite(*args)
    ref = stripe_grad.fused_grad_striped_lite_plain(*args)
    torch.cuda.synchronize()
    label = (f"K4 {geom} {L}x{W} row0={row0} of {h_pad} true {h_true}x"
             f"{w_true} w={weight} prob={prob} halo={halo} dyn={dynamic}")
    floor = 1e-5 * max(1.0, float(ref[0].float().abs().max()))
    err = bf16_gate(label, "grad", got[0], ref[0], floor)
    if not any(prob):
        require(bool(torch.equal(got[0], ref[0])),
                f"{label}: bf16 gradients differ without a prob term")
    for name, a, b in (("sumsq", got[1], ref[1]), ("tv", got[2], ref[2]),
                       ("tv2", got[3], ref[3])):
        _rel_gate(label, name, a, b, 1e-5)
    log(f"  {label}: grad err {err:.3g}, sums ok")
    return err


def _k5_problem(rng, H, W, samps, prob, gap_rows=0, pad=None):
    """K5's inputs: f ~ N(0, 50), d ~ N(0, 2) and g ~ N(0, 1) (bf16),
    small step scales, boxes centred on fmid's own coefficients with a
    +-2-step jitter (some bind); `gap_rows` coefficient rows of channel 0
    a region gap (FREE quant, data 0); `pad` = (h, w): the canvas beyond
    it frozen padding (q == 0, data 0, a zero state)."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.kernels.project_step import FREE_Q
    from jpeg2png_tpu_torch.ops.dct_raster import sampled_dct

    C = len(samps)
    f, d = _rand_state(rng, (C, H, W))
    g = torch.as_tensor(rng.normal(0, 1, (C, H, W)).astype(np.float32),
                        device=DEVICE).to(torch.bfloat16)
    if pad is not None:
        for t in (f, d, g):
            t[:, pad[0]:] = 0
            t[:, :, pad[1]:] = 0
    scales = torch.as_tensor(rng.uniform(0.01, 0.05, C).astype(np.float32),
                             device=DEVICE)
    factor = 0.41
    datas, qs = [], []
    for c, (sy, sx) in enumerate(samps):
        hc, wc = H // sy, W // sx
        q = torch.as_tensor(np.tile(rng.integers(1, 60, (8, 8)).astype(
            np.float32), (hc // 8, wc // 8)), device=DEVICE)
        fmid = f[c] + factor * d[c].float() - scales[c] * g[c].float()
        jitter = torch.as_tensor(rng.integers(-2, 3, (hc, wc)),
                                 device=DEVICE, dtype=torch.float32)
        data = torch.clamp(torch.round(sampled_dct(fmid, sy, sx) / q)
                           + jitter, -2000, 2000)
        if c == 0 and gap_rows:
            q[-gap_rows:] = FREE_Q
            data[-gap_rows:] = 0
        if pad is not None:
            q[pad[0] // sy:] = 0
            q[:, pad[1] // sx:] = 0
            data[pad[0] // sy:] = 0
            data[:, pad[1] // sx:] = 0
        datas.append(data.to(torch.int16))
        qs.append(q)
    pa_ss = [0.36 * sy * sx if p else 0.0 for (sy, sx), p in zip(samps, prob)]
    return (f, d, g, factor, scales, datas, qs, pa_ss, samps)


def _coef_mag(datas, qs) -> float:
    """max |data * q| + max q over the constrained coefficients."""
    import torch

    return max(float((d.to(torch.float32) * torch.where(q < 2.0 ** 39, q, 0))
                     .abs().max() + q[q < 2.0 ** 39].max())
               for d, q in zip(datas, qs))


def _k5_case(rng, geom, H, W, prob, gap_rows=0, pad=None):
    """K5 against its plain version: fnew to K2's gate (1e-5 of its
    magnitude: the transforms sum in another order, with fused
    multiply-adds); dnew = bf16(fnew - f) within one bf16 step plus that
    gate; devq within one bf16 step plus K3's coefficient gate (2e-6 of
    the coefficients' magnitude, q >= 1); distances rtol 1e-5.  Frozen
    padding must stay exactly 0 in fnew, dnew and devq."""
    import torch

    from jpeg2png_tpu_torch.kernels import project_step

    samps = LITE_GEOMETRIES[geom]
    args = _k5_problem(rng, H, W, samps, prob, gap_rows, pad)
    got = project_step.fused_project_multi_lite(*args)
    ref = project_step.fused_project_multi_lite_plain(*args)
    torch.cuda.synchronize()
    label = (f"K5 {geom} {H}x{W} prob={prob} gap_rows={gap_rows} "
             f"pad={pad}")
    f_err = max_err(got[0], ref[0])
    f_tol = 1e-5 * float(ref[0].abs().max())
    require(f_err <= f_tol, f"{label} fnew: {f_err} > {f_tol}")
    d_err = bf16_gate(label, "dnew", got[1], ref[1], f_tol)
    q_err = 0.0
    d_tol = 2e-6 * _coef_mag(args[5], args[6])
    for c, p in enumerate(prob):
        if not p:
            require(got[2][c] is None and float(got[3][c]) == 0.0,
                    f"{label} channel {c}: prob off but devq/dist set")
            continue
        q_err = max(q_err, bf16_gate(label, f"devq c{c}", got[2][c],
                                     ref[2][c], d_tol))
        _rel_gate(label, f"dist c{c}", got[3][c], ref[3][c], 1e-5)
    if pad is not None:
        h, w = pad
        for t in (got[0], got[1]):
            require(not t[:, h:].any() and not t[:, :, w:].any(),
                    f"{label}: padding is not 0")
        for dq, (sy, sx) in zip(got[2], samps):
            if dq is not None:
                require(not dq[h // sy:].any() and not dq[:, w // sx:].any(),
                        f"{label}: devq padding is not 0")
    log(f"  {label}: fnew err {f_err:.3g} (tol {f_tol:.3g}), dnew err "
        f"{d_err:.3g}, devq err {q_err:.3g}, dists ok")
    return f_err


def _k3_lite_compare(label, args, extents=None):
    """K3's lite mode against its plain version, one iteration at a time
    from the kernel's own state.  The kernel runs launches of 1..n
    iterations from the same start (a launch of k iterations is the
    first k of the n-iteration one: the state is all in device memory);
    iteration k of the kernel is then held against the plain version's
    single iteration from the kernel's state after k - 1, elementwise,
    with its partials row.  So every iteration of a multi-iteration
    launch is held to one iteration's tolerance, and bf16 rounding that
    flips the other way on the two sides does not compound.

    Tolerances of one iteration: the f32 part as K3's (f 1e-5 of its
    magnitude, devq 2e-6 of the coefficients' magnitude, sums rtol 1e-5,
    distances rtol 1e-4); a gradient element whose f32 values on the two
    sides straddle a bf16 rounding boundary is stored one bf16 step
    apart, which moves fmid, and so fnew, by at most scale_c * |g| * 2^-7
    (the projection is non-expansive), the bound `flip` below; d and
    devq are rounded from those values (one bf16 step plus the error
    they carried).  The iterates must then move 100x the f tolerance
    between iteration 1 and the last.  Bucket padding stays exactly 0."""
    import torch

    from jpeg2png_tpu_torch.kernels import iter_step, stripe_grad

    f0, d0, dq0, factors = args[0], args[1], list(args[2]), args[3]
    rest = args[4:]
    step, samps, pa_ss, weight = args[4], args[8], args[7], args[9]
    n = len(factors)
    C = len(samps)
    kw = {} if extents is None else {"extents": extents}
    runs = [iter_step.fused_solve_lite(f0, d0, dq0, factors[:k], *rest, **kw)
            for k in range(1, n + 1)]
    torch.cuda.synchronize()
    coef_mag = _coef_mag(args[5], args[6])
    worst, state = 0.0, (f0, d0, dq0)
    f_tol = 0.0
    for k in range(n):
        got = runs[k]
        for t in (got[0], got[1], got[3], *got[2]):
            require(bool(torch.isfinite(t.float()).all()),
                    f"K3 lite {label}: non-finite")
        ref = iter_step.fused_solve_lite_plain(
            *state, factors[k:k + 1], *rest, **kw)
        # the flip bound from this iteration's own gradient
        fs, ds, dqs = state
        flip = 0.0
        steps = (torch.as_tensor(step).reshape(-1).tolist()
                 if extents is not None else [float(step)])
        for b in range(fs.shape[0] if extents is not None else 1):
            sel = (lambda t: t[b]) if extents is not None else (lambda t: t)
            h, w = ((int(extents[b, 0]), int(extents[b, 1]))
                    if extents is not None else fs.shape[-2:])
            g, sumsq, _, _ = stripe_grad.fused_grad_striped_lite_plain(
                sel(fs), sel(ds), [sel(x) for x in dqs], None,
                float(factors[k]), 0, weight, samps, pa_ss, fs.shape[-2], h,
                w)
            scale = torch.where(sumsq == 0, 0.0, steps[b] / torch.sqrt(sumsq))
            flip = max(flip, float((scale[:, None, None] * g.float().abs())
                                   .max()) * 2.0 ** -7)
        f_tol = 1e-5 * float(ref[0].abs().max()) + flip
        f_err = max_err(got[0], ref[0])
        require(f_err <= f_tol, f"K3 lite {label} iteration {k + 1}: f err "
                                f"{f_err} > {f_tol}")
        bf16_gate(f"K3 lite {label} iteration {k + 1}", "d", got[1], ref[1],
                  f_tol)
        for x, y in zip(got[2], ref[2]):
            bf16_gate(f"K3 lite {label} iteration {k + 1}", "devq", x, y,
                      2e-6 * coef_mag + flip)
        row_got = runs[-1][3][..., k, :]
        row_ref = ref[3][..., 0, :]
        zero = row_ref == 0
        require(bool((row_got[zero] == 0).all()),
                f"K3 lite {label}: zero columns")
        rel = torch.where(zero, 0.0, (row_got - row_ref).abs()
                          / row_ref.abs().clamp_min(1e-30))
        require(float(rel[..., :C + 2].max()) <= 1e-5,
                f"K3 lite {label} row {k}: sums rel "
                f"{float(rel[..., :C + 2].max())}")
        require(float(rel[..., C + 2:].max()) <= 1e-4,
                f"K3 lite {label} row {k}: distances rel "
                f"{float(rel[..., C + 2:].max())}")
        worst = max(worst, f_err)
        state = (got[0], got[1], list(got[2]))
    if n > 1:
        moved = max_err(runs[-1][0], runs[0][0])
        require(moved > 100 * f_tol,
                f"K3 lite {label}: iterations 2-{n} moved f {moved:.3g}, "
                f"under 100x the tolerance {f_tol:.3g}")
    if extents is not None:
        prob_cs = [c for c, pa in enumerate(pa_ss) if pa != 0.0]
        got = runs[-1]
        for b, (h, w) in enumerate(extents.cpu().tolist()):
            for t in (got[0][b], got[1][b]):
                require(not t[:, h:].any() and not t[:, :, w:].any(),
                        f"K3 lite {label}: image {b} padding is not 0")
            for dq, c in zip(got[2], prob_cs):
                sy, sx = samps[c]
                require(not dq[b, h // sy:].any()
                        and not dq[b, :, w // sx:].any(),
                        f"K3 lite {label}: image {b} devq padding")
    log(f"  K3 lite {label}: f err {worst:.3g} (last tol {f_tol:.3g})"
        + (f", moved {moved:.3g} after iteration 1" if n > 1 else ""))
    return worst


def _k3_lite_random_case(rng, label, B, H, W, samps, prob, weight, nsteps,
                         exts=None, gap_rows=0):
    """_k3_random_case's data in the lite state (d = bf16(f - fista),
    devq bf16), through K3's lite mode."""
    import torch

    a, ext, where = _k3_random_args(rng, B, H, W, samps, prob, weight,
                                    nsteps, exts, gap_rows)
    lite = (a[0], (a[0] - a[1]).to(torch.bfloat16),
            [x.to(torch.bfloat16) for x in a[2]]) + tuple(a[3:])
    return _k3_lite_compare(f"random {label} {where} n={nsteps}", lite,
                            extents=ext)


def k4_edge_cases(rng):
    """The CPU mirror of K4's grid (stripe_grad.lite_partial_rows) against
    the library's, then K4 where its row-marching grid and its prob
    windows have edges: 3 strips with a ragged last one (W = 512, 4:2:0;
    W = 520, 4:4:0, where the last strip holds one coefficient block), 4:1:1
    at W = 1024 (strip edges inside 32-column blocks), heights over many
    segments whose boundaries fall inside a block row of the sy = 2
    channels, dynamic extents that end on and past a strip boundary, and
    the striped lite body's band [3, 2048, 12288] with random halos at
    row0 = 2048, with and without a prob term."""
    from jpeg2png_tpu_torch.kernels import stripe_grad

    lib, _ = stripe_grad._launcher()
    slots = lib.j2p_grad_lite_partial_rows(3, 1, 1 << 24, 8)
    for L, W in ((2048, 3072), (2048, 12288), (1504, 512), (64, 520),
                 (8, 8)):
        rows = lib.j2p_grad_lite_partial_rows(3, 1, L, W)
        mirror = stripe_grad.lite_partial_rows(L, W, slots)
        require(rows == mirror, f"K4 grid of {L}x{W}: the library's {rows} "
                f"partial rows, the mirror's {mirror}")
    # the 1504-row cases start segments inside a block row of sy = 2
    seg = stripe_grad.lite_segment_rows(3, True, 1504, 512)
    require(seg < 1504 and seg % 16 != 0,
            f"K4 edge cases: 1504 x 512 segments of {seg} rows start on "
            "16-row block rows only")
    return [
        _k4_case(rng, "4:2:0", [True] * 3, 0.3, 64, 512),
        _k4_case(rng, "4:4:0", [True, False, True], 0.3, 64, 520,
                 ext=(60, 515)),
        _k4_case(rng, "4:4:0", [False] * 3, 0.3, 64, 520, row0=64,
                 h_pad=192, halo=True),
        _k4_case(rng, "4:1:1", [True] * 3, 0.3, 64, 1024, row0=64,
                 h_pad=256, halo=True),
        _k4_case(rng, "4:1:1", [False] * 3, 0.5, 64, 1024),
        _k4_case(rng, "4:2:0", [True] * 3, 0.3, 1504, 512),
        _k4_case(rng, "4:2:0", [False] * 3, 0.3, 1504, 512, ext=(1500, 510)),
        _k4_case(rng, "4:2:0", [True] * 3, 0.3, 128, 512, ext=(120, 254),
                 dynamic=True),
        _k4_case(rng, "4:2:0", [True, False, True], 0.3, 128, 512,
                 ext=(128, 300), dynamic=True),
        _k4_case(rng, "4:2:0", [True] * 3, 0.3, 2048, 12288, row0=2048,
                 h_pad=8192, halo=True),
        _k4_case(rng, "4:2:0", [False] * 3, 0.3, 2048, 12288, row0=2048,
                 h_pad=8192, halo=True),
    ]


def lite_kernel_cases(rng, bucket, exts):
    """K4, K5 and K3's lite mode against their plain versions: the
    geometries of the two-lite tier and of serving, odd ones, and the
    3072x2048 canvas.  Returns the max abs errors (K4 grad, K5 fnew, K3
    lite f)."""
    k4 = [
        _k4_case(rng, "4:2:0", [True] * 3, 0.3, 2048, 3072),
        _k4_case(rng, "4:2:0", [False] * 3, 0.0, 2048, 3072),
        _k4_case(rng, "4:2:0", [True] * 3, 0.3, 128, 256, row0=64,
                 h_pad=320, ext=(300, 250), halo=True),
        _k4_case(rng, "4:2:0", [True, True, False], 0.3, 128, 256, row0=128,
                 h_pad=256, ext=(200, 200), halo=True, dynamic=True),
        _k4_case(rng, "4:2:2", [False] * 3, 0.5, 64, 192, row0=32,
                 h_pad=128, halo=True),
        _k4_case(rng, "4:4:0", [True, False, True], 0.3, 96, 120,
                 ext=(90, 111)),
        _k4_case(rng, "4:1:1", [True] * 3, 0.3, 48, 128, row0=16, h_pad=64,
                 ext=(60, 128), halo=True, dynamic=True),
        _k4_case(rng, "4:4:4", [True] * 3, 0.3, 40, 72),
        _k4_case(rng, "C=1", [True], 0.0, 40, 56, row0=8, h_pad=64,
                 ext=(57, 50), halo=True),
    ] + k4_edge_cases(rng)
    k5 = [
        _k5_case(rng, "4:2:0", 2048, 3072, [True] * 3),
        _k5_case(rng, "4:2:0", 2048, 3072, [False] * 3),
        _k5_case(rng, "4:2:0", 64, 112, [True, True, False], gap_rows=8),
        _k5_case(rng, "4:2:0", 96, 128, [True] * 3, pad=(64, 80)),
        _k5_case(rng, "4:2:2", 48, 96, [True] * 3, pad=(32, 64)),
        _k5_case(rng, "4:4:0", 48, 80, [True, False, True]),
        _k5_case(rng, "4:1:1", 40, 128, [True] * 3, gap_rows=16),
        _k5_case(rng, "4:4:4", 40, 64, [True] * 3),
        _k5_case(rng, "C=1", 40, 64, [True]),
    ]
    s420 = S420
    k3 = [
        _k3_lite_random_case(rng, "4:2:0", len(exts), *bucket, s420,
                             [True] * 3, 0.3, 3, exts=exts),
        _k3_lite_random_case(rng, "4:2:0", 1, 2048, 3072, s420, [True] * 3,
                             0.3, 3),
        _k3_lite_random_case(rng, "4:2:0 gap", 1, 64, 96, s420, [True] * 3,
                             0.3, 3, gap_rows=16),
        _k3_lite_random_case(rng, "4:1:1 prob off", 1, 48, 128,
                             LITE_GEOMETRIES["4:1:1"], [True, False, True],
                             0.5, 3),
        _k3_lite_random_case(rng, "4:2:0", 2, 128, 128, s420, [True] * 3,
                             0.3, 3, exts=[(96, 112), (128, 80)]),
        _k3_lite_random_case(rng, "4:2:2", 1, 80, 96,
                             LITE_GEOMETRIES["4:2:2"], [True] * 3, 0.3, 3),
        _k3_lite_random_case(rng, "4:4:0", 1, 96, 120,
                             LITE_GEOMETRIES["4:4:0"], [True] * 3, 0.3, 3),
        _k3_lite_random_case(rng, "C=1 weight 0", 1, 40, 56, [(1, 1)],
                             [True], 0.0, 3),
    ]
    return max(k4), max(k5), max(k3)


def _csv_rows(path: pathlib.Path, channel: int = 3):
    import numpy as np

    with open(path) as f:
        rows = [r for r in csv.DictReader(f) if int(r["channel"]) == channel]
    return np.array([[float(r[k]) for k in
                      ("objective", "prob_dist", "tv", "tv2")] for r in rows])


TIERS = ("mega", "mega-lite", "two-lite", "two")


@contextlib.contextmanager
def gates(mega: int, mega_lite: int, two_lite: int):
    """Set solver.tier_rule's size gates for a serving run that sends
    buckets to every class (the CLI has no tier flag; single-image runs
    force a tier with tier= instead)."""
    from jpeg2png_tpu_torch.models import solver

    names = ("MEGA_MAX_PIXELS", "MEGA_LITE_MAX_PIXELS", "TWO_LITE_MAX_PIXELS")
    saved = [getattr(solver, n) for n in names]
    for n, v in zip(names, (mega, mega_lite, two_lite)):
        setattr(solver, n, v)
    try:
        yield
    finally:
        for n, v in zip(names, saved):
            setattr(solver, n, v)


def tier_launches(tier: str, n: int) -> dict:
    """The launch counts of `n` solver steps on `tier`: n iterations on
    the two-kernel tiers (one launch of each kernel per iteration), n
    launches of K3 on the mega tiers."""
    kernels = {"two": ("fused_grad", "fused_project_multi"),
               "mega": ("fused_solve",), "mega-lite": ("fused_solve_lite",),
               "two-lite": ("fused_grad_striped_lite",
                            "fused_project_multi_lite")}[tier]
    return {fn.__name__: n if fn.__name__ in kernels else 0
            for fn in _counters()}


def _expect(counts: dict, want: dict, what: str):
    require(counts == want, f"{what}: launches {counts}, expected {want}")


def phase_goldens():
    """Three goldens at -i 50 and the photo512 -i 5 CSV through every
    tier, forced with the pipeline's tier= (what cli.main runs)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from pngdec import decode_png

    from jpeg2png_tpu_torch.pipeline import decode_file
    from jpeg2png_tpu_torch.utils.config import SolverConfig
    from jpeg2png_tpu_torch.utils.logger import ConvergenceLogger

    cfg = SolverConfig()
    for tier in TIERS:
        zero_counts()
        for name in GOLDENS:
            out = OUT_DIR / f"{name}_i50_{tier}.png"
            decode_file(str(FIXTURES / f"{name}.jpg"), str(out), cfg,
                        device=DEVICE, tier=tier)
            gold = decode_png((FIXTURES / "golden" / f"{name}_i50.png")
                              .read_bytes())
            p = psnr(read_own_png(out), gold)
            log(f"  golden {name} i50 ({tier} tier): PSNR {p:.2f} dB")
            require(p > 45.0, f"golden {name} ({tier}): PSNR {p:.2f} dB")

        name = "photo512_q10_420"
        log_path = OUT_DIR / f"{name}_i5_{tier}.csv"
        with open(log_path, "w") as f:
            decode_file(str(FIXTURES / f"{name}.jpg"),
                        str(OUT_DIR / f"{name}_i5_{tier}.png"),
                        SolverConfig(iterations=(5,) * 3),
                        logger=ConvergenceLogger(f), device=DEVICE, tier=tier)
        ours = _csv_rows(log_path)[:2]
        gold = _csv_rows(FIXTURES / "golden" / f"{name}_i5.csv")[:2]
        # the reference CSV gate of tests/test_e2e.py before the chaos point
        for col, rtol, atol in METRIC_GATES:
            ok = np.allclose(ours[:, col], gold[:, col], rtol=rtol, atol=atol)
            require(ok, f"{name} CSV column {col} ({tier}): {ours[:, col]} "
                        f"vs {gold[:, col]}")
        log(f"  golden {name} i5 CSV rows 0-1 agree (rtol 6e-3, {tier} tier)")
        # 3 one-shot decodes, then -i 5 with a CSV: 5 one-iteration chunks
        mega = tier.startswith("mega")
        _expect(read_counts(),
                tier_launches(tier, 3 + 5 if mega else 3 * 50 + 5),
                f"goldens ({tier} tier)")

    # the converged golden (-i 1000) through the whole-solve tiers
    converged = {}
    for tier in ("mega", "mega-lite"):
        zero_counts()
        p = converged[tier] = golden_i1000(tier)
        _expect(read_counts(), tier_launches(tier, 1),
                f"photo512 -i 1000 ({tier} tier)")
        log(f"  golden photo512_q10_420 i1000 ({tier} tier): PSNR {p:.2f} dB "
            f"(gate {GOLDEN_I1000_DB[tier]} dB)")
        require(p > GOLDEN_I1000_DB[tier],
                f"golden photo512 i1000 ({tier}): PSNR {p:.2f} dB")

    # -s with per-channel triples through the pipeline, every tier: each
    # channel's CSV rows and the PNG, tests/test_e2e.py's gates
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.pipeline import smooth_decode

    img = read_jpeg(FIXTURES / f"{STRIPLE}.jpg")
    gold_png = decode_png(
        (FIXTURES / "golden" / f"{STRIPLE}_striple_i543.png").read_bytes())
    golden = [_csv_rows(FIXTURES / "golden" / f"{STRIPLE}_striple_i543.csv",
                        c) for c in range(3)]
    triples = SolverConfig(weights=(0.5, 0.2, 0.1),
                           pweights=(0.002, 0.001, 0.0005),
                           iterations=(5, 4, 3), separate_components=True)
    striple = {}
    for tier in TIERS:
        zero_counts()
        result = smooth_decode(img, triples, device=DEVICE, tier=tier)
        # one solve per channel, one-shot: 5 + 4 + 3 iterations
        _expect(read_counts(), tier_launches(
            tier, 3 if tier.startswith("mega") else 12),
            f"-s triples ({tier} tier)")
        for c in range(3):
            ours = result.metrics_per_channel[c]
            require(ours.shape == golden[c].shape,
                    f"-s triples channel {c} ({tier}): {ours.shape} rows")
            for col, rtol, atol in METRIC_GATES:
                require(np.allclose(ours[:, col], golden[c][:, col],
                                    rtol=rtol, atol=atol),
                        f"-s triples channel {c} column {col} ({tier}): "
                        f"{ours[:, col]} vs {golden[c][:, col]}")
        p = striple[tier] = psnr(result.pixels, gold_png)
        log(f"  golden {STRIPLE} -s -w 0.5,0.2,0.1 -p 0.002,0.001,0.0005 "
            f"-i 5,4,3 ({tier} tier): every channel's CSV rows agree (rtol "
            f"6e-3), PSNR {p:.2f} dB")
        require(p > 45.0, f"-s triples ({tier}): PSNR {p:.2f} dB")
    return converged, striple


def _grad_split(fn, a, reps=20):
    """Device ms per launch of the K1 / K7 wrapper's two kernels, the
    gradient kernel and the fixed-order reduction of its partial sums,
    from torch.profiler's device times per kernel (None: not measured, the
    profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    saved_n = getattr(fn, "launches", 0)
    fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*a)
        torch.cuda.synchronize()
    if hasattr(fn, "launches"):
        fn.launches = saved_n     # timing launches are not path ones
    split = {}
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        for key in ("grad_kernel", "reduce_columns"):
            if key in evt.key:
                split[key] = split.get(key, 0.0) + t / 1e3 / reps
    return split if split.get("grad_kernel") else None


def _split_msg(name, split, card):
    if split is None:
        return f"  {name} split: not measured (no device time recorded)"
    return (f"  {name} split (torch.profiler): gradient kernel "
            f"{split['grad_kernel']:.4f} ms, reduction "
            f"{split.get('reduce_columns', 0.0):.4f} ms per launch  [{card}]")


def _record(name, src, replaces, launches, err, ms, plain_ms, nbytes, ops):
    bound, by = bound_ms(nbytes, ops)
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by,
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
    """Per-iteration cost of every tier at 0.26, 1.23, 3.15, 6.29 and
    8.0 MP (50-iteration solves, warm; the tiers in order, then
    reversed; the better of each tier's two runs): the numbers behind
    solver.tier_rule's gates."""
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.models import solver

    sweep = []
    for path in (FIXTURES / "photo512_q10_420.jpg", *MID_JPEGS, SMOKE_JPEG,
                 BIG_JPEG):
        img = read_jpeg(path)
        for tier in TIERS:
            _solve_ms(img, tier)                      # warm
        runs = {t: [] for t in TIERS}
        for tier in TIERS + TIERS[::-1]:
            runs[tier].append(_solve_ms(img, tier))
        mp = img.height * img.width / 1e6
        row = {"image": path.name, "mp": mp, "runs_ms": runs}
        row.update({f"{t}_ms_per_iter": min(v) / 50 for t, v in runs.items()})
        # the gates' policy: the fastest f32 tier, unless a lite tier beats
        # it by solver.LITE_MIN_GAIN; beside the tier the rule gives
        per = {t: row[f"{t}_ms_per_iter"] for t in TIERS}
        f32 = min(("mega", "two"), key=per.get)
        lite = min(("mega-lite", "two-lite"), key=per.get)
        row["policy_pick"] = (lite if per[lite] <= (1 - solver.LITE_MIN_GAIN)
                              * per[f32] else f32)
        geoms = solver._geometry(*_args(img)[::2])
        row["rule_pick"] = solver.active_tier(geoms)
        sweep.append(row)
        log(f"  tiers at {path.name} ({mp:.2f} MP), ms per iteration: "
            + ", ".join(f"{t} {per[t]:.4f}" for t in TIERS)
            + f"; fastest by the gates' policy {row['policy_pick']}, the "
            f"rule gives {row['rule_pick']}  [{card}]")
    return sweep


def _patched_plain(module):
    """Point the kernel names `module` holds (the solver's, the striped
    solver's) at the plain versions (and back)."""
    from jpeg2png_tpu_torch.kernels import (grad_step, iter_step,
                                            project_step, stripe_grad)

    names = {"fused_grad": grad_step.fused_grad_plain,
             "fused_project_multi": project_step.fused_project_multi_plain,
             "fused_solve": iter_step.fused_solve_plain,
             "fused_solve_lite": iter_step.fused_solve_lite_plain,
             "fused_grad_striped_lite":
                 stripe_grad.fused_grad_striped_lite_plain,
             "fused_project_multi_lite":
                 project_step.fused_project_multi_lite_plain,
             "fused_grad_striped": stripe_grad.fused_grad_striped_plain,
             "fused_project": project_step.fused_project_plain}
    names = {n: fn for n, fn in names.items() if hasattr(module, n)}

    @contextlib.contextmanager
    def cm():
        saved = {n: getattr(module, n) for n in names}
        for n, fn in names.items():
            setattr(module, n, fn)
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)
    return cm()


def phase_main_path(card: str, errs):
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.cli import main as cli_main
    from jpeg2png_tpu_torch.io import encode_png, read_jpeg
    from jpeg2png_tpu_torch.kernels import (grad_step, iter_step,
                                            project_step, stripe_grad)
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.ops.color import ycbcr_to_rgb_packed
    from jpeg2png_tpu_torch.pipeline import decode_file
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    img = read_jpeg(SMOKE_JPEG)
    datas, quants, samps = _args(img)
    geoms = solver._geometry(datas, samps)
    tier0 = solver.active_tier(geoms)
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
    steps = {t: 1 if t.startswith("mega") else 50 for t in TIERS}
    _expect(launches, tier_launches(tier0, steps[tier0]),
            f"3072x2048 CLI decode ({tier0} tier)")
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

    # the same decode through the pipeline, forced to the two-lite tier
    out_lite = OUT_DIR / "torch_smoke_art3072x2048_two_lite.png"
    zero_counts()
    t0 = time.perf_counter()
    decode_file(str(SMOKE_JPEG), str(out_lite), SolverConfig(),
                device=DEVICE, tier="two-lite")
    torch.cuda.synchronize()
    lite_s = time.perf_counter() - t0
    counts = {"two-lite decode": read_counts()}
    _expect(counts["two-lite decode"], tier_launches("two-lite", 50),
            "3072x2048 decode forced to two-lite")
    log(f"  decode forced to two-lite: {lite_s:.3f} s; launches "
        f"{counts['two-lite decode']}")

    # every tier, forced, on the same solve
    args = (datas, quants, samps, 0.3, [0.001] * 3, 50)
    fdata = {}
    for tier in TIERS:
        zero_counts()
        fd, metrics = solver.solve_joint(*args, device=DEVICE, tier=tier)
        torch.cuda.synchronize()
        counts[tier] = read_counts()
        _expect(counts[tier], tier_launches(tier, steps[tier]),
                f"3072x2048 solve forced to {tier}")
        require(bool(torch.isfinite(fd).all()) and np.isfinite(metrics).all(),
                f"non-finite solver output ({tier})")
        fdata[tier] = fd

    def pack(f):
        h, w = img.height, img.width
        return ycbcr_to_rgb_packed(f[0][:h, :w] + 128.0, f[1][:h, :w],
                                   f[2][:h, :w])
    two = pack(fdata["two"])
    p_tiers = {t: psnr(pack(fdata[t]), two) for t in TIERS if t != "two"}
    p_tiers["two-lite decode"] = psnr(read_own_png(out_lite), two)
    for t, p in p_tiers.items():
        log(f"  {t} vs two tier (50 iterations): PSNR {p:.2f} dB")
        require(p > 45.0, f"{t} vs two tier PSNR {p:.2f} <= 45 dB")

    # kernel path vs plain path on the card, whole solve, each tier
    p_plain = {}
    with _patched_plain(solver):
        for tier in TIERS:
            fd_plain, _ = solver.solve_joint(*args, device=DEVICE, tier=tier)
            p_plain[tier] = psnr(pack(fdata[tier]), pack(fd_plain))
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
    H, W = prob.H, prob.W
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
    _, _, lcarry = solver.solve_steps(*args, nsteps=3, device=DEVICE,
                                      tier="two-lite")
    k3l_args = (lcarry[0], lcarry[1], list(lcarry[2])) + k3_args[3:]
    k4_args = (lcarry[0], lcarry[1], list(lcarry[2]), None, 0.5, 0, 0.3,
               prob.samps, prob.pa_sss, H, H, W)
    lgrads, lsumsq, _, _ = stripe_grad.fused_grad_striped_lite(*k4_args)
    lscale = torch.where(lsumsq == 0, 0.0,
                         prob.step_size / torch.sqrt(lsumsq))
    k5_args = (lcarry[0], lcarry[1], lgrads, 0.5, lscale, prob.dats_c,
               prob.qs_c, prob.pa_sss, prob.samps)
    C = 3
    costs = kernel_cost_table(C, H, W, prob.samps, nsteps=50)
    bounds = {name: (costs[k]["bytes"], costs[k]["ops"]) for name, k in (
        ("fused_grad", "K1"), ("fused_project_multi", "K2"),
        ("fused_solve", "K3"), ("fused_solve_lite", "K3 lite"),
        ("fused_grad_striped_lite", "K4"), ("fused_project_multi_lite", "K5"))}
    timed = {}
    for name, fn, plain, a, reps, plain_reps in (
            ("fused_grad", grad_step.fused_grad, grad_step.fused_grad_plain,
             k1_args, 20, 5),
            ("fused_project_multi", project_step.fused_project_multi,
             project_step.fused_project_multi_plain, k2_args, 20, 5),
            ("fused_solve", iter_step.fused_solve,
             iter_step.fused_solve_plain, k3_args, 5, 1),
            ("fused_solve_lite", iter_step.fused_solve_lite,
             iter_step.fused_solve_lite_plain, k3l_args, 5, 1),
            ("fused_grad_striped_lite", stripe_grad.fused_grad_striped_lite,
             stripe_grad.fused_grad_striped_lite_plain, k4_args, 20, 5),
            ("fused_project_multi_lite",
             project_step.fused_project_multi_lite,
             project_step.fused_project_multi_lite_plain, k5_args, 20, 5)):
        saved_n = fn.launches
        ms = cuda_ms(lambda: fn(*a), reps)
        fn.launches = saved_n         # timing launches are not path ones
        timed[name] = (ms, cuda_ms(lambda: plain(*a), plain_reps))
    k1_split = _grad_split(grad_step.fused_grad, k1_args)
    log(_split_msg("fused_grad", k1_split, card))
    sources = {
        "fused_grad": ("grad_step.cu", "grad_step.py:388"),
        "fused_project_multi": ("project_step.cu", "project_step.py:528"),
        "fused_solve": ("iter_step.cu", "iter_step.py:602"),
        # the lite mode of the same kernel (lite=True, :664-670, :758-761)
        "fused_solve_lite": ("iter_step.cu", "iter_step.py:602"),
        "fused_grad_striped_lite": ("stripe_grad.cu", "stripe_grad.py:672"),
        "fused_project_multi_lite": ("project_lite.cu",
                                     "project_step.py:883"),
    }
    path_launches = {
        "fused_grad": counts["two"]["fused_grad"],
        "fused_project_multi": counts["two"]["fused_project_multi"],
        "fused_solve": None, "fused_solve_lite": None,     # from serving
        "fused_grad_striped_lite":
            counts["two-lite decode"]["fused_grad_striped_lite"],
        "fused_project_multi_lite":
            counts["two-lite decode"]["fused_project_multi_lite"],
    }
    records = [
        _record(name, f"jpeg2png_tpu_torch/csrc/{src}",
                f"jpeg2png_tpu/kernels/{rep}", path_launches[name],
                errs[name], *timed[name], *bounds[name])
        for name, (src, rep) in sources.items()]
    for r in records:
        log(f"  {r['name']}: {r['ms']:.4f} ms median (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms  [{card}]")
    coefs = sum(H // sy * (W // sx) for sy, sx in prob.samps)
    for name, per_px in (("fused_solve", 32), ("fused_solve_lite", 22)):
        ms = timed[name][0]
        stream = (per_px * C * H * W + (14 if per_px == 32 else 10) * coefs)
        log(f"  {name}: {ms / 50:.4f} ms per iteration (50 per launch at "
            f"{H}x{W}); streaming the state through device memory each "
            f"iteration would take {stream / PEAK_BYTES * 1e3:.4f} ms")
    return records, {"tier": tier0, "launches": counts,
                     "total_s": total_s, "two_lite_decode_s": lite_s,
                     "setup_ms": setup_ms, "jpeg_read_s": read_s,
                     "k1_split_ms": k1_split,
                     "png_encode_s": png_s,
                     "psnr_vs_two": {t: p if math.isfinite(p) else None
                                     for t, p in p_tiers.items()},
                     "psnr_kernel_vs_plain": {
                         t: p if math.isfinite(p) else None
                         for t, p in p_plain.items()}}


def _serve(label, card, files, images, refs):
    """One cli.main --tpu-batch run on the corpus: the launch counts of
    each kernel against the runner's plan (dyn buckets: K3 per image
    chunk, f32 or lite by their tier; dyn2 images: 50 K4 + K5; exact
    images: 50 K1 + K2), every PNG > 45 dB against the file's two-tier
    decode."""
    import torch

    from jpeg2png_tpu_torch.cli import main as cli_main

    out_dir = OUT_DIR / f"serving_{label}"
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = [out_dir / (pathlib.Path(f).stem + ".png") for f in files]
    for o in outs:
        o.unlink(missing_ok=True)
    want, images_by_tier = _plan_launches(images)
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
    log(f"  serving ({label}): {len(files)} files, {wall_s:.3f} s wall; "
        f"images per tier {images_by_tier}; launches {launches}")
    _expect(launches, want, f"serving ({label})")
    require(stats["k3_dispatches"] == want["fused_solve"]
            and stats["k3_lite_dispatches"] == want["fused_solve_lite"]
            and stats["bucket_tiers"] == images_by_tier,
            f"serving ({label}) stats {stats} disagree with the plan")
    worst = math.inf
    for ref, o in zip(refs, outs):
        p = psnr(read_own_png(o), ref)
        require(p > 45.0, f"serving ({label}) {o.name}: PSNR {p:.2f} <= 45")
        worst = min(worst, p)
    mp = sum(im.height * im.width for im in images) / 1e6
    summary = {
        "files": len(files), "wall_s": wall_s,
        "files_per_s": len(files) / wall_s,
        "mp_iter_per_s": mp * 50 / stats["solve_s"],
        "true_mp": mp, "launches": launches,
        "images_per_tier": images_by_tier, "n_buckets": stats["n_buckets"],
        "bucket_classes": stats["bucket_classes"],
        "bucket_shapes": stats["bucket_shapes"],
        "read_s": stats["read_s"], "solve_s": stats["solve_s"],
        "png_thread_s": stats["on_pixels_s"],
        "min_psnr_vs_two_tier": worst if math.isfinite(worst) else None}
    log(f"  serving ({label}): {summary['files_per_s']:.2f} files/s, "
        f"{summary['mp_iter_per_s']:.1f} MP*iter/s ({mp:.2f} true MP x 50 / "
        f"solve {stats['solve_s']:.3f} s), read {stats['read_s']:.3f} s, PNG "
        f"{stats['on_pixels_s']:.3f} thread-s, {stats['n_buckets']} buckets "
        f"{stats['bucket_classes']} {stats['bucket_shapes']}; min PSNR vs "
        f"two tier {worst:.2f} dB  [{card}]")
    return launches, summary


def phase_serving(card, files, images):
    """cli.main --tpu-batch on the corpus twice: with the tier gates
    the sweep set (solver.tier_rule as committed), and with gates that
    send each class work (mega up to 1280x1024 buckets, mega-lite up to
    1536x2048, two-lite above: K3, K3 lite, K4 + K5)."""
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.pipeline import _pack

    refs = []
    for img in images:
        fd, _ = solver.solve_joint(*_args(img), 0.3, [0.001] * 3, 50,
                                   device=DEVICE, tier="two")
        refs.append(_pack(list(fd), img, 8))
    runs = {"default": _serve("default", card, files, images, refs)}
    with gates(1280 * 1024, 1536 * 2048, 1 << 62):
        runs["every class"] = _serve("every-class", card, files, images,
                                     refs)
    for label, (launches, _) in runs.items():
        require(launches["fused_solve"] + launches["fused_solve_lite"] > 0,
                f"serving ({label}): K3 never launched")
    every = runs["every class"][0]
    for name in ("fused_solve", "fused_solve_lite", "fused_grad_striped_lite"):
        require(every[name] > 0, f"serving (every class): {name} never ran")
    return runs


# ------------------------------------------------ the reader (host C)

PROG_TWINS = FIXTURES / "torch_progressive"
PROG_GOLDEN = "lineart64_q20_420_prog"
# the reader of an earlier tree, for timing in turns (gitignored; written
# by `git show <commit>:jpeg2png_tpu_torch/io/jpeg_reader.py`)
PARENT_READER = ROOT / "jpeg2png_tpu_torch" / "_build" / "parent" / \
    "jpeg_reader.py"
READ_REPS = 5


def _twin_original(twin: pathlib.Path) -> pathlib.Path:
    stem = twin.name.split("_prog")[0] + ".jpg"
    for d in (FIXTURES, SERVING):
        if (d / stem).exists():
            return d / stem
    raise SmokeFailure(f"no original for {twin.name}")


def _read_s(read, path) -> float:
    """Median host seconds of READ_REPS reads of one file."""
    times = []
    for _ in range(READ_REPS):
        t0 = time.perf_counter()
        read(path)
        times.append(time.perf_counter() - t0)
    return sorted(times)[READ_REPS // 2]


def _parent_read():
    """The earlier tree's read_jpeg, or None where it was not provided."""
    import importlib.util

    if not PARENT_READER.exists():
        return None
    spec = importlib.util.spec_from_file_location("parent_jpeg_reader",
                                                  PARENT_READER)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.read_jpeg


def _golden_tiers(src: pathlib.Path, stem: str) -> dict:
    """`src` through every tier against the reference's goldens `stem`
    (its own, or its Huffman original's where the coefficients are the
    same): -i 5 with a CSV (rows 0-1 within METRIC_GATES, PSNR > 45 dB)
    and -i 50 (PSNR > 45 dB), each tier's launch counts.  Returns the
    PSNRs per tier."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from pngdec import decode_png

    from jpeg2png_tpu_torch.pipeline import decode_file
    from jpeg2png_tpu_torch.utils.config import SolverConfig
    from jpeg2png_tpu_torch.utils.logger import ConvergenceLogger

    gold5 = decode_png((FIXTURES / "golden" / f"{stem}_i5.png").read_bytes())
    gold50 = decode_png((FIXTURES / "golden" / f"{stem}_i50.png")
                        .read_bytes())
    csv_gold = _csv_rows(FIXTURES / "golden" / f"{stem}_i5.csv")[:2]
    golden = {}
    for tier in TIERS:
        zero_counts()
        log_path = OUT_DIR / f"{src.stem}_i5_{tier}.csv"
        out5 = OUT_DIR / f"{src.stem}_i5_{tier}.png"
        with open(log_path, "w") as f:
            decode_file(str(src), str(out5), SolverConfig(iterations=(5,) * 3),
                        logger=ConvergenceLogger(f), device=DEVICE, tier=tier)
        ours = _csv_rows(log_path)[:2]
        for col, rtol, atol in METRIC_GATES:
            require(np.allclose(ours[:, col], csv_gold[:, col], rtol=rtol,
                                atol=atol),
                    f"{src.name} CSV column {col} ({tier}): "
                    f"{ours[:, col]} vs {csv_gold[:, col]}")
        out50 = OUT_DIR / f"{src.stem}_i50_{tier}.png"
        decode_file(str(src), str(out50), SolverConfig(), device=DEVICE,
                    tier=tier)
        # -i 5 with a CSV: 5 one-iteration chunks; then one -i 50 decode
        mega = tier.startswith("mega")
        _expect(read_counts(), tier_launches(tier, 5 + (1 if mega else 50)),
                f"{src.name} ({tier} tier)")
        p5 = psnr(read_own_png(out5), gold5)
        p50 = psnr(read_own_png(out50), gold50)
        golden[tier] = {"i5": p5, "i50": p50}
        log(f"  {src.name} against golden {stem} ({tier} tier): CSV rows "
            f"0-1 agree (rtol 6e-3), PSNR i5 {p5:.2f} dB, i50 {p50:.2f} dB")
        require(p5 > 45.0 and p50 > 45.0,
                f"{src.name} ({tier}): PSNR {p5:.2f} / {p50:.2f} dB")
    return golden


def _cli_twins(twins: dict):
    """The default CLI on the smoke JPEG and on each of its twins (label
    -> path): the same pixels and launch counts as the original, which
    are the two tier's at -i 50 (K1 = K2 = 50).  Returns the counts and
    the wall seconds (host clock) of each decode, per label."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.cli import main as cli_main

    outs, counts, walls = {}, {}, {}
    for label, path in (("sequential", SMOKE_JPEG), *twins.items()):
        outs[label] = OUT_DIR / f"reader_{label}.png"
        zero_counts()
        t0 = time.perf_counter()
        rc = cli_main([str(path), "-o", str(outs[label]), "-f", "-q",
                       "--device", DEVICE])
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        counts[label] = read_counts()
        require(rc == 0, f"cli.main on the {label} smoke JPEG returned {rc}")
        _expect(counts[label], tier_launches("two", 50),
                f"the {label} smoke JPEG, default CLI")
    for label in twins:
        require(np.array_equal(read_own_png(outs["sequential"]),
                               read_own_png(outs[label])),
                f"the smoke JPEG's {label} twin decodes to other pixels")
        log(f"  smoke JPEG's {label} twin, default CLI: the same pixels and "
            f"launches as the original ({counts[label]}); wall "
            f"{walls[label]:.4f} s, the original's {walls['sequential']:.4f} s")
    return counts, walls


def phase_reader(card, files):
    """The JPEG reader (io/jpeg_reader.py on csrc/jpeg_entropy.c): every
    progressive twin equal to its sequential original; the progressive
    golden through every tier at -i 5 (CSV rows 0-1, PNG) and -i 50 (PNG);
    the smoke JPEG's twin through the default CLI, pixel- and
    launch-equal to the original's decode; read times (single files, the
    parent tree's reader where provided, the 48-file corpus on one thread
    and on the runner's threads)."""
    import concurrent.futures

    import numpy as np

    from jpeg2png_tpu_torch.io import read_jpeg

    twins = sorted(PROG_TWINS.glob("*.jpg"))
    require(len(twins) >= 10, f"{len(twins)} progressive twins")
    for twin in twins:
        a, b = read_jpeg(twin), read_jpeg(_twin_original(twin))
        require(a.progressive and not b.progressive and not a.warnings
                and (a.height, a.width) == (b.height, b.width)
                and all(np.array_equal(pa.data, pb.data)
                        and np.array_equal(pa.quant, pb.quant)
                        for pa, pb in zip(a.planes, b.planes)),
                f"{twin.name} does not read equal to its original")
    log(f"  {len(twins)} progressive twins read bit-equal to their "
        "sequential originals")

    # the progressive golden through every tier
    golden = _golden_tiers(FIXTURES / f"{PROG_GOLDEN}.jpg", PROG_GOLDEN)

    # the smoke JPEG's progressive twin through the default CLI
    twin = PROG_TWINS / (SMOKE_JPEG.stem + "_prog.jpg")
    counts, _ = _cli_twins({"progressive": twin})

    # read times
    parent = _parent_read()
    times = {"smoke_s": _read_s(read_jpeg, SMOKE_JPEG),
             "smoke_twin_s": _read_s(read_jpeg, twin),
             "parent_smoke_s": (_read_s(parent, SMOKE_JPEG) if parent
                                else None)}
    t0 = time.perf_counter()
    for f in files:
        read_jpeg(f)
    times["corpus_one_thread_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(read_jpeg, files))
    times["corpus_8_threads_s"] = time.perf_counter() - t0
    if parent:
        t0 = time.perf_counter()
        for f in files:
            parent(f)
        times["parent_corpus_one_thread_s"] = time.perf_counter() - t0
    log("  reads (host clock, median of %d): smoke JPEG %.4f s, its twin "
        "%.4f s, the parent reader %s; %d files on one thread %.4f s, on 8 "
        "threads %.4f s%s  [%s]" % (
            READ_REPS, times["smoke_s"], times["smoke_twin_s"],
            "%.4f s" % times["parent_smoke_s"] if parent else "not provided",
            len(files), times["corpus_one_thread_s"],
            times["corpus_8_threads_s"],
            (", the parent reader on one thread %.4f s"
             % times["parent_corpus_one_thread_s"]) if parent else "", card))
    return {"twins": len(twins), "golden_psnr": golden,
            "smoke_twin_launches": counts["progressive"], "read": times}


# ------------------------------------------------ the reader, arithmetic

ARITH_TWINS = FIXTURES / "torch_arith"
ARITH_GOLDEN = "lineart64_q20_420"      # its arithmetic twin has its goldens


def phase_arith_reader(card):
    """Arithmetic-coded input (SOF9, SOF10; the QM decoder in
    csrc/jpeg_entropy.c): every arithmetic twin (tests/fixtures/
    torch_arith/ and lineart64's) reads bit-equal to its Huffman original;
    lineart64's arithmetic twin through every tier against the original's
    goldens (-i 5 CSV rows 0-1 and PNG, -i 50 PNG); the smoke JPEG's
    sequential and progressive arithmetic twins through the default CLI,
    pixel- and launch-equal to the original (K1 = K2 = 50), with the
    decodes' wall seconds; read times of the smoke JPEG, its Huffman
    progressive twin and its two arithmetic twins."""
    import numpy as np

    from jpeg2png_tpu_torch.io import read_jpeg

    twins = sorted(ARITH_TWINS.glob("*.jpg")) + [
        FIXTURES / f"{ARITH_GOLDEN}_arith.jpg"]
    require(len(twins) >= 21, f"{len(twins)} arithmetic twins")
    for twin in twins:
        a = read_jpeg(twin)
        b = read_jpeg(FIXTURES / (twin.name.split("_arith")[0] + ".jpg"))
        require(a.progressive == ("_prog" in twin.name) and not b.progressive
                and not a.warnings and a.n_warnings == 0
                and (a.height, a.width) == (b.height, b.width)
                and all((pa.h_samp, pa.w_samp) == (pb.h_samp, pb.w_samp)
                        and np.array_equal(pa.data, pb.data)
                        and np.array_equal(pa.quant, pb.quant)
                        for pa, pb in zip(a.planes, b.planes)),
                f"{twin.name} does not read equal to its original")
    log(f"  {len(twins)} arithmetic twins read bit-equal to their Huffman "
        "originals")

    golden = _golden_tiers(FIXTURES / f"{ARITH_GOLDEN}_arith.jpg",
                           ARITH_GOLDEN)

    seq = ARITH_TWINS / (SMOKE_JPEG.stem + "_arith.jpg")
    prog = ARITH_TWINS / (SMOKE_JPEG.stem + "_arith_prog.jpg")
    counts, walls = _cli_twins({"arith": seq, "arith_prog": prog})

    files = {"smoke_s": SMOKE_JPEG,
             "smoke_prog_s": PROG_TWINS / (SMOKE_JPEG.stem + "_prog.jpg"),
             "smoke_arith_s": seq, "smoke_arith_prog_s": prog}
    times = {k: _read_s(read_jpeg, f) for k, f in files.items()}
    log("  reads (host clock, median of %d warm reads): smoke JPEG %.4f s, "
        "its Huffman progressive twin %.4f s, arithmetic %.4f s (%.2fx), "
        "arithmetic progressive %.4f s (%.2fx)  [%s]" % (
            READ_REPS, times["smoke_s"], times["smoke_prog_s"],
            times["smoke_arith_s"], times["smoke_arith_s"] / times["smoke_s"],
            times["smoke_arith_prog_s"],
            times["smoke_arith_prog_s"] / times["smoke_s"], card))
    return {"twins": len(twins), "golden_psnr": golden,
            "smoke_twin_launches": counts["arith"], "read": times,
            "cli_s": walls}


# ------------------------------------ the row-striped path (K6, K7)

STRIPE_BANDS = 4          # bands of the striped runs, all on the one card
TILE = 4                  # the 100.7 MP problem: the smoke JPEG's blocks 4x4


def _band_mesh():
    """STRIPE_BANDS bands on the current card (stripe_mesh maps bands onto
    cards one each by default; an explicit list may repeat a card)."""
    import torch

    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh

    dev = torch.device(DEVICE, torch.cuda.current_device())
    return stripe_mesh(STRIPE_BANDS, [dev] * STRIPE_BANDS)


def _rand(rng, shape, sd):
    import numpy as np
    import torch

    return torch.as_tensor(rng.normal(0, sd, shape).astype(np.float32),
                           device=DEVICE)


def _k7_case(rng, label, C, L, W, row0, ext, prob, weight, halo):
    """K7 against its plain version on random data, K1's gates: gradient
    within 1e-5 of its magnitude (the stencil rounds op for op,
    -fmad=false; only the channel sums of the norms may associate
    differently), extrap 1e-6, sums rtol 1e-5 (summation order).  halo =
    (top, bottom), each "null" (no halo arrays: zeros), "zero" or "random"
    rows of f and fista.  Outside the true extent the gradient must be the
    prob term exactly (0 without one)."""
    import torch

    from jpeg2png_tpu_torch.kernels import stripe_grad

    f = _rand(rng, (C, L, W), 50)
    fi = f + _rand(rng, (C, L, W), 2)
    pg = _rand(rng, (sum(prob), L, W), 1)
    it = iter(pg)
    pgs = [next(it) if p else None for p in prob]
    rows = {}
    for side, kind in zip(("top", "bot"), halo):
        rows[side] = (None if kind == "null" else
                      [_rand(rng, (C, 2, W), 50) if kind == "random"
                       else torch.zeros((C, 2, W), device=DEVICE)
                       for _ in range(2)])
    halos = None
    if rows["top"] is not None or rows["bot"] is not None:
        z = torch.zeros((C, 2, W), device=DEVICE)
        top = rows["top"] or [z, z]
        bot = rows["bot"] or [z, z]
        halos = (top[0], bot[0], top[1], bot[1])
    args = (f, fi, pgs, halos, 0.37, row0, weight, *ext)
    got = stripe_grad.fused_grad_striped(*args)
    ref = stripe_grad.fused_grad_striped_plain(*args)
    torch.cuda.synchronize()
    label = (f"K7 {label} [{C}, {L}, {W}] row0={row0} true {ext[0]}x{ext[1]} "
             f"prob={prob} w={weight} halo={halo}")
    g_err = max_err(got[0], ref[0])
    g_tol = 1e-5 * max(1.0, float(ref[0].abs().max()))
    e_err = max_err(got[1], ref[1])
    e_tol = 1e-6 * float(ref[1].abs().max())
    require(g_err <= g_tol, f"{label} grad: {g_err} > {g_tol}")
    require(e_err <= e_tol, f"{label} extrap: {e_err} > {e_tol}")
    for name, a, b in (("sumsq", got[2], ref[2]), ("tv", got[3], ref[3]),
                       ("tv2", got[4], ref[4])):
        _rel_gate(label, name, a, b, 1e-5)
    h_out = max(0, min(L, ext[0] - row0))
    for c, p in enumerate(pgs):
        want = torch.zeros_like(f[c]) if p is None else p
        require(torch.equal(got[0][c, h_out:], want[h_out:])
                and torch.equal(got[0][c, :, ext[1]:], want[:, ext[1]:]),
                f"{label}: gradient outside the true extent")
    log(f"  {label}: grad err {g_err:.3g} (tol {g_tol:.3g}), extrap err "
        f"{e_err:.3g}, sums ok")
    return g_err


def _k6_inputs(rng, H, W, sy, sx, prob, gap_rows=0, pad_rows=0):
    """K6's inputs: extrap ~ N(0, 50), grad ~ N(0, 1), a one-element step
    scale, boxes centred on fmid's own coefficients with a +-2-step jitter
    (some bind); `gap_rows` coefficient rows a region gap (+-2^39, no prob
    term); `pad_rows` coefficient rows frozen padding (zero state, lo = hi
    = dq = iq = 0)."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.kernels.project_step import GAP_BOX
    from jpeg2png_tpu_torch.ops.dct_raster import sampled_dct

    e, g = _rand(rng, (H, W), 50), _rand(rng, (H, W), 1)
    scale = torch.as_tensor(rng.uniform(0.01, 0.05, 1).astype(np.float32),
                            device=DEVICE)
    if pad_rows:
        e[-pad_rows * sy:] = 0.0
        g[-pad_rows * sy:] = 0.0
    hc, wc = H // sy, W // sx
    q = torch.as_tensor(np.tile(rng.integers(1, 60, (8, 8)).astype(
        np.float32), (hc // 8, wc // 8)), device=DEVICE)
    jitter = torch.as_tensor(rng.integers(-2, 3, (hc, wc)), device=DEVICE,
                             dtype=torch.float32)
    dq = (torch.round(sampled_dct(e - scale * g, sy, sx) / q) + jitter) * q
    lo, hi, iq = dq - 0.5 * q, dq + 0.5 * q, 1.0 / q
    if gap_rows:
        lo[-gap_rows:], hi[-gap_rows:] = -GAP_BOX, GAP_BOX
        dq[-gap_rows:], iq[-gap_rows:] = 0.0, 0.0
    if pad_rows:
        for a in (lo, hi, dq, iq):
            a[-pad_rows:] = 0.0
    pa_ss = 0.36 * sy * sx if prob else 0.0
    return (e, g, scale, lo, hi, dq if prob else None, iq if prob else None,
            pa_ss, sy, sx)


def _k6_case(rng, H, W, sy, sx, prob, gap_rows=0, pad_rows=0):
    """K6 against its plain version, K2's gates: fnew within 1e-5 of its
    magnitude (the same f32 transforms, other summation orders and fused
    multiply-adds), pgrad to _pgrad_tol, the distance rtol 1e-5; frozen
    padding exactly 0.  Then K6 against K2 on the same one-channel band
    (the same device functions; K6's footprint is a compile-time
    constant), to the same gates."""
    import torch

    from jpeg2png_tpu_torch.kernels import project_step

    args = _k6_inputs(rng, H, W, sy, sx, prob, gap_rows, pad_rows)
    got = project_step.fused_project(*args)
    ref = project_step.fused_project_plain(*args)
    e, g, scale, lo, hi, dq, iq, pa_ss = args[:8]
    k2 = project_step.fused_project_multi(
        e[None], g[None], scale, [lo], [hi], [dq], [iq], [pa_ss], [(sy, sx)])
    torch.cuda.synchronize()
    label = (f"K6 {H}x{W} samp=({sy}, {sx}) prob={prob} gap_rows={gap_rows} "
             f"pad_rows={pad_rows}")
    f_tol = 1e-5 * float(ref[0].abs().max())
    f_err = max_err(got[0], ref[0])
    require(f_err <= f_tol, f"{label} fnew: {f_err} > {f_tol}")
    k2_err = max_err(got[0], k2[0][0])
    require(k2_err <= f_tol, f"{label} fnew vs K2: {k2_err} > {f_tol}")
    if prob:
        p_tol = _pgrad_tol(ref[1], pa_ss / (sy * sx), [dq])
        for what, a, b in (("pgrad", got[1], ref[1]),
                           ("pgrad vs K2", got[1], k2[1][0])):
            err = max_err(a, b)
            require(err <= p_tol, f"{label} {what}: {err} > {p_tol}")
        _rel_gate(label, "dist", got[2], ref[2], 1e-5)
        _rel_gate(label, "dist vs K2", got[2], k2[2][0], 1e-5)
    else:
        require(got[1] is None and float(got[2]) == 0.0,
                f"{label}: prob off but pgrad/dist set")
    if pad_rows:
        require(not got[0][-pad_rows * sy:].any(), f"{label}: padding not 0")
    log(f"  {label}: fnew err {f_err:.3g} (tol {f_tol:.3g}); K6 vs K2 fnew "
        f"{k2_err:.3g} ({'bit-equal' if k2_err == 0 else 'within the gate'})")
    return f_err


def k7_edge_cases(rng):
    """K7 where the row-marching grid has edges: bands of 8 and 16 rows,
    40 rows (no multiple of the segment), 8 columns and 328 (no multiple
    of the strip), C = 4 over two strips, the segment boundary on h_true - 1 (as the last
    row of a segment and as the first), and a band whose true extent ends
    inside its first segment."""
    from jpeg2png_tpu_torch.kernels import grad_step

    seg = grad_step.segment_rows(3, True, 64, 96)
    require(seg < 64, f"K7 edge cases: 64 rows make one segment ({seg})")
    rr, rz = ("random", "random"), ("random", "zero")
    return [
        _k7_case(rng, "8-row band", 3, 8, 64, 8, (64, 64), [True] * 3, 0.3,
                 rr),
        _k7_case(rng, "16-row band", 3, 16, 128, 16, (40, 124),
                 [True, False, True], 0.3, rr),
        _k7_case(rng, "40-row band", 2, 40, 96, 40, (200, 96), [True, True],
                 0.5, rr),
        _k7_case(rng, "8 columns", 3, 64, 8, 64, (256, 8), [True] * 3, 0.3,
                 rr),
        _k7_case(rng, "328 columns", 3, 64, 328, 128, (180, 325), [True] * 3,
                 0.3, rz),
        _k7_case(rng, "C=4", 4, 96, 264, 96, (400, 260), [True] * 4, 0.3, rr),
        _k7_case(rng, "segment ends on h_true - 1", 3, 64, 96, 64,
                 (64 + seg, 96), [True] * 3, 0.3, rz),
        _k7_case(rng, "segment starts on h_true - 1", 3, 64, 96, 64,
                 (64 + seg + 1, 96), [False] * 3, 0.3, rz),
        _k7_case(rng, "true extent inside the first segment", 3, 64, 96, 64,
                 (70, 90), [True] * 3, 0.3, rz),
    ]


def striped_kernel_cases(rng):
    """K7 and K6 against their plain versions: K7 on the first, a middle
    and the last band, a band wholly in the padding, null, zero and random
    halos, C = 1, 2, 3, prob on and off, weight 0 and 0.3, and once at the
    100.7 MP problem's band [3, 2048, 12288]; K6 at (1,1), (2,2), (2,1),
    (1,2) and (1,4), prob on and off, a region gap, frozen padding, and at
    that band's shape.  Returns the max abs errors (K7 grad, K6 fnew)."""
    k7 = [
        _k7_case(rng, "first band", 3, 128, 256, 0, (512, 256), [True] * 3,
                 0.3, ("null", "random")),
        _k7_case(rng, "middle band", 3, 128, 256, 128, (512, 250),
                 [True, False, True], 0.3, ("random", "random")),
        _k7_case(rng, "last band, true extent inside", 3, 128, 256, 384,
                 (450, 250), [True] * 3, 0.3, ("random", "zero")),
        _k7_case(rng, "band in the padding", 1, 64, 96, 256, (200, 96),
                 [True], 0.3, ("random", "zero")),
        _k7_case(rng, "C=1 weight 0", 1, 64, 128, 64, (1000, 128), [False],
                 0.0, ("random", "random")),
        _k7_case(rng, "last band weight 0", 3, 32, 64, 32, (64, 60),
                 [False] * 3, 0.0, ("random", "null")),
        _k7_case(rng, "odd band", 2, 40, 72, 40, (100, 70), [False, True],
                 0.5, ("zero", "random")),
        _k7_case(rng, "100.7 MP band", 3, 2048, 12288, 2048, (8192, 12288),
                 [True] * 3, 0.3, ("random", "random")),
    ]
    k7 += k7_edge_cases(rng)
    k6 = [
        _k6_case(rng, 128, 256, 1, 1, True),
        _k6_case(rng, 128, 256, 2, 2, True, gap_rows=8),
        _k6_case(rng, 128, 256, 2, 1, False, pad_rows=16),
        _k6_case(rng, 64, 256, 1, 2, True),
        _k6_case(rng, 64, 96, 1, 1, False),
        _k6_case(rng, 48, 128, 1, 4, True, pad_rows=8),
        _k6_case(rng, 2048, 12288, 1, 1, True),
        _k6_case(rng, 2048, 12288, 2, 2, True),
    ]
    return max(k7), max(k6)


def _rgb8(f, h, w):
    """The 8-bit RGB pixels pipeline._pack gives, kept on the card."""
    import torch

    y = f[0][:h, :w] + 128.0
    cb, cr = f[1][:h, :w], f[2][:h, :w]
    rgb = torch.stack([y + 1.402 * cr, y - 0.34414 * cb - 0.71414 * cr,
                       y + 1.772 * cb]).clamp(0.0, 255.0)
    return rgb.to(torch.int32).to(torch.float64)


def _psnr_dev(a, b) -> float:
    mse = float(((a - b) ** 2).mean())
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def _rows01_gate(label, ours, ref):
    """CSV rows 0-1 of a striped solve against the two tier: rtol 1e-4,
    the prob distance also atol 1e-4 (tests/test_torch_solver.py's gate;
    the band partial sums add in another order)."""
    import numpy as np

    for col in range(4):
        atol = 1e-4 if col == 1 else 0.0
        require(np.allclose(ours[:2, col], ref[:2, col], rtol=1e-4,
                            atol=atol),
                f"{label} rows 0-1 column {col}: {ours[:2, col]} vs "
                f"{ref[:2, col]}")


def _launches(**nonzero) -> dict:
    """Every kernel's expected launch count: `nonzero`, else 0."""
    want = {fn.__name__: 0 for fn in _counters()}
    want.update(nonzero)
    return want


def _timed_solve(fn):
    """(result, ms, peak bytes) of fn() on the card: CUDA events around it
    and torch.cuda.max_memory_allocated after a reset."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated()


def phase_striped(card: str, errs):
    """The row-striped path on the card, STRIPE_BANDS bands on one card:
    the 3072x2048 smoke JPEG (rows 0-1 and 50 iterations against the two
    tier and the striped plain path, launch and collective counts, the
    lite body forced), three goldens and -s through the pipeline, the
    100.7 MP tiled problem against the two tier (times and peak memory),
    -s on it (each channel a one-channel striped solve: K7 + K6), K7's
    and K6's times at its band shapes, and `cli --tpu-stripes 4` on one
    card (the clamp warning)."""
    import io

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from pngdec import decode_png

    from jpeg2png_tpu_torch.cli import main as cli_main
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.kernels import project_step, stripe_grad
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.parallel import stripes
    from jpeg2png_tpu_torch.pipeline import decode_file
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    n, it = STRIPE_BANDS, 50
    path = {}

    # --- the smoke JPEG over 4 bands
    img = read_jpeg(SMOKE_JPEG)
    h, w = img.height, img.width
    args = _args(img) + (0.3, [0.001] * 3, it)
    mesh = _band_mesh()
    zero_counts()
    fd_s, m_s = stripes.solve_striped(*args, mesh)
    torch.cuda.synchronize()
    _expect(read_counts(), _launches(fused_grad_striped=n * it,
                                     fused_project_multi=n * it),
            "striped smoke solve (f32 body)")
    require(mesh.comm.counts == {"halo": 2 * it, "all_reduce": it},
            f"collectives {mesh.comm.counts}, expected 3 per iteration")
    require(bool(torch.isfinite(fd_s).all()) and np.isfinite(m_s).all(),
            "non-finite striped output")
    fd_2, m_2 = solver.solve_joint(*args, device=DEVICE, tier="two")
    _rows01_gate("striped smoke vs two tier", m_s, m_2)
    p_two = _psnr_dev(_rgb8(fd_s, h, w), _rgb8(fd_2, h, w))
    with _patched_plain(stripes):
        fd_p, _ = stripes.solve_striped(*args, _band_mesh())
    p_plain = _psnr_dev(_rgb8(fd_s, h, w), _rgb8(fd_p, h, w))
    zero_counts()
    fd_l, m_l = stripes.solve_striped(*args, _band_mesh(), body="lite")
    torch.cuda.synchronize()
    _expect(read_counts(), _launches(fused_grad_striped_lite=n * it,
                                     fused_project_multi_lite=n * it),
            "striped smoke solve (lite body)")
    p_lite = _psnr_dev(_rgb8(fd_l, h, w), _rgb8(fd_2, h, w))
    log(f"  striped {w}x{h}, {n} bands on one card, {it} iterations: "
        f"K7 = K2 = {n * it} launches, {mesh.comm.counts}; rows 0-1 within "
        f"rtol 1e-4 of the two tier; PSNR vs two tier {p_two:.2f} dB, vs "
        f"the striped plain path {p_plain:.2f} dB; lite body (K4 = K5 = "
        f"{n * it}) vs two tier {p_lite:.2f} dB")
    for what, p in (("vs two tier", p_two), ("vs plain path", p_plain),
                    ("lite vs two tier", p_lite)):
        require(p > 45.0, f"striped smoke {what}: PSNR {p:.2f} <= 45 dB")
    del fd_s, fd_2, fd_p, fd_l

    # --- goldens and -s through the pipeline, 4 bands each
    golden_psnr = {}
    for name in GOLDENS:
        out = OUT_DIR / f"{name}_i50_striped.png"
        zero_counts()
        decode_file(str(FIXTURES / f"{name}.jpg"), str(out), SolverConfig(),
                    device=DEVICE, mesh=_band_mesh())
        _expect(read_counts(), _launches(fused_grad_striped=n * it,
                                         fused_project_multi=n * it),
                f"golden {name} striped")
        gold = decode_png((FIXTURES / "golden" / f"{name}_i50.png")
                          .read_bytes())
        golden_psnr[name] = p = psnr(read_own_png(out), gold)
        log(f"  golden {name} i50 striped over {n} bands: PSNR {p:.2f} dB")
        require(p > 45.0, f"golden {name} striped: PSNR {p:.2f} dB")
    name = "photo512_q10_420"
    sep = SolverConfig(separate_components=True)
    out = OUT_DIR / f"{name}_s_striped.png"
    zero_counts()
    decode_file(str(FIXTURES / f"{name}.jpg"), str(out), sep, device=DEVICE,
                mesh=_band_mesh())
    sep_counts = read_counts()
    _expect(sep_counts, _launches(fused_grad_striped=3 * n * it,
                                  fused_project=3 * n * it),
            "-s striped photo512")
    ref = OUT_DIR / f"{name}_s_two.png"
    decode_file(str(FIXTURES / f"{name}.jpg"), str(ref), sep, device=DEVICE,
                tier="two")
    p_sep = psnr(read_own_png(out), read_own_png(ref))
    log(f"  -s striped {name} over {n} bands: K7 = K6 = {3 * n * it} "
        f"launches; PSNR vs the -s two-tier decode {p_sep:.2f} dB")
    require(p_sep > 45.0, f"-s striped: PSNR {p_sep:.2f} <= 45 dB")

    # --- the 100.7 MP problem: the smoke JPEG's blocks tiled TILE x TILE
    tiled = ([np.tile(d, (TILE, TILE, 1, 1)) for d in args[0]], args[1],
             args[2], 0.3, [0.001] * 3, it)
    H, W = h * TILE, w * TILE
    big = {}
    for label, fn in (
            ("striped", lambda: stripes.solve_striped(*tiled, _band_mesh())),
            ("two", lambda: solver.solve_joint(*tiled, device=DEVICE,
                                               tier="two"))):
        fn()                                                     # warm
        zero_counts()
        (fd, _), ms, peak = _timed_solve(fn)
        big[label] = {"fd": fd, "ms": ms, "peak": peak,
                      "launches": read_counts()}
    _expect(big["striped"]["launches"],
            _launches(fused_grad_striped=n * it, fused_project_multi=n * it),
            "100.7 MP striped solve")
    path["fused_grad_striped"] = n * it
    p_big = _psnr_dev(_rgb8(big["striped"]["fd"], H, W),
                      _rgb8(big["two"]["fd"], H, W))
    del fd
    for v in big.values():
        del v["fd"]
    log(f"  {W}x{H} ({H * W / 1e6:.1f} MP) over {n} bands, {it} iterations: "
        f"striped {big['striped']['ms'] / it:.4f} ms per iteration, two "
        f"tier {big['two']['ms'] / it:.4f} (set-up included); peak memory "
        f"{big['striped']['peak'] / 2**30:.2f} / "
        f"{big['two']['peak'] / 2**30:.2f} GiB; PSNR striped vs two tier "
        f"{p_big:.2f} dB  [{card}]")
    require(p_big > 45.0, f"100.7 MP striped vs two: PSNR {p_big:.2f} dB")

    # --- -s on the 100.7 MP problem: each channel its own one-channel
    #     striped solve (K7 + K6 bands), as pipeline.smooth_decode runs it
    ones = [([tiled[0][c]], [tiled[1][c]], [tiled[2][c]],
             SolverConfig().channel(c).weight, [0.001], it) for c in range(3)]
    zero_counts()
    sep_runs = [_timed_solve(lambda one=one: stripes.solve_striped(
        *one, _band_mesh())) for one in ones]
    sep_counts = read_counts()
    _expect(sep_counts, _launches(fused_grad_striped=3 * n * it,
                                  fused_project=3 * n * it),
            "-s striped 100.7 MP solve")
    path["fused_project"] = sep_counts["fused_project"]
    sep_fd = [r[0][0][0] for r in sep_runs]
    sep_ms = sum(r[1] for r in sep_runs)
    del sep_runs
    sep_ref = [solver.solve_joint(*one, device=DEVICE, tier="two")[0][0]
               for one in ones]
    p_sep_big = _psnr_dev(_rgb8(sep_fd, H, W), _rgb8(sep_ref, H, W))
    del sep_fd, sep_ref
    log(f"  -s on the {H * W / 1e6:.1f} MP problem, each channel striped over "
        f"{n} bands: K7 = K6 = {3 * n * it} launches, {sep_ms / it:.4f} ms "
        f"per iteration of the three solves; PSNR vs the per-channel two "
        f"tier {p_sep_big:.2f} dB  [{card}]")
    require(p_sep_big > 45.0, f"-s striped 100.7 MP: PSNR {p_sep_big:.2f}")
    torch.cuda.empty_cache()

    # --- K7 and K6 at the 100.7 MP problem's band shapes, on a real state
    problem = stripes._Striped(*tiled, True, _band_mesh(), "f32")
    carry, _ = problem.run(problem.initial_carry(), 3)
    fs, fis, pgs = carry[:3]
    above, below = problem._exchange(fs, fis)
    b, C = 1, 3
    k7_args = (fs[b], fis[b], list(pgs[b]),
               (above[b][:C], below[b][:C], above[b][C:], below[b][C:]),
               0.5, problem.row0s[b], 0.3, problem.H, problem.W)
    luma = stripes._Striped([tiled[0][0]], [tiled[1][0]], [tiled[2][0]], 0.3,
                            [0.001], it, True, _band_mesh(), "f32")
    lc, _ = luma.run(luma.initial_carry(), 3)
    g1, e1, sumsq, _, _ = stripe_grad.fused_grad_striped(
        lc[0][b], lc[1][b], [lc[2][b][0]], None, 0.5, luma.row0s[b], 0.3,
        luma.H, luma.W)
    scale = luma.step / torch.sqrt(sumsq)
    los, his, dqs, iqs = luma.consts[b]
    k6_args = (e1[0], g1[0], scale, los[0], his[0], dqs[0], iqs[0],
               luma.pa_sss[0], 1, 1)
    # K2 on the same band (the striped f32 body's projection)
    g7, e7, sumsq7, _, _ = stripe_grad.fused_grad_striped(*k7_args)
    los, his, dqs, iqs = problem.consts[b]
    k2_args = (e7, g7, torch.where(sumsq7 == 0, 0.0,
                                   problem.step / torch.sqrt(sumsq7)),
               los, his, dqs, iqs, problem.pa_sss, problem.samps)
    timed = {}
    for name, fn, plain, a in (
            ("fused_grad_striped", stripe_grad.fused_grad_striped,
             stripe_grad.fused_grad_striped_plain, k7_args),
            ("fused_project", project_step.fused_project,
             project_step.fused_project_plain, k6_args),
            ("fused_project_multi", project_step.fused_project_multi,
             project_step.fused_project_multi_plain, k2_args)):
        saved_n = fn.launches
        timed[name] = (cuda_ms(lambda: fn(*a), 20),
                       cuda_ms(lambda: plain(*a), 3))
        fn.launches = saved_n         # timing launches are not path ones
    L, Wb = problem.L, problem.W
    k7_split = _grad_split(stripe_grad.fused_grad_striped, k7_args)
    log(_split_msg("fused_grad_striped", k7_split, card))
    k2_bound = bytes_k2(C, C, L, Wb, problem.samps, [True] * C)
    log(f"  fused_project_multi (K2) on the same band: "
        f"{timed['fused_project_multi'][0]:.4f} ms (bytes bound "
        f"{k2_bound / PEAK_BYTES * 1e3:.4f} ms)  [{card}]")
    costs = kernel_cost_table(C, H, W, problem.samps, band_rows=L)
    bounds = {name: (costs[k]["bytes"], costs[k]["ops"]) for name, k in (
        ("fused_grad_striped", "K7"), ("fused_project", "K6"))}
    records = [
        _record("fused_grad_striped", "jpeg2png_tpu_torch/csrc/grad_step.cu",
                "jpeg2png_tpu/kernels/stripe_grad.py:317",
                path["fused_grad_striped"], errs["fused_grad_striped"],
                *timed["fused_grad_striped"], *bounds["fused_grad_striped"]),
        _record("fused_project", "jpeg2png_tpu_torch/csrc/project_step.cu",
                "jpeg2png_tpu/kernels/project_step.py:274",
                path["fused_project"], errs["fused_project"],
                *timed["fused_project"], *bounds["fused_project"]),
    ]
    for r in records:
        log(f"  {r['name']}: {r['ms']:.4f} ms median (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms  [{card}]")
    del problem, luma, carry, lc, fs, fis, pgs, above, below, k7_args, k6_args
    del g7, e7, k2_args, los, his, dqs, iqs
    torch.cuda.empty_cache()

    # --- the CLI on one card: --tpu-stripes 4 clamps with a warning
    err = io.StringIO()
    zero_counts()
    with contextlib.redirect_stderr(err):
        rc = cli_main([str(FIXTURES / "photo512_q10_420.jpg"), "-o",
                       str(OUT_DIR / "cli_stripes4.png"), "-f", "-q",
                       "--tpu-stripes", "4", "--device", DEVICE])
    cards = torch.cuda.device_count()
    warned = f"--tpu-stripes 4 exceeds the {cards} available" in err.getvalue()
    k7 = read_counts()["fused_grad_striped"]
    require(rc == 0 and warned and (k7 == 0 if cards == 1 else k7 > 0),
            f"cli --tpu-stripes 4: rc {rc}, K7 {k7}, stderr "
            f"{err.getvalue()!r}")
    log(f"  cli --tpu-stripes 4 on {cards} card(s): exit {rc}, warned: "
        f"{err.getvalue().strip()!r}; K7 launches {k7}")
    def finite(p):
        return p if math.isfinite(p) else None
    summary = {
        "bands": n, "smoke_psnr_vs_two": finite(p_two),
        "smoke_psnr_vs_plain": finite(p_plain),
        "smoke_lite_psnr_vs_two": finite(p_lite),
        "golden_psnr": {k: finite(v) for k, v in golden_psnr.items()},
        "separate_psnr_vs_two": finite(p_sep), "tiled_mp": H * W / 1e6,
        "tiled_psnr_vs_two": finite(p_big),
        "tiled_separate_psnr_vs_two": finite(p_sep_big),
        "tiled_separate_ms_per_iter": sep_ms / it,
        "tiled_ms_per_iter": {k: v["ms"] / it for k, v in big.items()},
        "tiled_peak_gib": {k: v["peak"] / 2 ** 30 for k, v in big.items()},
        "k7_split_ms": k7_split,
        "k2_band_ms": timed["fused_project_multi"][0],
        "k2_band_bound_ms": k2_bound / PEAK_BYTES * 1e3,
        "collectives_per_iteration": 3}
    return records, summary


# ------------------------------------------------ checkpoint / resume

CKPT_ITERS = 50          # iterations of each checkpointed solve
CKPT_EVERY = 20          # snapshot interval: chunks of 20, 20 and 10
CKPT_CRASH = {"single": 20, "striped": 40}   # where the simulated crash stops


def _wall(fn):
    """(fn(), host seconds) with the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _leaves(carry):
    from jpeg2png_tpu_torch.models import checkpoint

    leaves = []
    checkpoint._flatten(carry, leaves)
    return leaves


def _bits(t):
    import torch

    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _snapshot_round(label, card, path, carry, gather, fp, done):
    """The snapshot of a run cut after `done` iterations: `gather(carry)`
    brings it to the host, save_state writes it (after a check of the free
    disk), load_state reads it back bit-exact; each step timed."""
    import shutil

    import torch

    from jpeg2png_tpu_torch.models import checkpoint

    host, gather_s = _wall(lambda: gather(carry))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(host))
    free = shutil.disk_usage(OUT_DIR).free
    # the temp file and the snapshot it replaces coexist for a moment
    require(free > 2 * nbytes + (1 << 30),
            f"{label}: {free} bytes free under {OUT_DIR}; a snapshot takes "
            f"{nbytes}, twice while it replaces the last, and 1 GiB spare")
    _, save_s = _wall(lambda: checkpoint.save_state(str(path), host, done, fp))
    (loaded, it), load_s = _wall(lambda: checkpoint.load_state(str(path), fp))
    got = _leaves(loaded)
    require(it == done and len(got) == len(_leaves(host)) and all(
        a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        for a, b in zip(got, _leaves(host))),
        f"{label}: load_state did not give back the saved carry")
    out = {"carry_bytes": nbytes, "file_bytes": path.stat().st_size,
           "gather_s": gather_s, "save_s": save_s, "load_s": load_s}
    log(f"  {label}: snapshot at {done} of {CKPT_ITERS} iterations, "
        f"{out['file_bytes']} bytes ({nbytes} of carry); host gather "
        f"{gather_s:.3f} s, save_state {save_s:.3f} s, load_state "
        f"{load_s:.3f} s  [{card}]")
    return out


def _same_run(label, fdata, metrics, ref):
    import numpy as np
    import torch

    require(torch.equal(fdata, ref[0]),
            f"{label}: fdata differs from the one-shot run (max |diff| "
            f"{max_err(fdata, ref[0])})")
    require(np.array_equal(metrics, ref[1]),
            f"{label}: metric rows differ from the one-shot run")


def _checkpoint_case(label, card, one_shot, steps, gather, fp, run, crash,
                     want, comm=None):
    """One path's gates: the one-shot run; a run cut after `crash`
    iterations (`steps(crash)` -> (metrics, carry)), snapshotted and
    resumed by `run(path)`; the checkpointed run from scratch with its
    launch counts (`want`) and, striped, its collectives (`comm()` gives
    the run's communicator counts).  Both must be bit-equal with the
    one-shot run and leave no snapshot."""
    path = OUT_DIR / f"ckpt_{label.replace(' ', '_')}.npz"
    ref, one_s = _wall(one_shot)
    m_head, carry = steps(crash)
    snap = _snapshot_round(label, card, path, carry, gather, fp, crash)
    del carry
    res, resume_s = _wall(lambda: run(path))
    require(res.resumed_from == crash,
            f"{label}: resumed from {res.resumed_from}, not {crash}")
    import numpy as np

    _same_run(f"{label} resumed at {crash}", res.fdata,
              np.concatenate([m_head, res.metrics]), ref)
    require(not path.exists(), f"{label}: the resumed run left its snapshot")
    zero_counts()
    res, ckpt_s = _wall(lambda: run(path))
    counts = read_counts()
    _expect(counts, want, f"{label}: checkpointed solve")
    if comm is not None:
        require(comm() == {"halo": 2 * CKPT_ITERS, "all_reduce": CKPT_ITERS},
                f"{label}: collectives {comm()}, expected 3 per iteration")
    require(res.resumed_from == 0, f"{label}: resumed a stale snapshot")
    _same_run(f"{label} chunked by {CKPT_EVERY}", res.fdata, res.metrics,
              ref)
    require(not path.exists(), f"{label}: the finished run left its snapshot")
    nonzero = {k: v for k, v in counts.items() if v}
    log(f"  {label}: checkpointed (every {CKPT_EVERY}) and resumed (at "
        f"{crash}) runs bit-equal with the one-shot run; launches "
        f"{nonzero}; wall {ckpt_s:.3f} s checkpointed vs {one_s:.3f} s "
        f"one-shot, resume {resume_s:.3f} s  [{card}]")
    snap.update({"launches": nonzero, "one_shot_s": one_s,
                 "checkpointed_s": ckpt_s, "resume_s": resume_s})
    return snap


def phase_checkpoint(card: str):
    """Checkpoint/resume (models/checkpoint.py) on every path: the smoke
    JPEG through each tier (solve_checkpointed against solve_joint), the
    100.7 MP problem over 4 bands with the f32 body and the smoke JPEG over
    4 bands with the lite body (solve_striped_checkpointed against
    solve_striped); each chunked by CKPT_EVERY and cut at CKPT_CRASH, bit
    for bit, with snapshot sizes and times."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.models import checkpoint, solver
    from jpeg2png_tpu_torch.parallel import stripes

    it, out = CKPT_ITERS, {}
    img = read_jpeg(SMOKE_JPEG)
    args = _args(img) + (0.3, [0.001] * 3, it)
    geoms = solver._geometry(args[0], args[2])
    for tier in TIERS:
        crash = CKPT_CRASH["single"]
        out[tier] = _checkpoint_case(
            f"{tier} tier {img.width}x{img.height}", card,
            lambda tier=tier: solver.solve_joint(*args, device=DEVICE,
                                                 tier=tier),
            lambda n, tier=tier: solver.solve_steps(
                *args, nsteps=n, device=DEVICE, tier=tier)[1:],
            lambda carry: checkpoint._to(carry, "cpu"),
            checkpoint.fingerprint(geoms, tier, 0.3, [0.001] * 3, it, True),
            lambda path, tier=tier: checkpoint.solve_checkpointed(
                *args, str(path), checkpoint_every=CKPT_EVERY, device=DEVICE,
                tier=tier),
            crash, tier_launches(tier, (it + CKPT_EVERY - 1) // CKPT_EVERY
                                 if tier.startswith("mega") else it))
        torch.cuda.empty_cache()

    n = STRIPE_BANDS
    tiled = ([np.tile(d, (TILE, TILE, 1, 1)) for d in args[0]],) + args[1:]
    for label, body, a, want in (
            (f"striped f32 {img.width * TILE}x{img.height * TILE}", "f32",
             tiled, _launches(fused_grad_striped=n * it,
                              fused_project_multi=n * it)),
            (f"striped lite {img.width}x{img.height}", "lite", args,
             _launches(fused_grad_striped_lite=n * it,
                       fused_project_multi_lite=n * it))):
        mesh = {}

        def run(path, a=a, body=body):
            mesh["last"] = _band_mesh()
            return checkpoint.solve_striped_checkpointed(
                *a, mesh["last"], str(path), checkpoint_every=CKPT_EVERY,
                body=body)

        out[f"striped-{body}"] = _checkpoint_case(
            label, card,
            lambda a=a, body=body: stripes.solve_striped(
                *a, _band_mesh(), body=body),
            lambda k, a=a, body=body: stripes.striped_steps(
                *a, _band_mesh(), nsteps=k, body=body)[1:],
            checkpoint.gather_striped_carry,
            checkpoint.striped_fingerprint(
                solver._geometry(a[0], a[2]), n, body, 0.3, [0.001] * 3, it,
                True),
            run, CKPT_CRASH["striped"], want,
            comm=lambda: mesh["last"].comm.counts)
        torch.cuda.empty_cache()
    return out


# ------------------------------------- quality fixtures, every tier

# the i50 goldens phase 5 does not read (4:4:4, 4:1:1, 4:4:0, odd, 4:2:2)
GOLDENS_MORE = ("art440x320_q85_444", "art128x96_q35_411", "art120x88_q40_440",
                "lineart64_q50_444", "odd100x52_q25_420", "photo80_q30_422")


def phase_quality(card: str):
    """Every quality case (tools/torch_quality_eval.py's CASES, the
    converged photo512x384_q25_420_i1000 included) through every tier
    (forced with tier=), with its GATES, tests/test_quality.py's: PSNR
    against the ground truth >= the reference's - 0.05 dB, > 0.5 dB above
    the plain decode, > 45 dB against the reference's PNG; then the six
    more i50 goldens through every tier, > 45 dB.  Returns {case: {tier:
    PSNR vs ground truth}} and {golden: {tier: PSNR}}."""
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT / "tools"))
    from pngdec import decode_png
    from torch_quality_eval import CASES, evaluate, gate_failures

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.pipeline import smooth_decode
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    quality = {}
    for name, iters, _ in CASES:
        for tier in TIERS:
            row = evaluate(name, iters, DEVICE, tier)
            quality.setdefault(name, {
                "reference": row["psnr_reference_vs_gt"],
                "plain": row["psnr_plain_vs_gt"]})
            p = quality[name][tier] = row["psnr_ours_vs_gt"]
            log(f"  quality {name} -i {iters} ({tier} tier): {p:.3f} dB vs "
                f"ground truth (reference {row['psnr_reference_vs_gt']:.3f}, "
                f"plain {row['psnr_plain_vs_gt']:.3f}), "
                f"{row['psnr_ours_vs_reference']:.2f} dB vs the reference's "
                "PNG")
            missed = gate_failures(row)
            require(not missed, f"quality {name} ({tier}): {missed}")
    goldens = {}
    for name in GOLDENS_MORE:
        img = read_jpeg(FIXTURES / f"{name}.jpg")
        gold = decode_png((FIXTURES / "golden" / f"{name}_i50.png")
                          .read_bytes())
        goldens[name] = {}
        for tier in TIERS:
            ours = smooth_decode(img, SolverConfig(), device=DEVICE,
                                 tier=tier).pixels
            p = goldens[name][tier] = psnr(ours, gold)
            require(p > 45.0, f"golden {name} ({tier}): PSNR {p:.2f} dB")
        log(f"  golden {name} i50, mega / mega-lite / two-lite / two: "
            + " / ".join(f"{goldens[name][t]:.2f}" for t in TIERS) + " dB")
    log(f"  quality fixtures and {len(GOLDENS_MORE)} goldens pass in every "
        f"tier  [{card}]")
    return quality, goldens


# ------------------------------- several workers: serving, batched stripes

def _plan_launches(images):
    """The launches of a 50-iteration serving run of `images` under the
    current gates, from the runner's bucket plan (dyn buckets: K3 per image
    chunk, f32 or lite by their tier; dyn2 images: 50 K4 + K5; exact
    images: 50 K1 + K2), and the images per tier."""
    from jpeg2png_tpu_torch import runner

    pweights = [0.001] * 3
    want = {k: 0 for k in read_counts()}
    images_by_tier = {t: 0 for t in TIERS}
    for key, members in runner.plan_buckets(images, pweights).items():
        tier = runner.bucket_tier(key, pweights)
        images_by_tier[tier] += len(members)
        n = (runner.bucket_dispatches(len(members), 50, False)
             if tier.startswith("mega") else 50 * len(members))
        for k, v in tier_launches(tier, n).items():
            want[k] += v
    return want, images_by_tier


def _serve_workers(label, card, files, images, workers):
    """runner.decode_files_batched on the corpus over `workers` (a device
    list: one host thread each), against phase 7's one-worker PNGs of the
    same gates: every image pixel-equal, the launches the plan's, every
    worker used."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch import runner
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    want, _ = _plan_launches(images)
    stats = {}
    zero_counts()
    t0 = time.perf_counter()
    out = runner.decode_files_batched([str(f) for f in files], SolverConfig(),
                                      stats=stats, devices=workers)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    _expect(launches, want, f"serving over {len(workers)} workers ({label})")
    require(stats["cards"] == [str(torch.device(w)) for w in workers]
            and min(stats["card_items"]) > 0,
            f"serving ({label}): workers {stats['cards']} ran items "
            f"{stats['card_items']}")
    for f in files:
        one = read_own_png(OUT_DIR / f"serving_{label}" / (f.stem + ".png"))
        require(np.array_equal(out[str(f)], one),
                f"serving over {len(workers)} workers ({label}) {f.name}: "
                "pixels differ from the one-worker run")
    log(f"  serving over {stats['cards']} ({label}): {len(files)} files in "
        f"{wall_s:.3f} s ({len(files) / wall_s:.2f} files/s), solve "
        f"{stats['solve_s']:.3f} s; items per worker {stats['card_items']}, "
        f"busy s {[round(b, 3) for b in stats['card_busy_s']]}; every image "
        f"equal to the one-worker run; launches {launches}  [{card}]")
    return {"wall_s": wall_s, "files_per_s": len(files) / wall_s,
            "solve_s": stats["solve_s"], "card_items": stats["card_items"],
            "card_busy_s": stats["card_busy_s"], "launches": launches}


def _reordered(datas):
    """A second coefficient set of the same geometry: every plane's 8x8
    blocks in reverse order along both axes."""
    import numpy as np

    return [np.ascontiguousarray(d[::-1, ::-1]) for d in datas]


def phase_several_workers(card: str, files, images):
    """Phase 7's serving over two workers on the one card
    (devices=["cuda:0"] * 2), with the committed gates and the every-class
    gates; then solve_striped_batched: the smoke JPEG and its blocks
    reordered, 2 images x 2 bands on ["cuda:0"] * 4, each equal to its own
    solve_striped over 2 bands, in both bodies."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.parallel import stripes
    from jpeg2png_tpu_torch.parallel.mesh import batch_stripe_mesh, stripe_mesh

    dev = torch.device(DEVICE, torch.cuda.current_device())
    out = {"serving": {}}
    t0 = time.perf_counter()
    out["serving"]["default"] = _serve_workers("default", card, files,
                                               images, [dev] * 2)
    with gates(1280 * 1024, 1536 * 2048, 1 << 62):
        out["serving"]["every class"] = _serve_workers(
            "every-class", card, files, images, [dev] * 2)
    log(f"  (serving over two workers: {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    img = read_jpeg(SMOKE_JPEG)
    datas, quants, samps = _args(img)
    batch = [datas, _reordered(datas)]
    it, nb, ns = 50, 2, 2
    out["striped_batched"] = {}
    for body, kernels in (("f32", ("fused_grad_striped",
                                   "fused_project_multi")),
                          ("lite", ("fused_grad_striped_lite",
                                    "fused_project_multi_lite"))):
        mesh = batch_stripe_mesh(nb, ns, [dev] * (nb * ns))
        zero_counts()
        (fd, m), ms, peak = _timed_solve(lambda: stripes.solve_striped_batched(
            batch, [quants] * nb, samps, 0.3, [0.001] * 3, it, mesh,
            body=body))
        launches = read_counts()
        _expect(launches, _launches(**{k: nb * ns * it for k in kernels}),
                f"batched striping ({body} body)")
        for g in mesh:
            require(g.comm.counts == {"halo": 2 * it, "all_reduce": it},
                    f"batched striping ({body}): collectives {g.comm.counts}")
        for b in range(nb):
            ref, m_ref = stripes.solve_striped(
                batch[b], quants, samps, 0.3, [0.001] * 3, it,
                stripe_mesh(ns, [dev] * ns), body=body)
            require(torch.equal(fd[b], ref) and np.array_equal(m[b], m_ref),
                    f"batched striping ({body}) image {b}: differs from its "
                    "own striped solve")
        del fd, ref
        out["striped_batched"][body] = {"ms": ms, "ms_per_iteration": ms / it,
                                        "peak_bytes": peak,
                                        "launches": launches}
        log(f"  solve_striped_batched ({body} body): {nb} images x {ns} bands "
            f"of {img.width}x{img.height} on one card, {it} iterations: "
            f"{ms:.1f} ms ({ms / it:.3f} ms per iteration), peak "
            f"{peak / 2**30:.2f} GiB; launches {launches}; each image equal "
            f"to its own solve_striped  [{card}]")
    torch.cuda.empty_cache()
    log(f"  (batched striping: {time.perf_counter() - t0:.1f} s)")
    return out


# ------------------------------------------------ the measurement layer

# the bounds (ms) phases 6 and 8 printed before their formulas moved into
# utils/profiling.py: K1-K5 at 3072x2048 4:2:0 (K3 per 50-iteration
# launch), K6 and K7 on the 12288x8192 problem's 2048-row bands
PRINTED_BOUNDS = {"K1": 0.1126828, "K2": 0.1352193528358209,
                  "K3": 1.5775591164179106, "K3 lite": 1.690241910447761,
                  "K4": 0.05070726328358209, "K5": 0.10141451820895522,
                  "K6": 0.24038996059701492, "K7": 0.45108331582089556}


def phase_measurement(card: str, records, files):
    """The measurement layer on the card: (a) device_trace around a
    50-iteration two-tier solve of the smoke JPEG, trace_breakdown naming
    K1 and K2 with 50 launches each (the wrappers' counters) and idle >= 0;
    (b) marginal_rate(joint_timer) at photo512, 200 -> 600 iterations; (c)
    the build counter over a warm repeat of phase 7's serving run reads 0;
    (d) under fp_exceptions the default CLI decode raises nothing, and a
    NaN planted in K1's input raises FloatingPointError from the kernel
    wrapper's check after the launch (never from the plain version); (e)
    kernel_cost_table gives the bounds phases 6 and 8 printed."""
    import traceback

    import torch

    from jpeg2png_tpu_torch.cli import main as cli_main
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.kernels import grad_step
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.utils import profiling
    from jpeg2png_tpu_torch.utils.debug import fp_exceptions
    from jpeg2png_tpu_torch.utils.timing import (
        BuildCounter, joint_timer, marginal_rate)

    out = {}
    # (a)
    img = read_jpeg(SMOKE_JPEG)
    args = _args(img) + (0.3, [0.001] * 3, 50)
    solver.solve_joint(*args, device=DEVICE, tier="two")          # warm
    zero_counts()
    with profiling.device_trace(OUT_DIR / "trace_two_tier", DEVICE) as prof:
        solver.solve_joint(*args, device=DEVICE, tier="two")
    counts = read_counts()
    _expect(counts, tier_launches("two", 50), "traced two-tier solve")
    bd = profiling.trace_breakdown(prof, 50, counts)
    traced = {k: round(r["launches"] * 50) for k, r in bd["kernels"].items()}
    require(traced == {"K1": counts["fused_grad"],
                       "K2": counts["fused_project_multi"]} == {
                           "K1": 50, "K2": 50},
            f"trace_breakdown launches {traced}, counters {counts}")
    require(bd["idle_us"] >= 0 and min(bd["host_in_idle_us"].values()) >= 0,
            f"negative idle in {bd}")
    log(f"  traced two-tier solve, 3072x2048, 50 iterations: K1 = K2 = 50 "
        f"launches in the trace and the counters  [{card}]")
    for line in profiling.format_breakdown(bd):
        log("    " + line)
    out["two_tier_breakdown"] = bd
    # (b)
    p512 = read_jpeg(FIXTURES / "photo512_q10_420.jpg")
    rate = marginal_rate(joint_timer(*_args(p512), 2, device=DEVICE),
                         p512.height * p512.width / 1e6, 200, 600)
    require(math.isfinite(rate) and rate > 0, f"marginal rate {rate}")
    log(f"  photo512 marginal rate (200 -> 600 iterations, the rule's tier): "
        f"{rate:.1f} MP*iter/s  [{card}]")
    out["photo512_marginal_mp_iter_per_s"] = rate
    # (c)
    out_dir = OUT_DIR / "serving_warm"
    out_dir.mkdir(parents=True, exist_ok=True)
    argv = [str(f) for f in files] + [
        a for f in files for a in ("-o", str(out_dir / (f.stem + ".png")))]
    with BuildCounter() as builds:
        rc = cli_main(argv + ["--tpu-batch", "-q", "--device", DEVICE])
        torch.cuda.synchronize()
    require(rc == 0, f"warm serving repeat returned {rc}")
    require(builds.count == 0, f"the warm serving repeat built "
                               f"{builds.count} libraries")
    log(f"  warm repeat of the serving run: {builds.count} library builds")
    out["warm_serving_builds"] = builds.count
    # (d)
    with fp_exceptions():
        rc = cli_main([str(SMOKE_JPEG), "-o", str(OUT_DIR / "fp_traps.png"),
                       "-f", "-q", "--device", DEVICE])
    require(rc == 0, f"the default decode under fp_exceptions returned {rc}")
    _, _, carry = solver.solve_steps(*args, nsteps=3, device=DEVICE,
                                     tier="two")
    f_nan = carry[0].clone()
    f_nan[1, 100, 200] = float("nan")
    saved = grad_step.fused_grad.launches
    try:
        with fp_exceptions():
            grad_step.fused_grad(f_nan, carry[1], list(carry[2]), 0.5, 0.3)
        raise SmokeFailure("a NaN in K1's input raised nothing")
    except FloatingPointError as e:
        frames = [f.name for f in traceback.extract_tb(e.__traceback__)]
        launched = grad_step.fused_grad.launches - saved
    finally:
        grad_step.fused_grad.launches = saved    # not a launch of the path
    require(launched == 1 and frames[-2:] == ["fused_grad", "check_finite"]
            and "fused_grad_plain" not in frames,
            f"the NaN trap: launches {launched}, frames {frames}")
    log("  fp_exceptions: the default decode traps nothing; a NaN in K1's "
        "input raises FloatingPointError from fused_grad's check after its "
        "launch")
    # (e)
    tables = (kernel_cost_table(3, img.height, img.width, _args(img)[2]),
              kernel_cost_table(3, img.height * TILE, img.width * TILE,
                                _args(img)[2], band_rows=img.height * TILE
                                // STRIPE_BANDS))
    for k, want in PRINTED_BOUNDS.items():
        got = tables[k in ("K6", "K7")][k]["bound_ms"]
        require(abs(got - want) <= 1e-12 * want,
                f"kernel_cost_table {k}: {got} ms, printed {want}")
    for r in records:
        k = profiling.WRAPPERS[r["name"]]
        require(r["bound_ms"] == tables[k in ("K6", "K7")][k]["bound_ms"],
                f"{r['name']}: record bound {r['bound_ms']} is not the "
                "table's")
    log("  kernel_cost_table gives every bound phases 6 and 8 print:\n"
        + "\n".join("    " + x for x in profiling.format_cost_table(
            tables[0]).splitlines()))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from jpeg2png_tpu_torch.io import read_jpeg

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    phase_s = {}

    def phase(title, fn, *args):
        """Run one phase under its title; log and keep its seconds."""
        log(title)
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[title.split(":")[0]] = dt = time.perf_counter() - t0
        log(f"  ({title.split(':')[0]}: {dt:.1f} s)")
        return out

    # every phase raises on failure: the traceback ends the run, exit 1
    card = phase_device()
    build_s = phase("phase 2: build", phase_build)
    files = sorted(SERVING.glob("*.jpg"))
    require(len(files) == N_SERVING, f"serving corpus: {len(files)} files")
    t0 = time.perf_counter()
    images = [read_jpeg(f) for f in files]
    log(f"serving corpus read (one thread): {time.perf_counter() - t0:.3f} s")
    errs = phase("phase 3-4: kernels against their plain versions",
                 phase_kernels, images)
    errs["fused_grad_striped"], errs["fused_project"] = striped_kernel_cases(
        np.random.default_rng(1))
    converged, striple = phase("phase 5: goldens, every tier", phase_goldens)
    records, single = phase(
        "phase 6: single image, 3072x2048 4:2:0 default flags, every tier",
        phase_main_path, card, errs)
    k3_points = phase("phase 6 (K3 points)", phase_k3_points, card, images)
    sweep = phase("phase 6 (tier sweep)", phase_tier_sweep, card)
    serving = phase("phase 7: serving, cli --tpu-batch on the 48-file corpus",
                    phase_serving, card, files, images)
    by_name = {r["name"]: r for r in records}
    by_name["fused_solve"]["launches"] = serving["default"][0]["fused_solve"]
    by_name["fused_solve_lite"]["launches"] = (
        serving["every class"][0]["fused_solve_lite"])
    single["solve_ms_per_iter"] = {
        t: sweep[3][f"{t}_ms_per_iter"] for t in TIERS}
    striped_records, striped = phase(
        f"phase 8: the row-striped path, {STRIPE_BANDS} bands on one card",
        phase_striped, card, errs)
    records += striped_records
    ckpt = phase("phase 9: checkpoint / resume, every tier and both striped "
                 "bodies", phase_checkpoint, card)
    reader = phase("phase 10: the reader, progressive input and read times",
                   phase_reader, card, files)
    reader_arith = phase("phase 11: the reader, arithmetic-coded input and "
                         "read times", phase_arith_reader, card)
    quality, goldens_more = phase(
        "phase 12: the quality fixtures and six more i50 goldens, every tier",
        phase_quality, card)
    several = phase("phase 13: several workers on the card: serving and "
                    "batched striping", phase_several_workers, card, files,
                    images)
    measurement = phase("phase 14: the measurement layer", phase_measurement,
                        card, records, files)
    log(json.dumps({"card": card, "build_s": build_s, "single": single,
                    "golden_i1000_psnr": converged,
                    "golden_striple_psnr": striple, "k3_points": k3_points,
                    "tier_sweep": sweep,
                    "serving": {k: v[1] for k, v in serving.items()},
                    "striped": striped, "checkpoint": ckpt,
                    "reader": reader, "reader_arith": reader_arith,
                    "quality": quality, "goldens_i50_more": goldens_more,
                    "several_workers": several,
                    "measurement": measurement, "phase_s": phase_s,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
