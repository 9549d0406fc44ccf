#!/usr/bin/env python3
"""Proof that the PyTorch port runs its main path on an NVIDIA GPU.

    python3 chip_smoke.py            # one CUDA card, from the repo root

Phases (each raises on failure; the traceback then ends the run with a
non-zero exit and no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from jpeg2png_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build seconds and ptxas report;
  3. TF32 off for the plain PyTorch versions;
  4. each kernel against its plain version on the card, at the main
     path's 3072x2048 4:2:0 geometry and at small odd geometries (region
     gap, h_true < H, 4:2:2, 4:4:0, 4:1:1, prob on and off);
  5. goldens: three fixtures through the port's cli.main at -i 50 must
     reach PSNR > 45 dB against the reference binary's PNGs, and the
     photo512 -i 5 CSV must agree with the reference on iterations 0-1;
  6. the main path: the default-flag CLI decode of a 3072x2048 4:2:0 q30
     JPEG with both launch counters read around it (50 each), the solve
     timed with CUDA events on a warm second run, per-kernel medians over
     20 launches beside their bounds and the plain versions' times, and
     PSNR of the kernel path against the plain path;
  7. a JSON line of end-to-end numbers, one JSON line of kernel records,
     then the device line last.

Imports nothing of JAX or of the JAX package jpeg2png_tpu.  Writes only
under jpeg2png_tpu_torch/_build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

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


def phase_kernels():
    import numpy as np
    import torch

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
    return k1[0], k2[0]


def _csv_rows(path: pathlib.Path, channel: int = 3):
    import numpy as np

    with open(path) as f:
        rows = [r for r in csv.DictReader(f) if int(r["channel"]) == channel]
    return np.array([[float(r[k]) for k in
                      ("objective", "prob_dist", "tv", "tv2")] for r in rows])


def phase_goldens():
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from pngdec import decode_png

    from jpeg2png_tpu_torch.cli import main as cli_main

    for name in GOLDENS:
        out = OUT_DIR / f"{name}_i50.png"
        rc = cli_main([str(FIXTURES / f"{name}.jpg"), "-o", str(out), "-f",
                       "-q", "-i", "50", "--device", DEVICE])
        require(rc == 0, f"cli.main on {name} returned {rc}")
        gold = decode_png((FIXTURES / "golden" / f"{name}_i50.png")
                          .read_bytes())
        p = psnr(read_own_png(out), gold)
        log(f"  golden {name} i50: PSNR {p:.2f} dB")
        require(p > 45.0, f"golden {name}: PSNR {p:.2f} <= 45 dB")

    name = "photo512_q10_420"
    log_path = OUT_DIR / f"{name}_i5.csv"
    rc = cli_main([str(FIXTURES / f"{name}.jpg"), "-o",
                   str(OUT_DIR / f"{name}_i5.png"), "-f", "-q", "-i", "5",
                   "-c", str(log_path), "--device", DEVICE])
    require(rc == 0, f"cli.main -i 5 on {name} returned {rc}")
    ours = _csv_rows(log_path)[:2]
    gold = _csv_rows(FIXTURES / "golden" / f"{name}_i5.csv")[:2]
    # the reference CSV gate of tests/test_e2e.py before the chaos point
    for col, rtol, atol in ((0, 6e-3, 0.0), (2, 6e-3, 0.0), (3, 6e-3, 1e-3),
                            (1, 5e-2, 1e-3)):
        ok = np.allclose(ours[:, col], gold[:, col], rtol=rtol, atol=atol)
        require(ok, f"{name} CSV column {col}: {ours[:, col]} vs "
                    f"{gold[:, col]}")
    log(f"  golden {name} i5 CSV rows 0-1 agree (rtol 6e-3)")


def _bytes_k1(C, P, H, W, nblocks):
    return 4 * H * W * (2 * C + P) + 4 * H * W * 2 * C + 4 * nblocks * (C + 2)


def _bytes_k2(C, P, H, W, samps, prob):
    coef = sum(4 * (H // sy) * (W // sx) * (4 if p else 2)
               for (sy, sx), p in zip(samps, prob))
    return 4 * H * W * 2 * C + coef + 4 * H * W * (C + P)


def phase_main_path(card: str, errs):
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.cli import main as cli_main
    from jpeg2png_tpu_torch.io import encode_png, read_jpeg
    from jpeg2png_tpu_torch.kernels import grad_step, project_step
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.ops.color import ycbcr_to_rgb_packed

    out = OUT_DIR / "torch_smoke_art3072x2048.png"
    grad_step.fused_grad.launches = 0
    project_step.fused_project_multi.launches = 0
    t0 = time.perf_counter()
    rc = cli_main([str(SMOKE_JPEG), "-o", str(out), "-f", "-q",
                   "--device", DEVICE])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"fused_grad": grad_step.fused_grad.launches,
                "fused_project_multi": project_step.fused_project_multi.launches}
    require(rc == 0, f"cli.main on the smoke JPEG returned {rc}")
    log(f"  main path: cli.main default flags, {total_s:.3f} s total; "
        f"launches {launches}")
    for name, n in launches.items():
        require(n == 50, f"{name} launched {n} times, expected 50")
    t0 = time.perf_counter()
    img = read_jpeg(SMOKE_JPEG)
    read_s = time.perf_counter() - t0
    pix = read_own_png(out)
    require(pix.shape == (img.height, img.width, 3),
            f"output shape {pix.shape}")
    t0 = time.perf_counter()
    encode_png(pix)
    png_s = time.perf_counter() - t0
    log(f"  host: JPEG read {read_s:.3f} s, PNG encode {png_s:.3f} s")
    datas = [p.data for p in img.planes]
    quants = [p.quant for p in img.planes]
    samps = [(p.h_samp, p.w_samp) for p in img.planes]
    args = (datas, quants, samps, 0.3, [0.001] * 3, 50)
    kw = {"device": DEVICE}
    solver.solve_joint(*args, **kw)                 # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fdata, metrics = solver.solve_joint(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    solve_s = start.elapsed_time(end) / 1e3
    H, W = fdata.shape[1:]
    rate = H * W / 1e6 * 50 / solve_s
    require(bool(torch.isfinite(fdata).all()) and np.isfinite(metrics).all(),
            "non-finite solver output")
    log(f"  solve (warm, CUDA events): {solve_s:.4f} s, "
        f"{rate:.1f} MP*iter/s at {H}x{W}, 50 iterations")

    # kernel path vs plain path on the card, whole solve
    saved = solver.fused_grad, solver.fused_project_multi
    solver.fused_grad = grad_step.fused_grad_plain
    solver.fused_project_multi = project_step.fused_project_multi_plain
    try:
        fdata_plain, _ = solver.solve_joint(*args, **kw)
    finally:
        solver.fused_grad, solver.fused_project_multi = saved

    def pack(f):
        h, w = img.height, img.width
        return ycbcr_to_rgb_packed(f[0][:h, :w] + 128.0, f[1][:h, :w],
                                   f[2][:h, :w])
    p_kp = psnr(pack(fdata), pack(fdata_plain))
    log(f"  kernel path vs plain path (50 iterations): PSNR {p_kp:.2f} dB")
    require(p_kp > 45.0, f"kernel vs plain path PSNR {p_kp:.2f} <= 45 dB")

    # per-kernel times at the main path's shapes, on a real state
    _, _, carry = solver.solve_steps(*args, nsteps=3, **kw)
    fd, fi, pgrads = carry[0], carry[1], carry[2]
    start.record()
    prob = solver._build_problem(datas, quants, samps, 0.3, [0.001] * 3,
                                 50, True, torch.device(DEVICE))
    end.record()
    torch.cuda.synchronize()
    setup_ms = start.elapsed_time(end)
    log(f"  solver set-up (upload, initial decode, boxes): {setup_ms:.3f} ms")
    pgs = list(pgrads)
    k1_args = (fd, fi, pgs, 0.5, 0.3, H, W)
    grads, extraps, sumsq, _, _ = grad_step.fused_grad(*k1_args)
    scale = torch.where(sumsq == 0, 0.0, prob.step_size / torch.sqrt(sumsq))
    k2_args = (extraps, grads, scale, prob.los, prob.his, prob.dqs_c,
               prob.iqs_c, prob.pa_sss, prob.samps)
    C, P = 3, 3
    nblocks = -(-H // grad_step.TILE_H) * -(-W // grad_step.TILE_W)
    b1 = _bytes_k1(C, P, H, W, nblocks)
    b2 = _bytes_k2(C, P, H, W, prob.samps, [True] * 3)
    ops1 = K1_OPS_PER_CHANNEL_PIXEL * C * H * W
    ops2 = K2_OPS_PER_COEF * sum(H // sy * (W // sx) for sy, sx in prob.samps)
    records = []
    for name, fn, plain, nbytes, ops, src, replaces, launches_n, err in (
            ("fused_grad", grad_step.fused_grad, grad_step.fused_grad_plain,
             b1, ops1, "jpeg2png_tpu_torch/csrc/grad_step.cu",
             "jpeg2png_tpu/kernels/grad_step.py:388", launches["fused_grad"],
             errs[0]),
            ("fused_project_multi", project_step.fused_project_multi,
             project_step.fused_project_multi_plain, b2, ops2,
             "jpeg2png_tpu_torch/csrc/project_step.cu",
             "jpeg2png_tpu/kernels/project_step.py:528",
             launches["fused_project_multi"], errs[1])):
        a = k1_args if name == "fused_grad" else k2_args
        saved_n = fn.launches
        ms = cuda_ms(lambda: fn(*a), 20)
        fn.launches = saved_n         # timing launches are not main-path ones
        plain_ms = cuda_ms(lambda: plain(*a), 5)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_F32 * 1e3
        records.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches_n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log(f"  {name}: {ms:.4f} ms median of 20 (bound {max(t_bytes, t_ops):.4f}"
            f" ms by {records[-1]['bound_by']}, {nbytes / 1e6:.1f} MB), plain "
            f"{plain_ms:.4f} ms  [{card}]")
    return records, {"total_s": total_s, "solve_s": solve_s,
                     "mp_iter_per_s": rate, "setup_ms": setup_ms,
                     "jpeg_read_s": read_s, "png_encode_s": png_s,
                     "psnr_kernel_vs_plain": p_kp if math.isfinite(p_kp)
                     else None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    # every phase raises on failure: the traceback ends the run, exit 1
    card = phase_device()
    log("phase 2: build")
    build_s = phase_build()
    log("phase 3-4: kernels against their plain versions")
    errs = phase_kernels()
    log("phase 5: goldens")
    phase_goldens()
    log("phase 6: main path, 3072x2048 4:2:0 default flags")
    records, summary = phase_main_path(card, errs)
    log(json.dumps({"card": card, "build_s": build_s, **summary}))
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
