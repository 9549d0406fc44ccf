"""Per-file decode pipeline: JPEG -> smooth solve -> PNG.

The equivalent of decode_file (reference: jpeg2png.c:120-172): read
coefficients on the host, run the solver on the device (joint or
per-channel), re-add the +128 luma offset (jpeg2png.c:156-159), convert
YCbCr -> RGB on the device with the reference's exact constants and
clamp-then-scale order (png.c:44-47), and pack a PNG on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from jpeg2png_tpu_torch import resolve_device
from jpeg2png_tpu_torch.io import (
    JpegImage, read_jpeg, require_supported, write_png)
from jpeg2png_tpu_torch.models.solver import (
    initial_decode, solve_joint, solve_joint_chunked)
from jpeg2png_tpu_torch.ops.color import gray_packed, ycbcr_to_rgb_packed
from jpeg2png_tpu_torch.ops.resample import upsample_nearest_clamped
from jpeg2png_tpu_torch.utils.config import SolverConfig
from jpeg2png_tpu_torch.utils.logger import ConvergenceLogger
from jpeg2png_tpu_torch.utils.progress import ProgressBar


@dataclasses.dataclass
class DecodeResult:
    pixels: np.ndarray          # [H, W, 3] or [H, W] uint8/uint16
    metrics_per_channel: dict   # channel id (3 = joint) -> [iters, 4]


def _pack(channels, img: JpegImage, bits: int) -> np.ndarray:
    h, w = img.height, img.width
    y = channels[0][:h, :w] + 128.0
    if len(channels) == 1:
        return gray_packed(y, bits)
    return ycbcr_to_rgb_packed(y, channels[1][:h, :w], channels[2][:h, :w],
                               bits)


def smooth_decode(img: JpegImage, cfg: SolverConfig,
                  progress: Optional[ProgressBar] = None,
                  bits: int = 8, metrics_stream=None,
                  device="cuda", tier=None) -> DecodeResult:
    """Solve and convert one parsed JPEG to output pixels.

    metrics_stream: optional callable (channel, start_iteration,
    metrics_chunk) fired DURING the solve — with it (or a progress bar)
    active, solves run as resumable chunks so the bar ticks and the CSV
    streams mid-solve, like the reference's per-iteration hooks
    (compute.c:449-452, logger.c:20).  Chunked and one-shot solves run
    the same kernels on the same carry and agree exactly.  `tier` forces
    a solver tier (models/solver.py TIERS; None: tier_rule).
    """
    require_supported(img)
    if cfg.dtype != "float32":
        raise ValueError(f"unsupported solver dtype {cfg.dtype!r} "
                         "(the kernels are float32)")
    device = resolve_device(device)
    datas = [p.data for p in img.planes]
    quants = [p.quant for p in img.planes]
    samps = [(p.h_samp, p.w_samp) for p in img.planes]
    C = img.nchannel
    live = progress is not None or metrics_stream is not None

    def solve(ds, qs, ss, w, pw, iters, channel_id):
        if not (live and iters > 0):
            fd, metrics = solve_joint(ds, qs, ss, w, pw, iters,
                                      cfg.simd_compat_logging, device, tier)
            if progress:
                progress.increment(iters)
            if metrics_stream:
                metrics_stream(channel_id, 0, metrics)
            return fd, metrics

        def on_chunk(done, chunk_metrics):
            if progress:
                progress.increment(chunk_metrics.shape[0])
            if metrics_stream:
                metrics_stream(channel_id, done - chunk_metrics.shape[0],
                               chunk_metrics)

        # short solves (<= 16 iterations) tick per iteration, like the
        # reference's bar (progressbar.c:37-47)
        return solve_joint_chunked(
            ds, qs, ss, w, pw, iters, on_chunk=on_chunk,
            chunk=1 if iters <= 16 else None,
            simd_compat_logging=cfg.simd_compat_logging, device=device,
            tier=tier)

    metrics_out = {}
    if not cfg.separate_components or C == 1:
        channel_id = 3 if C > 1 else 0
        fdata, metrics_out[channel_id] = solve(
            datas, quants, samps, cfg.weights[0], cfg.pweights[:C],
            cfg.iterations[0], channel_id)
        channels = list(fdata)
    else:
        channels = []
        for c in range(C):
            s = cfg.channel(c)
            fd, metrics_out[c] = solve(
                [datas[c]], [quants[c]], [samps[c]], s.weight, [s.pweight],
                s.iterations, c)
            channels.append(fd[0])
    return DecodeResult(pixels=_pack(channels, img, bits),
                        metrics_per_channel=metrics_out)


def decode_file(
    infile: str,
    outfile: str,
    cfg: SolverConfig,
    bits: int = 8,
    logger: Optional[ConvergenceLogger] = None,
    progress: Optional[ProgressBar] = None,
    device="cuda",
    tier=None,
) -> DecodeResult:
    """Full per-file pipeline (jpeg2png.c:120-172).  CSV rows stream
    DURING the solve (chunked execution), like the reference's in-loop
    logger (logger.c:20)."""
    img = read_jpeg(infile)
    stream = None
    if logger is not None:
        def stream(channel, start, metrics):
            logger.log_metrics(infile, channel, metrics,
                               start_iteration=start)
    result = smooth_decode(img, cfg, progress, bits, metrics_stream=stream,
                           device=device, tier=tier)
    write_png(outfile, result.pixels, bits)
    return result


def plain_decode(img: JpegImage, bits: int = 8, device="cuda") -> np.ndarray:
    """Baseline (blocky) decode without smoothing — the solver's starting
    point, exposed for comparisons and tests (jpeg.c:83-92 + write_png)."""
    device = resolve_device(device)
    H = max(p.ph * p.h_samp for p in img.planes)
    W = max(p.pw * p.w_samp for p in img.planes)
    chans = []
    for p in img.planes:
        dec = initial_decode(
            torch.as_tensor(p.data, device=device),
            torch.as_tensor(p.quant.astype(np.float32), device=device))
        chans.append(upsample_nearest_clamped(dec, p.h_samp, p.w_samp, H, W))
    return _pack(chans, img, bits)
