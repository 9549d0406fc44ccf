"""Per-file decode pipeline: JPEG -> smooth solve -> PNG.

The equivalent of decode_file (reference: jpeg2png.c:120-172): read
coefficients on the host, run the solver on the device (joint or
per-channel, whole or striped in row bands over several devices), re-add
the +128 luma offset (jpeg2png.c:156-159), convert YCbCr -> RGB on the
device with the reference's exact constants and clamp-then-scale order
(png.c:44-47), and pack a PNG on the host.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

from jpeg2png_tpu_torch import resolve_device
from jpeg2png_tpu_torch.io import (
    JpegImage, read_jpeg, require_supported, write_png)
from jpeg2png_tpu_torch.models.solver import (
    canvas_inputs, solve_joint, solve_joint_chunked)
from jpeg2png_tpu_torch.ops.color import canvas_pixels
from jpeg2png_tpu_torch.parallel import distributed
from jpeg2png_tpu_torch.parallel.mesh import available_devices, stripe_mesh
from jpeg2png_tpu_torch.parallel.stripes import solve_striped
from jpeg2png_tpu_torch.utils import profiling
from jpeg2png_tpu_torch.utils.config import SolverConfig
from jpeg2png_tpu_torch.utils.logger import ConvergenceLogger
from jpeg2png_tpu_torch.utils.progress import ProgressBar


@dataclasses.dataclass
class DecodeResult:
    pixels: np.ndarray          # [H, W, 3] or [H, W] uint8/uint16
    metrics_per_channel: dict   # channel id (3 = joint) -> [iters, 4]


# the name chip_smoke.py imports
_pack = canvas_pixels


def striped_mesh_for(stripes: int, device):
    """The mesh a `--tpu-stripes N` decode runs on, or None for the
    single-device solver.  N bands go one per device (in a multi-process
    run the global devices, every process's: jpeg2png_tpu/pipeline.py:104;
    the CPU holds any number); N beyond the devices clamps to them with a
    warning on rank 0 (the mesh itself refuses to truncate), and to the
    single-device solver when one is left."""
    if stripes <= 1:
        return None
    device = resolve_device(device)
    avail = available_devices(device)
    if stripes > avail:
        if distributed.is_primary():
            what = (f"striping over {avail}" if avail > 1 else
                    "falling back to the single-device solver")
            print(f"jpeg2png_tpu_torch: --tpu-stripes {stripes} exceeds "
                  f"the {avail} available device(s); {what}",
                  file=sys.stderr)
        stripes = avail
    if stripes <= 1:
        return None
    if device.type == "cpu" and not distributed.is_joined():
        return stripe_mesh(stripes, [device] * stripes)
    return stripe_mesh(stripes)


def smooth_decode(img: JpegImage, cfg: SolverConfig,
                  progress: Optional[ProgressBar] = None,
                  bits: int = 8, metrics_stream=None,
                  device="cuda", tier=None, stripes: int = 0,
                  mesh=None) -> DecodeResult:
    """Solve and convert one parsed JPEG to output pixels.

    metrics_stream: optional callable (channel, start_iteration,
    metrics_chunk) fired DURING the solve — with it (or a progress bar)
    active, solves run as resumable chunks so the bar ticks and the CSV
    streams mid-solve, like the reference's per-iteration hooks
    (compute.c:449-452, logger.c:20).  Chunked and one-shot solves run
    the same kernels on the same carry and agree exactly.  `tier` forces
    a solver tier (models/solver.py TIERS; None: tier_rule).

    stripes > 1 solves the image in that many row bands
    (parallel/stripes.py; striped_mesh_for places them), or `mesh`, a
    parallel.mesh.stripe_mesh, gives the bands as they are (e.g. four
    bands on one card).  With -s each channel is a one-channel striped
    solve of its own.
    """
    require_supported(img)
    if cfg.dtype != "float32":
        raise ValueError(f"unsupported solver dtype {cfg.dtype!r} "
                         "(the kernels are float32)")
    device = resolve_device(device)
    if mesh is None:
        mesh = striped_mesh_for(stripes, device)
    datas = [p.data for p in img.planes]
    quants = [p.quant for p in img.planes]
    samps = [(p.h_samp, p.w_samp) for p in img.planes]
    C = img.nchannel
    # the chunking decision must be the same on every process: a striped
    # chunk is a schedule of collectives, and observers (bar, CSV) live on
    # rank 0 only, so in a multi-process run every rank chunks
    live = (progress is not None or metrics_stream is not None
            or distributed.is_multi_process())

    def solve(ds, qs, ss, w, pw, iters, channel_id):
        on_chunk = None
        if live and iters > 0:
            def on_chunk(done, chunk_metrics):
                if progress:
                    progress.increment(chunk_metrics.shape[0])
                if metrics_stream:
                    metrics_stream(channel_id, done - chunk_metrics.shape[0],
                                   chunk_metrics)
        # chunks of solver.iter_chunk iterations
        if mesh is not None:
            fd, metrics = solve_striped(
                ds, qs, ss, w, pw, iters, mesh, cfg.simd_compat_logging,
                on_chunk=on_chunk)
            # a multi-process result is sharded by rows: gathered once,
            # here at the end
            fd = distributed.gather_output(fd)
        elif on_chunk is not None:
            fd, metrics = solve_joint_chunked(
                ds, qs, ss, w, pw, iters, on_chunk=on_chunk,
                simd_compat_logging=cfg.simd_compat_logging, device=device,
                tier=tier)
        else:
            fd, metrics = solve_joint(ds, qs, ss, w, pw, iters,
                                      cfg.simd_compat_logging, device, tier)
        if on_chunk is None:
            if progress:
                progress.increment(iters)
            if metrics_stream:
                metrics_stream(channel_id, 0, metrics)
        return fd, metrics

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
    return DecodeResult(pixels=canvas_pixels(channels, img, bits),
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
    stripes: int = 0,
    mesh=None,
) -> DecodeResult:
    """Full per-file pipeline (jpeg2png.c:120-172).  CSV rows stream
    DURING the solve (chunked execution), like the reference's in-loop
    logger (logger.c:20).  In a multi-process run every process decodes
    and rank 0 alone writes the file and the CSV rows.  The read is a
    "read" span; the solve, the fetch and the write have their own."""
    with profiling.span("read"):
        img = read_jpeg(infile)
    primary = distributed.is_primary()
    stream = None
    if logger is not None and primary:
        def stream(channel, start, metrics):
            logger.log_metrics(infile, channel, metrics,
                               start_iteration=start)
    result = smooth_decode(img, cfg, progress, bits, metrics_stream=stream,
                           device=device, tier=tier, stripes=stripes,
                           mesh=mesh)
    # the barrier keeps the other ranks from running ahead of the write; in
    # a finally, so that a failed write on rank 0 surfaces there instead of
    # stranding the others at the barrier
    try:
        if primary:
            write_png(outfile, result.pixels, bits)
    finally:
        distributed.barrier()
    return result


def plain_decode(img: JpegImage, bits: int = 8, device="cuda") -> np.ndarray:
    """Baseline (blocky) decode without smoothing — the solver's starting
    point (solver.canvas_inputs' f0), exposed for comparisons and tests
    (jpeg.c:83-92 + write_png)."""
    datas = [p.data for p in img.planes]
    samps = [(p.h_samp, p.w_samp) for p in img.planes]
    canvas = (max(p.ph * p.h_samp for p in img.planes),
              max(p.pw * p.w_samp for p in img.planes))
    f0, _, _, _ = canvas_inputs([datas], [[p.quant for p in img.planes]],
                                samps, canvas, resolve_device(device))
    return canvas_pixels(f0[0], img, bits)
