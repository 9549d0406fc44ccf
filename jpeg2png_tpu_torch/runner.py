"""Batched multi-image decoding: bucketed serving through the whole-solve
kernel and the lite pair.

The reference parallelizes over input files with OpenMP threads
(jpeg2png.c:330-337); the port batches images like the JAX package's
runner (jpeg2png_tpu/runner.py:154-432, 778-942, 947-1126):

  * images are read on the host by a thread pool,
  * grouped into buckets by subsampling and a coarsened canvas shape:
    every member is zero-padded into the bucket canvas and carries its
    true extent and step size as device values (models/solver.py builds
    and solves them: solve_canvas, the set-up and the tiers' host loops
    of single-image solves),
  * the crop and the colour conversion run on the device
    (ops/color.canvas_pixels); each image's pixels are fetched once.

solver.tier_rule, the single-image tier rule applied to the bucket
canvas, sorts each image into one of three classes:

  "dyn"    the bucket's tier is mega or mega-lite: up to 8 images of
           different sizes per launch of K3 in dynamic-extent mode, f32
           or lite (solve_bucket);
  "dyn2"   its two-lite bucket's tier is two-lite: one image at a time
           through K4 + K5 per iteration in dynamic-extent mode, on the
           shared bucket canvas (two_lite_bucket_for, solve_bucket_two);
  "exact"  the rest: one image at a time on the two-kernel tier.

Every bucket's work items (a dyn bucket's chunks of up to 8 images, a
dyn2 or exact image) are dealt to the cards, one host thread per card
draining one queue of items across all buckets (dp_degree, -t caps the
cards); a chunk is formed as on one card, so every image's result on N
cards is its one-card result, bit for bit.  In a multi-process run each
process serves the files i % world == rank on its own card.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jpeg2png_tpu_torch import on_device, resolve_device
from jpeg2png_tpu_torch.io import JpegImage, read_jpeg, require_supported
from jpeg2png_tpu_torch.models import solver
from jpeg2png_tpu_torch.models.solver import (
    ChannelGeometry, canvas_shape, solve_joint, takes, tier_rule)
from jpeg2png_tpu_torch.ops.color import canvas_pixels
from jpeg2png_tpu_torch.parallel import distributed
from jpeg2png_tpu_torch.utils import profiling
from jpeg2png_tpu_torch.utils.config import SolverConfig

CHUNK_IMAGES = solver.MAX_IMAGES   # images per K3 launch
# geometric size ladder for bucket coarsening (~1.2-1.5x steps): assorted
# photo sizes collapse onto a handful of rungs at modest padding waste
_BUCKET_LADDER = (128, 192, 256, 384, 512, 640, 768, 1024, 1280, 1536,
                  2048, 2560, 3072, 4096)
# a coarsened bucket may hold at most this multiple of the natural area
_MAX_WASTE = 1.8


def geometry_key(img: JpegImage) -> Tuple:
    return tuple((p.nby, p.nbx, p.h_samp, p.w_samp) for p in img.planes)


@dataclasses.dataclass
class BatchResult:
    fdata: Optional[torch.Tensor]  # [B, C, H, W] on the device; None with finish=
    metrics: np.ndarray            # [B, iterations, 4]


def _present(dev: torch.device) -> torch.device:
    """`dev` itself, a CUDA device with its index; raises RuntimeError for
    a CUDA device that is not there (no fall back to the CPU)."""
    resolve_device(dev)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= count:
        raise RuntimeError(f"{dev} is not present: this process sees "
                           f"{count} CUDA device(s)")
    return torch.device("cuda", index)


def dp_degree(B: int, requested: Optional[int] = None,
              devices: Optional[Sequence] = None,
              device="cuda") -> List[torch.device]:
    """The devices B work items fan out over, one host worker each:

      * in a multi-process run, this process's own devices
        (distributed.local_devices(): its share of the cards it sees, the
        counterpart of jax.local_devices(); the files are split across
        the processes);
      * else `devices` as given, which may repeat a device (["cuda:0"] *
        2: two workers on one card; ["cpu"] * 4: four on the CPU), or
        every visible CUDA card for device "cuda", or [device];
      * at most `requested` (the CLI's -t) and at most B, at least one.

    A CUDA device that is not there raises RuntimeError."""
    if distributed.is_multi_process():
        devs = distributed.local_devices()
    elif devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("an empty device list")
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [dev]
    devs = [_present(d) for d in devs]
    n = len(devs) if requested is None else min(len(devs), int(requested))
    return devs[:max(1, min(n, B))]


def _run_on_cards(work, devices, stats: Optional[dict] = None) -> None:
    """Run `work`, callables fn(device), on one host thread per entry of
    `devices`: each thread takes the next item of one shared queue, in
    order, inside its device's context (on_device: the kernels launch on
    the calling thread's current device), each item in an "item" span
    (card: the CUDA ordinal), a child of the span open on the calling
    thread.  The first exception on any thread stops every thread taking
    more and is raised here once all have stopped.  `stats` receives the
    devices (cards), the items each ran (card_items), each one's seconds
    inside its items (card_busy_s), and the two tier's iterations run
    inside CUDA graph replays and eagerly (two_graph_iters,
    two_eager_iters: the counts of the items' "solve.loop" spans)."""
    queue = list(reversed(work))
    lock = threading.Lock()
    failed: List[BaseException] = []
    done: List[list] = [[] for _ in devices]
    loops: List[list] = [[] for _ in devices]
    parent = profiling.current()

    def worker(k):
        dev = devices[k]
        with on_device(dev), profiling.within(parent), \
                profiling.collected("solve.loop") as loops[k]:
            while True:
                with lock:
                    if failed or not queue:
                        return
                    fn = queue.pop()
                sp = None
                try:
                    with profiling.span("item", card=dev.index) as sp:
                        fn(dev)
                except BaseException as e:
                    with lock:
                        failed.append(e)
                    raise
                finally:
                    done[k].append(sp)

    with concurrent.futures.ThreadPoolExecutor(
            len(devices), thread_name_prefix="j2p-card") as pool:
        futures = [pool.submit(worker, k) for k in range(len(devices))]
        concurrent.futures.wait(futures)
    if failed:
        raise failed[0]
    if stats is not None:
        stats["cards"] = [str(d) for d in devices]
        stats["card_items"] = [len(d) for d in done]
        stats["card_busy_s"] = [sum(sp.seconds for sp in d) for d in done]
        for key in ("graph_iters", "eager_iters"):
            stats[f"two_{key}"] = sum(sp.attrs.get(key, 0)
                                      for sps in loops for sp in sps)


class _BucketSolve:
    """One bucket's solve as work items (lists of member indices) that run
    on any device.  Each item's metric rows land in `metrics`; its solved
    canvases [n, C, HB, WB] go to finish(members, f) on the device that
    solved them, or are kept and joined in member order by result()."""

    def __init__(self, n_images: int, iterations: int, finish):
        self.metrics = np.zeros((n_images, iterations, 4), np.float32)
        self.finish = finish
        self._kept: Dict[int, torch.Tensor] = {}

    def items(self) -> List[List[int]]:
        raise NotImplementedError

    def solve(self, members: List[int], device) -> torch.Tensor:
        raise NotImplementedError

    def run(self, members: List[int], device) -> None:
        f = self.solve(members, device)
        if self.finish is not None:
            self.finish(members, f)
        else:
            self._kept[members[0]] = f

    def result(self, device) -> BatchResult:
        if self.finish is not None:
            return BatchResult(None, self.metrics)
        return BatchResult(torch.cat([self._kept[k].to(device)
                                      for k in sorted(self._kept)]),
                           self.metrics)


def _solve_on_cards(job: _BucketSolve, data_parallel, devices, device):
    devs = dp_degree(len(job.items()), data_parallel, devices, device)
    _run_on_cards([functools.partial(job.run, m) for m in job.items()], devs)
    return job.result(devs[0])


def _canvas(img: JpegImage) -> Tuple[int, int]:
    return canvas_shape(tuple(ChannelGeometry(p.nby, p.nbx, p.h_samp,
                                              p.w_samp) for p in img.planes))


def _samps(img: JpegImage):
    return [(p.h_samp, p.w_samp) for p in img.planes]


def _align(H: int, W: int, samps) -> Tuple[int, int]:
    """Round (H, W) up to whole 8x8 coefficient blocks of every channel
    (K3's alignment: 16 rows/cols at 4:2:0)."""
    ay = 8 * max(sy for sy, _ in samps)
    ax = 8 * max(sx for _, sx in samps)
    return -(-H // ay) * ay, -(-W // ax) * ax


def bucket_shape_for(img: JpegImage) -> Tuple[int, int]:
    """The natural (smallest) dynamic-extent bucket of an image."""
    H, W = _canvas(img)
    return _align(H, W, _samps(img))


def quantized_bucket_for(img: JpegImage) -> Tuple[int, int]:
    """A coarsened bucket: the canvas rounded up the size ladder, so a
    corpus of assorted sizes lands in a few shared bucket shapes; the
    natural bucket when coarsening would waste more than 1.8x its area."""
    H, W = _canvas(img)
    samps = _samps(img)

    def up(v):
        for x in _BUCKET_LADDER:
            if x >= v:
                return x
        return v

    natural = _align(H, W, samps)
    coarse = _align(up(H), up(W), samps)
    if coarse[0] * coarse[1] <= _MAX_WASTE * natural[0] * natural[1]:
        return coarse
    return natural


def two_lite_bucket_for(img: JpegImage) -> Optional[Tuple[int, int]]:
    """The dyn2 (two-lite, dynamic-extent) bucket of an image, or None
    when the lite pair cannot take it (jpeg2png_tpu/runner.py:778 of the
    JAX package): the ladder-coarsened shape when it wastes at most 1.8x
    the natural bucket's area, else the natural bucket, which must stay
    within 2x the true canvas.  The port's kernels need no lane or band
    padding, so the natural bucket is the canvas in whole 8x8 blocks of
    every channel, and the lite pair's gate does not depend on the prob
    channels."""
    H, W = _canvas(img)
    samps = _samps(img)
    natural = _align(H, W, samps)
    if (natural[0] * natural[1] > 2 * H * W
            or not takes("two-lite", len(samps), *natural, samps, 0)):
        return None
    return quantized_bucket_for(img)


def _planes(images):
    """Per image, per channel: (int16 coefficients, quant tables)."""
    return ([[p.data for p in img.planes] for img in images],
            [[p.quant for p in img.planes] for img in images])


def _check_sampling(images) -> None:
    """Raise ValueError unless every image has the first's sampling (the
    solver checks that each fits the bucket canvas)."""
    samps = _samps(images[0])
    for img in images:
        if _samps(img) != samps:
            raise ValueError(f"image samps={_samps(img)} differ from the "
                             f"bucket's samps={samps}")


def prepare_chunk(images, bucket, iterations, device="cuda"):
    """K3's dynamic-extent inputs for up to 8 images of one bucket, as
    solve_bucket builds them (solver.bucket_inputs): (f0, int16 rasters,
    quant rasters, extents, step sizes)."""
    _check_sampling(images)
    return solver.bucket_inputs(*_planes(images), _samps(images[0]), bucket,
                                iterations, resolve_device(device))


def bucket_dispatches(n_images: int, iterations: int,
                      streamed: bool) -> int:
    """K3 launches solve_bucket makes for a bucket of n_images."""
    if iterations == 0:
        return 0
    chunk = solver.iter_chunk(iterations, streamed)
    return -(-n_images // CHUNK_IMAGES) * -(-iterations // chunk)


class _CanvasSolve(_BucketSolve):
    """A bucket-canvas class (dyn, dyn2): each work item's images go
    through solver.solve_canvas in the bucket canvas, each with its true
    extent and step size, on the bucket's tier."""

    def __init__(self, images, bucket, weight, pweights, iterations,
                 simd_compat_logging, on_chunk, iter_chunk, finish):
        super().__init__(len(images), iterations, finish)
        _check_sampling(images)
        self.samps = _samps(images[0])
        C = len(self.samps)
        self.tier = self.bucket_tier(
            C, *bucket, sum(1 for p in pweights[:C] if p != 0.0))
        self.datas, self.quants = _planes(images)
        self.chunk = (solver.iter_chunk(iterations, on_chunk is not None)
                      if iter_chunk is None else iter_chunk)
        self.args = (bucket, weight, pweights, iterations,
                     simd_compat_logging)
        self.on_chunk = on_chunk

    def bucket_tier(self, C, HB, WB, n_prob) -> str:
        raise NotImplementedError

    def solve(self, members, device):
        on_chunk = None
        if self.on_chunk is not None:
            def on_chunk(done, metrics):
                self.on_chunk(members, done, metrics)
        f, self.metrics[members] = solver.solve_canvas(
            [self.datas[m] for m in members],
            [self.quants[m] for m in members], self.samps, *self.args,
            device=device, tier=self.tier, chunk=self.chunk,
            on_chunk=on_chunk)
        return f


class _DynSolve(_CanvasSolve):
    """A dyn bucket (solve_bucket): work items are its chunks of up to
    CHUNK_IMAGES images, formed as one device forms them (K3's plan, and
    so the order of its partial sums, depends on the chunk's size)."""

    def bucket_tier(self, C, HB, WB, n_prob):
        if tier_rule(C, HB, WB, self.samps, n_prob) == "mega-lite":
            return "mega-lite"
        return "mega"

    def items(self):
        B = len(self.datas)
        return [list(range(i, min(i + CHUNK_IMAGES, B)))
                for i in range(0, B, CHUNK_IMAGES)]


def solve_bucket(
    images: Sequence[JpegImage],
    bucket: Tuple[int, int],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    simd_compat_logging: bool = True,
    on_chunk=None,
    iter_chunk: Optional[int] = None,
    finish=None,
    device="cuda",
    data_parallel: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> BatchResult:
    """Solve mixed-size same-subsampling images through K3 in
    dynamic-extent mode: f32, or its lite mode on the lite state (bf16
    FISTA difference and devq) where solver.tier_rule sends the bucket
    canvas to the mega-lite tier.

    Every image is padded into the `bucket` canvas; its true extent and
    step size (radius of its own canvas / sqrt(1 + iterations),
    compute.c:425) ride in as device values.  Images go through in
    chunks of up to 8 per launch; with `on_chunk`, iterations run in
    resumable chunks (`iter_chunk` each; default solver.iter_chunk, the
    single-file pipeline's rule), bit-identical to one-shot, and
    `on_chunk(member_indices, done_iterations, metrics_chunk)` fires
    after each.

    The image chunks are dealt to the devices of dp_degree(chunks,
    data_parallel, devices, device), one host thread each, whole: every
    image's result is the one a single device gives, bit for bit.
    on_chunk and finish then run on those threads, several at once.

    `finish(member_indices, fdata_device)`, when given, receives each
    image chunk's solved canvases [n, C, HB, WB] on the device that solved
    them, and BatchResult.fdata is None.  Otherwise fdata is [B, C, HB, WB]
    on the first of those devices (crop with each image's height/width).
    """
    job = _DynSolve(images, bucket, weight, pweights, iterations,
                    simd_compat_logging, on_chunk, iter_chunk, finish)
    return _solve_on_cards(job, data_parallel, devices, device)


class _Dyn2Solve(_CanvasSolve):
    """A dyn2 bucket (solve_bucket_two): one image per work item."""

    def bucket_tier(self, C, HB, WB, n_prob):
        return "two-lite"

    def items(self):
        return [[m] for m in range(len(self.datas))]


def solve_bucket_two(
    images: Sequence[JpegImage],
    bucket: Tuple[int, int],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    simd_compat_logging: bool = True,
    on_chunk=None,
    iter_chunk: Optional[int] = None,
    finish=None,
    device="cuda",
    data_parallel: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> BatchResult:
    """solve_bucket for the dyn2 class (jpeg2png_tpu/runner.py:826 of the
    JAX package): images of one two-lite bucket, one at a time, each
    padded into the bucket canvas with its true extent and step size as
    device values, through K4 + K5 per iteration in dynamic-extent mode
    (the two-lite tier's body).  The images are dealt to the devices as
    solve_bucket deals its chunks.  The same contract as solve_bucket:
    `on_chunk(member_indices, done_iterations, metrics_chunk)` after each
    iteration chunk, `finish(member_indices, fdata_device [1, C, HB,
    WB])` per image."""
    job = _Dyn2Solve(images, bucket, weight, pweights, iterations,
                     simd_compat_logging, on_chunk, iter_chunk, finish)
    return _solve_on_cards(job, data_parallel, devices, device)


class _ExactSolve(_BucketSolve):
    """The exact-geometry class (solve_batched): one image per work item,
    on the two-kernel tier; on_chunk(members, iterations, metrics) fires
    after each."""

    def __init__(self, datas, quants, samps, weight, pweights, iterations,
                 simd_compat_logging, on_chunk=None, finish=None):
        super().__init__(len(datas), iterations, finish)
        self.args = (datas, quants, samps, weight, pweights, iterations,
                     simd_compat_logging)
        self.on_chunk = on_chunk

    def items(self):
        return [[i] for i in range(len(self.args[0]))]

    def solve(self, members, device):
        (i,) = members
        datas, quants, samps, weight, pweights, iterations, simd = self.args
        fd, self.metrics[i] = solve_joint(datas[i], quants[i], samps, weight,
                                          pweights, iterations, simd, device,
                                          tier="two")
        if self.on_chunk is not None:
            self.on_chunk(members, iterations, self.metrics[members])
        return fd[None]


def solve_batched(
    datas: Sequence[Sequence[np.ndarray]],   # [B][C] int16 coef tensors
    quants: Sequence[Sequence[np.ndarray]],  # [B][C] quant tables
    samps: Sequence[Tuple[int, int]],
    weight: float,
    pweights: Sequence[float],
    iterations: int,
    simd_compat_logging: bool = True,
    device="cuda",
    data_parallel: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> BatchResult:
    """The exact-geometry class: B images of one geometry, solved one at
    a time on the two-kernel tier (what the mega gate refuses), dealt to
    the devices as solve_bucket deals its chunks.  fdata [B, C, H, W] on
    the first device."""
    job = _ExactSolve(datas, quants, samps, weight, pweights, iterations,
                      simd_compat_logging)
    return _solve_on_cards(job, data_parallel, devices, device)


def plan_buckets(images: Sequence[Optional[JpegImage]],
                 pweights: Sequence[float]) -> Dict[Tuple, List[int]]:
    """Bucket keys -> member indices (None entries skipped), by
    solver.tier_rule, the single-image tier rule, applied to the canvas
    each class would run: a "dyn" key ("dyn", HB, WB, samps) is a K3
    bucket (quantized_bucket_for) whose tier is mega or mega-lite; a
    "dyn2" key ("dyn2", HB, WB, samps) a two-lite bucket
    (two_lite_bucket_for) whose tier is two-lite; an "exact" key
    ("exact",) + geometry_key holds the rest, for the two-kernel tier."""
    buckets: Dict[Tuple, List[int]] = defaultdict(list)
    for i, img in enumerate(images):
        if img is None:
            continue
        samps = tuple(_samps(img))
        n_prob = sum(1 for p in pweights[:img.nchannel] if p != 0.0)
        bucket = quantized_bucket_for(img)
        if tier_rule(img.nchannel, *bucket, samps, n_prob) in (
                "mega", "mega-lite"):
            buckets[("dyn",) + bucket + (samps,)].append(i)
            continue
        b2 = two_lite_bucket_for(img)
        if (b2 is not None and tier_rule(img.nchannel, *b2, samps, n_prob)
                == "two-lite"):
            buckets[("dyn2",) + b2 + (samps,)].append(i)
        else:
            buckets[("exact",) + geometry_key(img)].append(i)
    return buckets


def bucket_tier(key: Tuple, pweights: Sequence[float]) -> str:
    """The solver tier a planned bucket runs: mega or mega-lite for a
    "dyn" key (tier_rule on its canvas), two-lite for "dyn2", two for
    "exact"."""
    if key[0] == "dyn2":
        return "two-lite"
    if key[0] != "dyn":
        return "two"
    samps = key[3]
    n_prob = sum(1 for p in pweights[:len(samps)] if p != 0.0)
    return tier_rule(len(samps), key[1], key[2], samps, n_prob)


def _item_cost(key: Tuple, img: JpegImage, n: int) -> int:
    """A work item's size for the schedule: canvas pixels times images."""
    if key[0] == "exact":
        return n * img.height * img.width
    return n * key[1] * key[2]


def decode_files_batched(
    infiles: Sequence[str],
    cfg: SolverConfig,
    bits: int = 8,
    io_threads: int = 8,
    logger=None,
    errors: Optional[List[str]] = None,
    progress=None,
    stats: Optional[dict] = None,
    on_pixels=None,
    device="cuda",
    data_parallel: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Dict[str, np.ndarray]:
    """Read, bucket, batch-solve and colour-convert many files (joint
    mode only).  Returns {infile: pixels}.

    The work items of every bucket (a dyn bucket's chunks of up to 8
    images, a dyn2 or exact image) form one queue, largest first, that
    one host thread per device drains (dp_degree(items, data_parallel,
    devices, device)): each image's result is the one device's, bit for
    bit.  In a multi-process run (parallel/distributed.py) each process
    takes the files i % world == rank and solves them on its own card;
    the returned dict, the callbacks and the stats cover those files.

    Error isolation: with `errors` a list, a file that fails to read (or
    a bucket that fails to solve) drops out with a message appended and
    the rest still decode; with errors=None the first failure raises.

    With `progress`/`logger`, buckets run in iteration chunks so the bar
    ticks and CSV rows stream during the solve.  `on_pixels(infile,
    pixels)`, when given, receives each image's pixels as they arrive;
    the calls run on a thread pool (`io_threads` workers), overlapping
    PNG encoding with the remaining solves, and the returned dict is then
    empty.

    `stats`, when given, receives: n_files, n_buckets, bucket_classes
    (dyn, dyn2, exact), bucket_shapes ({"HxW": members} of the dyn and
    dyn2 buckets), bucket_tiers ({tier: images}), k3_dispatches and
    k3_lite_dispatches (the K3 launches the f32 and the lite dyn buckets
    make), read_s (threaded JPEG reads), cards (the device of each
    worker), card_items and card_busy_s (the work items each worker ran
    and its seconds inside them), solve_s (bucket solves including the
    device-side crop, colour and the pixel fetch), on_pixels_s (seconds
    inside on_pixels, summed over threads) and wall_s (the read pool's
    start to the last solve's or callback's end), png_strips and
    png_bytes (the strips and file bytes of the PNGs the callbacks wrote,
    io/png_writer.py).  Each is read from the spans of the call:
    "read.pool", "solve.pool" (the work items' set-up and the card
    workers), one "item" per work item, one "on_pixels" per callback (a
    child of the item that fetched the pixels), the "png" spans that close
    inside the callbacks.
    """
    if devices is None:
        resolve_device(device)    # no card: RuntimeError before any read
    world = distributed.world_size()
    if world > 1:
        # the JAX package's split (runner.py:202-209): batched serving
        # needs no collectives, each process serves its own files
        rank = distributed.rank()
        infiles = [f for i, f in enumerate(infiles) if i % world == rank]

    def read_one(f):
        try:
            img = read_jpeg(f)
            require_supported(img)
            return img
        except (ValueError, OSError) as e:
            if errors is None:
                raise
            errors.append(f"{f}: {e}")
            return None

    with profiling.span("read.pool") as read_span, \
            concurrent.futures.ThreadPoolExecutor(io_threads) as pool:
        images = list(pool.map(read_one, infiles))

    iterations = cfg.iterations[0]
    buckets = plan_buckets(images, cfg.pweights)
    streamed = logger is not None or progress is not None
    if stats is not None:
        stats["n_files"] = sum(1 for im in images if im is not None)
        stats["n_buckets"] = len(buckets)
        stats["bucket_classes"] = {
            cls: sum(1 for k in buckets if k[0] == cls)
            for cls in ("dyn", "dyn2", "exact")}
        stats["bucket_shapes"] = {
            f"{k[0]} {k[1]}x{k[2]}" + ("" if k[3] == ((1, 1), (2, 2), (2, 2))
                                       else f" {k[3]}"): len(v)
            for k, v in buckets.items() if k[0] != "exact"}
        tiers = {k: bucket_tier(k, cfg.pweights) for k in buckets}
        stats["bucket_tiers"] = {
            t: sum(len(v) for k, v in buckets.items() if tiers[k] == t)
            for t in ("mega", "mega-lite", "two-lite", "two")}
        for name, tier in (("k3_dispatches", "mega"),
                           ("k3_lite_dispatches", "mega-lite")):
            stats[name] = sum(
                bucket_dispatches(len(v), iterations, streamed)
                for k, v in buckets.items() if tiers[k] == tier)
        stats["read_s"] = read_span.seconds

    out: Dict[str, np.ndarray] = {}
    lock = threading.Lock()
    failed_buckets = set()

    def deliver(parent, infile, pix):
        with profiling.within(parent), profiling.collected("png") as pngs, \
                profiling.span("on_pixels") as sp:
            on_pixels(infile, pix)
        return sp, pngs

    def fail(b, members, e):
        """Bucket b drops out: one error line per member, once."""
        if errors is None:
            raise e
        with lock:
            if b not in failed_buckets:
                failed_buckets.add(b)
                errors.extend(f"{infiles[i]}: {e}" for i in members)

    def guarded(b, members, run, dev):
        if b in failed_buckets:
            return
        try:
            run(dev)
        except (ValueError, OSError) as e:
            fail(b, members, e)

    with concurrent.futures.ThreadPoolExecutor(io_threads) as cb_pool, \
            profiling.span("solve.pool") as solve_span:
        jobs = []

        def emit(i, fd):
            pix = canvas_pixels(fd, images[i], bits)
            if on_pixels is None:
                out[infiles[i]] = pix
            else:
                jobs.append(cb_pool.submit(deliver, profiling.current(),
                                           infiles[i], pix))

        work = []
        for b, (key, members) in enumerate(buckets.items()):
            imgs = [images[i] for i in members]
            C = imgs[0].nchannel
            ch_id = 3 if C > 1 else 0

            def on_chunk(mbs, done, metrics_chunk, members=members,
                         ch_id=ch_id):
                n = metrics_chunk.shape[1]
                if logger is not None:
                    for bi, m in enumerate(mbs):
                        logger.log_metrics(infiles[members[m]], ch_id,
                                           metrics_chunk[bi],
                                           start_iteration=done - n)
                if progress is not None:
                    progress.increment(len(mbs) * n)

            def finish(mbs, f_dev, members=members):
                for bi, m in enumerate(mbs):
                    emit(members[m], f_dev[bi])

            args = (cfg.weights[0], list(cfg.pweights[:C]), iterations,
                    cfg.simd_compat_logging)
            try:
                if key[0] == "exact":
                    job = _ExactSolve(
                        *_planes(imgs), _samps(imgs[0]), *args,
                        on_chunk=on_chunk if streamed else None,
                        finish=finish)
                else:
                    cls = _DynSolve if key[0] == "dyn" else _Dyn2Solve
                    job = cls(imgs, (key[1], key[2]), *args,
                              on_chunk if streamed else None, None, finish)
            except (ValueError, OSError) as e:
                fail(b, members, e)
                continue
            for item in job.items():
                work.append((_item_cost(key, imgs[item[0]], len(item)),
                             functools.partial(
                                 guarded, b, members,
                                 functools.partial(job.run, item))))
        # largest first: the last items to start are the short ones, so the
        # workers finish close together
        work.sort(key=lambda w: -w[0])
        devs = dp_degree(len(work), data_parallel, devices, device)
        _run_on_cards([fn for _, fn in work], devs, stats)
    # result() surfaces callback exceptions
    cb_spans, pngs = [], []
    for job in jobs:
        sp, png = job.result()
        cb_spans.append(sp)
        pngs += png
    if stats is not None:
        stats["solve_s"] = solve_span.seconds
        stats["on_pixels_s"] = sum(sp.seconds for sp in cb_spans)
        for key in ("strips", "bytes"):
            stats[f"png_{key}"] = sum(sp.attrs.get(key, 0) for sp in pngs)
        t_end = max([solve_span.t1] + [sp.t1 for sp in cb_spans])
        stats["wall_s"] = (t_end - read_span.t0) / 1e9
    return out
