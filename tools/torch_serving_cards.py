"""Serve on several CUDA cards with the PyTorch port, and solve a batch of
giant images over card groups.

    python3 tools/torch_serving_cards.py [--cards 4]
    python3 tools/torch_serving_cards.py --device cpu --cards 4 --files 6 \\
        --iterations 3 --tile 1 --jpeg tests/fixtures/photo600x400_q20_420.jpg

Four runs, each held to a reference, any miss exits non-zero:

  * serving: `cli --tpu-batch` on the 48-file corpus
    (tests/fixtures/torch_serving, the first --files of it) on 1, 2 and
    --cards cards (a process each, CUDA_VISIBLE_DEVICES naming the
    cards), and once more on --cards cards with -t 2 (which caps the
    cards, and the host threads, at 2).  Each process decodes the corpus
    twice and reports the second run: files/s, the runner's solve_s, each
    card's work items and busy seconds, and the PNG writes' thread-s.
    Every PNG must equal the one-card run's, pixel for pixel;
  * processes: `cli --tpu-batch --tpu-distributed` as --cards processes
    on localhost, one card each (NCCL; gloo with --device cpu): process
    r serves the files i % cards == r (after a warm-up of its share on
    its card, outside the group).  The buckets then hold other
    images than on one card, so each PNG is held to > 45 dB against the
    one-card run's;
  * batched striping: two copies of chip_smoke.py's problem (the 3072x2048
    smoke JPEG's blocks tiled --tile x --tile; 4: 12288 x 8192, 100.7 MP)
    as 2 images x 2 bands over 4 cards
    (parallel.mesh.batch_stripe_mesh, stripes.solve_striped_batched),
    each bit-equal to the same image striped over 2 cards; ms per
    iteration (CUDA events, the second of two runs) and each card's peak
    memory;
  * batched striping over processes: the same 2 x 2 batch as 4 processes
    on localhost, one card each (NCCL; gloo with --device cpu), image b
    on processes 2b and 2b + 1 with a sub-group of its own
    (batch_stripe_mesh in a joined group); every process's result, both
    images, bit-equal to the image striped over 2 cards in one process
    (by SHA-256); ms per iteration on each process (CUDA events on its
    card, the second of two runs) and the slowest, beside the in-process
    batch and the one image on 2 cards.

With --device cpu every run is a rehearsal on the CPU: the serving runs
use the one CPU worker the CLI gives, the batched striping four CPU
bands, the processes gloo (one thread each, as the batched striping's
reference).  Prints the first card's name and power limit,
then one JSON line of the results.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import pathlib
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SERVING = ROOT / "tests" / "fixtures" / "torch_serving"
SMOKE_JPEG = ROOT / "tests" / "fixtures" / "torch_smoke_art3072x2048_q30_420.jpg"
OUT = ROOT / "jpeg2png_tpu_torch" / "_build" / "serving_cards"


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"torch_serving_cards: {msg}")


def _corpus(args):
    return sorted(SERVING.glob("*.jpg"))[:args.files]


def _argv(args, files, out_dir):
    return ([str(f) for f in files]
            + [a for f in files for a in ("-o", str(out_dir / (f.stem + ".png")))]
            + ["-q", "-i", str(args.iterations), "--tpu-batch",
               "--device", args.device])


def serve_worker(args) -> None:
    """One serving process: cli --tpu-batch twice (a warm-up, then the
    measured run) on the cards this process sees; writes the measured
    run's stats to --result."""
    from jpeg2png_tpu_torch.cli import main as cli_main

    files = _corpus(args)
    out_dir = pathlib.Path(args.out_dir)
    extra = [] if args.threads is None else ["-t", str(args.threads)]
    warm = out_dir / "warm-up"
    warm.mkdir(parents=True, exist_ok=True)
    _check(cli_main(_argv(args, files, warm) + extra) == 0,
           "warm-up serving run failed")
    stats = {}
    t0 = time.perf_counter()
    rc = cli_main(_argv(args, files, out_dir) + extra, stats=stats)
    wall_s = time.perf_counter() - t0
    _check(rc == 0, "serving run failed")
    stats["cli_wall_s"] = wall_s
    stats["files_per_s"] = len(files) / wall_s
    pathlib.Path(args.result).write_text(json.dumps(stats))


def proc_worker(args) -> None:
    """One process of the multi-process serving run (JPEG2PNG_* from the
    environment): cli --tpu-batch --tpu-distributed; writes its stats."""
    import torch

    from jpeg2png_tpu_torch import runner
    from jpeg2png_tpu_torch.cli import main as cli_main
    from jpeg2png_tpu_torch.parallel import distributed
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    rank = int(os.environ["JPEG2PNG_PROCESS_ID"])
    world = int(os.environ["JPEG2PNG_NUM_PROCESSES"])
    files = _corpus(args)
    if args.device == "cpu":
        torch.set_num_threads(1)        # the processes share the host's cores
    # a warm-up of this rank's share on its card, outside the group: the
    # measured run then finds the libraries loaded and the card's context
    # made, as the serving runs' second run does
    device = "cpu"
    if args.device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    runner.decode_files_batched(
        [str(f) for f in files[rank::world]],
        SolverConfig(iterations=(args.iterations,) * 3), devices=[device])
    stats = {}
    t0 = time.perf_counter()
    rc = cli_main(_argv(args, files, pathlib.Path(args.out_dir))
                  + ["--tpu-distributed"], stats=stats)
    stats["cli_wall_s"] = time.perf_counter() - t0
    _check(rc == 0 and not distributed.is_joined(),
           f"rank {rank}: returned {rc}")
    pathlib.Path(args.result).write_text(json.dumps(stats))


def _spawn(args, mode, out_dir, result, env_extra, threads=None):
    argv = [sys.executable, __file__, mode, "--device", args.device,
            "--files", str(args.files), "--iterations", str(args.iterations),
            "--out-dir", str(out_dir), "--result", str(result)]
    if threads is not None:
        argv += ["--threads", str(threads)]
    return subprocess.Popen(argv, env=dict(os.environ, **env_extra), cwd=ROOT)


def _wait(procs, timeout: float) -> list:
    """The exit codes of `procs`, waiting `timeout` seconds at most; the
    first failure (or the deadline) kills the rest, since a process whose
    peer died waits in its collectives until the backend's own timeout."""
    deadline = time.monotonic() + timeout
    try:
        while (any(p.poll() is None for p in procs)
               and all(p.returncode in (None, 0) for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def _psnr(a, b) -> float:
    import numpy as np

    mse = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean()
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def serving(args) -> dict:
    """cli --tpu-batch on 1, 2, ..., --cards cards and with -t 2, each in a
    process of its own; every PNG equal to the one-card run's."""
    import numpy as np

    from chip_smoke import read_own_png

    files = _corpus(args)
    counts = [n for n in (1, 2, 4) if n < args.cards] + [args.cards]
    runs = [(f"{n} card{'s' * (n > 1)}", n, None) for n in counts]
    runs.append((f"{args.cards} cards, -t 2", args.cards, 2))
    out = {}
    for label, n, threads in runs:
        out_dir = OUT / label.replace(" ", "_").replace(",", "")
        out_dir.mkdir(parents=True, exist_ok=True)
        result = out_dir / "stats.json"
        result.unlink(missing_ok=True)
        env = {}
        if args.device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(n))
        rcs = _wait([_spawn(args, "--serve-worker", out_dir, result, env,
                            threads)], args.timeout)
        _check(rcs == [0], f"serving on {label}: exit code {rcs[0]}")
        stats = json.loads(result.read_text())
        out[label] = {k: stats[k] for k in (
            "files_per_s", "cli_wall_s", "solve_s", "read_s", "on_pixels_s",
            "cards", "card_items", "card_busy_s", "n_buckets",
            "bucket_classes", "k3_dispatches")}
        out[label]["dir"] = out_dir
        print(f"  serving on {label}: {stats['files_per_s']:.2f} files/s "
              f"({len(files)} files, {stats['cli_wall_s']:.3f} s), solve_s "
              f"{stats['solve_s']:.3f}, PNG {stats['on_pixels_s']:.3f} "
              f"thread-s; cards {stats['cards']}, items "
              f"{stats['card_items']}, busy s "
              f"{[round(b, 3) for b in stats['card_busy_s']]}", flush=True)
    one = out[runs[0][0]]["dir"]
    for label in out:
        d = out[label].pop("dir")
        for f in files:
            png = f.stem + ".png"
            _check(np.array_equal(read_own_png(d / png),
                                  read_own_png(one / png)),
                   f"serving on {label}: {png} differs from the one-card "
                   "run's")
        out[label]["pixel_equal_to_one_card"] = True
    return out


def processes(args, one_card_dir: pathlib.Path) -> dict:
    """cli --tpu-batch --tpu-distributed as --cards processes; the union
    of their PNGs against the one-card run's (> 45 dB each)."""
    from chip_smoke import read_own_png

    files = _corpus(args)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = OUT / "processes"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.png"):
        old.unlink()
    procs, results = [], []
    t0 = time.perf_counter()
    for r in range(args.cards):
        results.append(out_dir / f"stats{r}.json")
        results[-1].unlink(missing_ok=True)
        procs.append(_spawn(args, "--proc-worker", out_dir, results[-1], {
            "JPEG2PNG_COORDINATOR": f"localhost:{port}",
            "JPEG2PNG_NUM_PROCESSES": str(args.cards),
            "JPEG2PNG_PROCESS_ID": str(r)}))
    rcs = _wait(procs, args.timeout)
    wall_s = time.perf_counter() - t0
    _check(rcs == [0] * args.cards, f"process exit codes {rcs}")
    ranks = [json.loads(p.read_text()) for p in results]
    for r, st in enumerate(ranks):
        _check(st["n_files"] == len(files[r::args.cards]),
               f"rank {r} served {st['n_files']} files")
    worst = math.inf
    for f in files:
        worst = min(worst, _psnr(
            read_own_png(out_dir / (f.stem + ".png")),
            read_own_png(one_card_dir / (f.stem + ".png"))))
    _check(worst > 45.0, f"processes: min PSNR {worst:.2f} dB vs one card")
    print(f"  {args.cards} processes: {len(files)} files, {wall_s:.3f} s from "
          f"launch to exit, per rank solve_s "
          f"{[round(st['solve_s'], 3) for st in ranks]}, cli wall s "
          f"{[round(st['cli_wall_s'], 3) for st in ranks]}; min PSNR vs one "
          f"card {worst:.2f} dB", flush=True)
    return {"wall_s_launch_to_exit": wall_s, "min_psnr_vs_one_card": worst,
            "ranks": [{k: st[k] for k in ("n_files", "solve_s", "read_s",
                                          "on_pixels_s", "cli_wall_s",
                                          "cards")} for st in ranks]}


def _problem(args):
    import numpy as np

    from jpeg2png_tpu_torch.io import read_jpeg

    img = read_jpeg(args.jpeg)
    datas = [np.tile(p.data, (args.tile, args.tile, 1, 1)) for p in img.planes]
    return (datas, [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes], 0.3,
            [0.001] * len(img.planes), args.iterations_striped)


def _timed(fn, devices):
    """(result, ms): the second of two runs; CUDA events on the first
    device with every device synchronised (the host clock on the CPU)."""
    import torch

    fn()
    if devices[0].type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    for d in devices:
        torch.cuda.synchronize(d)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    for d in devices:
        torch.cuda.synchronize(d)
    end.record()
    torch.cuda.synchronize(devices[0])
    return out, start.elapsed_time(end)


def _digest(fd, metrics) -> str:
    """SHA-256 of an image's canvas and metrics bytes."""
    h = hashlib.sha256(fd.cpu().numpy().tobytes())
    h.update(metrics.tobytes())
    return h.hexdigest()


def batched_striping(args) -> dict:
    """Two copies of the problem as 2 images x 2 bands over 4 devices,
    each equal to the image striped over 2 devices."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.parallel import stripes
    from jpeg2png_tpu_torch.parallel.mesh import batch_stripe_mesh, stripe_mesh

    if args.device == "cuda":
        devices = [torch.device("cuda", i) for i in range(4)]
    else:
        devices = [torch.device("cpu")] * 4
        # one thread, as in the processes of batched_processes: the CPU's
        # sums split by thread count
        torch.set_num_threads(1)
    datas, quants, samps, weight, pweights, it = _problem(args)
    (ref, m_ref), ms_ref = _timed(lambda: stripes.solve_striped(
        datas, quants, samps, weight, pweights, it,
        stripe_mesh(2, devices[:2])), devices[:2])
    ref = ref.to(devices[0])
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    (fd, m), ms = _timed(lambda: stripes.solve_striped_batched(
        [datas, datas], [quants, quants], samps, weight, pweights, it,
        batch_stripe_mesh(2, 2, devices)), devices)
    peak = [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else None
            for d in devices]
    for b in range(2):
        _check(torch.equal(fd[b], ref) and np.array_equal(m[b], m_ref),
               f"batched striping: image {b} differs from the image striped "
               "over 2 devices")
    H, W = solver.canvas_shape(solver._geometry(datas, samps))
    print(f"  batched striping: 2 images x 2 bands of {W}x{H} "
          f"({H * W / 1e6:.1f} MP) over {[str(d) for d in devices]}, {it} "
          f"iterations: {ms / it:.3f} ms per iteration (one image over 2 "
          f"devices: {ms_ref / it:.3f}); peak GiB per card "
          f"{[None if p is None else round(p / 2**30, 2) for p in peak]}; "
          "each image bit-equal to the 2-device solve", flush=True)
    return {"canvas": [H, W], "mp": H * W / 1e6, "iterations": it,
            "ms_per_iteration": ms / it,
            "ms_per_iteration_one_image_2_devices": ms_ref / it,
            "peak_bytes_per_card": peak, "bit_equal": True,
            "digest": _digest(ref, m_ref)}


def batch_worker(args) -> None:
    """One process of the batched striping over processes (JPEG2PNG_* from
    the environment): its share of batch_stripe_mesh(2, 2) over the
    global devices; writes its times and the digests of both images."""
    import torch

    from jpeg2png_tpu_torch.parallel import distributed, stripes
    from jpeg2png_tpu_torch.parallel.mesh import batch_stripe_mesh

    if args.device == "cpu":
        torch.set_num_threads(1)
    rank, world = distributed.initialize(device=args.device)
    datas, quants, samps, weight, pweights, it = _problem(args)
    mesh = batch_stripe_mesh(2, 2)
    devices = distributed.local_devices()
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    (fd, m), ms = _timed(lambda: stripes.solve_striped_batched(
        [datas, datas], [quants, quants], samps, weight, pweights, it,
        mesh), devices)
    worst = torch.tensor([ms], dtype=torch.float64,
                         device=distributed.home_device())
    torch.distributed.all_reduce(worst, op=torch.distributed.ReduceOp.MAX)
    pathlib.Path(args.result).write_text(json.dumps({
        "rank": rank, "ms": ms, "ms_slowest_rank": float(worst),
        "groups": [list(g.ranks) for g in mesh],
        "comms": [type(g.comm).__name__ for g in mesh],
        "counts": [g.comm.counts for g in mesh if g.devices],
        "peak_bytes": [torch.cuda.max_memory_allocated(d)
                       if d.type == "cuda" else None for d in devices],
        "digests": [_digest(fd[b], m[b]) for b in range(2)]}))
    distributed.shutdown()


def batched_processes(args, batched: dict) -> dict:
    """batched_striping's batch as 4 processes of one card each, image b
    over processes 2b and 2b + 1 (a sub-group each); every process's
    images against the in-process reference's digest."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = OUT / "batched_processes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, results = [], []
    for r in range(4):
        results.append(out_dir / f"rank{r}.json")
        results[-1].unlink(missing_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--batch-worker", "--device",
             args.device, "--jpeg", str(args.jpeg), "--tile", str(args.tile),
             "--iterations-striped", str(args.iterations_striped),
             "--result", str(results[-1])],
            env=dict(os.environ, JPEG2PNG_COORDINATOR=f"localhost:{port}",
                     JPEG2PNG_NUM_PROCESSES="4", JPEG2PNG_PROCESS_ID=str(r)),
            cwd=ROOT))
    rcs = _wait(procs, args.timeout)
    _check(rcs == [0] * 4, f"batched striping over processes: exit codes "
                           f"{rcs}")
    ranks = [json.loads(p.read_text()) for p in results]
    it = batched["iterations"]
    for st in ranks:
        _check(st["groups"] == [[0, 1], [2, 3]]
               and st["comms"].count("DistributedComm") == 1,
               f"rank {st['rank']}: groups {st['groups']}, {st['comms']}")
        _check(st["counts"] == [{"halo": 4 * it, "all_reduce": 2 * it}],
               f"rank {st['rank']}: collectives {st['counts']}")
        _check(st["digests"] == [batched["digest"]] * 2,
               f"rank {st['rank']}: an image differs from the image "
               "striped over 2 devices")
    ms = ranks[0]["ms_slowest_rank"]
    peak = [st["peak_bytes"][0] for st in ranks]
    print(f"  batched striping over 4 processes (a sub-group per image): "
          f"{ms / it:.3f} ms per iteration (slowest rank; per rank "
          f"{[round(st['ms'] / it, 3) for st in ranks]}); in one process "
          f"{batched['ms_per_iteration']:.3f}, one image over 2 devices "
          f"{batched['ms_per_iteration_one_image_2_devices']:.3f}; peak GiB "
          f"per card {[p and round(p / 2**30, 2) for p in peak]}; "
          "every image bit-equal", flush=True)
    return {"ms_per_iteration": ms / it,
            "ms_per_iteration_per_rank": [st["ms"] / it for st in ranks],
            "ms_per_iteration_in_one_process": batched["ms_per_iteration"],
            "ms_per_iteration_one_image_2_devices":
                batched["ms_per_iteration_one_image_2_devices"],
            "peak_bytes_per_card": peak, "bit_equal": True}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--files", type=int, default=48,
                   help="the first FILES of the serving corpus")
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--jpeg", default=str(SMOKE_JPEG))
    p.add_argument("--tile", type=int, default=4)
    p.add_argument("--iterations-striped", type=int, default=50)
    p.add_argument("--timeout", type=int, default=600,
                   help="seconds each child process may take")
    p.add_argument("--serve-worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--proc-worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--batch-worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--out-dir", help=argparse.SUPPRESS)
    p.add_argument("--result", help=argparse.SUPPRESS)
    p.add_argument("--threads", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.serve_worker:
        serve_worker(args)
        return 0
    if args.proc_worker:
        proc_worker(args)
        return 0
    if args.batch_worker:
        batch_worker(args)
        return 0

    import torch

    from jpeg2png_tpu_torch import resolve_device
    from jpeg2png_tpu_torch.kernels import _build

    resolve_device(args.device)        # no card: RuntimeError
    card = "cpu"
    if args.device == "cuda":
        have = torch.cuda.device_count()
        _check(have >= max(args.cards, 4),
               f"{max(args.cards, 4)} cards needed, {have} present")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        # every child process loads the libraries built here once
        build_s = _build.build()
    else:
        build_s = _build.build(list(_build.HOST_LIBRARIES))
    print(card, flush=True)
    print(f"  build: {build_s:.1f} s", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    serve = serving(args)
    serve_s = time.perf_counter() - t0
    one_card = OUT / "1_card"
    t0 = time.perf_counter()
    procs = processes(args, one_card)
    procs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched = batched_striping(args)
    batched_s = time.perf_counter() - t0
    if args.device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batched_procs = batched_processes(args, batched)
    batched_procs_s = time.perf_counter() - t0
    print(json.dumps({"card": card, "cards": args.cards,
                      "files": args.files, "iterations": args.iterations,
                      "serving": serve, "processes": procs,
                      "batched_striping": batched,
                      "batched_striping_processes": batched_procs,
                      "seconds": {"build": build_s, "serving": serve_s,
                                  "processes": procs_s,
                                  "batched_striping": batched_s,
                                  "batched_striping_processes":
                                      batched_procs_s}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
