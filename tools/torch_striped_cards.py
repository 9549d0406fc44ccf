"""Time the PyTorch port's row-striped solve across several CUDA cards.

    python3 tools/torch_striped_cards.py [--cards 4] [--procs 2]
    python3 tools/torch_striped_cards.py --device cpu --cards 4 --procs 2 \\
        --tile 1 --jpeg tests/fixtures/photo600x400_q20_420.jpg --iterations 3

The problem is chip_smoke.py's: the 3072x2048 smoke JPEG's coefficient
blocks tiled --tile x --tile (4: 12288 x 8192, 100.7 MP), default flags
(-w 0.3 -p 0.001), --iterations (50).  It is solved

  * on the two tier over the whole canvas, on one device (the reference);
  * in --cards bands on one device (as chip_smoke.py runs it);
  * in --cards bands, one per card, in this process
    (parallel.mesh.stripe_mesh: halo rows copied between cards, the
    all-reduce summed on card 0);
  * in --cards processes on localhost, one band each
    (parallel.distributed: NCCL on cards, gloo with --device cpu);
  * with --procs P, also in P processes of --cards / P cards and bands
    each (the cards split by distributed.split_cards; on the CPU an even
    share of the bands).

Every striped result must equal the one-band-per-card solve (on the CPU
the bands-on-one-device solve) bit for bit: canvas and metrics, by their
SHA-256.  In each multi-process run the same solve is also checkpointed
(models/checkpoint.py::solve_striped_checkpointed, a snapshot every 2/5
of the iterations: rank 0 gathers every band over NCCL or gloo and
writes, every rank resumes) and cut after 4/5 of them and resumed from
its snapshot: both must equal the one-shot multi-process solve bit for
bit, with the snapshot's bytes and seconds reported (rank 0's clock).
Each striped result is held against the reference (PSNR > 45 dB on the
8-bit RGB pixels) and its collectives counted (3 per iteration); each
solve is timed on the device clock (CUDA events on the first card around
the second of two runs, every card synchronised, set-up included: every
process builds the whole problem; the host clock with --device cpu).  Prints the first card's name and power limit,
then one JSON line of the results; exits non-zero on any miss.  Needs
--cards cards on one host.  Imports nothing of JAX.
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
SMOKE_JPEG = ROOT / "tests" / "fixtures" / "torch_smoke_art3072x2048_q30_420.jpg"


def _problem(args):
    import numpy as np

    from jpeg2png_tpu_torch.io import read_jpeg

    img = read_jpeg(args.jpeg)
    datas = [np.tile(p.data, (args.tile, args.tile, 1, 1)) for p in img.planes]
    return (datas, [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes], 0.3,
            [0.001] * len(img.planes), args.iterations)


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
    """SHA-256 of a result's canvas and metrics bytes."""
    h = hashlib.sha256(fd.cpu().numpy().tobytes())
    h.update(metrics.tobytes())
    return h.hexdigest()


def _rgb8(f):
    import torch

    y, cb, cr = f[0] + 128.0, f[1], f[2]
    rgb = torch.stack([y + 1.402 * cr, y - 0.34414 * cb - 0.71414 * cr,
                       y + 1.772 * cb]).clamp(0.0, 255.0)
    return rgb.to(torch.int32).to(torch.float64)


def _psnr(a, b) -> float:
    """PSNR of the 8-bit RGB pixels; equal pixels read as 999 dB."""
    a, b = _rgb8(a), _rgb8(b.to(a.device))
    mse = float(((a - b) ** 2).mean())
    return 999.0 if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"torch_striped_cards: {msg}")


def _host_s(fn, device):
    """(fn(), host seconds), the device synchronised before and after."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _checkpointed(args, problem, fd, metrics, device) -> dict:
    """The multi-process solve checkpointed and cut-and-resumed, each held
    bit-equal to the one-shot (fd gathered, metrics); rank 0's numbers."""
    import numpy as np
    import torch

    from jpeg2png_tpu_torch.models import checkpoint, solver
    from jpeg2png_tpu_torch.parallel import distributed
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
    from jpeg2png_tpu_torch.parallel.stripes import striped_steps

    it = args.iterations
    every, crash = max(1, 2 * it // 5), max(1, 4 * it // 5)
    path = ROOT / "jpeg2png_tpu_torch" / "_build" / "striped_cards_ckpt.npz"
    res, ckpt_s = _host_s(lambda: checkpoint.solve_striped_checkpointed(
        *problem, stripe_mesh(args.cards), str(path),
        checkpoint_every=every), device)
    _check(torch.equal(res.fdata, fd) and np.array_equal(res.metrics, metrics)
           and res.resumed_from == 0 and not path.exists(),
           "checkpointed solve differs from the one-shot solve")
    mesh = stripe_mesh(args.cards)
    _, head, carry = striped_steps(*problem, mesh, nsteps=crash)
    host, gather_s = _host_s(lambda: checkpoint.gather_striped_carry(carry),
                             device)
    fp = checkpoint.striped_fingerprint(
        solver._geometry(problem[0], problem[2]), mesh.n, "f32",
        *problem[3:], True)
    _, save_s = _host_s(lambda: checkpoint.save_state(str(path), host, crash,
                                                      fp), device)
    nbytes = path.stat().st_size
    del carry, host
    res, resume_s = _host_s(lambda: checkpoint.solve_striped_checkpointed(
        *problem, stripe_mesh(args.cards), str(path),
        checkpoint_every=every), device)
    _check(torch.equal(res.fdata, fd) and res.resumed_from == crash
           and np.array_equal(np.concatenate([head, res.metrics]), metrics)
           and not path.exists(),
           f"resumed solve (rank {distributed.rank()}, from "
           f"{res.resumed_from}) differs from the one-shot solve")
    return {"bit_equal": True, "every": every, "crash": crash,
            "file_bytes": nbytes, "gather_s": gather_s, "save_s": save_s,
            "checkpointed_s": ckpt_s, "resume_s": resume_s}


def worker(args) -> None:
    """One process of a multi-process run: its share of the --cards bands
    (one band on a card each, or several); rank 0 solves the reference on
    its own device and writes the results."""
    import torch

    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.parallel import distributed
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
    from jpeg2png_tpu_torch.parallel.stripes import solve_striped

    if args.device == "cpu":
        # the processes share the host's cores; and one thread, as in the
        # parent: the CPU's sums split by thread count
        torch.set_num_threads(1)
    rank, world = distributed.initialize(device=args.device)
    device = distributed.home_device()
    problem = _problem(args)
    mesh = stripe_mesh(args.cards)
    (fd, metrics), ms = _timed(lambda: solve_striped(*problem, mesh),
                               distributed.local_devices())
    counts = dict(mesh.comm.counts)
    fd = distributed.gather_output(fd)
    worst = torch.tensor([ms], dtype=torch.float64, device=device)
    torch.distributed.all_reduce(worst, op=torch.distributed.ReduceOp.MAX)
    ckpt = _checkpointed(args, problem, fd, metrics, device)
    if distributed.is_primary():
        ref, _ = solver.solve_joint(*problem, device=device, tier="two")
        out = {"ms": ms, "ms_slowest_rank": float(worst), "counts": counts,
               "psnr_vs_two": _psnr(fd, ref), "world": world,
               "bands_per_process": len(mesh.devices),
               "cards_per_process": len(set(mesh.devices)),
               "digest": _digest(fd, metrics), "checkpoint": ckpt}
        pathlib.Path(os.environ["STRIPED_CARDS_OUT"]).write_text(
            json.dumps(out))
    distributed.barrier()
    torch.distributed.destroy_process_group()


def _wait_all(procs, timeout: float) -> list:
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


def _multi_process(args, procs: int) -> dict:
    """The worker in `procs` processes on localhost; rank 0's results."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = (ROOT / "jpeg2png_tpu_torch" / "_build"
           / f"striped_cards_{procs}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    argv = [sys.executable, __file__, "--worker", "--device", args.device,
            "--jpeg", str(args.jpeg), "--tile", str(args.tile),
            "--iterations", str(args.iterations), "--cards", str(args.cards)]
    children = []
    for i in range(procs):
        env = dict(os.environ, JPEG2PNG_COORDINATOR=f"localhost:{port}",
                   JPEG2PNG_NUM_PROCESSES=str(procs),
                   JPEG2PNG_PROCESS_ID=str(i), STRIPED_CARDS_OUT=str(out))
        children.append(subprocess.Popen(argv, env=env, cwd=ROOT))
    rcs = _wait_all(children, args.timeout)
    _check(rcs == [0] * procs, f"{procs} processes: worker exit codes {rcs}")
    return json.loads(out.read_text())


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--procs", type=int, default=None,
                   help="also run the bands in this many processes, "
                        "--cards / PROCS cards each")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--jpeg", default=str(SMOKE_JPEG))
    p.add_argument("--tile", type=int, default=4)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--timeout", type=int, default=600,
                   help="seconds each worker process may take")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        worker(args)
        return 0

    import torch

    from jpeg2png_tpu_torch import resolve_device
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
    from jpeg2png_tpu_torch.parallel.stripes import solve_striped

    device = resolve_device(args.device)        # no card: RuntimeError
    if device.type == "cpu":
        torch.set_num_threads(1)        # as in the workers: the same sums
    n, it = args.cards, args.iterations
    _check(args.procs is None or (0 < args.procs <= n and n % args.procs == 0),
           f"--procs {args.procs} does not divide --cards {n}")
    card = "cpu"
    if device.type == "cuda":
        _check(torch.cuda.device_count() >= n,
               f"{n} cards asked for, {torch.cuda.device_count()} present")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        device = torch.device("cuda", 0)
    print(card, flush=True)
    problem = _problem(args)
    (ref, _), ms_two = _timed(
        lambda: solver.solve_joint(*problem, device=device, tier="two"),
        [device])
    runs = {"two": {"ms": ms_two}}
    for label, devices in (("bands on one device", [device] * n),
                           ("one band per card", None)):
        if devices is None and device.type != "cuda":
            continue
        mesh = stripe_mesh(n, devices)
        (fd, metrics), ms = _timed(lambda: solve_striped(*problem, mesh),
                                   list(mesh.devices))
        runs[label] = {"ms": ms, "counts": dict(mesh.comm.counts),
                       "psnr_vs_two": _psnr(fd, ref),
                       "digest": _digest(fd, metrics)}
        del fd
    del ref
    if device.type == "cuda":
        torch.cuda.empty_cache()
    runs["one band per process"] = _multi_process(args, n)
    if args.procs is not None and args.procs != n:
        runs[f"{args.procs} processes x {n // args.procs} bands"] = (
            _multi_process(args, args.procs))
    want_digest = runs["one band per card" if device.type == "cuda"
                       else "bands on one device"]["digest"]
    for label, r in runs.items():
        if label == "two":
            continue
        # two solves (warm, timed) on each mesh: 3 collectives per
        # iteration each
        want = {"halo": 4 * it, "all_reduce": 2 * it}
        _check(r["counts"] == want, f"{label}: collectives {r['counts']}, "
                                    f"expected {want}")
        _check(r["psnr_vs_two"] > 45.0,
               f"{label}: PSNR {r['psnr_vs_two']:.2f} <= 45 dB")
        _check(r["digest"] == want_digest,
               f"{label}: the result differs from the in-process solve's")
    H, W = solver.canvas_shape(solver._geometry(problem[0], problem[2]))
    print(json.dumps({"card": card, "cards": n, "canvas": [H, W],
                      "mp": H * W / 1e6, "iterations": it,
                      "ms_per_iteration": {k: v["ms"] / it
                                           for k, v in runs.items()},
                      "bit_equal": True,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
