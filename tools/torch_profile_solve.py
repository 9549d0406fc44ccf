#!/usr/bin/env python
"""Where one solve's time goes, per iteration (torch.profiler trace).

The PyTorch port's counterpart of tools/profile_solve.py.  Runs a solve
of the port on --device, warm, then traces --repeat more inside
utils/profiling.device_trace and prints utils/profiling.trace_breakdown
as "us/iter" lines: each hand-written kernel by its K-number (with its
launches per iteration, which must equal the wrappers' counters), the
small PyTorch device ops by the host op that launched them, the device's
idle time and what the host was doing meanwhile (synchronising, copying
or allocating, launching, other CUDA calls, PyTorch's host work,
Python), then one JSON line with the breakdown, the launch counters and
the untraced wall time of the same solve (device synchronised
around it, the median of 5) beside the traced one.  The loop alone (the
first hand-written kernel's start to the last one's end, set-up and
fetch excluded) is split the same way and held against the untraced
marginal time per iteration, (t(4 x iters) - t(iters)) / (3 x iters),
which cancels the set-up as the bench's marginal rate does; the rest of
the solve, traced and untraced, is printed beside it.

    python tools/torch_profile_solve.py --jpeg \\
        tests/fixtures/torch_smoke_art3072x2048_q30_420.jpg --tier two
    python tools/torch_profile_solve.py --jpeg \\
        tests/fixtures/photo512_q10_420.jpg --tier mega --repeat 20
    python tools/torch_profile_solve.py --jpeg \\
        tests/fixtures/torch_smoke_art3072x2048_q30_420.jpg --tile 4 \\
        --striped 4            # 100.7 MP over 4 bands on one card
    python tools/torch_profile_solve.py --nby 8 --nbx 16 --iters 2 \\
        --device cpu           # host op inventory only
    python tools/torch_profile_solve.py --serve   # cli --tpu-batch, all cards

The problem: --jpeg's coefficients (tiled --tile x --tile), or
utils/timing.synth_coefs(--nby, --nbx); default flags (-w 0.3 -p 0.001).
--tier forces a solver tier (solve_joint(tier=)); --striped N solves in N
row bands on the one device (stripe_mesh(N, [device] * N)) with --body.
An unstriped solve is also split on the host clock, the device
synchronised after each piece, best of 5: solver._build_problem (the
upload, the initial decode, the boxes), the tier's initial carry, and the
tier's run (K3's plan and launch, or the per-iteration launches, and the
metrics fetch).  --serve traces a warm `cli --tpu-batch` run of the
48-file serving corpus (tests/fixtures/torch_serving/, PNGs written) on
every visible card instead, per run: each card's busy and idle time and
each host thread's time in CUDA calls (the profiler records aten ops on
the calling thread only) beside the runner's own stats.
Without a card it raises unless given --device cpu, where the plain
versions run: then no device activity exists and the lines give the host
ops (an inventory, not a timing of any card).  The trace is written to
--trace-dir/trace.json (Perfetto; the discarded and CUDA-only traces in
its warm/ and device/), overwriting only those files.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def problem(args):
    """(datas, quants, samps) of the solve the flags describe."""
    import numpy as np

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.utils.timing import synth_coefs

    if args.jpeg is None:
        return synth_coefs(args.nby, args.nbx)
    img = read_jpeg(args.jpeg)
    return ([np.tile(p.data, (args.tile, args.tile, 1, 1))
             for p in img.planes], [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes])


def traced(run, repeat, n, dev, trace_dir):
    """Trace `repeat` calls of run(): on a card first a discarded trace (a
    process's first profiler run costs more), then one with the CUDA
    activity alone (the device split), then one with the host's aten ops
    too (what the host did during the idle).  Returns (the device
    breakdown, None on the CPU; the host trace's breakdown; the launch
    counts of one traced pass; the host trace's profile)."""
    from jpeg2png_tpu_torch.utils import profiling

    trace_dir = pathlib.Path(trace_dir)
    bd = None
    if dev.type == "cuda":
        with profiling.device_trace(trace_dir / "warm", dev):
            run()
        with profiling.device_trace(trace_dir / "device", dev,
                                    host=False) as prof:
            for _ in range(repeat):
                run()
    profiling.zero_launch_counts()
    with profiling.device_trace(trace_dir, dev) as prof_host:
        for _ in range(repeat):
            run()
    launched = profiling.read_launch_counts()
    if dev.type == "cuda":
        bd = profiling.trace_breakdown(prof, n, launched)
    return bd, profiling.trace_breakdown(prof_host, n, launched), \
        launched, prof_host


def report(bd, bd_host, untraced_us, unit, dev, prof_host, n, top):
    """Print the breakdown lines (per `unit`)."""
    from jpeg2png_tpu_torch.utils import profiling

    if bd is None:     # no device: the host's ops, not a device breakdown
        print(f"{bd_host['wall_us']:10.1f} us/{unit}  wall (traced window, "
              "host)")
        for name, us in profiling.host_op_totals(prof_host, n, top).items():
            print(f"{us:10.1f} us/{unit}  host op {name}")
        return
    for line in profiling.format_breakdown(bd):
        print(line.replace("us/iter", f"us/{unit}"))
    print(f"{'':10} traced (CUDA activity) wall / untraced wall: "
          f"{bd['wall_us'] / untraced_us:.3f}")
    print(f"{bd_host['wall_us']:10.1f} us/{unit}  wall traced with the "
          f"host's aten ops; device idle {bd_host['idle_us']:.1f}, during "
          "it:")
    for c, us in bd_host["host_in_idle_us"].items():
        print(f"{us:10.1f} us/{unit}    host: {c}")
    for name, us in profiling.host_op_totals(prof_host, n, 8).items():
        print(f"{us:10.1f} us/{unit}    host op {name} (top-level)")
    for name, k in sorted(bd["cuda_calls"].items(), key=lambda kv: -kv[1]):
        print(f"{k:10.2f} calls/{unit}  {name}")


def setup_split(run_parts, dev, reps=5) -> dict:
    """Best host microseconds of each piece of one solve over `reps`
    solves: run_parts() yields after each piece, named."""
    import torch

    best = {}
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for name in run_parts():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            best[name] = min(best.get(name, float("inf")), (t1 - t0) * 1e6)
            t0 = t1
    return best


def serve(args, dev) -> int:
    """--serve: trace --repeat warm runs of cli --tpu-batch on the corpus."""
    import torch

    from jpeg2png_tpu_torch.cli import main as cli_main

    files = sorted((ROOT / "tests" / "fixtures" / "torch_serving")
                   .glob("*.jpg"))
    out_dir = ROOT / "jpeg2png_tpu_torch" / "_build" / "profile_serve"
    out_dir.mkdir(parents=True, exist_ok=True)
    argv = [str(f) for f in files] + [
        a for f in files for a in ("-o", str(out_dir / (f.stem + ".png")))]
    argv += ["--tpu-batch", "-q", "--device", str(dev)]

    def run():
        stats = {}
        if cli_main(argv, stats=stats) != 0:
            raise RuntimeError("cli --tpu-batch failed")
        return stats

    run()                                       # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        stats = run()
        walls.append(time.perf_counter() - t0)
    untraced = sorted(walls)[1]                 # the median
    bd, bd_host, launched, prof = traced(run, args.repeat, args.repeat, dev,
                                         args.trace_dir)
    cards = [torch.cuda.get_device_name(d) for d in range(
        torch.cuda.device_count())] if dev.type == "cuda" else ["cpu"]
    print(f"cli --tpu-batch on {len(files)} files, {len(cards)} card(s) "
          f"({cards[0]}); untraced run {untraced:.3f} s "
          f"({len(files) / untraced:.2f} files/s), card busy s "
          f"{stats.get('card_busy_s')}; per run:")
    report(bd, bd_host, untraced * 1e6, "run", dev, prof, args.repeat,
           args.top)
    if bd is not None:
        for d, r in sorted(bd["by_device"].items()):
            print(f"{r['busy_us']:10.1f} us/run  card {d} busy, "
                  f"{r['idle_us']:.1f} idle")
        for t, us in sorted(bd["host_threads_us"].items(),
                            key=lambda kv: -kv[1]):
            print(f"{us:10.1f} us/run  host thread {t} in CUDA calls")
    print(json.dumps({"what": "serve", "files": len(files), "cards": cards,
                      "untraced_s": untraced, "untraced_stats": stats,
                      "launched": launched, "breakdown": bd,
                      "host_breakdown": bd_host if bd is not None else None,
                      "trace": str(pathlib.Path(args.trace_dir)
                                   / "trace.json")}, default=str))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nby", type=int, default=256,
                    help="luma block rows of the synthetic problem")
    ap.add_argument("--nbx", type=int, default=384,
                    help="luma block columns of the synthetic problem")
    ap.add_argument("--jpeg", default=None,
                    help="solve this JPEG's coefficients instead")
    ap.add_argument("--tile", type=int, default=1,
                    help="tile --jpeg's coefficient blocks N x N")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeat", type=int, default=1,
                    help="solves inside the trace (the breakdown divides "
                         "by iters x repeat)")
    ap.add_argument("--tier", default=None,
                    help="force a solver tier (mega, mega-lite, two-lite, "
                         "two)")
    ap.add_argument("--striped", type=int, default=0, metavar="N",
                    help="solve in N row bands on the one device")
    ap.add_argument("--body", default=None, help="striped body: f32, lite")
    ap.add_argument("--serve", action="store_true",
                    help="trace cli --tpu-batch on the serving corpus")
    ap.add_argument("--top", type=int, default=14,
                    help="host ops listed (CPU runs)")
    ap.add_argument("--trace-dir", default=str(
        ROOT / "jpeg2png_tpu_torch" / "_build" / "profile"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from jpeg2png_tpu_torch import resolve_device
    from jpeg2png_tpu_torch.utils import profiling

    dev = resolve_device(args.device)      # no card: RuntimeError
    if args.serve:
        return serve(args, dev)
    datas, quants, samps = problem(args)
    C = len(datas)
    pweights = [0.001] * C
    if args.striped:
        from jpeg2png_tpu_torch.parallel.mesh import stripe_mesh
        from jpeg2png_tpu_torch.parallel.stripes import solve_striped

        mesh = stripe_mesh(args.striped, [dev] * args.striped)

        def run(iters=args.iters):
            return solve_striped(datas, quants, samps, 0.3, pweights,
                                 iters, mesh, body=args.body)
    else:
        from jpeg2png_tpu_torch.models.solver import solve_joint

        def run(iters=args.iters):
            return solve_joint(datas, quants, samps, 0.3, pweights,
                               iters, device=dev, tier=args.tier)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fd, _ = run()                    # warm: kernel builds, first launches
    H, W = fd.shape[-2:]
    del fd

    def untraced(iters):
        """Median microseconds of 5 solves of `iters` iterations."""
        walls = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            run(iters)
            sync()
            walls.append(time.perf_counter() - t0)
        return sorted(walls)[2] * 1e6

    solve_us = untraced(args.iters)
    marginal_us = (untraced(4 * args.iters) - solve_us) / (3 * args.iters)
    untraced_us = solve_us / args.iters
    n = args.iters * args.repeat
    bd, bd_host, launched, prof = traced(run, args.repeat, n, dev,
                                         args.trace_dir)
    what = (f"striped over {args.striped} bands ({args.body or 'default'} "
            f"body)" if args.striped else f"tier {args.tier or 'by rule'}")
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"canvas {W}x{H} ({H * W / 1e6:.2f} MP), {what}, {args.iters} "
          f"iterations x {args.repeat} solves on {card}; untraced "
          f"{untraced_us:.1f} us/iter")
    report(bd, bd_host, untraced_us, "iter", dev, prof, n, args.top)
    if bd is not None and bd["loop_us"] is not None:
        lp, t = bd["loop_us"], bd["timeline_us"]
        rest_traced = (t["before_first_kernel"] + t["after_last_kernel"]) / n
        rest_untraced = untraced_us - marginal_us
        print(f"{marginal_us:10.1f} us/iter  untraced marginal "
              f"(t({4 * args.iters}) - t({args.iters})) / "
              f"{3 * args.iters}; the loop's split / it: "
              f"{lp['sum'] / marginal_us:.3f}")
        print(f"{rest_traced:10.1f} us/iter  the rest of the solve (set-up "
              f"before the loop, fetch after it), traced; untraced "
              f"{rest_untraced:.1f} (solve minus marginal)")
    setup = None
    if not args.striped:
        from jpeg2png_tpu_torch.models import solver

        def parts():
            prob = solver._build_problem(datas, quants, samps, 0.3, pweights,
                                         args.iters, True, dev)
            yield "build_problem"
            tier = solver._resolve_tier(prob, args.tier, pweights)
            carry = solver._initial_carry(prob, tier)
            yield "initial_carry"
            solver._run(prob, carry, args.iters, tier)
            yield "run"
        setup = setup_split(parts, dev)
        for name, us in setup.items():
            print(f"{us:10.1f} us/solve  {name} (host clock, synchronised)")
    print(json.dumps({
        "canvas": [int(H), int(W)], "what": what, "iterations": args.iters,
        "repeat": args.repeat, "device": card,
        "untraced_us_per_iter": untraced_us,
        "untraced_marginal_us_per_iter": marginal_us, "launched": launched,
        "setup_us_per_solve": setup,
        "breakdown": bd,
        "host_breakdown": bd_host if bd is not None else None,
        "host_ops_us_per_iter": profiling.host_op_totals(prof, n, args.top),
        "trace": str(pathlib.Path(args.trace_dir) / "trace.json")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
