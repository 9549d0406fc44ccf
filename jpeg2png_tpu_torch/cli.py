"""Command-line interface, flag-for-flag compatible with the reference.

Every flag of jpeg2png (reference: jpeg2png.c:27-117, parsing at
:177-267) is honored with the same names, defaults, validation rules
and output-naming behavior:

  -o/--output, -f/--force, -w/--second-order-weight w[,cb,cr],
  -p/--probability-weight p[,cb,cr], -i/--iterations n[,cb,cr],
  -q/--quiet, -s/--separate-components, -t/--threads,
  -1/--16-bits-png, -c/--csv-log, -h/--help, -V/--version

plus --device {cuda,cpu}: the solve runs on the CUDA card by default
and fails without one; --device cpu runs the plain PyTorch path; and the
JAX package's --tpu-* flags for the same modes:
  --tpu-batch        several inputs in joint mode are solved in mixed-size
                     buckets through the whole-solve kernel (runner.py),
                     spread over every visible card (-t caps the cards);
  --tpu-stripes N    each image is solved in N row bands, one per CUDA
                     card (parallel/stripes.py; with -s each channel on
                     its own); N beyond the cards clamps to them with a
                     warning, and one card runs the single-device solver;
  --tpu-distributed  join a multi-process run (parallel/distributed.py:
                     JPEG2PNG_COORDINATOR, JPEG2PNG_NUM_PROCESSES,
                     JPEG2PNG_PROCESS_ID); the bands are then the
                     processes, and rank 0 writes the outputs; with
                     --tpu-batch each process serves every world-th file
                     on its own card and writes its own PNGs, rank 0
                     the CSV of its files.

    python -m jpeg2png_tpu_torch.cli picture.jpg
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import sys

from jpeg2png_tpu_torch import __version__
from jpeg2png_tpu_torch.utils.config import (
    DEFAULT_ITERATIONS, DEFAULT_PWEIGHT, DEFAULT_WEIGHT, SolverConfig,
)


def _parse_triple(s: str, conv, what: str):
    parts = s.split(",")
    if len(parts) not in (1, 3):
        raise SystemExit(f"invalid {what}")
    try:
        vals = [conv(p) for p in parts]
    except ValueError:
        raise SystemExit(f"invalid {what}")
    return vals


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jpeg2png_tpu_torch",
        description="Silky smooth JPEG decoding on a CUDA GPU — recover "
        "the smoothest image that re-encodes to the input JPEG.",
        epilog="Progress note: the solve runs on the device; the bar's "
        "total counts iterations and advances in resumable device "
        "chunks (per iteration for solves of <= 16 iterations, roughly "
        "8-50 iterations each beyond that).",
        add_help=False,
    )
    p.add_argument("inputs", nargs="*", metavar="picture.jpg")
    p.add_argument("-o", "--output", action="append", default=[],
                   metavar="picture.png",
                   help="output file name; zero times or once per input "
                        "(overwrites when given)")
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite outputs even without explicit -o")
    p.add_argument("-w", "--second-order-weight", default=None,
                   metavar="weight[,cb,cr]",
                   help=f"TGV weight alpha_1 (default {DEFAULT_WEIGHT}; "
                        "chroma defaults to 0; triple requires -s)")
    p.add_argument("-p", "--probability-weight", default=None,
                   metavar="pweight[,cb,cr]",
                   help=f"DCT distance weight (default {DEFAULT_PWEIGHT})")
    p.add_argument("-i", "--iterations", default=None,
                   metavar="iterations[,cb,cr]",
                   help=f"optimization steps (default {DEFAULT_ITERATIONS}; "
                        "triple requires -s)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="don't show the progress bar")
    p.add_argument("-s", "--separate-components", action="store_true",
                   help="optimize components separately")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="max parallelism: host worker threads for "
                        "multi-file IO, and with --tpu-batch also the "
                        "max devices a bucket fans out over (the "
                        "reference's -t bounds OpenMP solve threads; "
                        "here solves are device dispatches, so -t "
                        "bounds both pools)")
    p.add_argument("-1", "--16-bits-png", dest="png16", action="store_true",
                   help="output 16-bit PNG")
    p.add_argument("-c", "--csv-log", default=None, metavar="csv_log",
                   help="write per-iteration optimization log")
    p.add_argument("-h", "--help", action="help",
                   help="display this help text and exit")
    p.add_argument("-V", "--version", action="version",
                   version=f"jpeg2png_tpu_torch version {__version__}")
    p.add_argument("--tpu-stripes", type=int, default=0, metavar="N",
                   help="shard each image into N row stripes across "
                        "devices (0 = auto: single device); with -s, "
                        "each channel runs its own striped solve")
    p.add_argument("--tpu-batch", action="store_true",
                   help="solve several inputs batched: mixed sizes share "
                        "bucketed whole-solve launches, dealt to every "
                        "visible card (joint mode only)")
    p.add_argument("--tpu-distributed", action="store_true",
                   help="join a multi-process run (torch.distributed: "
                        "coordinator/rank from JPEG2PNG_COORDINATOR, "
                        "JPEG2PNG_NUM_PROCESSES, JPEG2PNG_PROCESS_ID); "
                        "stripes then span the processes")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the solve runs (default cuda; cpu runs "
                        "the plain PyTorch path)")
    return p


def config_from_args(args) -> SolverConfig:
    weights = [DEFAULT_WEIGHT, 0.0, 0.0]
    if args.second_order_weight is not None:
        vals = _parse_triple(args.second_order_weight, float, "weight")
        if len(vals) == 3:
            if not args.separate_components:
                raise SystemExit("different weights are only possible when "
                                 "using separated components")
            weights = vals
        else:
            weights = [vals[0], 0.0, 0.0]

    pweights = [DEFAULT_PWEIGHT] * 3
    if args.probability_weight is not None:
        vals = _parse_triple(args.probability_weight, float,
                             "probability weight")
        pweights = vals if len(vals) == 3 else [vals[0]] * 3

    iterations = [DEFAULT_ITERATIONS] * 3
    if args.iterations is not None:
        vals = _parse_triple(args.iterations, int, "number of iterations")
        if len(vals) == 3:
            if not args.separate_components:
                raise SystemExit("different iteration counts are only "
                                 "possible when using separated components")
            iterations = vals
        else:
            iterations = [vals[0]] * 3

    return SolverConfig(
        weights=tuple(weights),
        pweights=tuple(pweights),
        iterations=tuple(iterations),
        separate_components=args.separate_components,
    )


def derive_output_name(infile: str) -> str:
    """original name with .jpg/.jpeg replaced by .png (jpeg2png.c:291-301)."""
    lower = infile.lower()
    if lower.endswith(".jpeg"):
        return infile[:-5] + ".png"
    if lower.endswith(".jpg"):
        return infile[:-4] + ".png"
    return infile + ".png"


def _run_batched(pairs, cfg, bits, logger, progress, threads, device,
                 stats):
    """--tpu-batch: one bucketed solve per bucket (runner.py); PNGs are
    written from the runner's on_pixels as each image's pixels arrive.
    Returns the error lines."""
    import collections
    import threading

    from jpeg2png_tpu_torch.io import write_png
    from jpeg2png_tpu_torch.runner import decode_files_batched

    outmap = collections.defaultdict(list)
    for infile, outfile in pairs:
        outmap[infile].append(outfile)
    errors = []
    lock = threading.Lock()

    def on_pixels(infile, pix):
        for outfile in outmap[infile]:
            try:
                write_png(outfile, pix, bits)
            except (ValueError, OSError) as e:
                with lock:
                    errors.append(f"{infile}: {e}")

    decode_files_batched(list(outmap), cfg, bits, io_threads=threads or 8,
                         logger=logger, errors=errors, progress=progress,
                         on_pixels=on_pixels, stats=stats, device=device,
                         data_parallel=threads)
    return errors


def main(argv=None, stats=None) -> int:
    """Run the CLI on `argv` (default sys.argv[1:]); returns the exit
    code.  `stats`, a dict, receives the runner's stage breakdown of a
    --tpu-batch run (runner.decode_files_batched)."""
    args = build_parser().parse_args(argv)
    if not args.inputs:
        build_parser().print_help()
        return 1

    cfg = config_from_args(args)
    bits = 16 if args.png16 else 8

    nin = len(args.inputs)
    nout = len(args.output)
    if nout not in (0, nin):
        raise SystemExit("must give output file names for all input files "
                         "or none")

    if nout:
        outfiles = list(args.output)
    else:
        outfiles = []
        for infile in args.inputs:
            if not os.path.exists(infile):
                raise SystemExit(f"could not open input file `{infile}`")
            outfile = derive_output_name(infile)
            if not args.force and os.path.exists(outfile):
                raise SystemExit(f"not overwriting output file `{outfile}`")
            outfiles.append(outfile)

    # lazy imports so --help/--version don't pay for torch startup
    from jpeg2png_tpu_torch import resolve_device
    from jpeg2png_tpu_torch.parallel import distributed
    from jpeg2png_tpu_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    device = resolve_device(args.device)   # no card: RuntimeError, no fallback
    batched = args.tpu_batch and nin > 1 and not cfg.separate_components
    # a group this call joins, it leaves before returning; a caller's
    # group stays joined
    joined_here = False
    if args.tpu_distributed:
        joined_here = not distributed.is_joined()
        distributed.initialize(device=device)
    try:
        rc = _decode_all(args, cfg, bits, outfiles, device, batched, stats)
    except BaseException:
        if joined_here:     # the other processes may never reach a barrier
            distributed.shutdown(sync=False)
        raise
    if joined_here:
        distributed.shutdown()
    return rc


def _decode_all(args, cfg, bits, outfiles, device, batched, stats) -> int:
    """Every input's decode (one after another, on threads, or batched);
    returns the exit code."""
    from jpeg2png_tpu_torch.parallel.distributed import (
        is_multi_process, is_primary, world_size)
    from jpeg2png_tpu_torch.pipeline import decode_file
    from jpeg2png_tpu_torch.utils.logger import ConvergenceLogger
    from jpeg2png_tpu_torch.utils.progress import ProgressBar

    nin = len(args.inputs)
    # host side effects happen once, on rank 0: one CSV, one progress bar
    primary = is_primary()
    csv_f = open(args.csv_log, "w") if (args.csv_log and primary) else None
    # without a CSV nothing listens to the metrics: solves run one-shot
    logger = ConvergenceLogger(csv_f) if csv_f else None
    total = (nin * cfg.iterations[0] if not cfg.separate_components
             else nin * sum(cfg.iterations))
    if batched:
        # the runner solves each distinct input once, and in a
        # multi-process run rank 0 only every world-th of them
        # (runner.decode_files_batched): the bar counts rank 0's share
        distinct = list(dict.fromkeys(args.inputs))
        total = len(distinct[::world_size()]) * cfg.iterations[0]
    progress = None if (args.quiet or not primary) else ProgressBar(total)

    def run_one(pair):
        infile, outfile = pair
        try:
            decode_file(infile, outfile, cfg, bits, logger, progress,
                        device=device, stripes=args.tpu_stripes)
            return None
        except (ValueError, OSError) as e:
            return f"{infile}: {e}"

    # per-image error isolation: one bad file doesn't kill the batch
    # (an improvement over the reference, where die() exits)
    pairs = list(zip(args.inputs, outfiles))
    if batched:
        errors = _run_batched(pairs, cfg, bits, logger, progress,
                              args.threads, device, stats)
    elif (args.threads and args.threads > 1 and nin > 1
          and not is_multi_process()):
        # threads only in a single process: every rank of a multi-process
        # run must reach each file's collectives in the same order
        with concurrent.futures.ThreadPoolExecutor(args.threads) as pool:
            errors = [e for e in pool.map(run_one, pairs) if e]
    else:
        errors = [e for e in map(run_one, pairs) if e]

    if progress:
        progress.clear()
    if csv_f:
        csv_f.close()
    for e in errors:
        print(f"jpeg2png_tpu_torch: {e}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
