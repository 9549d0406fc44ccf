"""Fingerprints of what the port computes, for holding a refactor bit-equal
to an earlier tree.

Run once with each tree's package and compare the two JSON files:

    python3 tools/torch_bit_equal.py --root . --out new.json
    python3 tools/torch_bit_equal.py --root /path/to/old --out old.json
    python3 tools/torch_bit_equal.py --compare old.json new.json

`--root` is the checkout whose jpeg2png_tpu_torch is imported; the
inputs come from this file's checkout.  SHA-256 of, on `--device`:
  * each fixture's solver set-up (_build_problem's tensors) and plain
    decode;
  * runner.prepare_chunk of every dyn bucket the fixtures plan into;
  * runner.decode_files_batched over the fixtures, per image its pixels
    and its metric rows as floats, under the committed tier gates and
    under two sets of opened gates, so that every class runs (dyn, dyn
    lite, dyn2, exact), each one-shot and streamed (iteration chunks);
  * pipeline.decode_file per fixture (pixels, metrics) and `cli.main -c`
    per fixture (PNG and CSV bytes);
  * with `--bench-seed N`, the PNG bytes of one `cli --tpu-batch -q` call
    over the benchmark's batch48 files of seed N and of `cli -q` per file
    over its cli_each files (benchmark/inputs/corpus.py mints them).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
NAMES = ["lineart64_q20_420", "lineart128_q10_420", "photo80_q30_422",
         "gray64_q30", "odd100x52_q25_420", "art120x88_q40_440",
         "art128x96_q35_411", "photo72_q85_444", "photo600x400_q20_420"]
# (mega, mega-lite, two-lite) pixel gates; None: as committed
GATES = {"committed": None,
         "dyn-lite": (80 * 80, 128 * 128, 64 * 112),
         "dyn2": (80 * 80, 0, 1 << 62)}


def digest(x) -> str:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":
            x = x.view(dtype=__import__("torch").int16)
        x = x.numpy()
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x).tobytes()
    return hashlib.sha256(x).hexdigest()


class RawLog:
    """A ConvergenceLogger stand-in that keeps the metric rows as floats."""

    def __init__(self):
        self.rows = {}

    def log_metrics(self, filename, channel, metrics, start_iteration=0):
        key = (pathlib.Path(filename).name, int(channel))
        self.rows.setdefault(key, {})[start_iteration] = np.asarray(metrics)

    def digests(self):
        return {f"{name}/{ch}": digest(np.concatenate(
            [chunks[k] for k in sorted(chunks)]))
            for (name, ch), chunks in sorted(self.rows.items())}


def fixture_prints(device, out, tmp):
    import jpeg2png_tpu_torch as pkg
    from jpeg2png_tpu_torch import cli, runner
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.pipeline import decode_file, plain_decode
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    print(f"package: {pkg.__file__}", file=sys.stderr)
    paths = [FIXTURES / f"{n}.jpg" for n in NAMES]
    images = [read_jpeg(p) for p in paths]
    for name, img in zip(NAMES, images):
        planes = [p.data for p in img.planes], [p.quant for p in img.planes]
        samps = [(p.h_samp, p.w_samp) for p in img.planes]
        prob = solver._build_problem(*planes, samps, 0.3, [0.001] * 3, 50,
                                     True, device)
        for field in ("f0", "dats_c", "qs_c", "los", "his", "dqs_c",
                      "iqs_c", "dqs", "inv_qs"):
            val = getattr(prob, field)
            for c, t in enumerate(val if isinstance(val, list) else [val]):
                out[f"setup/{name}/{field}/{c}"] = digest(t)
        out[f"setup/{name}/step"] = repr(prob.step_size)
        out[f"plain/{name}"] = digest(plain_decode(img, device=device))
    for key, members in runner.plan_buckets(images, [0.001] * 3).items():
        if key[0] != "dyn":
            continue
        tag = "x".join(map(str, key[1:3])) + str(key[3])
        for i in range(0, len(members), runner.CHUNK_IMAGES):
            chunk = [images[m] for m in members[i:i + runner.CHUNK_IMAGES]]
            f0, dats, qs, ext, step = runner.prepare_chunk(
                chunk, key[1:3], 50, device)
            for label, ts in (("f0", [f0]), ("dats", dats), ("qs", qs),
                              ("ext", [ext]), ("step", [step])):
                for c, t in enumerate(ts):
                    out[f"chunk/{tag}/{i}/{label}/{c}"] = digest(t)

    # nine copies of one file make a dyn bucket of two chunks
    files = [str(p) for p in paths] + [str(paths[0])] * 8
    links = []
    for k, f in enumerate(files):
        dst = pathlib.Path(tmp) / f"{k:02d}_{pathlib.Path(f).name}"
        dst.write_bytes(pathlib.Path(f).read_bytes())
        links.append(str(dst))
    saved = (solver.MEGA_MAX_PIXELS, solver.MEGA_LITE_MAX_PIXELS,
             solver.TWO_LITE_MAX_PIXELS)
    for label, gates in GATES.items():
        (solver.MEGA_MAX_PIXELS, solver.MEGA_LITE_MAX_PIXELS,
         solver.TWO_LITE_MAX_PIXELS) = gates or saved
        for iters in (5, 20):
            cfg = SolverConfig(iterations=(iters,) * 3)
            for streamed in (False, True):
                log = RawLog() if streamed else None
                stats = {}
                pix = runner.decode_files_batched(
                    links, cfg, logger=log, stats=stats, device=device,
                    io_threads=2)
                tag = (f"serve/{label}/i{iters}/"
                       + ("streamed" if streamed else "one-shot"))
                out[f"{tag}/classes"] = json.dumps(stats["bucket_classes"])
                out[f"{tag}/tiers"] = json.dumps(stats["bucket_tiers"])
                for f in links:
                    out[f"{tag}/pixels/{pathlib.Path(f).name}"] = digest(
                        pix[f])
                for k, v in (log.digests() if log else {}).items():
                    out[f"{tag}/metrics/{k}"] = v
    (solver.MEGA_MAX_PIXELS, solver.MEGA_LITE_MAX_PIXELS,
     solver.TWO_LITE_MAX_PIXELS) = saved

    cfg = SolverConfig(iterations=(20,) * 3)
    for name, p in zip(NAMES, paths):
        png = pathlib.Path(tmp) / f"{name}.png"
        log = RawLog()
        res = decode_file(str(p), str(png), cfg, logger=log, device=device)
        out[f"file/{name}/pixels"] = digest(res.pixels)
        for ch, m in res.metrics_per_channel.items():
            out[f"file/{name}/metrics/{ch}"] = digest(m)
        for k, v in log.digests().items():
            out[f"file/{name}/streamed/{k}"] = v
        csv = pathlib.Path(tmp) / f"{name}.csv"
        rc = cli.main(["-q", "-i", "20", "-c", str(csv), "-o", str(png),
                       "--device", str(device), str(p)])
        out[f"cli/{name}/rc"] = str(rc)
        out[f"cli/{name}/png"] = digest(png.read_bytes())
        out[f"cli/{name}/csv"] = digest(csv.read_bytes().replace(
            str(p).encode(), b"IN"))


def bench_prints(seed, device, out, tmp):
    sys.path.append(str(REPO))
    from benchmark.inputs.corpus import corpus

    from jpeg2png_tpu_torch import cli

    flags = ["-w", "0.3", "-p", "0.001", "-i", "50",
             "--device", str(device)]
    for traffic in ("batch48", "cli_each"):
        mix = json.loads((REPO / "benchmark" / "traffic"
                          / f"{traffic}.json").read_text())
        items = corpus(seed, mix, log=lambda s: print(s, file=sys.stderr))
        outs = [str(pathlib.Path(tmp) / f"{traffic}_{it.index:03d}.png")
                for it in items]
        if traffic == "batch48":
            argv = ["--tpu-batch", "-q", *flags]
            for o in outs:
                argv += ["-o", o]
            rcs = [cli.main(argv + [it.path for it in items])]
        else:
            rcs = [cli.main(["-q", *flags, "-o", o, it.path])
                   for o, it in zip(outs, items)]
        out[f"bench/{traffic}/rc"] = json.dumps(rcs)
        for it, o in zip(items, outs):
            out[f"bench/{traffic}/{pathlib.Path(it.path).name}"] = digest(
                pathlib.Path(o).read_bytes())


def compare(a_path, b_path) -> int:
    a = json.loads(pathlib.Path(a_path).read_text())
    b = json.loads(pathlib.Path(b_path).read_text())
    differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    for k in differ:
        print(f"DIFFERS {k}: {a.get(k)} / {b.get(k)}")
    print(f"{len(set(a) & set(b))} common keys, {len(differ)} differ")
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--bench-seed", type=int)
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    torch.set_num_threads(4)
    device = torch.device(args.device)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fixture_prints(device, out, tmp)
        if args.bench_seed is not None:
            bench_prints(args.bench_seed, device, out, tmp)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=0,
                                                 sort_keys=True))
    print(f"{len(out)} fingerprints -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
