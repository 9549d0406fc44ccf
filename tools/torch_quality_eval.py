#!/usr/bin/env python
"""Quality against ground truth: the PyTorch port beside the plain decode
and the reference binary, on the committed quality fixtures.

The port's counterpart of tools/quality_eval.py, evaluation only.
tests/fixtures/quality/ holds, per case, a ground-truth image
(`<case>_gt.png`), its JPEG (`<case>.jpg`) and the reference binary's
smoothed output at the case's iterations (`<case>_ref_i<N>.png`), minted
by `tools/quality_eval.py --mint` (which needs the reference binary, so
minting stays with the JAX tool).  For each case this prints one JSON
line: the PSNR against the ground truth of the plain decode, of the
reference and of the port (default flags but the case's iterations,
through --tier or the rule's tier), the port against the reference's
PNG, and the gates that missed, then the worst port-minus-reference
margin.  The gates (GATES) are tests/test_quality.py's; CASES and GATES
are the ones tests/test_torch_quality.py and chip_smoke.py hold the port
to, so the tool, the test and the card check cannot drift apart.

    python tools/torch_quality_eval.py [--tier two] [--case NAME ...]
    python tools/torch_quality_eval.py --device cpu --case \\
        lineart160x120_q20_420

Exits 1 if a gate missed.  Without a card it raises unless given
--device cpu (the plain versions).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
QUALITY_DIR = ROOT / "tests" / "fixtures" / "quality"

# tests/test_quality.py's cases: (name, iterations, held on the CPU by
# tests/test_torch_quality.py).  photo512x384_q25_420_i1000 runs on the
# card (chip_smoke.py phase 12), as tests/tpu_checks.py runs it for the
# JAX package.
CASES = (
    ("lineart160x120_q20_420", 50, True),
    ("photo168x128_q30_420", 50, True),
    ("lineart160x120_q50_444", 50, True),
    ("lineart160x120_q20_420_i1000", 1000, True),
    ("photo512x384_q25_420", 50, True),
    ("photo512x384_q25_420_i1000", 1000, False),
    ("photo512x384_q30_444", 50, True),
    ("lineart512x384_q25_422", 50, True),
)
# tests/test_quality.py's gates: the port's PSNR against the ground truth
# at least the reference's less 0.05 dB; more than 0.5 dB above the plain
# decode's; more than 45 dB against the reference's own PNG
BELOW_REFERENCE_DB = 0.05
ABOVE_PLAIN_DB = 0.5
VS_REFERENCE_DB = 45.0


def psnr(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = ((a - b) ** 2).mean()
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def gate_failures(row: dict) -> list:
    """The gates `row` (evaluate's keys) misses, as messages."""
    ours = row["psnr_ours_vs_gt"]
    out = []
    if not ours >= row["psnr_reference_vs_gt"] - BELOW_REFERENCE_DB:
        out.append(f"{ours:.3f} dB vs ground truth is below the reference's "
                   f"{row['psnr_reference_vs_gt']:.3f} - {BELOW_REFERENCE_DB}")
    if not ours > row["psnr_plain_vs_gt"] + ABOVE_PLAIN_DB:
        out.append(f"{ours:.3f} dB is not {ABOVE_PLAIN_DB} dB above the "
                   f"plain decode's {row['psnr_plain_vs_gt']:.3f}")
    if not row["psnr_ours_vs_reference"] > VS_REFERENCE_DB:
        out.append(f"{row['psnr_ours_vs_reference']:.2f} dB vs the "
                   f"reference's PNG is not above {VS_REFERENCE_DB}")
    return out


def fixture_pixels(name: str, iterations: int):
    """(ground truth, the reference's output) of a case, uint8 RGB."""
    sys.path.insert(0, str(ROOT / "tests"))
    from pngdec import decode_png

    gt = decode_png((QUALITY_DIR / f"{name}_gt.png").read_bytes())
    ref = decode_png((QUALITY_DIR / f"{name}_ref_i{iterations}.png")
                     .read_bytes())
    return gt, ref


def evaluate(name: str, iterations: int, device="cuda", tier=None) -> dict:
    """One case's PSNRs (and the plain decode's), the port's solve through
    `tier` (None: the rule's)."""
    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.pipeline import plain_decode, smooth_decode
    from jpeg2png_tpu_torch.utils.config import SolverConfig

    gt, ref = fixture_pixels(name, iterations)
    img = read_jpeg(QUALITY_DIR / f"{name}.jpg")
    ours = smooth_decode(img, SolverConfig(iterations=(iterations,) * 3),
                         device=device, tier=tier).pixels
    plain = plain_decode(img, device=device)
    return {"config": name, "iterations": iterations,
            "tier": tier or "rule",
            "psnr_plain_vs_gt": psnr(plain, gt),
            "psnr_reference_vs_gt": psnr(ref, gt),
            "psnr_ours_vs_gt": psnr(ours, gt),
            "psnr_ours_vs_reference": psnr(ours, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", default=None,
                    help="force a solver tier (mega, mega-lite, two-lite, "
                         "two); default the rule's")
    ap.add_argument("--case", action="append", default=None,
                    help="evaluate this case only (repeatable)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from jpeg2png_tpu_torch import resolve_device

    dev = resolve_device(args.device)      # no card: RuntimeError
    names = {n for n, _, _ in CASES}
    for c in args.case or ():
        if c not in names:
            raise SystemExit(f"unknown case {c!r} (one of {sorted(names)})")
    rows = []
    for name, iters, _ in CASES:
        if args.case and name not in args.case:
            continue
        row = evaluate(name, iters, dev, args.tier)
        row["gates_missed"] = gate_failures(row)
        rows.append(row)
        print(json.dumps(row), flush=True)
    worst = min(r["psnr_ours_vs_gt"] - r["psnr_reference_vs_gt"]
                for r in rows)
    print(f"# worst ours-minus-reference margin: {worst:+.3f} dB "
          f"(gate: >= -{BELOW_REFERENCE_DB})")
    return 1 if any(r["gates_missed"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
