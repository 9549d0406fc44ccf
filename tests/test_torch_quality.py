"""The port held to the quality fixtures and the i50 goldens on the CPU
(the kernels' plain PyTorch versions).

tests/fixtures/quality/ holds, per case, a ground-truth image, its JPEG
and the reference binary's smoothed output; tests/test_quality.py holds
the JAX package to three gates there, and the port meets the same ones:

  1. its PSNR against the ground truth >= the reference's - 0.05 dB;
  2. it beats the plain (blocky) decode by more than 0.5 dB;
  3. > 45 dB against the reference's own PNG.

The cases and the gates are tools/torch_quality_eval.py's CASES and
gate_failures, which the tool and chip_smoke.py apply too.

The i50 goldens below (4:4:4, 4:1:1, 4:4:0, an odd size and 4:2:2) are
the reference binary's -i 50 outputs; the port's decode must reach
> 45 dB against each, the gate of tests/test_e2e.py.
"""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.pipeline import smooth_decode  # noqa: E402
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402
from test_quality import psnr  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_quality_eval  # noqa: E402

torch.set_num_threads(2)

# the tool's CPU cases; photo512x384_q25_420_i1000 runs on the card
# (chip_smoke.py), as tests/tpu_checks.py runs it for the JAX package
QUALITY_CASES = [(name, iters) for name, iters, cpu
                 in torch_quality_eval.CASES if cpu]

# the i50 goldens no earlier port test reads
GOLDENS_I50 = ["art440x320_q85_444", "art128x96_q35_411",
               "art120x88_q40_440", "lineart64_q50_444",
               "odd100x52_q25_420", "photo80_q30_422"]


@pytest.mark.parametrize("name,iters", QUALITY_CASES)
def test_torch_psnr_vs_ground_truth_beats_reference(name, iters):
    row = torch_quality_eval.evaluate(name, iters, device="cpu")
    assert not torch_quality_eval.gate_failures(row), row


@pytest.mark.parametrize("name", GOLDENS_I50)
def test_torch_golden_i50(fixtures_dir, name):
    img = read_jpeg(fixtures_dir / f"{name}.jpg")
    ours = smooth_decode(img, SolverConfig(), device="cpu").pixels
    gold = np.asarray(Image.open(fixtures_dir / "golden" / f"{name}_i50.png"))
    assert ours.shape == gold.shape
    p = psnr(ours, gold)
    assert p > 45.0, f"PSNR vs reference output too low: {p:.2f} dB"
