"""The port held to the quality fixtures and the i50 goldens on the CPU
(the kernels' plain PyTorch versions).

tests/fixtures/quality/ holds, per case, a ground-truth image, its JPEG
and the reference binary's smoothed output; tests/test_quality.py holds
the JAX package to three gates there, and the port meets the same ones:

  1. its PSNR against the ground truth >= the reference's - 0.05 dB;
  2. it beats the plain (blocky) decode by more than 0.5 dB;
  3. > 45 dB against the reference's own PNG.

The i50 goldens below (4:4:4, 4:1:1, 4:4:0, an odd size and 4:2:2) are
the reference binary's -i 50 outputs; the port's decode must reach
> 45 dB against each, the gate of tests/test_e2e.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.pipeline import plain_decode, smooth_decode  # noqa: E402
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402
from test_quality import psnr  # noqa: E402

torch.set_num_threads(2)

# tests/test_quality.py's CPU cases; photo512x384_q25_420_i1000 runs on
# the card (chip_smoke.py), as tests/tpu_checks.py runs it for the JAX
# package
QUALITY_CASES = [
    ("lineart160x120_q20_420", 50),
    ("photo168x128_q30_420", 50),
    ("lineart160x120_q50_444", 50),
    ("lineart160x120_q20_420_i1000", 1000),
    ("photo512x384_q25_420", 50),
    ("photo512x384_q30_444", 50),
    ("lineart512x384_q25_422", 50),
]

# the i50 goldens no earlier port test reads
GOLDENS_I50 = ["art440x320_q85_444", "art128x96_q35_411",
               "art120x88_q40_440", "lineart64_q50_444",
               "odd100x52_q25_420", "photo80_q30_422"]


@pytest.mark.parametrize("name,iters", QUALITY_CASES)
def test_torch_psnr_vs_ground_truth_beats_reference(fixtures_dir, name,
                                                    iters):
    qdir = fixtures_dir / "quality"
    gt = np.asarray(Image.open(qdir / f"{name}_gt.png").convert("RGB"))
    ref = np.asarray(
        Image.open(qdir / f"{name}_ref_i{iters}.png").convert("RGB"))
    img = read_jpeg(qdir / f"{name}.jpg")
    ours = smooth_decode(img, SolverConfig(iterations=(iters,) * 3),
                         device="cpu").pixels
    plain = plain_decode(img, device="cpu")

    psnr_ref, psnr_ours = psnr(ref, gt), psnr(ours, gt)
    assert psnr_ours >= psnr_ref - 0.05, (psnr_ours, psnr_ref)
    assert psnr_ours > psnr(plain, gt) + 0.5, (psnr_ours, psnr(plain, gt))
    assert psnr(ours, ref) > 45.0, psnr(ours, ref)


@pytest.mark.parametrize("name", GOLDENS_I50)
def test_torch_golden_i50(fixtures_dir, name):
    img = read_jpeg(fixtures_dir / f"{name}.jpg")
    ours = smooth_decode(img, SolverConfig(), device="cpu").pixels
    gold = np.asarray(Image.open(fixtures_dir / "golden" / f"{name}_i50.png"))
    assert ours.shape == gold.shape
    p = psnr(ours, gold)
    assert p > 45.0, f"PSNR vs reference output too low: {p:.2f} dB"
