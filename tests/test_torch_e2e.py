"""End-to-end golden tests of the PyTorch port against the reference
binary's outputs, on the CPU (the kernels' plain PyTorch versions).

The same gates as tests/test_e2e.py: per-iteration CSV metrics before
the chaos point (rtol 6e-3) and PNG PSNR > 45 dB, never bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.pipeline import smooth_decode  # noqa: E402
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402
from test_e2e import assert_metrics_close, load_golden_csv, psnr  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("name,trace_iters", [
    ("lineart64_q20_420", 5),    # 4:2:0
    ("lineart64_q50_444", 5),    # 4:4:4 (no resample path)
    ("photo80_q30_422", 5),      # 4:2:2 (anisotropic sampling)
    ("odd100x52_q25_420", 5),    # luma region smaller than chroma canvas
    ("photo512_q10_420", 2),     # flat photo regions: chaos from iteration 2
    ("art120x88_q40_440", 5),    # 4:4:0 (sy=2, sx=1)
    ("art128x96_q35_411", 5),    # 4:1:1 (sy=1, sx=4)
])
def test_torch_joint_i5_matches_reference(name, trace_iters, fixtures_dir):
    img = read_jpeg(fixtures_dir / f"{name}.jpg")
    result = smooth_decode(img, SolverConfig(iterations=(5,) * 3),
                           device="cpu")
    golden = load_golden_csv(fixtures_dir / "golden" / f"{name}_i5.csv")
    assert_metrics_close(result.metrics_per_channel[3][:trace_iters],
                         golden[3][:trace_iters])
    gold_png = np.asarray(
        Image.open(fixtures_dir / "golden" / f"{name}_i5.png"))
    p = psnr(result.pixels, gold_png)
    assert p > 45.0, f"PSNR vs reference output too low: {p:.2f} dB"


def test_torch_progressive_matches_reference(fixtures_dir):
    # a progressive (SOF2) input against the reference binary's golden:
    # CSV rows 0-1 before the chaos point and the PNG
    img = read_jpeg(fixtures_dir / "lineart64_q20_420_prog.jpg")
    assert img.progressive
    result = smooth_decode(img, SolverConfig(iterations=(5,) * 3),
                           device="cpu")
    golden = load_golden_csv(
        fixtures_dir / "golden" / "lineart64_q20_420_prog_i5.csv")
    assert_metrics_close(result.metrics_per_channel[3][:2], golden[3][:2])
    gold_png = np.asarray(Image.open(
        fixtures_dir / "golden" / "lineart64_q20_420_prog_i5.png"))
    p = psnr(result.pixels, gold_png)
    assert p > 45.0, f"PSNR vs reference output too low: {p:.2f} dB"


def test_torch_arithmetic_matches_reference(fixtures_dir):
    # an arithmetic-coded (SOF9) input: its coefficients are its Huffman
    # original's, so the solve is the original's bit for bit, and meets
    # the original's golden (the counterpart of tests/test_io.py's
    # test_arithmetic_jpeg_e2e_solve)
    cfg = SolverConfig(iterations=(5,) * 3)
    img = read_jpeg(fixtures_dir / "lineart64_q20_420_arith.jpg")
    result = smooth_decode(img, cfg, device="cpu")
    orig = smooth_decode(read_jpeg(fixtures_dir / "lineart64_q20_420.jpg"),
                         cfg, device="cpu")
    np.testing.assert_array_equal(result.pixels, orig.pixels)
    for a, b in zip(result.metrics_per_channel, orig.metrics_per_channel):
        np.testing.assert_array_equal(a, b)
    golden = load_golden_csv(fixtures_dir / "golden" /
                             "lineart64_q20_420_i5.csv")
    assert_metrics_close(result.metrics_per_channel[3][:2], golden[3][:2])
    gold_png = np.asarray(
        Image.open(fixtures_dir / "golden" / "lineart64_q20_420_i5.png"))
    p = psnr(result.pixels, gold_png)
    assert p > 45.0, f"PSNR vs reference output too low: {p:.2f} dB"


def test_torch_16bit_output_matches_reference(fixtures_dir):
    from pngdec import decode_png

    img = read_jpeg(fixtures_dir / "lineart64_q20_420.jpg")
    result = smooth_decode(img, SolverConfig(iterations=(5,) * 3), bits=16,
                           device="cpu")
    assert result.pixels.dtype == np.uint16
    gold = decode_png(
        (fixtures_dir / "golden" / "lineart64_q20_420_16b_i5.png").read_bytes())
    diff = (result.pixels.astype(np.float64) - gold.astype(np.float64)) / 256.0
    mse = (diff ** 2).mean()
    p = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert p > 45.0, p
    # reference scale convention: 16-bit white is 65280 (png.c:44-47)
    assert result.pixels.max() <= 65280


def test_torch_separate_components_matches_reference(fixtures_dir):
    img = read_jpeg(fixtures_dir / "lineart64_q20_420.jpg")
    cfg = SolverConfig(iterations=(5,) * 3, separate_components=True)
    result = smooth_decode(img, cfg, device="cpu")
    golden = load_golden_csv(
        fixtures_dir / "golden" / "lineart64_q20_420_s_i5.csv")
    for c in range(3):
        assert_metrics_close(result.metrics_per_channel[c], golden[c])
    gold_png = np.asarray(Image.open(
        fixtures_dir / "golden" / "lineart64_q20_420_s_i5.png"))
    assert psnr(result.pixels, gold_png) > 45.0


def test_torch_separate_triple_weights_matches_reference(fixtures_dir):
    """-s with per-channel w/p/i triples (-w 0.5,0.2,0.1 -p
    0.002,0.001,0.0005 -i 5,4,3; the triple forms are only legal with
    -s): each channel's metric rows against the reference's CSV and the
    PNG > 45 dB, the gates tests/test_e2e.py holds the JAX package to."""
    img = read_jpeg(fixtures_dir / "lineart64_q20_420.jpg")
    cfg = SolverConfig(weights=(0.5, 0.2, 0.1),
                       pweights=(0.002, 0.001, 0.0005),
                       iterations=(5, 4, 3), separate_components=True)
    result = smooth_decode(img, cfg, device="cpu")
    golden = load_golden_csv(
        fixtures_dir / "golden" / "lineart64_q20_420_striple_i543.csv")
    for c in range(3):
        assert result.metrics_per_channel[c].shape[0] == (5, 4, 3)[c]
        assert_metrics_close(result.metrics_per_channel[c], golden[c])
    gold_png = np.asarray(Image.open(
        fixtures_dir / "golden" / "lineart64_q20_420_striple_i543.png"))
    assert psnr(result.pixels, gold_png) > 45.0


@pytest.mark.parametrize("csv_name,cfg", [
    ("lineart64_q20_420_w0_i5", SolverConfig(weights=(0.0,) * 3,
                                             iterations=(5,) * 3)),
    ("lineart64_q20_420_p0_i5", SolverConfig(pweights=(0.0,) * 3,
                                             iterations=(5,) * 3)),
])
def test_torch_tv_only_and_prob_off_match_reference(csv_name, cfg,
                                                    fixtures_dir):
    img = read_jpeg(fixtures_dir / "lineart64_q20_420.jpg")
    ours = smooth_decode(img, cfg, device="cpu").metrics_per_channel[3]
    golden = load_golden_csv(fixtures_dir / "golden" / f"{csv_name}.csv")
    assert_metrics_close(ours, golden[3])
    if cfg.weights[0] == 0.0:
        assert (ours[:, 3] == 0).all()
    if cfg.pweights[0] == 0.0:
        assert (ours[:, 1] == 0).all()


def test_torch_cli_default_flags_golden(fixtures_dir, tmp_path):
    """The CLI with the default flags (-w 0.3 -p 0.001 -i 50, joint),
    CSV log and PNG, against the reference's 50-iteration output."""
    import shutil

    from jpeg2png_tpu_torch.cli import main

    src = tmp_path / "lineart64_q20_420.jpg"
    shutil.copy(fixtures_dir / "lineart64_q20_420.jpg", src)
    csv_path = tmp_path / "log.csv"
    assert main([str(src), "-q", "--device", "cpu", "-c", str(csv_path)]) == 0
    got = np.asarray(Image.open(tmp_path / "lineart64_q20_420.png"))
    gold = np.asarray(Image.open(
        fixtures_dir / "golden" / "lineart64_q20_420_i50.png"))
    assert psnr(got, gold) > 40.0
    rows = csv_path.read_text().strip().splitlines()
    assert rows[0] == "filename,channel,iteration,objective,prob_dist,tv,tv2"
    assert len(rows) == 51
