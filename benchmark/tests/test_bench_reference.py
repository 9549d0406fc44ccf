"""The plain reference against the port's plain path (--device cpu) on
fixtures decoded by both, at -i 1 and -i 50, with the gates of
tests/test_torch_e2e.py (PSNR > 45 dB) and the benchmark's own limits;
the frozen PNG reader against the port's writer."""

import json
import pathlib

import numpy as np
import pytest

from benchmark.harness import BENCH
from benchmark.inputs.corpus import synth_image
from benchmark.reference import compare
from benchmark.reference.pngread import read_png
from benchmark.reference.solve import solve
from jpeg2png_tpu_torch.io import encode_png, read_jpeg
from jpeg2png_tpu_torch.pipeline import decode_file
from jpeg2png_tpu_torch.utils.config import SolverConfig

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
LIMITS = json.loads((BENCH / "configs" / "defaults_i50.json").read_text())[
    "limits"]


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", ["photo512_q10_420", "art440x320_q30_422",
                                  "art440x320_q85_444", "odd100x52_q25_420"])
@pytest.mark.parametrize("iterations", [1, 50])
def test_reference_matches_the_port_on_the_cpu(name, iterations, tmp_path):
    path = FIXTURES / f"{name}.jpg"
    img = read_jpeg(path)
    comps = [(p.data, p.quant, (p.h_samp, p.w_samp)) for p in img.planes]
    ref = solve(comps, img.height, img.width, 0.3, 0.001, iterations)
    cfg = SolverConfig(iterations=(iterations,) * 3)
    out = tmp_path / "out.png"
    port = decode_file(str(path), str(out), cfg, device="cpu").pixels
    assert psnr(port, ref) > 45.0
    got = compare.numbers(read_png(out.read_bytes()), ref)
    assert all(got[n] <= LIMITS[n] for n in compare.NUMBERS), got


@pytest.mark.parametrize("w,h,bits", [(1, 1, 8), (37, 19, 8), (64, 48, 16),
                                      (200, 144, 8)])
def test_png_reader_reads_the_port_writer(w, h, bits):
    px = synth_image(w, h, 3)
    if bits == 16:
        px = px.astype(np.uint16) * 257
    assert np.array_equal(read_png(encode_png(px, bits)), px)
    gray = px[..., 1]
    assert np.array_equal(read_png(encode_png(gray, bits)), gray)


def test_compare_numbers():
    a = np.zeros((64, 64, 3), np.uint8)
    b = a.copy()
    b[:32, :32] = 4
    got = compare.numbers(a, b)
    assert got == {"mean_abs": 1.0, "tile_mean_abs": 4.0}
    assert compare.numbers(a, a[:32])["mean_abs"] == float("inf")
    assert compare.verdict({"mean_abs": 0.1, "tile_mean_abs": 0.2},
                           {"mean_abs": 0.1, "tile_mean_abs": 0.2}, 0)
    assert not compare.verdict({"mean_abs": 0.0, "tile_mean_abs": 0.0},
                               {"mean_abs": 0.1, "tile_mean_abs": 0.2}, 1)
