"""The giant-image deployment's path at a CPU size: a 384x256 4:2:0 q30
JPEG (the 12288x8192 image's 3:2 aspect, the benchmark's photo-class
content) through `cli.main` in the two tier the giant image takes,
held to the benchmark's plain reference (benchmark/reference/solve.py,
which imports nothing of the program) by PSNR and by the giant
configuration's limits; and the counters the giant cell reads from the
solver's spans: the set-up's uploaded bytes and the loop's tier."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.inputs.corpus import synth_image
from benchmark.inputs.jpeg_writer import encode
from benchmark.reference import compare
from benchmark.reference.pngread import read_png_file
from benchmark.reference.solve import solve as reference_solve
from jpeg2png_tpu_torch import cli
from jpeg2png_tpu_torch.io import read_jpeg
from jpeg2png_tpu_torch.models import solver
from jpeg2png_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
GIANT = json.loads((ROOT / "benchmark" / "configs" /
                    "giant_100mp.json").read_text())
W, H, QUALITY = 384, 256, 30


def _jpeg(tmp_path, seed):
    rgb = synth_image(W, H, np.random.SeedSequence([seed, 0]))
    data, comps = encode(rgb, QUALITY, "4:2:0")
    path = tmp_path / f"giant_{seed}.jpg"
    path.write_bytes(data)
    return path, comps


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("iterations", [1, 50])
@pytest.mark.parametrize("seed", [4700000011, 2 ** 33 + 7])
def test_two_tier_cli_against_the_plain_reference(tmp_path, monkeypatch,
                                                  seed, iterations):
    monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", 0)
    src, comps = _jpeg(tmp_path, seed)
    out = tmp_path / "out.png"
    flags = ["-w", "0.3", "-p", "0.001", "-i", str(iterations)]
    with profiling.recording() as spans:
        rc = cli.main(["-q", "--device", "cpu", *flags, "-o", str(out),
                       str(src)])
    assert rc == 0
    assert [s.attrs["tier"] for s in spans if s.name == "solve.loop"] == [
        "two"]
    got = read_png_file(out)
    ref = reference_solve(comps, H, W, 0.3, 0.001, iterations)
    assert got.shape == ref.shape == (H, W, 3)
    assert _psnr(got, ref) > 45.0
    numbers = compare.numbers(got, ref)
    for name in compare.NUMBERS:
        assert numbers[name] <= GIANT["limits"][name], (name, numbers)


def _problem(tmp_path):
    src, _ = _jpeg(tmp_path, 3)
    img = read_jpeg(str(src))
    return ([p.data for p in img.planes], [p.quant for p in img.planes],
            [(p.h_samp, p.w_samp) for p in img.planes])


def test_setup_span_counts_the_uploaded_bytes(tmp_path):
    datas, quants, samps = _problem(tmp_path)
    want = sum(d.nbytes for d in datas) + 4 * 64 * len(quants)
    for chunked in (False, True):
        with profiling.collected("solve.setup") as got:
            if chunked:
                solver.solve_joint_chunked(datas, quants, samps, 0.3,
                                           [0.001] * 3, 2, device="cpu")
            else:
                solver.solve_joint(datas, quants, samps, 0.3, [0.001] * 3,
                                   2, device="cpu")
        (sp,) = got
        assert sp.attrs == {"bytes": want}
    # tensors already on the device cross nothing
    on_device = [torch.as_tensor(d) for d in datas]
    q_device = [torch.as_tensor(q, dtype=torch.float32) for q in quants]
    with profiling.collected("solve.setup") as got:
        solver.solve_joint(on_device, q_device, samps, 0.3, [0.001] * 3, 2,
                           device="cpu")
    assert got[0].attrs == {}


@pytest.mark.parametrize("mega_max,forced,want", [
    (None, None, "mega"), (0, None, "two"), (None, "two", "two"),
    (None, "two-lite", "two-lite")])
def test_loop_span_tier_is_the_tier_that_ran(tmp_path, monkeypatch,
                                             mega_max, forced, want):
    if mega_max is not None:
        monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", mega_max)
    datas, quants, samps = _problem(tmp_path)
    if forced is None:
        assert solver.active_tier(solver._geometry(datas, samps)) == want
    with profiling.recording() as spans:
        solver.solve_joint(datas, quants, samps, 0.3, [0.001] * 3, 2,
                           device="cpu", tier=forced)
    (loop,) = [s for s in spans if s.name == "solve.loop"]
    # the two tier also counts its iterations: on the CPU every one eager
    counts = {"graph_iters": 0, "eager_iters": 2} if want == "two" else {}
    assert loop.attrs == {"tier": want, **counts}
