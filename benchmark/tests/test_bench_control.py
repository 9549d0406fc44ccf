"""The control of `correct` fails the configurations' limits: the
reference with TF32 in its matrix products (the precision below the
configurations' float32), held against the reference itself, reads
above every limit it is compared with, on a few files of every chroma
layout.  On the card TF32 is the card's own; on the CPU, which has none,
the products' inputs are rounded to TF32's 10-bit mantissa."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import BENCH
from benchmark.inputs.corpus import synth_image
from benchmark.inputs.jpeg_writer import encode
from benchmark.reference import compare, solve as ref

FILES = [(256, 176, "4:2:0", 20), (240, 192, "4:2:0", 90),
         (200, 144, "4:2:2", 50), (160, 120, "4:4:4", 75)]


def _limits(config):
    return json.loads((BENCH / "configs" / f"{config}.json").read_text())[
        "limits"]


def _worst(device, tf32_of, iterations):
    readings = []
    for i, (w, h, layout, q) in enumerate(FILES):
        _, comps = encode(synth_image(w, h, [2 ** 31 + 5, i]), q, layout)
        args = (comps, h, w, 0.3, 0.001, iterations)
        good = ref.solve(*args, device=device)
        bad = tf32_of(args)
        readings.append(compare.numbers(bad, good))
    return compare.worst(readings)


def _round_tf32(x):
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("config,iterations", [("defaults_i50", 50),
                                               ("converge_i1000", 200)])
def test_emulated_tf32_control_fails_the_limits(config, iterations,
                                                monkeypatch):
    real = torch.einsum

    def tf32_of(args):
        with monkeypatch.context() as m:
            m.setattr(ref.torch, "einsum", lambda eq, *ops: real(
                eq, *[_round_tf32(o) for o in ops]))
            return ref.solve(*args)

    worst = _worst("cpu", tf32_of, iterations)
    assert not compare.verdict(worst, _limits(config), 0), worst
    assert all(worst[n] > _limits(config)[n] for n in compare.NUMBERS)


@pytest.mark.chip
@pytest.mark.parametrize("config,iterations", [("defaults_i50", 50),
                                               ("converge_i1000", 1000)])
def test_tf32_control_fails_the_limits_on_the_card(config, iterations,
                                                   cuda_card):
    worst = _worst(cuda_card, lambda args: ref.solve(
        *args, device=cuda_card, tf32=True), iterations)
    assert all(worst[n] > _limits(config)[n] for n in compare.NUMBERS)


@pytest.mark.chip
def test_the_reference_on_the_card_agrees_with_the_cpu(cuda_card):
    for i, (w, h, layout, q) in enumerate(FILES):
        _, comps = encode(synth_image(w, h, [2 ** 31 + 6, i]), q, layout)
        args = (comps, h, w, 0.3, 0.001, 50)
        got = compare.numbers(ref.solve(*args, device=cuda_card),
                              ref.solve(*args))
        limits = _limits("defaults_i50")
        assert all(got[n] <= limits[n] for n in compare.NUMBERS), got
        assert np.isfinite(got["mean_abs"])


@pytest.mark.parametrize("name", ["defaults_i50.batch48",
                                  "defaults_i50.cli_each"])
def test_program_readings_in_one_process_pass_the_limits(name):
    """control.py --program runs one unit of the traffic's entry and holds
    the program's answers against the reference, as the check does."""
    from benchmark import control
    from conftest import tiny_cell

    cell = tiny_cell(name, iterations=10)
    got = control.readings(cell["config"], cell["traffic"], 2 ** 31 + 77,
                           device="cpu", program=True, control=False)
    assert set(got) == {"seed", "files", "program", "reference_s"}
    assert len(got["files"]) == 4
    assert compare.verdict(got["program"], _limits("defaults_i50"), 0), got
