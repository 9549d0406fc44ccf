"""The check fails a run whose timed path is broken.  The harness's CPU
path (no card: the program's plain versions) runs a cell cut to a few
small files, with the program broken underneath in each way a cell can
be, and `correct` must come out false; unbroken, true."""

import dataclasses

import numpy as np
import pytest

from benchmark import harness
from conftest import tiny_cell


def unchanged_state(mp):
    """Every solve returns its starting state: zero iterations run."""
    from jpeg2png_tpu_torch import cli

    real = cli.config_from_args
    mp.setattr(cli, "config_from_args", lambda args: dataclasses.replace(
        real(args), iterations=(0, 0, 0)))


def half_left_out(mp):
    """Every other PNG is never written."""
    import jpeg2png_tpu_torch.io as io
    import jpeg2png_tpu_torch.pipeline as pipeline

    real, n = io.write_png, [0]

    def write(path, pix, bits=8):
        n[0] += 1
        if n[0] % 2:
            real(path, pix, bits)

    mp.setattr(io, "write_png", write)
    mp.setattr(pipeline, "write_png", write)


def card_left_out(mp):
    """The work items a second card would take are never run (the
    exchange of results between the cards' workers left out)."""
    from jpeg2png_tpu_torch import runner

    real = runner._run_on_cards
    mp.setattr(runner, "_run_on_cards",
               lambda work, devices, stats=None: real(work[::2], devices,
                                                      stats))


def answer_altered(mp):
    """One file's pixels shifted by a column where they are written."""
    import jpeg2png_tpu_torch.io as io
    import jpeg2png_tpu_torch.pipeline as pipeline

    real = io.write_png

    def write(path, pix, bits=8):
        if pix.shape[:2] == (120, 160):
            pix = np.roll(pix, 1, axis=1)
        real(path, pix, bits)

    mp.setattr(io, "write_png", write)
    mp.setattr(pipeline, "write_png", write)


FAULTS = {"batch48": [unchanged_state, half_left_out, card_left_out,
                      answer_altered],
          "cli_each": [unchanged_state, half_left_out, answer_altered]}


@pytest.mark.parametrize("name,fault", [
    (n, f) for n, fs in (("defaults_i50.batch48", FAULTS["batch48"]),
                         ("defaults_i50.cli_each", FAULTS["cli_each"]))
    for f in [None] + fs], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name, iterations=10)
    if fault is not None:
        fault(monkeypatch)
    result = harness.run(cell, 2 ** 31 + 99, 0.1, False, device="cpu")
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
