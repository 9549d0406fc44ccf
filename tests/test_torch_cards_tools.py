"""The four-card tools rehearsed on the CPU (gloo processes, plain
versions, tile 1, 3 iterations): tools/torch_striped_cards.py with
--procs 2 (4 bands as 4 processes x 1 band and as 2 processes x 2
bands, each bit-equal to the in-process solve, checkpointed and resumed
in each) and tools/torch_serving_cards.py (serving, the processes, the
2 x 2 batch in one process and as 4 processes with a sub-group per
image).  CPU numbers are not a card's: the gates are the tools' own
checks (exit 0) and the shape of their JSON line."""

import json
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
JPEG = "tests/fixtures/photo600x400_q20_420.jpg"


def _run(argv, timeout):
    out = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, timeout=timeout, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "cpu"
    return lines, json.loads(lines[-1])


def test_torch_striped_cards_procs_rehearsal():
    _, res = _run(["tools/torch_striped_cards.py", "--device", "cpu",
                   "--cards", "4", "--procs", "2", "--tile", "1", "--jpeg",
                   JPEG, "--iterations", "3"], timeout=300)
    assert res["bit_equal"] and res["card"] == "cpu"
    runs = res["runs"]
    assert set(runs) == {"two", "bands on one device",
                         "one band per process", "2 processes x 2 bands"}
    assert len({r["digest"] for k, r in runs.items() if k != "two"}) == 1
    for label, world, bands in (("one band per process", 4, 1),
                                ("2 processes x 2 bands", 2, 2)):
        r = runs[label]
        assert (r["world"], r["bands_per_process"]) == (world, bands)
        assert r["counts"] == {"halo": 12, "all_reduce": 6}
        assert r["checkpoint"]["bit_equal"]
        assert r["checkpoint"]["crash"] == 2


def test_torch_serving_cards_rehearsal():
    lines, res = _run(["tools/torch_serving_cards.py", "--device", "cpu",
                       "--cards", "4", "--files", "6", "--iterations", "3",
                       "--tile", "1", "--jpeg", JPEG, "--iterations-striped",
                       "3"], timeout=600)
    assert res["batched_striping"]["bit_equal"]
    procs = res["batched_striping_processes"]
    assert procs["bit_equal"] and len(procs["ms_per_iteration_per_rank"]) == 4
    assert procs["ms_per_iteration_in_one_process"] == (
        res["batched_striping"]["ms_per_iteration"])
    assert any("a sub-group per image" in x for x in lines)
