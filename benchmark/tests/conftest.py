"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository's root.  Tests marked `chip` need a CUDA card and skip
without one; run them on the card with

    python3 -m pytest benchmark/tests -m chip
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_cell(name="defaults_i50.batch48", iterations=3, sizes=None):
    """A cell of BENCHMARK.json cut to a size a CPU test can hold: a few
    small files of every chroma layout, a few iterations."""
    import json

    from benchmark import harness

    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(name, spec)
    sizes = sizes or [[160, 120, "4:2:0"], [101, 67, "4:2:2"],
                      [99, 77, "4:4:4"], [64, 48, "4:2:0"]]
    cell["traffic"] = dict(cell["traffic"], sizes=sizes, repeat=1)
    flags = ["-w", "0.3", "-p", "0.001", "-i", str(iterations)]
    cell["config"] = dict(cell["config"], flags=flags,
                          check={"groups": [{"n": len(sizes)}]})
    return cell
