"""What the benchmark loads: a run of the harness's CPU path loads
neither JAX nor the JAX package (top-level module names compared whole:
jpeg2png_tpu_torch begins with jpeg2png_tpu), and the reference loads
nothing of the program."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from benchmark import harness
from conftest import tiny_cell
if __name__ == "__main__":
    result = harness.run(tiny_cell({name!r}), 12345, 0.1, False, device="cpu")
    print(json.dumps([result["correct"],
                      sorted({{m.split(".")[0] for m in sys.modules}})]))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.solve, benchmark.reference.pngread
import benchmark.reference.compare
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code, tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    for name in ("defaults_i50.batch48", "defaults_i50.cli_each"):
        correct, mods = _modules(RUN.format(
            root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"),
            name=name), tmp_path)
        assert correct
        assert "jpeg2png_tpu_torch" in mods
        assert not {"jax", "jaxlib", "flax", "jpeg2png_tpu"} & set(mods)


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    mods = _modules(REFERENCE.format(root=str(ROOT)), tmp_path)
    assert "torch" in mods and "numpy" in mods
    assert not {"jpeg2png_tpu_torch", "jpeg2png_tpu", "jax"} & set(mods)


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the run fails
    before its window and prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", ".cache",
                                                  "__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "defaults_i50.batch48", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "jpeg2png_tpu_torch" in out.stderr
