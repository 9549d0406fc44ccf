"""Smoke tests of the port's measurement tools on the CPU (plain
versions, tiny sizes): tools/torch_bench.py, torch_bench_tiers.py,
torch_bench_batch.py, torch_quality_eval.py, torch_measure_halo_rt.py and
torch_fuzz_reader.py.  CPU numbers are not a card's: the gates are the
tools' output forms, their keys (bench.py's for torch_bench), and their
agreement with the tests and the JAX tools they mirror.
"""

import ast
import importlib.util
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"

torch.set_num_threads(2)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_keys():
    """The keys bench.py puts in its JSON line: those of its `out` dict
    literal and of its `out["..."] = ` assignments."""
    keys = set()
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name) and node.value.id == "out"
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_torch_bench_quick_prints_one_json_line(capsys, monkeypatch):
    bench = _tool("torch_bench")
    monkeypatch.setattr(bench, "FIXTURE", FIXTURES / "lineart64_q20_420.jpg")
    monkeypatch.setattr(bench, "QUICK", (2, 6, 1))
    assert bench.main(["--quick", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(out)
    assert out["metric"] == "mp_iter_per_s" and out["value"] > 0
    assert out["vs_baseline"] == out["value"] / bench.REFERENCE_MP_ITER_PER_S
    assert out["device"].startswith("cpu")


def test_torch_bench_full_line_has_bench_py_keys(capsys, monkeypatch,
                                                 tmp_path):
    bench = _tool("torch_bench")
    monkeypatch.setattr(bench, "FIXTURE", FIXTURES / "lineart64_q20_420.jpg")
    monkeypatch.setattr(bench, "HEADLINE", (2, 6, 1))
    monkeypatch.setattr(bench, "ROWS", tuple(
        (key, striped, 4, 4, 1, 3, 1)
        for key, striped, *_ in bench.ROWS))
    monkeypatch.setattr(bench, "BATCHED", (3, 2, tmp_path / "corpus"))
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert _bench_py_keys() <= set(out), _bench_py_keys() - set(out)
    assert out["batched_compiles_warm"] == 0
    assert all(math.isfinite(out[k]) and out[k] > 0 for k in (
        "value", "mp_iter_per_s_6mp", "mp_iter_per_s_striped_6mp",
        "mp_iter_per_s_25mp", "mp_iter_per_s_50mp"))


def test_torch_bench_tiers_rows(capsys, monkeypatch):
    tiers = _tool("torch_bench_tiers")
    monkeypatch.setattr(tiers, "TIERS", [("tiny 32x32", 4, 4, 1, 3)])
    monkeypatch.setattr(tiers, "STRIPED", ("tiny striped n=1", 4, 4, 1, 3))
    monkeypatch.setattr(tiers, "REPS", 2)
    assert tiers.main(["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rows, last = lines[:-1], lines[-1]
    # every tier holds a 32x32 4:2:0 canvas, then the striped row
    assert [r["solver_tier"] for r in rows] == [
        "mega", "mega-lite", "two-lite", "two", "striped"]
    assert all(r["mp_iter_per_s"] > 0 for r in rows)
    assert rows[0]["rule"] == "mega"
    assert set(last["tiers"]["tiny 32x32"]) == {"mega", "mega-lite",
                                                "two-lite", "two"}


def test_torch_bench_batch_same_geometry(capsys, monkeypatch):
    batch = _tool("torch_bench_batch")
    monkeypatch.setattr(batch, "FIXTURE", FIXTURES / "lineart64_q20_420.jpg")
    monkeypatch.setattr(batch, "BATCHES", (1, 2))
    assert batch.main(["--device", "cpu", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("B=  1:") and lines[1].startswith("B=  2:")
    rows = json.loads(lines[-1])["same_geometry"]
    assert [r["B"] for r in rows] == [1, 2]
    assert all(r["mp_iter_per_s"] > 0 for r in rows)


def test_torch_quality_eval_matches_the_test(capsys):
    """The tool's PSNRs for one case equal tests/test_torch_quality.py's
    way of computing them (Pillow's PNG reader, test_quality.psnr)."""
    from PIL import Image

    from jpeg2png_tpu_torch.io import read_jpeg
    from jpeg2png_tpu_torch.pipeline import plain_decode, smooth_decode
    from jpeg2png_tpu_torch.utils.config import SolverConfig
    from test_quality import psnr

    qeval = _tool("torch_quality_eval")
    name, iters = "lineart160x120_q20_420", 50
    assert qeval.main(["--device", "cpu", "--case", name]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row = json.loads(lines[0])
    assert lines[-1].startswith("# worst ours-minus-reference margin")
    qdir = FIXTURES / "quality"
    gt = np.asarray(Image.open(qdir / f"{name}_gt.png").convert("RGB"))
    ref = np.asarray(
        Image.open(qdir / f"{name}_ref_i{iters}.png").convert("RGB"))
    img = read_jpeg(qdir / f"{name}.jpg")
    ours = smooth_decode(img, SolverConfig(iterations=(iters,) * 3),
                         device="cpu").pixels
    assert row["psnr_ours_vs_gt"] == psnr(ours, gt)
    assert row["psnr_reference_vs_gt"] == psnr(ref, gt)
    assert row["psnr_plain_vs_gt"] == psnr(plain_decode(img, device="cpu"),
                                           gt)
    assert row["psnr_ours_vs_reference"] == psnr(ours, ref)
    assert row["gates_missed"] == []


def test_torch_measure_halo_rt_two_gloo_processes():
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_measure_halo_rt.py"),
         "--device", "cpu", "--reps", "3", "64", "256"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(x) for x in out.stdout.splitlines()]
    assert [r["W"] for r in rows] == [64, 256]
    for r in rows:
        assert r["payload_bytes_per_dir"] == 4 * 2 * 3 * 2 * r["W"]
        assert r["halo_round_trip_s"] > 0 and r["all_reduce_s"] > 0
        assert r["processes"] == 2 and r["backend"] == "gloo"


def test_torch_measure_halo_rt_refuses_without_two_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("checks the behaviour without two CUDA cards")
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_measure_halo_rt.py"),
         "--reps", "1", "64"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0 and "RuntimeError" in out.stderr
    assert out.stdout == ""


def test_torch_fuzz_reader_mutate_matches_jax_tool():
    ours, theirs = _tool("torch_fuzz_reader"), _tool("fuzz_reader")
    data = (FIXTURES / "photo512_q10_420.jpg").read_bytes()
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(300):
        assert ours.mutate(data, r1) == theirs.mutate(data, r2)
    res = ours.run(60, 0, verbose=False)
    assert res["parsed"] + res["rejected"] == 60
