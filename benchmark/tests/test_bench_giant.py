"""The giant-image cell (giant_100mp.cli_giant): its traffic's plan, the
per_file_stages entry on the CPU, its per-layer readers (its own and the
batch cells' it shares), and a traced run of the harness's CPU path
(with a stand-in for the profiler) that reports every one of them."""

import contextlib
import json
import os

import pytest

from benchmark import harness
from benchmark.inputs.corpus import corpus, plan
from conftest import tiny_cell

CELL = "giant_100mp.cli_giant"
STAGES = ("read", "solve_setup", "solve_loop", "fetch", "png")
# its own readers, and the batch cells' it is listed under
OWN = tuple(f"{s}_ms.giant" for s in STAGES[1:]) + (
    "setup_mb_per_mp.giant", "loop_busy_share.giant",
    "fetch_copy_gb_per_s.giant")
SHARED = ("reader_s_per_mp.batch", "device_idle_share.batch",
          "kernels_roofline.batch", "png_mb_per_mp.batch")
READERS = OWN + SHARED
KEYS = {"requests", "fetch_bytes", "png_bytes", "setup_bytes",
        "tiers"} | {f"{s}_s" for s in STAGES}


def test_the_traffic_is_one_giant_file():
    traffic = json.loads((harness.BENCH / "traffic" /
                          "cli_giant.json").read_text())
    ((i, w, h, layout, q),) = plan(traffic)
    assert (i, w * h, layout, q) == (0, 100_663_296, "4:2:0", 30)
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(CELL, spec)
    assert cell["chips"] == 1 and cell["traffic"]["entry"] == (
        "per_file_stages")
    assert [m["name"] for m in cell["end_to_end"]] == ["mp_per_s",
                                                       "setup_s"]
    assert sorted(m["name"] for m in cell["per_layer"]) == sorted(READERS)


def _entry(tmp_path, seed=2 ** 33 + 11):
    from benchmark.entries.per_file_stages import Entry

    cell = tiny_cell(CELL, iterations=2,
                     sizes=[[96, 64, "4:2:0"], [48, 32, "4:2:0"]])
    items = corpus(seed, cell["traffic"], workers=2, log=lambda *a: None)
    flags = cell["config"]["flags"] + ["--device", "cpu"]
    return items, Entry(items, flags, str(tmp_path), seed)


def test_one_cycle_on_the_cpu(tmp_path):
    items, entry = _entry(tmp_path)
    reqs, stats = entry.run(0)
    assert len(reqs) == 2 and all(r.ok for r in reqs)
    assert set(stats) == KEYS and stats["requests"] == 2
    stage_s = [stats[f"{s}_s"] for s in STAGES]
    assert all(v > 0 for v in stage_s)
    assert sum(stage_s) <= sum(r.t1 - r.t0 for r in reqs)
    by_index = {it.index: it for it in items}
    assert stats["png_bytes"] == sum(os.path.getsize(r.out) for r in reqs)
    assert stats["fetch_bytes"] == sum(
        12 * by_index[r.index].width * by_index[r.index].height
        for r in reqs)
    # the uploads: every component's int16 coefficients and f32 quant
    assert stats["setup_bytes"] == sum(
        c.nbytes + 64 * 4 for it in items for c, _, _ in it.components)
    # files this small solve in the mega tier
    assert stats["tiers"] == {"mega": 2}
    # the entry hands the cli module back after the cycle
    assert entry.cli.__name__ == "jpeg2png_tpu_torch.cli"


def test_the_giant_tier_on_a_small_file(tmp_path, monkeypatch):
    """With the mega gate shut the small files take the giant's tier."""
    from jpeg2png_tpu_torch.models import solver

    monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", 0)
    _, entry = _entry(tmp_path)
    reqs, stats = entry.run(0)
    assert all(r.ok for r in reqs)
    assert stats["tiers"] == {"two": 2}


def test_a_program_without_the_counters_gives_neither_key(
        tmp_path, monkeypatch):
    """A program whose set-up counts no bytes and whose loop carries no
    tier, as the parent of these counters: the stats leave both out and
    the readers of them read None."""
    from jpeg2png_tpu_torch.models import solver
    from jpeg2png_tpu_torch.utils import profiling

    real_build, real_span = solver._build_problem, profiling.span
    monkeypatch.setattr(solver, "_build_problem",
                        lambda *args: real_build(*args[:8]))
    monkeypatch.setattr(profiling, "span", lambda name, **attrs: real_span(
        name, **({} if name == "solve.loop" else attrs)))
    _, entry = _entry(tmp_path)
    reqs, stats = entry.run(0)
    assert all(r.ok for r in reqs)
    assert set(stats) == KEYS - {"setup_bytes", "tiers"}
    trace = {"window_s": 50.0, "busy_s": [5.0], "kernel_s": 0.5,
             "device_ops": [("K1/K7 grad_kernel", 0.1)]}
    record = {"stats": [stats], "mp": 0.006144, "trace": trace}
    assert harness.reader("setup_mb_per_mp.giant")(record) is None
    assert harness.reader("loop_busy_share.giant")(record) is None
    assert harness.reader("png_ms.giant")(record) > 0


def _record(stats, mp=201.326592, trace=None, least_s=None):
    return {"stats": stats, "mp": mp, "trace": trace, "cards": 1,
            "least_s": least_s}


def _stats(**kw):
    return [dict(dict(requests=1, read_s=0.5, solve_setup_s=0.2,
                      solve_loop_s=0.4, fetch_s=0.6, png_s=5.0,
                      fetch_bytes=1_200_000_000, png_bytes=50_000_000,
                      setup_bytes=302_000_000, tiers={"two": 1}), **kw),
            dict(requests=1, read_s=0.7, solve_setup_s=0.4,
                 solve_loop_s=0.5, fetch_s=0.8, png_s=6.0,
                 fetch_bytes=1_200_000_000, png_bytes=50_000_000,
                 setup_bytes=302_000_000, tiers={"two": 1})]


TRACE = {"window_s": 50.0, "busy_s": [5.0], "kernel_s": 0.5,
         "device_ops": [("copy device to host", 1.2),
                        ("K2 project_kernel", 0.4),
                        ("K1/K7 grad_kernel", 0.32),
                        ("K2/K6/K5 reduce_dists", 0.01),
                        ("copy host to device", 0.1)]}


def test_readers_on_a_hand_made_record():
    rec = _record(_stats(), trace=TRACE, least_s=0.05)
    want = {"reader_s_per_mp.batch": 1.2 / 201.326592,
            "solve_setup_ms.giant": 300.0,
            "solve_loop_ms.giant": 450.0, "fetch_ms.giant": 700.0,
            "png_ms.giant": 5500.0,
            "setup_mb_per_mp.giant": 604.0 / 201.326592,
            "png_mb_per_mp.batch": 100.0 / 201.326592,
            "device_idle_share.batch": 90.0,
            "kernels_roofline.batch": 10.0,
            # K1 and K2 0.72 s over 0.9 s of loops
            "loop_busy_share.giant": 80.0,
            # 2.4 GB over 1.2 s of device -> host copies
            "fetch_copy_gb_per_s.giant": 2.0}
    assert set(want) == set(READERS)
    for name, value in want.items():
        assert harness.reader(name)(rec) == pytest.approx(value), name


@pytest.mark.parametrize("tiers", [{"two": 1, "mega": 1}, {"mega": 2}, {}])
def test_the_loop_share_is_read_only_where_every_loop_is_two(tiers):
    rec = _record(_stats(tiers=tiers), trace=TRACE)
    assert harness.reader("loop_busy_share.giant")(rec) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_stats_or_trace(name):
    assert harness.reader(name)(_record([])) is None


def test_a_traced_run_reports_every_metric_of_the_cell(monkeypatch):
    """The harness's traced path on the CPU, with a stand-in for the
    profiler and the mega gate shut, so that the small file takes the
    giant's tier: the result line holds every per-layer metric of the
    cell."""
    from benchmark.trace import capture
    from jpeg2png_tpu_torch.models import solver

    @contextlib.contextmanager
    def stand_in(cards, sink):
        yield
        sink["events"], sink["seconds"] = [], {}

    monkeypatch.setattr(solver, "MEGA_MAX_PIXELS", 0)
    monkeypatch.setattr(capture, "traced", stand_in)
    monkeypatch.setattr(capture, "summarize", lambda events, cards: {
        "window_s": 1.0, "busy_s": [0.25], "kernel_s": 0.5,
        "device_ops": [("K1/K7 grad_kernel", 1e-6),
                       ("copy device to host", 1e-3)],
        "idle_gaps": []})
    cell = tiny_cell(CELL, iterations=2, sizes=[[96, 64, "4:2:0"]])
    res = harness.run(cell, 2 ** 33 + 13, 0.2, True, device="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == set(READERS)
    assert res["metrics"]["device_idle_share.batch"]["value"] == 75.0
    assert res["metrics"]["setup_mb_per_mp.giant"]["value"] > 0
    assert 0 < res["metrics"]["loop_busy_share.giant"]["value"] < 100
