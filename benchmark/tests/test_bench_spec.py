"""BENCHMARK.json against the benchmark's contract: its keys and limits,
names, units and lengths, and that every cell, configuration, traffic mix
and metric it names has its file under benchmark/."""

import json
import math
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])


def test_configs_and_cells():
    names = [c["name"] for c in SPEC["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(len(cells) * 0.25))
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        traffic = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        entry = json.loads(traffic.read_text())["entry"]
        assert (ROOT / "benchmark" / "entries" / f"{entry}.py").is_file()
    assert {c["config"] for c in cells} == set(names)


def test_metrics():
    e2e, layer = SPEC["end_to_end"], SPEC["per_layer"]
    all_names = [m["name"] for m in e2e + layer]
    assert len(set(all_names)) == len(all_names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        mine = [m for m in e2e if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        moved = {m["name"] for m in mine}
        assert any(cell in m.get("workloads", []) or (
            "workloads" not in m and m["moves"] in moved) for m in layer)
    for m in layer:
        for cell in m.get("workloads", []):
            reported = {x["name"] for x in e2e
                        if cell in x.get("workloads", [cell])}
            assert m["moves"] in reported


def test_every_seed_compares_each_group_of_the_sample():
    """The check's sample takes its count from each size group on every
    seed: at -i 1000, one file above 1280 x 1024 (an exact K1+K2 image)
    and three at or below it (K3 dyn chunks)."""
    import types

    from benchmark.inputs.corpus import plan
    from benchmark.verify import sample

    for cell in SPEC["workloads"]:
        conf = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
        check = json.loads((ROOT / conf["file"]).read_text())["check"]
        traffic = json.loads((ROOT / "benchmark" / "traffic" /
                              f"{cell['traffic']}.json").read_text())
        items = [types.SimpleNamespace(index=i, width=w, height=h)
                 for i, w, h, _, _ in plan(traffic)]
        for seed in (0, 1, 2 ** 31 + 3, 4200000003, 2 ** 33 + 1):
            picked = sample(items, check, seed)
            assert len(set(picked)) == len(picked)
            for g in check["groups"]:
                lo = g.get("min_pixels", 0)
                hi = g.get("max_pixels", math.inf)
                inside = [i for i in items if lo <= i.width * i.height <= hi]
                got = [i for i in inside if i.index in picked]
                assert len(got) == min(g["n"], len(inside)), (cell, seed, g)
        if cell["config"] == "converge_i1000":
            sizes = {(items[i].width, items[i].height)
                     for i in sample(items, check, 4200000003)}
            assert any(w * h > 1280 * 1024 for w, h in sizes)
