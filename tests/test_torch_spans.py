"""The port's spans (utils/profiling.py: span, recording, within, count)
on the CPU: nesting, parents across threads, thread ids, nothing
kept outside recording(); the spans of one per-file and one --tpu-batch
cli call; and the runner's stage seconds read from its spans."""

import concurrent.futures
import contextlib
import os
import threading

import pytest

torch = pytest.importorskip("torch")

from jpeg2png_tpu_torch import cli, runner  # noqa: E402
from jpeg2png_tpu_torch.io import read_jpeg  # noqa: E402
from jpeg2png_tpu_torch.utils import profiling  # noqa: E402
from jpeg2png_tpu_torch.utils.config import SolverConfig  # noqa: E402

torch.set_num_threads(2)

RGB = ["lineart64_q20_420", "photo80_q30_422", "odd100x52_q25_420"]


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


def test_spans_nest_under_the_innermost_open_span():
    with profiling.recording() as spans:
        with profiling.span("outer", files=2) as outer:
            with profiling.span("mid") as mid:
                with profiling.span("inner") as inner:
                    pass
            with profiling.span("second") as second:
                pass
        with profiling.span("other") as other:
            pass
    assert [s.name for s in spans] == ["inner", "mid", "second", "outer",
                                       "other"]
    assert outer.parent is None and outer.request == outer.id
    assert mid.parent == outer.id and second.parent == outer.id
    assert inner.parent == mid.id
    assert {s.request for s in (outer, mid, inner, second)} == {outer.id}
    assert other.parent is None and other.request == other.id != outer.id
    assert len({s.id for s in spans}) == 5
    assert outer.attrs == {"files": 2}
    for child, parent in ((mid, outer), (inner, mid), (second, outer)):
        assert _inside(child, parent)
    assert mid.t1 <= second.t0


def test_within_hands_the_parent_to_a_pool_thread():
    """A job submitted from an open span names that span as its parent on
    the pool's thread, as the runner's PNG jobs name their work item."""

    def job(parent):
        with profiling.within(parent), profiling.span("png") as sp:
            with profiling.span("deflate"):
                pass
        return sp

    with profiling.recording() as spans:
        with profiling.span("item") as item:
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                futs = [pool.submit(job, profiling.current())
                        for _ in range(3)]
                pngs = [f.result() for f in futs]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            orphan = pool.submit(job, None).result()
    for png in pngs:
        assert png.parent == item.id and png.request == item.request
    deflates = [s for s in spans if s.name == "deflate"]
    assert sorted(s.parent for s in deflates) == sorted(
        s.id for s in pngs + [orphan])
    assert orphan.parent is None and orphan.request == orphan.id
    # the parent went back off the pool thread's stack with the job
    assert profiling.current() is None


def test_nothing_is_kept_outside_recording():
    with profiling.span("alone", path="x") as sp:
        profiling.count(sp, "bytes", 3)
        assert profiling.current() is None
        with profiling.within(sp), profiling.span("child") as child:
            assert profiling.current() is None
    assert sp.id is None and sp.parent is None and sp.request is None
    assert sp.tid is None and child.id is None
    assert sp.t1 >= sp.t0 > 0 and sp.seconds >= 0
    assert sp.attrs == {"path": "x", "bytes": 3}
    with profiling.recording() as spans:
        pass
    with profiling.span("after"):
        pass
    assert spans == []


def test_collected_gathers_spans_by_name_recording_or_not():
    """collected(name): the spans of that name that close on this thread
    inside the block, nested blocks each their own, none from another
    thread."""

    def other():
        with profiling.span("png"):
            pass

    for rec in (False, True):
        with (profiling.recording() if rec else contextlib.nullcontext()):
            with profiling.collected("png") as outer:
                with profiling.span("png") as a, profiling.span("read"):
                    pass
                with profiling.collected("png") as inner:
                    with profiling.span("png") as b:
                        pass
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
            with profiling.span("png"):
                pass
        assert outer == [a, b] and inner == [b], rec


def test_spans_carry_their_thread_ids():
    """pthread_self, whose low 32 bits a profiler trace gives the thread
    of a CUDA call in some runs."""
    ids, done = {}, []

    def run(tag):
        with profiling.span(tag) as sp:
            ids[tag] = threading.get_ident()
        done.append(sp)

    with profiling.recording():
        run("main")
        t = threading.Thread(target=run, args=("t",))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    here, there = done
    assert here.tid == ids["main"] and there.tid == ids["t"]
    assert here.tid != there.tid


def test_a_span_closes_when_its_block_raises():
    with profiling.recording() as spans:
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner") as inner:
                    profiling.count(inner, "bytes", 2)
                    profiling.count(inner, "bytes", 5)
                    raise ValueError("boom")
        with profiling.span("next") as nxt:
            pass
    assert [s.name for s in spans] == ["inner", "outer", "next"]
    assert inner.t1 >= inner.t0 and inner.attrs == {"bytes": 7}
    assert nxt.parent is None


def _tree(spans):
    by_id = {s.id: s for s in spans}
    return by_id, {s.name: [c for c in spans if c.name == s.name]
                   for s in spans}


def test_cli_per_file_call_spans(fixtures_dir, tmp_path):
    src = fixtures_dir / "lineart64_q20_420.jpg"
    out = tmp_path / "out.png"
    with profiling.recording() as spans:
        rc = cli.main(["--device", "cpu", "-i", "2", "-q", "-o", str(out),
                       str(src)])
    assert rc == 0 and out.exists()
    by_id, named = _tree(spans)
    (main,) = named["cli.main"]
    assert main.parent is None
    for name in ("read", "solve.setup", "solve.loop", "fetch", "png"):
        (sp,) = named[name]
        assert sp.parent == main.id and _inside(sp, main), name
    assert {s.request for s in spans} == {main.id}
    # the fetch's and the PNG's counts are the attributes a per-file call
    # records
    img = read_jpeg(src)
    assert named["fetch"][0].attrs == {"bytes": 12 * img.width * img.height}
    assert named["png"][0].attrs == {"strips": 1,
                                     "bytes": out.stat().st_size}
    # the set-up's uploads (coefficients and quant tables) and the tier
    assert named["solve.setup"][0].attrs == {
        "bytes": sum(p.data.nbytes + 64 * 4 for p in img.planes)}
    assert named["solve.loop"][0].attrs == {"tier": "mega"}
    assert all(s.attrs == {} for s in spans if s.name not in (
        "fetch", "png", "solve.setup", "solve.loop"))
    # the stages in the order a file passes them
    order = sorted((named[n][0] for n in ("read", "solve.setup",
                                          "solve.loop", "fetch", "png")),
                   key=lambda s: s.t0)
    assert [s.name for s in order] == ["read", "solve.setup", "solve.loop",
                                       "fetch", "png"]


def test_cli_batch_call_spans(fixtures_dir, tmp_path):
    ins = [str(fixtures_dir / f"{n}.jpg") for n in RGB]
    outs = [str(tmp_path / f"{n}.png") for n in RGB]
    argv = ["--tpu-batch", "--device", "cpu", "-i", "2", "-q"]
    for o in outs:
        argv += ["-o", o]
    stats = {}
    with profiling.recording() as spans:
        assert cli.main(argv + ins, stats=stats) == 0
    by_id, named = _tree(spans)
    (main,) = named["cli.main"]
    assert {s.request for s in spans} == {main.id}
    (pool,) = named["read.pool"]
    (solve,) = named["solve.pool"]
    for sp in (pool, solve):
        assert sp.parent == main.id and _inside(sp, main)
    assert pool.t1 <= solve.t0
    items = named["item"]
    assert len(items) == sum(stats["card_items"])
    for it in items:
        assert it.parent == solve.id and _inside(it, solve)
        assert it.attrs == {"card": None}      # the CPU has no ordinal
    pngs = named["png"]
    assert len(pngs) == 3
    for png in pngs:
        # png <- on_pixels (a PNG-pool thread) <- the item that fetched it
        cb = by_id[png.parent]
        assert cb.name == "on_pixels" and by_id[cb.parent].name == "item"
        assert _inside(png, cb)
    # the runner's PNG stats are the sums of the png spans' counts
    assert stats["png_bytes"] == sum(os.path.getsize(o) for o in outs)
    assert stats["png_bytes"] == sum(p.attrs["bytes"] for p in pngs)
    assert stats["png_strips"] == sum(p.attrs["strips"] for p in pngs) == 3
    fetched = sorted(s.attrs["bytes"] for s in named["fetch"])
    want = []
    for i in ins:
        img = read_jpeg(i)
        want.append(12 * img.width * img.height)
    assert fetched == sorted(want)
    for f in named["fetch"]:
        assert by_id[f.parent].name == "item"


def test_runner_stats_are_sums_of_its_spans(fixtures_dir):
    files = [str(fixtures_dir / f"{n}.jpg") for n in RGB + ["gray64_q30"]]
    got = {}
    stats = {}
    with profiling.recording() as spans:
        runner.decode_files_batched(
            files, SolverConfig(iterations=(2,) * 3), stats=stats,
            on_pixels=lambda f, pix: got.setdefault(f, pix.shape),
            devices=["cpu", "cpu"])
    assert set(got) == set(files)
    named = {}
    for s in spans:
        named.setdefault(s.name, []).append(s)
    (pool,) = named["read.pool"]
    (solve,) = named["solve.pool"]
    assert stats["read_s"] == pool.seconds
    assert stats["solve_s"] == solve.seconds
    assert stats["on_pixels_s"] == sum(s.seconds for s in named["on_pixels"])
    assert len(named["on_pixels"]) == len(files)
    items = named["item"]
    workers = len(stats["card_busy_s"])
    tids = {s.tid for s in items}
    assert 1 <= len(tids) <= workers <= 2
    busy = [sum(s.seconds for s in items if s.tid == t) for t in tids]
    busy += [0.0] * (workers - len(busy))
    assert sorted(stats["card_busy_s"]) == pytest.approx(sorted(busy),
                                                         rel=1e-12)
    assert sum(stats["card_items"]) == len(items)
    assert all(_inside(s, solve) for s in items)
    end = max(s.t1 for s in named["on_pixels"] + [solve])
    assert stats["wall_s"] == (end - pool.t0) / 1e9
    # outside recording() the same keys come from the same clock readings
    quiet = {}
    runner.decode_files_batched(files[:2], SolverConfig(iterations=(2,) * 3),
                                stats=quiet, device="cpu")
    for key in ("read_s", "solve_s", "wall_s"):
        assert quiet[key] > 0
    assert quiet["card_items"] == [sum(quiet["card_items"])]
    # a callback that writes no PNG: no strips, no bytes
    assert stats["png_strips"] == stats["png_bytes"] == 0
    assert "bucket_sizes" not in quiet and "bucket_sizes" not in stats


def test_cli_batch_png_stats_outside_recording(fixtures_dir, tmp_path):
    """The runner reads its PNG stats from the png spans without
    recording(), as the benchmark's calls run."""
    ins = [str(fixtures_dir / f"{n}.jpg") for n in RGB[:2]]
    outs = [str(tmp_path / f"{n}.png") for n in RGB[:2]]
    argv = ["--tpu-batch", "--device", "cpu", "-i", "2", "-q"]
    for o in outs:
        argv += ["-o", o]
    stats = {}
    assert cli.main(argv + ins, stats=stats) == 0
    assert stats["png_bytes"] == sum(os.path.getsize(o) for o in outs) > 0
    assert stats["png_strips"] == 2


def test_cli_per_file_threads_keep_one_request(fixtures_dir, tmp_path):
    """-t 2 decodes two files on a pool: each file's spans are children of
    the call's cli.main span."""
    ins = [str(fixtures_dir / f"{n}.jpg") for n in RGB[:2]]
    argv = ["--device", "cpu", "-i", "2", "-q", "-t", "2"]
    for n in RGB[:2]:
        argv += ["-o", str(tmp_path / f"{n}.png")]
    with profiling.recording() as spans:
        assert cli.main(argv + ins) == 0
    (main,) = [s for s in spans if s.name == "cli.main"]
    assert {s.request for s in spans} == {main.id}
    for name in ("read", "solve.setup", "solve.loop", "fetch", "png"):
        got = [s for s in spans if s.name == name]
        assert len(got) == 2 and all(s.parent == main.id for s in got), name
