"""The program's spans on a synthetic device trace (benchmark/trace/
spans.py): the two-mark clock map, each card's busy intervals, the idle
shares in their order of claim on one and four cards, the per-file
stage means and cli.main's self time, the fetch-in-copy check; and
capture.summarize's keys and values as they were."""

import pytest

from benchmark.trace import capture, spans

MARK = "cudaDeviceSynchronize"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace():
    """test_bench_trace.py's synthetic trace: two cards, a window marked
    by two synchronises at each end, 100 to 1100 us."""
    return [_x("cuda_runtime", MARK, 90, 5), _x("cuda_runtime", MARK, 95, 5),
            _x("kernel", "void anonymous::grad_kernel<3>(P)", 200, 100,
               device=0),
            _x("kernel", "void anonymous::project_kernel<3>(P)", 250, 100,
               device=0),
            _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 50,
               device=0),
            _x("kernel", "void at::sqrt_kernel_cuda()", 400, 100, device=1),
            _x("cuda_runtime", "cudaLaunchKernel", 120, 70),
            _x("cuda_runtime", "cudaStreamSynchronize", 700, 300),
            _x("kernel", "before the window", 10, 20, device=0),
            _x("cuda_runtime", MARK, 1090, 5),
            _x("cuda_runtime", MARK, 1095, 5)]


def _span(name, t0, t1, id=None, parent=None, request=1, tid=7, **attrs):
    return {"name": name, "t0": t0, "t1": t1, "tid": tid, "id": id,
            "parent": parent, "request": request, "attrs": attrs}


def test_summarize_reads_as_before():
    """Every key and value summarize gave the synthetic trace before the
    spans came (test_bench_trace.py), and nothing more."""
    s = capture.summarize(_trace(), cards=2)
    assert set(s) == {"window_s", "busy_s", "kernel_s", "device_ops",
                      "idle_gaps"}
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx([200e-6, 100e-6])
    assert s["kernel_s"] == pytest.approx(300e-6)
    assert [n for n, _ in s["device_ops"]] == [
        "K1/K7 grad_kernel", "K2 project_kernel", "sqrt",
        "copy device to host"]
    assert [(g[0], round(g[1] * 1e6)) for g in s["idle_gaps"]] == [
        ("sync", 450), ("launch", 100), ("python", 100), ("python", 50)]


def test_window_pairs_and_card_busy_match_summarize():
    ev = _trace() + [_x("cuda_runtime", spans.PAIR, 101, 4),
                     _x("cuda_runtime", spans.PAIR, 150, 5),
                     _x("cuda_runtime", spans.PAIR, 1080, 6),
                     _x("cuda_runtime", spans.PAIR, 40, 5)]
    w0, w1, a0, a1 = spans.mark_times(ev, cards=2)
    assert (w0, w1, a0, a1) == (100, 1100, 105, 1086)
    with pytest.raises(RuntimeError, match="no clock pairs"):
        spans.mark_times(_trace(), cards=2)
    busy = spans.card_busy(ev, 2, w0, w1)
    assert busy == [[[200, 350], [600, 650]], [[400, 500]]]
    s = capture.summarize(ev, cards=2)
    assert [spans.iv.length(b) / 1e6 for b in busy] == pytest.approx(
        s["busy_s"])


def test_clock_map_through_two_pairs_at_a_rate_other_than_one():
    # the clock reads 1 ms at 500 us of the trace; 2 ms of clock later
    # the trace has moved 2002 us
    p0, p1 = 1_000_000, 3_000_000
    to_us, off0, off1, rate = spans.clock_map(p0, 500.0, p1, 2502.0)
    assert rate == pytest.approx(1.001)
    assert to_us(p0) == pytest.approx(500.0)
    assert to_us(p1) == pytest.approx(2502.0)
    assert to_us(2_000_000) == pytest.approx(1501.0)
    assert (off0, off1) == pytest.approx((-500.0, -498.0))
    sp = spans.mapped([_span("png", 1_500_000, 2_500_000)], to_us)[0]
    assert (sp["t0"], sp["t1"]) == pytest.approx((1000.5, 2001.5))
    assert sp["name"] == "png" and sp["tid"] == 7


def test_idle_shares_on_one_card():
    """Window 0-100, card busy 10-20 and 50-60 (idle 80): the item 5-40
    claims 25, the call's start to its first item 5, the PNGs 45-95 after
    the last item 40, where the card is idle, 40; 10 is left."""
    sp = [_span("cli.main", 0, 100, id=1),
          _span("item", 5, 40, id=2, parent=1, card=0),
          _span("png", 45, 95, id=3, parent=2),
          _span("fetch", 30, 38, id=4, parent=2, bytes=12)]
    sh = spans.idle_shares(sp, [[[10, 20], [50, 60]]], 0, 100)
    assert sh == pytest.approx({"idle": 80, "in_items": 25,
                                "before_items": 5, "png_tail": 40,
                                "residual": 10})


def _two_calls():
    """Two calls, 0-100 and 100-200, on cards 0 and 1."""
    return [_span("cli.main", 0, 100, id=1, request=1),
            _span("item", 10, 60, id=2, parent=1, request=1, card=0),
            _span("item", 20, 90, id=3, parent=1, request=1, card=1),
            _span("png", 50, 100, id=4, parent=2, request=1),
            _span("cli.main", 100, 200, id=5, request=5),
            _span("item", 130, 150, id=6, parent=5, request=5, card=0),
            _span("png", 140, 200, id=7, parent=6, request=5)]


@pytest.mark.parametrize("cards,want", [
    # card 0 busy 30-40: idle 190 = items 60 + before 40 + tail 60 + 30;
    # card 1 never busy: 200 = 70 + 40 + 60 + 30 (10-20, 130-150)
    (2, {"idle": 97.5, "in_items": 32.5, "before_items": 20,
         "png_tail": 30, "residual": 15}),
    # card 2 busy throughout, card 3 idle with no item of its own: 200 =
    # 0 + 40 + 60 + 100
    (4, {"idle": 73.75, "in_items": 16.25, "before_items": 15,
         "png_tail": 22.5, "residual": 20})])
def test_idle_shares_over_cards_claim_once_in_order(cards, want):
    busy = [[[30, 40]], [], [[0, 200]], []][:cards]
    sh = spans.idle_shares(_two_calls(), busy, 0, 200)
    assert sh == pytest.approx(want)
    assert sh["in_items"] + sh["before_items"] + sh["png_tail"] + (
        sh["residual"]) == pytest.approx(sh["idle"])


def test_per_file_means_and_cli_self_time():
    ms = 1_000_000
    sp = []
    for c, base, stages, end in (
            (1, 0, [("read", 1, 3), ("solve.setup", 3, 8),
                    ("solve.loop", 8, 20), ("fetch", 20, 22),
                    ("png", 22, 90)], 100),
            (10, 200, [("read", 200, 202), ("solve.setup", 202, 206),
                       ("solve.loop", 206, 210), ("fetch", 210, 211),
                       ("png", 211, 280)], 300)):
        sp.append(_span("cli.main", base * ms, end * ms, id=c, request=c))
        for k, (name, a, b) in enumerate(stages):
            sp.append(_span(name, a * ms, b * ms, id=c + k + 1, parent=c,
                            request=c))
    # a grandchild inside png is not the call's child
    sp.append(_span("png.inner", 30 * ms, 40 * ms, id=99, parent=6))
    got = spans.per_file_ms(sp)
    assert got == pytest.approx({
        "read": 2, "solve_setup": 4.5, "solve": 9.5, "png": 68.5,
        "cli_self": 15.5, "call": 100, "residual": 0, "calls": 2})
    # metrics() takes the spans mapped onto the trace's us
    on_trace = spans.mapped(sp, lambda ns: ns / 1e3)
    assert spans.metrics(on_trace, [], 0, 1, 0, []) == pytest.approx({
        "read_ms.single": 2, "solve_setup_ms.single": 4.5,
        "solve_ms.single": 9.5, "png_ms.single": 68.5,
        "cli_self_ms.single": 15.5})


def test_fetch_spans_holding_their_copy():
    ev = [_x("cuda_runtime", "cudaMemcpyAsync", 110, 20, tid=7,
             correlation=5),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 115, 10,
             correlation=5, bytes=1200),
          _x("cuda_runtime", "cudaMemcpyAsync", 310, 20, tid=8,
             correlation=6),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 315, 10,
             correlation=6, bytes=1200),
          _x("cuda_runtime", "cudaMemcpyAsync", 510, 20, tid=7,
             correlation=7),
          _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 515, 10,
             correlation=7, bytes=1200)]
    # a span's thread is pthread_self; the trace keeps its low 32 bits
    held = _span("fetch", 100, 140, tid=(0x7F3A << 32) + 7, bytes=1200)
    other_thread = _span("fetch", 300, 340, tid=7, bytes=1200)
    wrong_way = _span("fetch", 500, 540, tid=7, bytes=1200)
    wrong_size = _span("fetch", 100, 140, tid=7, bytes=1201)
    # the copy call 110-130 ends 5 us after this span: a map 5 us off
    late = _span("fetch", 100, 125, tid=7, bytes=1200)
    assert spans.fetch_in_copies([held], ev) == (1.0, 1.0)
    # other_thread holds the copy called on thread 8 at 310-330
    assert spans.fetch_in_copies(
        [held, other_thread, wrong_way, wrong_size], ev) == (0.5, 0.25)
    assert spans.fetch_in_copies([held, late], ev) == (0.5, 0.5)
    assert spans.fetch_in_copies([], ev) == (None, None)


def test_batch_metrics_by_name():
    sp = [_span("cli.main", 0, 100, id=1),
          _span("item", 5, 40, id=2, parent=1, card=0),
          _span("fetch", 30, 38, id=4, parent=2, bytes=24_000_000),
          _span("png", 45, 95, id=3, parent=2)]
    got = spans.metrics(sp, [[[10, 20], [50, 60]]], 0, 100, 2.0, [])
    assert got == pytest.approx({
        "idle_in_items_share.batch": 25, "idle_before_items_share.batch": 5,
        "idle_png_tail_share.batch": 40, "fetch_mb_per_mp.batch": 12.0})


@pytest.mark.parametrize("name", ["defaults_i50.batch48",
                                  "defaults_i50.cli_each"])
def test_span_run_traced_path_on_the_cpu(name, monkeypatch):
    """benchmark/span_run.py's traced run, with a stand-in for the
    profiler whose trace clock runs 5 ms ahead of perf_counter: the spans
    reach the analysis, map back by the marks, and give every number of
    the cell's kind."""
    import contextlib
    import time

    from benchmark import harness, span_run
    from benchmark.trace import capture
    from conftest import tiny_cell

    pairs = []

    def now():
        return time.perf_counter_ns() / 1e3 + 5000.0

    def pair():
        pairs.append(now())
        return time.perf_counter_ns()

    @contextlib.contextmanager
    def stand_in(cards, sink):
        a = now()
        yield
        b = now()
        sink["events"] = (
            [_x("cuda_runtime", MARK, a - 2, 1) for _ in range(cards)]
            + [_x("cuda_runtime", spans.PAIR, t - 1, 1) for t in pairs]
            + [_x("kernel", "k", a + 1, 1, device=d) for d in range(cards)]
            + [_x("cuda_runtime", MARK, b + 1, 1) for _ in range(cards)])
        sink["seconds"] = {}

    for mod, attr in ((capture, "traced"), (capture, "summarize"),
                      (harness, "reader")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))
    monkeypatch.setattr(spans, "_traced", stand_in)
    monkeypatch.setattr(spans, "_clock_pair", pair)
    seen = {}
    span_run.record_traced(seen)
    res = harness.run(tiny_cell(name), 5, 1.0, True, device="cpu")
    assert res["correct"]
    out = span_run.analyse(seen, 1)
    assert out["rate"] == pytest.approx(1.0, abs=1e-3)
    assert out["pair_offsets_us"] == pytest.approx([5000.0, 5000.0],
                                                   abs=500)
    got = out["metrics"]
    if "batch" in name:
        assert set(got) == {"idle_in_items_share.batch",
                            "idle_before_items_share.batch",
                            "idle_png_tail_share.batch",
                            "fetch_mb_per_mp.batch"}
        assert got["fetch_mb_per_mp.batch"] == pytest.approx(12.0)
        sh = out["idle"]
        # the CPU's items name no card: their time falls to the residual
        assert sh["in_items"] == 0 and sh["before_items"] > 0
        assert sh["in_items"] + sh["before_items"] + sh["png_tail"] + (
            sh["residual"]) == pytest.approx(sh["idle"])
    else:
        assert set(got) == {f"{k}_ms.single" for k in (
            "read", "solve_setup", "solve", "png", "cli_self")}
        pf = out["per_file"]
        for k in ("read", "solve_setup", "solve", "png", "cli_self"):
            assert got[f"{k}_ms.single"] == pytest.approx(pf[k], rel=1e-3)
        assert pf["calls"] == res["attempted"]
        assert pf["residual"] == pytest.approx(0.0, abs=1e-6)
        assert 0.8 * pf["latency_mean"] < pf["call"] <= pf["latency_mean"]
