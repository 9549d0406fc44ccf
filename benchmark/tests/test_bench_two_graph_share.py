"""benchmark/metrics/two_graph_share.batch.py: the share of the two tier's
iterations the runner's stats count inside graph replays, and nothing
where the stats lack the counts or hold no two-tier iteration."""

from benchmark import harness


def test_two_graph_share_reads_the_stats():
    read = harness.reader("two_graph_share.batch")
    stats = [{"two_graph_iters": 590, "two_eager_iters": 10},
             {"two_graph_iters": 600, "two_eager_iters": 0}]
    assert read({"stats": stats}) == 100.0 * 1190 / 1200
    # a program without the counters, no stats, no two-tier iteration
    assert read({"stats": [{"solve_s": 1.0}]}) is None
    assert read({"stats": stats[:1] + [{"solve_s": 1.0}]}) is None
    assert read({"stats": []}) is None
    assert read({"stats": [{"two_graph_iters": 0,
                            "two_eager_iters": 0}]}) is None
