"""% of the two tier's iterations that ran inside CUDA graph replays: the
runner's stats["two_graph_iters"] over it plus stats["two_eager_iters"]
(the counts of its exact images' "solve.loop" spans), summed over the
traced calls; None where the stats lack the keys, as a program without
the counters gives, or the calls ran no two-tier iteration."""


def read(record):
    stats = record["stats"]
    if not stats or not all("two_graph_iters" in s and "two_eager_iters" in s
                            for s in stats):
        return None
    graph = sum(s["two_graph_iters"] for s in stats)
    total = graph + sum(s["two_eager_iters"] for s in stats)
    return 100.0 * graph / total if total else None
