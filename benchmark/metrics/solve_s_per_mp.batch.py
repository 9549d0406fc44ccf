"""The runner's stats["solve_s"] summed over the traced calls, per
megapixel converted."""

from benchmark.metrics.common import per_mp


def read(record):
    return per_mp(record, "solve_s")
