"""The "solve.loop" span (the tier's iterations; on this cell the two
tier's K1 + K2 host loop), in ms per request: its seconds summed over
the traced window's cli calls, over the calls (per_file_stages
stats["solve_loop_s"])."""

from benchmark.metrics.stages import ms_per_request


def read(record):
    return ms_per_request(record, "solve_loop_s")
