"""The "solve.setup" span (_build_problem's uploads and device
constants, the tier, the initial carry), in ms per request: its seconds
summed over the traced window's cli calls, over the calls
(per_file_stages stats["solve_setup_s"])."""

from benchmark.metrics.stages import ms_per_request


def read(record):
    return ms_per_request(record, "solve_setup_s")
