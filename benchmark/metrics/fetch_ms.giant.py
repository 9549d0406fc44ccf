"""The "fetch" span (the device casts and the device -> host copy of the
pixels), in ms per request: its seconds summed over the traced window's
cli calls, over the calls (per_file_stages stats["fetch_s"])."""

from benchmark.metrics.stages import ms_per_request


def read(record):
    return ms_per_request(record, "fetch_s")
