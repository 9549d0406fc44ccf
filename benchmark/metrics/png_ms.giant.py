"""The "png" span (the PNG filter, deflate and write), in ms per
request: its seconds summed over the traced window's cli calls, over
the calls (per_file_stages stats["png_s"])."""

from benchmark.metrics.stages import ms_per_request


def read(record):
    return ms_per_request(record, "png_s")
