"""The runner's stats["png_bytes"] (the bytes of the PNGs its callbacks
wrote, from the program's "png" spans) summed over the traced calls, in
MB per megapixel converted; None where the stats lack the key, as a
program without the counter gives."""

from benchmark.metrics.common import per_mp


def read(record):
    if not all("png_bytes" in s for s in record["stats"]):
        return None
    value = per_mp(record, "png_bytes")
    return None if value is None else value / 1e6
