"""The median of every request's wall time, call to return (PNG on
disk), in ms."""

import numpy as np


def read(record):
    lat = record["latencies_s"]
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
