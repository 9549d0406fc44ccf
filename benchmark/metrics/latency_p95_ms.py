"""The 95th percentile of every request's wall time, in ms."""

import numpy as np


def read(record):
    lat = record["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
