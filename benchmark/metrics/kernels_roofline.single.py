"""% of every CUDA kernel's traced time that the solved images' work
needs at least on an H100 (benchmark/trace/work.py)."""

from benchmark.metrics.common import kernels_roofline


def read(record):
    return kernels_roofline(record)
