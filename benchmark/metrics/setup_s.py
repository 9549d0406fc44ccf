"""Process start to the window's start: imports, CUDA, the program's
libraries and one warm unit of the cell's traffic.  Making or loading
the seed's inputs is the benchmark's own work: it is timed apart and left
out, so the number does not depend on whether an earlier run cached the
seed."""


def read(record):
    return record["setup_s"]
