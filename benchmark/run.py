"""Run one cell of the benchmark of jpeg2png_tpu_torch on this machine's
CUDA cards:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers compared for `correct` are the last lines of
standard error.  See benchmark/harness.py.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
