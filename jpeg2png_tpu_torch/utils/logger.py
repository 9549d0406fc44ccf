"""CSV convergence logger.

Byte-compatible with the reference's optimization log (-c flag):
header `filename,channel,iteration,objective,prob_dist,tv,tv2`
(reference: logger.c:13), one row per iteration per solve, channel 3
denoting a joint solve (jpeg2png.c:143).  Values arrive as the metric
rows the solver fetches once per chunk, so logging costs nothing
on-device.
"""

from __future__ import annotations

import threading
from typing import IO, Optional

import numpy as np

HEADER = "filename,channel,iteration,objective,prob_dist,tv,tv2"


class ConvergenceLogger:
    def __init__(self, fileobj: Optional[IO[str]]):
        self._f = fileobj
        self._lock = threading.Lock()
        if self._f is not None:
            self._f.write(HEADER + "\n")

    def log_metrics(self, filename: str, channel: int, metrics,
                    start_iteration: int = 0) -> None:
        """metrics: [iterations, 4] array (objective, prob_dist, tv, tv2).

        start_iteration offsets the iteration column — chunked solves
        stream their rows incrementally (pipeline.smooth_decode)."""
        if self._f is None:
            return
        m = np.asarray(metrics)
        with self._lock:
            for i in range(m.shape[0]):
                self._f.write(
                    "%s,%d,%d,%f,%f,%f,%f\n"
                    % (filename, channel, start_iteration + i,
                       m[i, 0], m[i, 1], m[i, 2], m[i, 3])
                )
            self._f.flush()
