"""Terminal progress bar.

Same UX as the reference's 70-column bar with redraw suppression
(reference: progressbar.c:6-66): only repaints when the filled-char
count or the percentage changes.  The reference ticks once per
iteration from inside the hot loop (compute.c:449-452); here the
device loop runs as resumable chunks and the host ticks after each, in
chunks of models/solver.py::iter_chunk iterations (per iteration for
short solves of <= 16 iterations, iterations/20 within 8-50 beyond
that), for single files and serving buckets alike.
"""

from __future__ import annotations

import sys
import threading

BAR_WIDTH = 70


class ProgressBar:
    def __init__(self, total: int, stream=None):
        self.total = max(total, 1)
        self.current = 0
        self._last_chars = -1
        self._last_pct = -1
        self._stream = stream if stream is not None else sys.stderr
        self._lock = threading.Lock()
        self._draw()

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self.current = min(self.current + n, self.total)
            self._draw()

    def _draw(self) -> None:
        chars = self.current * BAR_WIDTH // self.total
        pct = self.current * 100 // self.total
        if chars == self._last_chars and pct == self._last_pct:
            return
        self._last_chars = chars
        self._last_pct = pct
        bar = "#" * chars + "-" * (BAR_WIDTH - chars)
        self._stream.write("\r[%s] %3d%%" % (bar, pct))
        self._stream.flush()

    def clear(self) -> None:
        with self._lock:
            self._stream.write("\r" + " " * (BAR_WIDTH + 8) + "\r")
            self._stream.flush()
