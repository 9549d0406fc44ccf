"""What several metric readers share.  A reader takes the run's record
(benchmark/harness.py: requests, stats, trace, ...) and returns a number,
or None where the run gives it nothing to read."""

from __future__ import annotations


def per_mp(record, key):
    """A runner stage's seconds summed over the window's calls, per
    megapixel converted (batch traffic only)."""
    if not record["stats"] or not record["mp"]:
        return None
    return sum(s[key] for s in record["stats"]) / record["mp"]


def idle_share(record):
    """% of cards x traced window in which no kernel, copy or memset ran
    on the card."""
    t = record["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sum(t["busy_s"]) / (record["cards"] * t["window_s"]))


def kernels_roofline(record):
    """% of the traced kernels' summed time that the images they solved
    needed at least (benchmark/trace/work.py)."""
    t = record["trace"]
    if t is None or t["kernel_s"] <= 0 or not record.get("least_s"):
        return None
    return 100.0 * record["least_s"] / t["kernel_s"]
