"""What the per-file stage readers share: the stats of the
per_file_stages entry (benchmark/entries/per_file_stages.py), one dict a
cycle of the traced window."""

from __future__ import annotations


def ms_per_request(record, key):
    """A stage's seconds summed over the window's cycles, per request, in
    ms; None where a cycle's stats lack the key."""
    stats = record["stats"]
    if not stats or not all(key in s for s in stats):
        return None
    n = sum(s["requests"] for s in stats)
    return 1e3 * sum(s[key] for s in stats) / n if n else None
