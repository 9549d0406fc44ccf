"""Megapixels (width x height) of every file whose PNG the window wrote,
over the window's wall time."""


def read(record):
    return record["mp"] / record["window_s"] if record["mp"] else None
