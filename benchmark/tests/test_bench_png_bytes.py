"""benchmark/metrics/png_mb_per_mp.batch.py: the PNG bytes the runner's
stats give per megapixel, and nothing where the stats lack them."""

from benchmark import harness


def test_png_mb_per_mp_reads_the_stats():
    read = harness.reader("png_mb_per_mp.batch")
    stats = [{"png_bytes": 3_000_000}, {"png_bytes": 5_000_000}]
    assert read({"stats": stats, "mp": 4.0}) == 2.0
    # a program without the counter (stats without the key), no stats, no MP
    assert read({"stats": [{"on_pixels_s": 1.0}], "mp": 4.0}) is None
    assert read({"stats": stats[:1] + [{}], "mp": 4.0}) is None
    assert read({"stats": [], "mp": 4.0}) is None
    assert read({"stats": stats, "mp": 0}) is None
