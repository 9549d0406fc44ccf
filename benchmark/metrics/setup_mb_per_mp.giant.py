"""The host -> device bytes of every solve's set-up (the "solve.setup"
span's counter "bytes": the coefficients and quantisation tables
uploaded), summed over the traced window's cli calls, in MB per
megapixel converted; None where the stats lack it, as a program
without the counter gives."""


def read(record):
    stats = record["stats"]
    if not stats or not record["mp"] or not all("setup_bytes" in s
                                                for s in stats):
        return None
    return sum(s["setup_bytes"] for s in stats) / record["mp"] / 1e6
