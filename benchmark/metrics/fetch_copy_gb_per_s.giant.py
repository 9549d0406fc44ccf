"""The pixel fetch's device -> host copy rate in GB/s: the "fetch" spans'
"bytes" summed over the window's cli calls (per_file_stages
stats["fetch_bytes"]) over the traced seconds of every device -> host
copy, into the fresh pageable host buffer that ops/color._pack hands
the copy; None where the stats lack the bytes or the trace has no such
copy."""


def read(record):
    t, stats = record["trace"], record["stats"]
    if t is None or not stats or not all("fetch_bytes" in s for s in stats):
        return None
    copy_s = sum(sec for name, sec in t["device_ops"]
                 if name == "copy device to host")
    nbytes = sum(s["fetch_bytes"] for s in stats)
    return nbytes / copy_s / 1e9 if copy_s > 0 and nbytes else None
