"""d2h_MB_per_GB: bytes the compressor copied from the device to the host
(its last_d2h_bytes after each request), in MB per GB of float32 input."""


def read(run):
    if "d2h_bytes" not in run.counters or not run.bytes_in:
        return None
    return run.total("d2h_bytes") / 1e6 / (run.bytes_in / 1e9)
