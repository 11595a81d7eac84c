"""h2d_MB_per_GB: bytes the 3D decompressor copied to the device
(TorchDecompressor3D.last_h2d_bytes after each request), in MB per GB of
float32 output."""


def read(run):
    if "h2d_bytes" not in run.counters or not run.bytes_out:
        return None
    return run.total("h2d_bytes") / 1e6 / (run.bytes_out / 1e9)
