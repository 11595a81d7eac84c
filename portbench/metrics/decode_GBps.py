"""decode_GBps: the float32 bytes that the window's completed requests
returned, over the window's wall (host clock), in GB/s."""


def read(run):
    if not run.bytes_out:
        return None
    return run.bytes_out / run.wall_s / 1e9
