"""encode_GBps: the float32 input bytes of every request the window
completed, over the window's wall (host clock), in GB/s."""


def read(run):
    if not run.bytes_in:
        return None
    return run.bytes_in / run.wall_s / 1e9
