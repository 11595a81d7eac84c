"""copy_ms_per_GB.<op>: device milliseconds of the window's host-device
copies (every memcpy event of the profiler's trace, summed) per GB of
float32 data the window's requests encoded or decoded.  Nothing is read
without a trace or a copy."""


def read(run):
    gb = (run.bytes_in + run.bytes_out) / 1e9
    if run.trace is None or not gb:
        return None
    s = run.trace.copy_seconds()
    return None if s is None else 1e3 * s / gb
