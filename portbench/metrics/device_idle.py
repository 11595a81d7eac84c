"""device_idle.<op>: 1 - the union of the device's kernel intervals over
the traced window's length (torch.profiler).  Copies and memsets are not
counted: the copies are read by copy_ms_per_GB.  Nothing is read where no
kernel ran."""


def read(run):
    if run.trace is None or not run.trace.busy:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
