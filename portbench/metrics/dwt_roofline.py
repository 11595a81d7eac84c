"""dwt_roofline.<op>: the least time of the wavelet transforms over the
device time of their kernels, in %.  The least time is each value of every
field the window encoded or decoded read once and written once as float32
(8 bytes a value) over the card's peak memory bandwidth (peaks.json); the
device time is the profiler's, summed over the kernels that
dwt_roofline.json names for the window's ops.  Nothing is read without a
trace, a known card or such a kernel."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "dwt_roofline.json")) as f:
    SPEC = json.load(f)


def read(run):
    if run.trace is None or "hbm_bytes_per_s" not in run.peaks:
        return None
    patterns = [p for op in run.ops for p in SPEC["kernels"].get(op, [])]
    t = run.trace.kernel_seconds(patterns) if patterns else None
    if t is None:
        return None
    values = (run.bytes_in + run.bytes_out) / 4
    return 100.0 * values * SPEC["bytes_per_value"] / run.peaks["hbm_bytes_per_s"] / t
