#!/usr/bin/env python3
"""Run one cell of the benchmark of sperr_tpu_torch and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number the
check compared beside its limit); the same numbers are the last lines of
standard error.  Without a CUDA device, or with fewer than the cell asks
for, it exits with 3 and prints no result.  ``--control`` runs the cell's
control (``control`` in its configuration), whose check has to fail.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this script's folder: the harness and the
# program are imported as packages from there
sys.path[0] = ROOT


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.Bench(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"no result: modules loaded that the benchmark must not load: {found}", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    for k, v in out["info"].items():
        print(f"info {k} {v!r}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
