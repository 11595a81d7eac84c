"""The benchmark's reading of a torch.profiler trace of the window.

The window runs inside ``record_function("portbench.window")`` and each
request inside ``record_function("portbench.<op>")``.  The trace is exported
in Chrome's format (Kineto writes it), read back here and deleted.  Device
activity is every kernel, memcpy and memset event; the device is busy over
the union of its kernels' intervals (the profiler busy-time arithmetic of
``sperr_tpu_torch/runtime/device_bench.py``, with overlaps counted once), so
a gap in which only a copy ran is idle and named by what the host did then.
The copies are summed apart (``copy_seconds``).  Times in the trace are
microseconds.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "portbench.window"


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespaces,
    arguments and long template arguments:
    ``void (anonymous namespace)::lift_x<4, true>(float*, ...)`` ->
    ``lift_x<4, true>``; ``void at::native::elementwise_kernel<128, 4, ...>(...)``
    -> ``elementwise_kernel<...>``."""
    s = name[5:] if name.startswith("void ") else name
    depth, head, targs = 0, None, ""
    for i, ch in enumerate(s):
        if ch == "<":
            if depth == 0 and head is None:
                head = i
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0 and head is not None and not targs:
                targs = s[head:i + 1]
        elif ch == "(" and depth == 0 and i > 0 and s[i - 1] not in " (":
            s = s[:i]
            break
    base = s[:head] if head is not None else s
    base = re.sub(r"^.*::", "", base)
    if targs and len(targs) > 32:
        targs = "<...>"
    return (base + targs) or name[:80]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """What the readers take from one traced window."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        w = win[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.device = []  # (name, start, end), clipped to the window
        self.copies = []  # (start, end) of each memcpy, clipped to the window
        self.host = []  # (name, start, end)
        kernels = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.device.append((e.get("name", cat), a, b))
                    if cat == "kernel":
                        kernels.append((a, b))
                    elif cat == "gpu_memcpy":
                        self.copies.append((a, b))
            elif cat in HOST_CATS and e.get("name") != WINDOW:
                self.host.append((e.get("name", cat), a, b))
        self.busy = _union(kernels)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def copy_seconds(self) -> Optional[float]:
        """Summed device seconds of the window's memcpy events; None if none
        ran."""
        return sum(b - a for a, b in self.copies) / 1e6 if self.copies else None

    def kernel_seconds(self, patterns) -> Optional[float]:
        """Summed device seconds of the kernels whose names match any of
        ``patterns`` (regular expressions, searched); None if none ran."""
        rx = [re.compile(p) for p in patterns]
        hit = [b - a for name, a, b in self.device if any(r.search(name) for r in rx)]
        return sum(hit) / 1e6 if hit else None

    def top_device_ops(self, k: int = 10) -> List[list]:
        per = defaultdict(float)
        for name, a, b in self.device:
            per[short_name(name)] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(per.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle device seconds in the window, summed by what the host was
        doing in each gap: the innermost host range (torch op, CUDA runtime
        call or request) open at the gap's middle."""
        gaps, last = [], self.t0
        for a, b in self.busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        per = defaultdict(float)
        active: list = []  # (duration, end, name) of ranges open so far
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                name, s, e = host[i]
                heapq.heappush(active, (e - s, e, name))
                i += 1
            while active and active[0][1] < mid:  # closed before this gap
                heapq.heappop(active)
            per[active[0][2] if active else "host, no range open"] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(per.items(), key=lambda x: -x[1])[:k]]


def read(prof) -> Trace:
    """Export ``prof``'s trace to a temporary file, read it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events)


def summary(tr: Trace) -> Dict[str, list]:
    return {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
