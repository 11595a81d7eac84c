"""Lightweight tracing/profiling subsystem.

The reference has no built-in tracing (SURVEY.md §5); this framework exposes
stage timers plus a torch.profiler capture for the device stages (the
port's copy of sperr_tpu/runtime/profiling.py; ``device_trace`` is torch's).

Usage:
    with trace("encode/dense"):
        ...
    report()                    # -> {stage: {calls, total_s}}
    with device_trace("tb"):    # Chrome trace viewable in TensorBoard/Perfetto
        ...
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict

_lock = threading.Lock()
_stats: Dict[str, list] = defaultdict(lambda: [0, 0.0])
enabled = False


def enable(on: bool = True) -> None:
    global enabled
    enabled = on


@contextlib.contextmanager
def trace(stage: str):
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats[stage]
            s[0] += 1
            s[1] += dt


def report() -> Dict[str, Dict[str, float]]:
    with _lock:
        return {k: {"calls": v[0], "total_s": round(v[1], 6)} for k, v in _stats.items()}


def reset() -> None:
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace around a code region: CPU activity,
    plus CUDA activity where a GPU is present.  A Chrome trace file
    (``*.pt.trace.json``) is written into ``logdir`` when the region ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
