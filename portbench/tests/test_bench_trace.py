"""The reading of a profiler trace, on a synthetic one."""

import pytest

from portbench import trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev(trace.WINDOW, "user_annotation", 100.0, 1000.0),
    _ev("portbench.encode", "user_annotation", 100.0, 1000.0),
    _ev("void (anonymous namespace)::lift_x<4, false>(float*, long long)", "kernel", 150.0, 50.0),
    _ev("void (anonymous namespace)::lift_x<4, true>(float*, long long)", "kernel", 180.0, 40.0),
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600.0, 100.0),
    _ev("dwt2d_level(Level, Lift)", "kernel", 50.0, 70.0),  # half before the window
    _ev("aten::copy_", "cpu_op", 550.0, 200.0),
    _ev("cudaStreamSynchronize", "cuda_runtime", 560.0, 20.0),
    _ev("outside", "kernel", 1200.0, 10.0),
]


def test_busy_and_window():
    tr = trace.Trace(EVENTS)
    assert tr.window_s == pytest.approx(1e-3)
    # the kernels alone: [100, 120] + [150, 220]; the copy is summed apart
    assert tr.busy_s == pytest.approx(90e-6)
    assert tr.copy_seconds() == pytest.approx(100e-6)
    assert trace.Trace(EVENTS[:4]).copy_seconds() is None
    assert tr.kernel_seconds([r"lift_x<\d+, false>"]) == pytest.approx(50e-6)
    assert tr.kernel_seconds([r"(?<!i)dwt2d_level"]) == pytest.approx(20e-6)
    assert tr.kernel_seconds(["nothing"]) is None


def test_names():
    tr = trace.Trace(EVENTS)
    ops = dict(tr.top_device_ops())
    assert ops["lift_x<4, false>"] == pytest.approx(50e-6) and "Memcpy DtoH (Device -> Pageable)" in ops
    gaps = dict(tr.idle_gaps())
    # [120, 150] and [220, 1100] (the copy is no kernel): the middle 135
    # lies in the request alone, 660 in aten::copy_, which issued the copy
    assert gaps == {"portbench.encode": pytest.approx(30e-6), "aten::copy_": pytest.approx(880e-6)}
    assert trace.short_name("void ns::k<1, (bool)0>(int)") == "k<1, (bool)0>"


def test_innermost_host_range_names_a_gap():
    ev = EVENTS[:2] + [_ev("k", "kernel", 100.0, 10.0), _ev("k", "kernel", 1090.0, 10.0),
                       _ev("aten::nonzero", "cpu_op", 400.0, 400.0),
                       _ev("cudaStreamSynchronize", "cuda_runtime", 500.0, 300.0)]
    assert dict(trace.Trace(ev).idle_gaps()) == {"cudaStreamSynchronize": pytest.approx(980e-6)}


def test_no_window_range():
    with pytest.raises(RuntimeError):
        trace.Trace(EVENTS[2:])
