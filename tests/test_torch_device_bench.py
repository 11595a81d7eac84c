"""The port's stage timer, tracing module and device stats against sperr_tpu's.

``runtime/device_bench.py`` keeps the JAX module's function names and result
keys (the sparse transfer's ``encode_core_sparse_*`` included), adds ``device``
and ``timed``, and runs on the CPU only when asked (the kernels' plain
versions; a CPU time says nothing about the card).  The JAX functions' keys
are read with their timers stubbed, so nothing of them is compiled in a
loop.  ``utils/stats.py`` and ``runtime/profiling.py`` behave as their
originals."""

import glob
import types

import numpy as np
import pytest
import torch

from sperr_tpu.runtime import device_bench as jdb
from sperr_tpu.runtime import profiling as j_prof
from sperr_tpu.utils import stats as j_stats
from sperr_tpu_torch.parallel.batched import TorchCompressor3D
from sperr_tpu_torch.runtime import device_bench as tdb
from sperr_tpu_torch.runtime import profiling as t_prof
from sperr_tpu_torch.utils import stats as t_stats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops per stage: with several pytest workers on one
    machine, torch's thread pools wait on each other, so one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,batch,seed,noise", [(8, 1, 7, 0.001), (12, 3, 7, 0.001),
                                                (16, 2, 5, 0.025)])
def test_smooth_field_equals_jax(n, batch, seed, noise):
    np.testing.assert_array_equal(tdb._smooth_field(n, batch, seed, noise),
                                  jdb._smooth_field(n, batch, seed, noise))


def _pair(seed, n=5000):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n).astype(np.float32)
    return a, (a + rng.normal(scale=1e-3, size=n)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calc_stats_device_equals_jax(seed):
    import jax.numpy as jnp

    a, b = _pair(seed)
    ours = t_stats.calc_stats_device(torch.from_numpy(a), torch.from_numpy(b))
    ref = j_stats.calc_stats_device(jnp.asarray(a), jnp.asarray(b))
    for x, y in zip(ours, ref):
        assert x.dim() == 0 and x.dtype == torch.float32
        np.testing.assert_allclose(x.item(), float(y), rtol=1e-6)
    assert t_stats.calc_stats(a, b) == j_stats.calc_stats(a, b)


def test_profiling_equals_jax(monkeypatch):
    ticks = iter(range(100))
    clock = types.SimpleNamespace(perf_counter=lambda: 0.25 * next(ticks))
    for mod in (j_prof, t_prof):
        monkeypatch.setattr(mod, "time", clock)
    reports = []
    for mod in (j_prof, t_prof):
        mod.reset()
        with mod.trace("off"):
            pass
        mod.enable()
        try:
            for stage in ("encode/dense", "encode/dense", "decode"):
                with mod.trace(stage):
                    pass
            with pytest.raises(ValueError), mod.trace("raises"):
                raise ValueError
        finally:
            mod.enable(False)
        reports.append(mod.report())
        mod.reset()
        assert mod.report() == {}
    assert reports[0] == reports[1]
    assert reports[1] == {"encode/dense": {"calls": 2, "total_s": 0.5}, "decode": {"calls": 1, "total_s": 0.25},
                          "raises": {"calls": 1, "total_s": 0.25}}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.device_trace(str(tmp_path)):
        torch.ones(64).sum()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        assert '"traceEvents"' in f.read()


# (name, kwargs) at a tiny size
_CASES = {
    "pipeline_stages": dict(n=16),
    "container_decode_stages": dict(n=16, chunks=2),
    "wave_entropy_breakdown": dict(n=16),
    "wave2d_stage": dict(nx=64, ny=64, batch=2),
    "wave_entropy_stage": dict(n=16),
}


def _jax_result(monkeypatch, name):
    monkeypatch.setattr(jdb, "time_stage", lambda fn, x, iters=8, reps=2, max_iters=128: 1.0)
    monkeypatch.setattr(jdb, "time_stage_coarse", lambda fn, x, reps=3: 1.0)
    return getattr(jdb, name)(**_CASES[name])


@pytest.mark.parametrize("name", sorted(_CASES))
def test_device_bench_keys_and_times(name, monkeypatch):
    ours = getattr(tdb, name)(device="cpu", **_CASES[name])
    ref = _jax_result(monkeypatch, name)
    want = set(ref)
    extra = {"device", "timed"} | {"wave_entropy_stage": {"tier"}, "wave_entropy_breakdown": {"dims"},
                                   "wave2d_stage": {"program"}}.get(name, set())
    assert set(ours) == want | extra
    assert ours["device"] == "cpu"
    if name in ("container_decode_stages", "wave_entropy_stage"):
        # stages compared: one method for all (the breakdown names one per
        # substage, the method of the two chains its delta subtracts)
        assert ours["timed"] == "cpu"
    else:
        assert ours["timed"] and set(ours["timed"].values()) == {"cpu"}
    if name == "wave_entropy_breakdown":
        assert set(ours["timed"]) == {"quantize", "schedule", "lis_items", "full_pack", "ref_words_abs"}
    absolute = [k for k in ours if k.endswith("_s") and not (
        name == "wave_entropy_breakdown" and not k.endswith(("_cum_s", "abs_s")))]
    absolute = [k for k in absolute if k != "entropy_stage_s"]
    assert absolute and all(ours[k] > 0 for k in absolute), {k: ours[k] for k in absolute}
    if name == "pipeline_stages":
        assert ours["quantize_kernel"] == "torch"
    if name == "container_decode_stages":
        assert ours["stream_bytes"] == ref["stream_bytes"]
        assert set(ours["hybrid"]) == set(ref["hybrid"])
        assert all(v > 0 for v in ours["hybrid"].values())
        assert ours["decode_total_s"] == min(ours["parse_s"] + ours["decode_core_s"],
                                             ours["hybrid"]["decode_total_s"])
    if name == "wave_entropy_stage":
        assert ours["regime"] == ref["regime"] == "smooth(tier 0)" and ours["fits"]
    if name == "wave2d_stage":
        prog = ours["program"]
        assert set(prog["timed"]) == {"schedule", "pixels", "walk", "lis_pack"}
        assert set(prog["timed"].values()) == {"cpu"} and prog["total_ms"] > 0


@pytest.mark.parametrize("n,regime", [(32, "smooth"), (32, "dense"), (16, "noisy")])
def test_wave_entropy_stage_lands_where_the_compressor_does(n, regime):
    r = tdb.wave_entropy_stage(n, regime=regime, iters=1, device="cpu")
    if regime == "noisy":
        vol = np.random.default_rng(11).normal(size=(n, n, n)).astype(np.float32)
    else:
        vol = tdb._smooth_field(n, noise=2.5e-2 if regime == "dense" else 0.001)[0]
    comp = TorchCompressor3D((n, n, n), (n, n, n), device="cpu", entropy="wave")
    comp.compress(vol, "pwe", 1e-2)
    assert comp.last_wave_tiers == [r["tier"]] and r["fits"]
    assert r["regime"] == f"{regime}(tier {r['tier']})"


def test_timers_on_the_cpu():
    x = torch.ones(8)
    secs, how = tdb.time_stage(lambda v: v * 2, x, iters=3)
    assert secs > 0 and how == "cpu"
    secs, how = tdb.time_stage_coarse(lambda v: v * 2, x)
    assert secs > 0 and how == "cpu"
    with pytest.raises(ValueError, match="no timer"):
        tdb.time_stage(lambda v: v, torch.ones(8, device="meta"))


@pytest.mark.parametrize("name", sorted(_CASES))
def test_device_bench_raises_without_a_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tdb, name)(**_CASES[name])



def test_time_stage_times_every_run_by_one_method(monkeypatch):
    """Runs of one stage that came out of different methods (the sleep
    covered one and not the other) are timed again by one."""
    asked = []

    def fake_time_ms(fn, calls, how=None):
        asked.append(how)
        if how is None:
            return (1.0, "device") if len(asked) == 1 else (3.0, "device-busy")
        return 2.0, how

    monkeypatch.setattr(tdb, "_on", lambda x: "cuda")
    monkeypatch.setattr(tdb, "time_ms", fake_time_ms)
    assert tdb.time_stage(lambda v: v, torch.ones(1), iters=1, reps=2) == (2e-3, "device-busy")
    assert asked == [None, None, "device-busy", "device-busy"]


@pytest.mark.parametrize("hows,want", [
    (("device", "device"), "device"),
    (("device", "device-busy"), "device-busy"),
    (("device", "host-issued"), "host-issued"),
    (("device-busy", "host-issued"), "host-issued"),
])
def test_compared_stages_share_one_method(hows, want, monkeypatch):
    """Stages whose times are compared or subtracted come out of one method:
    where their own methods differ, every stage is timed again by one."""

    def fake_time_stage(fn, x, iters=8, reps=2, how=None):
        k = fn(x)
        return (k, hows[k - 1]) if how is None else (10 * k, how)

    monkeypatch.setattr(tdb, "time_stage", fake_time_stage)
    secs, how = tdb._time_together({"a": lambda x: 1, "b": lambda x: 2}, torch.ones(1), 1)
    assert how == want
    # a stage already timed by the one method keeps its time
    assert secs == {k: (i if hows[i - 1] == want else 10 * i) for k, i in (("a", 1), ("b", 2))}


def test_time_ms_names_its_methods():
    with pytest.raises(ValueError, match="no timer"):
        tdb.time_ms(lambda: None, 1, how="wall")


@pytest.mark.parametrize("empty,ok", [(1, True), (2, True), (3, False)])
def test_busy_ms_takes_a_lost_trace_again(empty, ok, monkeypatch):
    """A profiler trace that holds no device time is taken again, twice at
    most; the third empty trace raises."""
    import contextlib
    import types

    import torch.profiler

    traces = []

    @contextlib.contextmanager
    def fake_profile(activities):
        k = len(traces)
        traces.append(k)
        ev = types.SimpleNamespace(key="k", self_device_time_total=0 if k < empty else 2000.0)
        yield types.SimpleNamespace(key_averages=lambda: [ev])

    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    if ok:
        assert tdb.busy_ms(lambda: calls.append(1), 2) == (1.0, {"k": 1.0})
        assert len(traces) == empty + 1
    else:
        with pytest.raises(RuntimeError, match="no device time, three times"):
            tdb.busy_ms(lambda: calls.append(1), 2)
        assert len(traces) == 3
    assert len(calls) == 1 + 2 * len(traces)
