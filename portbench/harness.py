"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, one cell or one metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json    sizes, entry-point settings, guarantee, generator
  workloads/<cell>.json    the traffic: op(s), mode, quality, fields, batch, limits
  metrics/<metric>.py      ``read(run) -> float | None`` (None: nothing to read);
                           a name ``<base>.<split>`` without a file of its own
                           is read by ``metrics/<base>.py``

The harness calls only sperr_tpu_torch's public entry points and reads its
counters; the reference it checks against (``reference/``) imports nothing
of the program.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, fields, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "sperr_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    root: str
    spec: dict = field(init=False)

    def __post_init__(self):
        self.spec = load_json(os.path.join(self.root, "BENCHMARK.json"))

    @property
    def folder(self) -> str:
        return os.path.join(self.root, "portbench")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.folder, "workloads", f"{name}.json"))

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, per_layer: bool) -> List[dict]:
        """The metrics this cell reports: an end-to-end metric where its
        ``workloads`` (if any) name the cell; a per-layer metric where its
        ``workloads`` name it, or, without the key, where the cell reports the
        end-to-end metric it moves."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if not per_layer:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names else [])]

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``, or, where a split name
        (``device_idle.encode``) has no file of its own, of the file of the
        name before its first dot."""
        path = os.path.join(self.folder, "metrics", f"{metric}.py")
        if not os.path.exists(path) and "." in metric:
            path = os.path.join(self.folder, "metrics", f"{metric.split('.')[0]}.py")
        spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


@dataclass
class Run:
    """What a metric's reader sees of one run."""

    cell: str
    op: str  # the traffic's op: "encode", "decode", or "mixed" for a list
    traffic: dict
    config: dict
    device_kind: str
    ops: tuple = ()  # the ops the window cycles over
    setup_s: float = 0.0
    wall_s: float = 0.0
    latencies: List[float] = field(default_factory=list)
    req_ops: List[str] = field(default_factory=list)  # the op of each completed request
    bytes_in: int = 0  # f32 bytes handed to the completed requests
    bytes_out: int = 0  # f32 bytes the completed requests returned
    counters: Dict[str, list] = field(default_factory=dict)  # per request
    launches: int = 0  # hand-kernel launches over the window
    errors: int = 0  # requests that raised
    trace: Optional[trace.Trace] = None
    peaks: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.ops:
            self.ops = (self.op,)

    @property
    def requests(self) -> int:
        """Requests the window completed."""
        return len(self.latencies)

    def latencies_of(self, op: str) -> List[float]:
        return [t for t, o in zip(self.latencies, self.req_ops) if o == op]

    def total(self, key: str) -> float:
        return float(sum(self.counters.get(key, [])))


class Cell:
    """The entry points of one cell and its requests.

    The traffic's ``op`` is ``encode``, ``decode`` or a list of them that the
    window's requests cycle over (a mixed window); ``mode`` (default ``pwe``)
    and ``quality`` (default ``rel_tol``, the PWE tolerance over the fields'
    value range of 1) are what the compressor is called with.  Request ``i``
    runs ``op_of(i)`` on the fields of group ``(i // len(ops)) % groups``."""

    def __init__(self, traffic: dict, config: dict, device, seed: int, control: bool = False):
        from sperr_tpu_torch import kernels
        from sperr_tpu_torch.parallel import batched, batched2d
        from sperr_tpu_torch.runtime.engine import default_engine

        self.traffic, self.config, self.device = traffic, config, torch.device(device)
        op = traffic["op"]
        self.ops = (op,) if isinstance(op, str) else tuple(op)
        self.op = op if isinstance(op, str) else "mixed"
        if not self.ops or set(self.ops) - {"encode", "decode"}:
            raise ValueError(f"op {op!r}: encode, decode or a list of them")
        self.control = control
        self.batch = int(traffic.get("batch", 1))
        self.mode = traffic.get("mode", "pwe")
        # a PWE tolerance is rel_tol x the fields' value range, which is 1
        self.tol = float(traffic["rel_tol"]) if "rel_tol" in traffic else None
        self.quality = float(traffic["quality"] if "quality" in traffic else traffic["rel_tol"])
        self.dims = tuple(int(d) for d in config["dims"])  # (nx, ny[, nz])
        self.ndim = len(self.dims)
        self.shape = tuple(reversed(self.dims))
        if self.device.type == "cuda":
            kernels.load(self.device)
        default_engine()
        gen = config["fields"]
        nfields = int(traffic["fields"])
        if nfields % self.batch:
            raise ValueError(f"{nfields} fields do not split into batches of {self.batch}")
        self.groups = nfields // self.batch
        self.fields = fields.make_fields(self.shape, nfields, float(gen["slope"]),
                                         float(gen["k_cut"]), seed, self.device)
        # what the program is handed; an encode's control hands it the
        # fields in the precision below the configuration's
        self.inputs = self.fields
        if control and "encode" in self.ops:
            low = getattr(torch, config["control"]["dtype"])
            self.inputs = torch.from_numpy(self.fields).to(low).to(torch.float32).numpy()
        comp_kw = dict(config["compressor"])
        if self.ndim == 3:
            self.comp = batched.TorchCompressor3D(self.dims, tuple(config["chunk_dims"]),
                                                  device=self.device, **comp_kw)
            self.dec = batched.TorchDecompressor3D(device=self.device, **config.get("decompressor", {}))
        else:
            self.comp = batched2d.TorchCompressor2D(self.dims, device=self.device, **comp_kw)
            self.dec = batched2d.TorchDecompressor2D(self.dims, device=self.device)
        self.streams = None
        if "decode" in self.ops:
            self.streams = [self._encode(g) for g in range(self.groups)]
            if "encode" not in self.ops:
                self.comp = None
        for i in range(len(self.ops)):  # the warm-up: each op at the cell's own shape
            self.run_request(i)

    @property
    def nreq_distinct(self) -> int:
        return len(self.ops) * self.groups

    def op_of(self, i: int) -> str:
        return self.ops[i % len(self.ops)]

    def group(self, i: int) -> int:
        return (i // len(self.ops)) % self.groups

    def field_ids(self, i: int) -> range:
        a = self.group(i) * self.batch
        return range(a, a + self.batch)

    def _encode(self, g: int):
        a = g * self.batch
        if self.ndim == 3:
            return self.comp.compress(self.inputs[a], self.mode, self.quality)
        return self.comp.compress_batch(self.inputs[a:a + self.batch], self.mode, self.quality)

    def _decode(self, g: int):
        s = self.streams[g]
        if self.control:
            low = getattr(torch, self.config["control"]["dtype"])
            return check.reference_decode(s, self, low).float().cpu().numpy()
        if self.ndim == 3:
            return self.dec.decompress(s, to_host=True)[0]
        return np.stack(self.dec.decompress_batch(s))

    def run_request(self, i: int):
        """One request -> (answer, input bytes, output bytes, counters)."""
        n = math.prod(self.dims)
        g = self.group(i)
        if self.op_of(i) == "encode":
            out = self._encode(g)
            c = self.comp
            tiers = list(c.last_wave_tiers)
            nbytes = len(out) if self.ndim == 3 else sum(len(x) for x in out)
            counters = {"d2h_bytes": c.last_d2h_bytes, "enc_chunks": len(tiers), "stream_bytes": nbytes,
                        "wave_chunks": c.last_wave_chunks, "uncertified": c.last_uncertified_chunks,
                        "attempts": sum(t + 1 for t in tiers if t is not None)}
            return out, 4 * n * self.batch, 0, counters
        out = self._decode(g)
        counters = {}
        if self.ndim == 3 and not self.control:
            d = self.dec
            counters = {"h2d_bytes": d.last_h2d_bytes, "hybrid_chunks": d.last_hybrid_chunks,
                        "dec_chunks": d.last_hybrid_chunks + sum(d.last_full_parse_chunks.values())}
        return out, 0, 4 * n * self.batch, counters


def _launches() -> int:
    from sperr_tpu_torch import kernels

    return sum(kernels.launches.values())


def window(cell: Cell, run: Run, seconds: float, seed: int, traced: bool):
    """The closed loop: one client, each request sent when the one before it
    returned, cycling over the cell's fields.  Every request started before
    ``seconds`` have passed runs to its end; the window's wall ends with the
    last, and sends at least one request of each op.  Returns the sampled
    answers [(request index, answer)], one for each distinct request the
    window sent."""
    rng = random.Random(seed)
    # one answer of each distinct request (the fields in rotation), drawn
    # from the seed among the window's requests that carry it (reservoirs)
    kept: Dict[int, list] = {}
    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)
    launches0 = _launches()
    prof = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cell.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    with prof, torch.profiler.record_function(trace.WINDOW):
        t0 = time.perf_counter()
        i = 0
        while i < len(cell.ops) or time.perf_counter() - t0 < seconds:
            op = cell.op_of(i)
            with torch.profiler.record_function(f"portbench.{op}"):
                r0 = time.perf_counter()
                try:
                    out, bin_, bout, counters = cell.run_request(i)
                except Exception as e:  # a request that raises fails; the window ends
                    print(f"request {i}: {type(e).__name__}: {e}", file=sys.stderr)
                    run.errors += 1
                    break
                run.latencies.append(time.perf_counter() - r0)
            run.req_ops.append(op)
            run.bytes_in += bin_
            run.bytes_out += bout
            for k, v in counters.items():
                run.counters.setdefault(k, []).append(v)
            slot = kept.setdefault(i % cell.nreq_distinct, [0, None, None])
            slot[0] += 1
            if rng.randrange(slot[0]) == 0:
                slot[1:] = [i, out]
            del out
            i += 1
        sync()
        run.wall_s = time.perf_counter() - t0
    run.launches = _launches() - launches0
    if traced:
        run.trace = trace.read(prof)
    return sorted(((i, out) for _, i, out in kept.values()), key=lambda k: k[0])


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(bench: Bench, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, control: bool = False) -> dict:
    """Set-up, window, check and metrics of one run -> the result line's
    object (its ``checks`` key last)."""
    spec = bench.cell(name)
    traffic = bench.traffic(name)
    config = bench.config(spec["config"])
    cell = Cell(traffic, config, device, seed, control)
    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    run = Run(cell=name, op=cell.op, ops=cell.ops, traffic=traffic, config=config, device_kind=kind,
              setup_s=time.perf_counter() - t_start,
              peaks=load_json(os.path.join(bench.folder, "peaks.json")).get(kind, {}))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kept = window(cell, run, seconds, seed, traced)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the program's state is freed before the check runs
    cell.comp = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = check.compare(cell, kept)
    metrics = {}
    for m in bench.metrics(name, traced):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": int(spec["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": run.errors == 0 and all(c["ok"] for c in checks.values()),
           "attempted": run.requests + run.errors, "failed": failed + run.errors,
           "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = trace.summary(run.trace)
    out["info"] = {"requests": run.requests, "wall_s": run.wall_s}
    if run.bytes_in:
        out["info"]["bpp"] = 8 * run.total("stream_bytes") / (run.bytes_in / 4)
        out["info"]["uncertified_chunks"] = run.total("uncertified")
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return out
