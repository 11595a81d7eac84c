"""Time this checkout's K9 stage, K13, the K15 and K14 walks, the
child-table and pyramid schedules, the 2D emission's planes and K16 beside
the parent commit's, in one process on one card.

    mkdir -p _checkout/parent
    git archive <parent> sperr_tpu_torch | tar -x -C _checkout/parent
    python3 compare_parent.py _checkout/parent

The parent's port is imported from DIR as the package ``sperr_parent`` and
builds its kernels from its own sources into its own build directory, so
both kernels run on the same card, inputs and clocks.  Each pair is first
held equal, output for output, then timed in turns (parent, new, new,
parent) on the device alone and as the host issues the calls, by
sperr_tpu_torch.runtime.device_bench's timer, and each kernel's launches
are timed by torch.profiler:

- K9 on headline chunk 0 (the first 256^3 chunk of smooth_field_3d(512,
  seed=7), as in chip_smoke.py phase 3) at tiers 0 and 1: each package's
  ``wave_pack.emit_cube`` (the parent of this checkout has K9's two-launch
  form too);
- K7 (``ops.speck_virtual.dense_anchor_ranks``) on that chunk's node
  passes, whose bitmap levels share kernels/rank.cuh with the table walks;
- K13 (``kernels.reconstruct_mags``) on that chunk's control parse, (1,
  256^3), and on the 8 chunks' control parses, (8, 256^3), as the 512^3
  decode batches them;
- the K15 walk (``ops.speck_lis._table_items_cuda`` on the table index) on
  the Hurricane ISABEL packet chunk (100, 256, 256) cut from that volume, at
  the node caps of tiers 0 and 1, and the K14 walk (the 2D index) on one
  1024^2 Turbulence1024-like field (``chip_smoke._turbulence_like``, seed
  0), each index built by its own package;
- the child-table schedule (``ops.speck.schedule_table``, each package's
  index) on that packet chunk as the 3D route calls it, and on that 1024^2
  field and a 1800 x 3600 one (seed 16) as the 2D route calls it, with the
  I-set passes; compared on num_bp, s, e, nm (and iset_s);
- one 1024^2 field's whole 2D device program at tier 0 (each package's
  ``parallel.batched2d._wave_emit_field`` on its own index and caps, as
  the wave encode runs it), device-busy and host-issued, compared on
  every output;
- that program's emission planes: the calls each package's program makes
  (the parent's ``wave_pack.emit_planes`` where it has one: three
  launches, one a class; the new ``wave_pack.emit_fields``, two: the
  pixel half, then the LIS half), compared plane for plane;
- K16, the PSNR search, on the inputs each front gives it at PSNR 80
  (each package's ``ops.quantize.estimate_q_psnr_batched``): phase 5's
  256^3 chunk, the headline volume's 8 chunks, phase 7's 16 x 1024^2
  fields and phase 8's 1800 x 3600 field, q compared row by row (a moved
  row printed with its MSE under the f32 and the f64 sum), host-issued
  and device-busy, and per launch; then phase 5's and phase 8's PSNR
  streams from each package's compressor, byte for byte;
- the pyramid schedule (``ops.speck.schedule_pyramid``) on the dyadic
  (97, 128, 118) chunk and SDRBench S3D 500^3's (244, 244, 244) edge chunk.

The card's name and power limit end every line of times.  Exits non-zero
without a CUDA device or when a pair differs.
"""

from __future__ import annotations

import importlib
import importlib.util
import itertools
import os
import sys
import time


def _load_parent(parent_dir: str):
    """The parent's kernels, ops (wave_pack, wave_unpack, speck_lis,
    speck_lis2, speck_virtual, speck, quantize), parallel.batched2d and
    parallel.batched modules,
    imported from parent_dir as the package ``sperr_parent``, its kernels
    built."""
    root = os.path.join(os.path.abspath(parent_dir), "sperr_tpu_torch")
    if not os.path.isfile(os.path.join(root, "kernels", "emit.cu")):
        raise SystemExit(f"compare_parent: no port under {parent_dir}")
    spec = importlib.util.spec_from_file_location("sperr_parent", os.path.join(root, "__init__.py"),
                                                  submodule_search_locations=[root])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["sperr_parent"] = mod
    spec.loader.exec_module(mod)
    mods = [importlib.import_module(f"sperr_parent.{m}")
            for m in ("kernels", "ops.wave_pack", "ops.wave_unpack", "ops.speck_lis", "ops.speck_lis2",
                      "ops.speck_virtual", "ops.speck", "parallel.batched2d", "ops.quantize", "parallel.batched")]
    t0 = time.perf_counter()
    mods[0].build()
    print(f"[parent] the parent's kernels built from {parent_dir} in {time.perf_counter() - t0:.1f} s")
    return mods


def _turns(fns, how: str, calls: int = 20):
    """Each of fns (label -> fn) timed in turns, a, b, b, a: {label: [ms, ms]}."""
    from sperr_tpu_torch.runtime.device_bench import time_ms

    labels = list(fns)
    out = {k: [] for k in labels}
    for k in labels + labels[::-1]:
        out[k].append(time_ms(fns[k], calls, how)[0])
    return out


def _compare(cs, label: str, fns, smi: str, dev_how: str = "device", calls: int = 20) -> None:
    """fns: {"parent": fn, "new": fn}, equal outputs; their turns (``calls``
    calls a time) and each one's launches (device ms per launch over 20
    calls).  ``dev_how``: the device-side method ("device-busy" for calls of
    more launches than the timer's sleep kernel covers, the walks)."""
    import torch

    a, b = (cs._flat(f()) for f in fns.values())
    cs._check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
              f"the parent's {label} differs from the new one")
    dev_t, host_t = _turns(fns, dev_how, calls), _turns(fns, "host-issued", calls)
    per = {k: cs._kernel_means(f, "", 20) for k, f in fns.items()}
    print(f"[compare] {label}: equal; {dev_how} ms (parent, new, new, parent) {dev_t['parent'][0]:.4f}, "
          f"{dev_t['new'][0]:.4f}, {dev_t['new'][1]:.4f}, {dev_t['parent'][1]:.4f}; host-issued "
          f"{host_t['parent'][0]:.4f}, {host_t['new'][0]:.4f}, {host_t['new'][1]:.4f}, {host_t['parent'][1]:.4f}; "
          + "; ".join(f"{k} per launch " + ", ".join(f"{cs._kernel_name(n)} {m:.4f}" for n, (m, _) in p.items())
                      for k, p in per.items())
          + f" -- {smi}")


def _psnr(cs, pq, pb, pb2, vol, smi: str) -> None:
    """K16 against the parent's PSNR search, as each package's front calls
    it at PSNR 80: phase 5's 256^3 chunk, the headline volume's 8 chunks,
    phase 7's 16 x 1024^2 fields and phase 8's 1800 x 3600 field.  Each
    row's q compared; a row whose q moved is printed with its MSE under
    both sums against t_mse.  Then the pair held equal and timed in turns
    (``_compare``: device-busy, as the call waits for its status words,
    host-issued, and per launch).  Then phase 5's and phase 8's PSNR
    streams from each package's compressor, compared byte for byte."""
    import numpy as np
    import torch

    from sperr_tpu_torch import kernels
    from sperr_tpu_torch.ops import cdf97, quantize
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.parallel.batched2d import TorchCompressor2D
    from sperr_tpu_torch.utils.testdata import smooth_field_3d

    dev = torch.device("cuda", 0)
    vol11 = smooth_field_3d(256, seed=11)
    f8 = cs._turbulence_like(1800, 3600, 16)
    inputs = (
        ("phase 5's 256^3 chunk", lambda: torch.from_numpy(vol11[None]).to(dev), cdf97.dwt3d, cdf97.idwt3d_),
        ("the headline volume's 8 chunks", lambda: torch.from_numpy(np.stack(
            [vol[z:z + 256, y:y + 256, x:x + 256] for z in (0, 256) for y in (0, 256) for x in (0, 256)])).to(dev),
         cdf97.dwt3d, cdf97.idwt3d_),
        ("phase 7's 16 x 1024^2 fields", lambda: torch.from_numpy(np.stack(
            [cs._turbulence_like(1024, 1024, seed) for seed in range(16)])).to(dev), cdf97.dwt2d, cdf97.idwt2d),
        ("phase 8's 1800 x 3600 field", lambda: torch.from_numpy(f8[None]).to(dev), cdf97.dwt2d, cdf97.idwt2d),
    )
    for label, make, fwd, inv in inputs:
        with cs._capture(quantize, ["estimate_q_psnr_batched"]) as calls:
            tb._dense_encode_rows(make(), "psnr", 80.0, "none", fwd, inv)
        ((c, rng, _),) = calls["estimate_q_psnr_batched"]
        fns = {"parent": lambda c=c, rng=rng: pq.estimate_q_psnr_batched(c, rng, 80.0),
               "new": lambda c=c, rng=rng: quantize.estimate_q_psnr_batched(c, rng, 80.0)}
        q_old, q_new = fns["parent"](), fns["new"]()
        moved = torch.nonzero(q_old != q_new).reshape(-1).tolist()
        t_mse, _ = quantize.psnr_start(rng, 80.0)
        for b in moved:
            for who, q in (("parent", q_old), ("new", q_new)):
                d = c[b] - q[b] * torch.round(c[b] * (1.0 / q[b]))
                print(f"[compare] K16 {label}: row {b} MOVED; at the {who}'s q {float(q[b])!r}: f32 mean "
                      f"{float(torch.mean(d * d))!r}, f64 mean {float(d.double().square().mean())!r}, t_mse "
                      f"{float(t_mse[b])!r}")
        print(f"[compare] K16 {label} ({c.shape[0]} x {c.shape[1]}): q of {c.shape[0] - len(moved)} of "
              f"{c.shape[0]} rows equal ({q_new.tolist()[:16]})")
        _compare(cs, f"K16 {label} ({c.shape[0]} x {c.shape[1]}, PSNR 80)", fns, smi, "device-busy", 10)
        del c, rng, calls
    # the PSNR streams of phases 5 and 8, each package's compressor
    for label, old_c, new_c, data in (
            ("phase 5: 256^3 PSNR 80", pb.TorchCompressor3D((256,) * 3, (256,) * 3, device="cuda", transfer="dense"),
             tb.TorchCompressor3D((256,) * 3, (256,) * 3, device="cuda", transfer="dense"), vol11),
            ("phase 8: 1800 x 3600 PSNR 80", pb2.TorchCompressor2D((3600, 1800), device="cuda"),
             TorchCompressor2D((3600, 1800), device="cuda"), f8)):
        a, b = bytes(old_c.compress(data, "psnr", 80.0)), bytes(new_c.compress(data, "psnr", 80.0))
        print(f"[compare] {label}: parent {len(a)} bytes, new {len(b)} bytes, "
              + ("equal byte for byte" if a == b else "DIFFERENT") + f" -- {smi}")
    kernels.reset_launch_counts()


def _pyramid(cs, pspk, vol, smi: str) -> None:
    """sched_pyramid against the parent's on the dyadic (97, 128, 118) chunk
    and SDRBench S3D 500^3's edge chunk (244, 244, 244), PWE 1e-2 fronts of
    the smooth fields.  The parent's index is given the new index's host
    tables and plan (the same fields in both packages: the same deep
    slots, node and parent boxes), which saves its host build (tens of
    seconds at 244^3)."""
    import numpy as np
    import torch

    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.ops import speck as spk
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.utils.testdata import smooth_field_3d

    dev = torch.device("cuda", 0)
    vol11 = smooth_field_3d(256, seed=11)
    for dims, field in (((97, 128, 118), vol11[:118, :128, :97]), ((244, 244, 244), vol[:244, :244, :244])):
        x = torch.from_numpy(np.ascontiguousarray(field)[None]).to(dev)
        m = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", cdf97.dwt3d, cdf97.idwt3d_)["mags"][0]
        m = m.reshape(-1).contiguous()
        t0 = time.perf_counter()
        pi = spk.pyramid_index(dims, dev)
        build = time.perf_counter() - t0
        ppi = object.__new__(pspk.PyramidIndex)
        for k in pspk.PyramidIndex.__slots__:
            setattr(ppi, k, getattr(pi, k))
        _compare(cs, f"sched_pyramid {dims} (index {build:.3f} s on the host; two launches each)",
                 {"parent": lambda m=m, ppi=ppi: pspk.schedule_pyramid(m, ppi),
                  "new": lambda m=m, pi=pi: spk.schedule_pyramid(m, pi)}, smi, calls=20)
        del x, m, pi, ppi


def main(argv) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_parent: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    import numpy as np

    from sperr_tpu_torch import kernels
    from sperr_tpu_torch.ops import cdf97, wave_pack
    from sperr_tpu_torch.ops import speck_virtual as sv
    from sperr_tpu_torch.parallel import batched as tb
    from sperr_tpu_torch.runtime import device_bench
    from sperr_tpu_torch.runtime.engine import default_engine
    from sperr_tpu_torch.utils.testdata import smooth_field_3d

    smi = cs._smi()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    dev = torch.device("cuda", 0)
    kernels.load()
    pk, pwp, _, psl, psl2, psv, pspk, pb2, pq, pb = _load_parent(argv[0])
    vol = smooth_field_3d(512, seed=7)
    d256 = (256, 256, 256)
    n = 256**3

    # K9: the emission's emit_cube calls at tiers 0 and 1 of headline chunk 0
    x = torch.from_numpy(np.ascontiguousarray(vol[:256, :256, :256])[None]).to(dev)
    f = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", cdf97.dwt3d, cdf97.idwt3d_, out_cap=max(1024, n // 1024))
    mags, signs = f["mags"][0].reshape(-1).contiguous(), f["signs"][0].reshape(-1).contiguous()
    li = sv.virtual_lis_index(d256, dev)
    tiers = tb.wave_tiers_for(n)
    for t in (0, 1):
        with cs._capture(wave_pack, ["emit_cube"]) as calls:
            tb._wave_emit_chunk(mags, signs, li, tb._wave_caps(li, d256, tiers[t], 34))
        (a9,) = calls["emit_cube"]
        _compare(cs, f"K9 stage, headline chunk 0 tier {t} (P {a9[-1]}, wexp_cap {a9[5]})",
                 {"parent": lambda a9=a9: pwp.emit_cube(*a9), "new": lambda a9=a9: wave_pack.emit_cube(*a9)}, smi)
    # K7 on the same chunk: its bitmap levels share kernels/rank.cuh with the table walks
    nb, _, _, nm = sv.schedule_virtual(mags, li)
    ns = torch.where(nm > 0, nb - nm, 0x7FFF).to(torch.int32)
    pvf = psv.virtual_lis_index(d256, dev)
    _compare(cs, "K7 anchor_ranks, headline chunk 0", {
        "parent": lambda: psv.dense_anchor_ranks(ns, pvf), "new": lambda: sv.dense_anchor_ranks(ns, li)}, smi)
    del x, f, mags, signs, calls, a9, ns, nm

    # K13: the control parses of chunk 0, and of the 8 chunks as the decode batches them
    engine = default_engine()
    bodies = []
    for z, y, x0 in itertools.product((0, 256), repeat=3):
        c = torch.from_numpy(np.ascontiguousarray(vol[z:z + 256, y:y + 256, x0:x0 + 256])[None]).to(dev)
        d = tb._dense_encode(c, "pwe", 1e-2, "dual")
        bodies.append(engine.encode(3, d["mags"][0].cpu().numpy(), d["signs"][0].cpu().numpy(), d256,
                                    tb._width_for(int(d["maxmag"][0])), 0))
    evw = tb._evw_cap(n)
    for label, parts in (("(1, 256^3)", bodies[:1]), ("(8, 256^3)", bodies)):
        args, _, p = device_bench._control_inputs(engine, parts, d256, dev)
        sp = args[0].to(torch.uint8).contiguous()
        _compare(cs, f"K13 {label}", {
            "parent": lambda sp=sp, args=args, p=p: pk.reconstruct_mags(sp, *args[1:], p, evw),
            "new": lambda sp=sp, args=args, p=p: kernels.reconstruct_mags(sp, *args[1:], p, evw),
        }, smi)
        del args, sp

    # K15: the table walk on the Hurricane packet chunk at tiers 0 and 1; K14: the 2D walk on a 1024^2 field
    from sperr_tpu_torch.codec.speck_wave import build_tree2
    from sperr_tpu_torch.ops import speck as spk
    from sperr_tpu_torch.ops import speck_lis as sl
    from sperr_tpu_torch.ops import speck_lis2 as sl2

    dims_h = (256, 256, 100)
    x = torch.from_numpy(np.ascontiguousarray(vol[:100, :256, :256])[None]).to(dev)
    f = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", cdf97.dwt3d, cdf97.idwt3d_)
    m, sg = f["mags"][0].reshape(-1).contiguous(), f["signs"][0].reshape(-1).contiguous()
    li, si = tb._wave_index(dims_h, dev)
    pli = psl.lis_index(dims_h, dev)
    # the child-table schedule as the 3D route calls it
    psi = pspk.tree_index(dims_h, dev)
    _compare(cs, f"sched_table, Hurricane packet chunk (100, 256, 256) (cuts {si.plan.cuts})", {
        "parent": lambda: pspk.schedule_table(m, psi),
        "new": lambda: spk.schedule_table(m, si),
    }, smi, calls=10)
    del psi
    nb, s, _, nm = tb._schedule(m, si)
    ns = spk.node_passes(nm, nb)
    tiers = tb.wave_tiers_for(256 * 256 * 100)
    for t in (0, 1):
        cap = tb._wave_caps(li, dims_h, tiers[t], 34)["node_cap"]
        _compare(cs, f"K15 walk, Hurricane packet chunk (100, 256, 256) tier {t} (node cap {cap})", {
            "parent": lambda cap=cap: psl._table_items_cuda(ns, s, sg, pli, cap),
            "new": lambda cap=cap: sl._table_items_cuda(ns, s, sg, li, cap),
        }, smi, "device-busy")
    del x, f, m, sg, s, ns
    nx = ny = 1024
    x = torch.from_numpy(cs._turbulence_like(ny, nx, 0)[None]).to(dev)
    f = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", cdf97.dwt2d, cdf97.idwt2d)
    m, sg = f["mags"][0].reshape(-1).contiguous(), f["signs"][0].reshape(-1).contiguous()
    tree = build_tree2((nx, ny))
    nb, s, _, nm, iset = spk.schedule_table(m, spk.tree_index((nx, ny), dev),
                                            iset_regions=tree.iset_regions[: tree.xf + 1])
    ns = spk.node_passes(nm, nb)
    li2, pli2 = sl2.lis2_index((nx, ny), dev), psl2.lis2_index((nx, ny), dev)
    _compare(cs, "K14 walk, 1024^2 field", {
        "parent": lambda: psl._table_items_cuda(ns, s, sg, pli2, pli2.nn, iset, nb),
        "new": lambda: sl._table_items_cuda(ns, s, sg, li2, li2.nn, iset, nb),
    }, smi, "device-busy")

    # the child-table schedule as the 2D route calls it, with the I-set passes
    for label, (fy, fx, seed), mm in (("1024^2 field", (ny, nx, 0), m), ("1800x3600 field", (1800, 3600, 16), None)):
        if mm is None:
            x = torch.from_numpy(cs._turbulence_like(fy, fx, seed)[None]).to(dev)
            mm = tb._dense_encode_rows(x, "pwe", 1e-2, "dual", cdf97.dwt2d, cdf97.idwt2d)["mags"][0]
            mm = mm.reshape(-1).contiguous()
        tree = build_tree2((fx, fy))
        ti, pti = spk.tree_index((fx, fy), dev), pspk.tree_index((fx, fy), dev)
        regions = tree.iset_regions[: tree.xf + 1]

        def parent(mm=mm, pti=pti, regions=regions):
            return pspk.schedule_table(mm, pti, iset_regions=regions)

        def new(mm=mm, ti=ti, regions=regions):
            return spk.schedule_table(mm, ti, iset_regions=regions)

        _compare(cs, f"sched_table with the I-set passes, {label} (cuts {ti.plan.cuts})",
                 {"parent": parent, "new": new}, smi, calls=10)
    # one 1024^2 field's whole 2D program at tier 0, each package's on its own index and caps
    from sperr_tpu_torch.parallel import batched2d as tb2

    comp = tb2.TorchCompressor2D((nx, ny), device=dev, entropy="wave")
    ev_cap = max(4096, int(comp.wave_event_tiers[0] * nx * ny))
    progs = {}
    for key, mod in (("parent", pb2), ("new", tb2)):
        index = mod._wave_index2((nx, ny), dev)
        caps = mod._wave_caps2(nx * ny, comp.num_bp_cap, index[1].nn, ev_cap)
        progs[key] = (lambda mod=mod, index=index, caps=caps: (
            lambda r: [r[k] for k in sorted(r)])(mod._wave_emit_field(m, sg, index, caps, comp.num_bp_cap)))
    _compare(cs, "2D field program (_wave_emit_field), 1024^2 field, tier 0", progs, smi, "device-busy")
    # its emission planes: each package's planes calls, as its program makes them
    calls = {}
    for key, mod, wp, names in (("parent", pb2, pwp, ["emit_planes", "emit_fields"]),
                                ("new", tb2, wave_pack, ["emit_fields"])):
        index = mod._wave_index2((nx, ny), dev)
        caps = mod._wave_caps2(nx * ny, comp.num_bp_cap, index[1].nn, ev_cap)
        with cs._capture(wp, [nm for nm in names if hasattr(wp, nm)]) as got:
            mod._wave_emit_field(m, sg, index, caps, comp.num_bp_cap)
        calls[key] = {k: v for k, v in got.items() if v}
    pcalls, ncalls = calls["parent"], calls["new"]
    cs._check(list(ncalls) == ["emit_fields"] and len(ncalls["emit_fields"]) == 2,
              f"the new 2D program's planes calls: { {k: len(v) for k, v in ncalls.items()} }")

    def parent_planes():
        if "emit_planes" in pcalls:  # one launch a class: LIP, REF, then LIS
            return [pwp.emit_planes(*a) for a in pcalls["emit_planes"]]
        px, lis = (pwp.emit_fields(*a) for a in pcalls["emit_fields"])
        return [px[0], px[2], lis[1]]

    def new_planes():
        px, lis = (wave_pack.emit_fields(*a) for a in ncalls["emit_fields"])
        return [px[0], px[2], lis[1]]

    _compare(cs, "2D emission planes, 1024^2 field, tier 0 (the parent's "
             + ", ".join(f"{len(v)} {k}" for k, v in pcalls.items()) + "; new: 2 emit_fields, pixel half then "
             "LIS half; outputs LIP, REF, LIS)", {"parent": parent_planes, "new": new_planes}, smi)
    del comp, progs, m, sg, calls, pcalls, ncalls

    _psnr(cs, pq, pb, pb2, vol, smi)
    _pyramid(cs, pspk, vol, smi)
    print(f"[compare] done -- {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
