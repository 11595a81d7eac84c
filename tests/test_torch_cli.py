"""The port's command-line tools (sperr_tpu_torch.cli) against sperr_tpu's.

With ``--exec host`` (the exact f64 engine) the port's tools write the JAX
tools' bytes and files and print their lines; ``--exec cpu`` runs the
port's device pipeline on the CPU (the kernels' plain versions), whose
streams the JAX tools decode within the bound and whose decodes agree with
the JAX tools' ``--exec tpu`` decodes within ROADMAP rule (b).  ``--exec
cuda`` is the default and raises without a GPU.  Sizes are those of
tests/test_cli_capi.py and tests/test_aux_tools.py."""

import os

import numpy as np
import pytest
import torch

from sperr_tpu.cli import raw_tools as j_raw
from sperr_tpu.cli import show_version as j_version
from sperr_tpu.cli import sperr2d as j2
from sperr_tpu.cli import sperr3d as j3
from sperr_tpu.cli import sperr3d_trunc as j_trunc
from sperr_tpu_torch.cli import raw_tools as t_raw
from sperr_tpu_torch.cli import show_version as t_version
from sperr_tpu_torch.cli import sperr2d as t2
from sperr_tpu_torch.cli import sperr3d as t3
from sperr_tpu_torch.cli import sperr3d_trunc as t_trunc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops per call: with several pytest workers on one
    machine, torch's thread pools wait on each other, so one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vol3(nx=40, ny=30, nz=20, seed=11):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    f = np.sin(x * 0.3) * np.cos(y * 0.2) * np.sin(z * 0.15) + 0.01 * rng.normal(size=(nz, ny, nx))
    return f.astype(np.float32)


def _field2d(nx=64, ny=48, seed=4):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx]
    return (np.sin(x * 0.2) * np.cos(y * 0.13) + 0.03 * rng.normal(size=(ny, nx))).astype(np.float32)


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _write(tmp_path, name, arr):
    p = tmp_path / name
    arr.tofile(p)
    return str(p)


_MODES3 = {"pwe": ["--pwe", "0.01"], "psnr": ["--psnr", "60"], "rate": ["--bpp", "2.0"],
           "dq": ["--dq", "0.01"]}


@pytest.mark.parametrize("mode", sorted(_MODES3))
def test_3d_host_streams_equal_jax(mode, tmp_path, capsys):
    vol = _vol3()
    inp = _write(tmp_path, "in.f32", vol)
    args = ["-c", inp, "--dims", "40", "30", "20", "--chunks", "16", "16", "16", *_MODES3[mode],
            "--print_stats"]
    outs = {}
    for name, tool, extra in (("jax", j3, []), ("port", t3, ["--exec", "host"])):
        bs, df, dd = (str(tmp_path / f"{name}.{e}") for e in ("sperr", "f32", "f64"))
        assert tool.run(args + extra + ["--bitstream", bs]) == 0
        printed = capsys.readouterr().out
        assert tool.run(["-d", bs, "--decomp_f", df, "--decomp_d", dd] + extra) == 0
        outs[name] = (_read(bs), _read(df), _read(dd), printed)
    assert outs["port"] == outs["jax"]
    assert "PSNR" in outs["port"][3] and "Bitrate" in outs["port"][3]


_MODES2 = {"pwe": ["--pwe", "0.01"], "psnr": ["--psnr", "60"], "rate": ["--bpp", "2.0"]}


@pytest.mark.parametrize("mode", sorted(_MODES2))
def test_2d_host_streams_equal_jax(mode, tmp_path, capsys):
    inp = _write(tmp_path, "in.f32", _field2d())
    args = ["-c", inp, "--dims", "64", "48", *_MODES2[mode], "--print_stats"]
    outs = {}
    for name, tool, extra in (("jax", j2, []), ("port", t2, ["--exec", "host"])):
        bs, df, dd = (str(tmp_path / f"{name}.{e}") for e in ("sperr", "f32", "f64"))
        assert tool.run(args + extra + ["--bitstream", bs]) == 0
        printed = capsys.readouterr().out
        assert tool.run(["-d", bs, "--decomp_f", df, "--decomp_d", dd] + extra) == 0
        outs[name] = (_read(bs), _read(df), _read(dd), printed)
    assert outs["port"] == outs["jax"]


def test_3d_host_precision_32_equals_jax(tmp_path):
    inp = _write(tmp_path, "in.f32", _vol3())
    args = ["-c", inp, "--dims", "40", "30", "20", "--chunks", "16", "16", "16", "--pwe", "0.01",
            "--precision", "32"]
    assert j3.run(args + ["--bitstream", str(tmp_path / "j.sperr")]) == 0
    assert t3.run(args + ["--exec", "host", "--bitstream", str(tmp_path / "t.sperr")]) == 0
    assert _read(tmp_path / "t.sperr") == _read(tmp_path / "j.sperr")
    for name, tool, extra in (("j", j3, []), ("t", t3, ["--exec", "host"])):
        assert tool.run(["-d", str(tmp_path / f"{name}.sperr"), "--precision", "32",
                         "--decomp_f", str(tmp_path / f"{name}.f32")] + extra) == 0
    assert _read(tmp_path / "t.f32") == _read(tmp_path / "j.f32")


def test_3d_cpu_stream_decodes_with_the_jax_tool(tmp_path, capsys):
    vol = _vol3()
    inp = _write(tmp_path, "in.f32", vol)
    bs = str(tmp_path / "v.sperr")
    assert t3.run(["-c", inp, "--exec", "cpu", "--dims", "40", "30", "20", "--chunks", "16", "16",
                   "16", "--pwe", "0.01", "--bitstream", bs, "--print_stats"]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "CPU engine: device-entropy chunks = 0"
    assert printed[1] == "PWE bound certified for both f64 and f32 device decoders (all chunks)"
    assert printed[2].startswith("Input range") and printed[3].startswith("Bitrate")
    for name, tool, extra in (("jax", j3, []), ("port", t3, ["--exec", "cpu"])):
        df = str(tmp_path / f"{name}.f32")
        assert tool.run(["-d", bs, "--decomp_f", df] + extra) == 0
        assert np.abs(np.fromfile(df, np.float32) - vol.ravel()).max() <= 0.01


def test_2d_cpu_stream_decodes_with_the_jax_tool(tmp_path):
    field = _field2d()
    inp = _write(tmp_path, "in.f32", field)
    bs = str(tmp_path / "f.sperr")
    assert t2.run(["-c", inp, "--exec", "cpu", "--dims", "64", "48", "--pwe", "0.01",
                   "--bitstream", bs]) == 0
    for name, tool, extra in (("jax", j2, []), ("port", t2, ["--exec", "cpu"])):
        df = str(tmp_path / f"{name}.f32")
        assert tool.run(["-d", bs, "--decomp_f", df] + extra) == 0
        assert np.abs(np.fromfile(df, np.float32) - field.ravel()).max() <= 0.01


def test_cpu_decodes_agree_with_the_jax_tpu_tool(tmp_path):
    """Rule (b): the port's --exec cpu and the JAX tool's --exec tpu run the
    same f32 pipeline.  On a 1/16 grid every partial sum of the mean is
    exact in f32, so both see the same conditioned data; the transforms may
    still differ by an ulp (XLA contracts into FMAs), which flips values at
    a rounding tie, so the decodes are compared, not the bytes."""
    rng = np.random.default_rng(8)
    z, y, x = np.mgrid[0:32, 0:32, 0:32]
    vol = np.sin(x * 0.3) * np.cos(y * 0.2 + z * 0.1) + 0.05 * rng.normal(size=(32, 32, 32))
    vol = (np.round(vol * 16) / 16).astype(np.float32)
    inp = _write(tmp_path, "in.f32", vol)
    args = ["-c", inp, "--dims", "32", "32", "32", "--chunks", "16", "16", "16", "--pwe", "0.01"]
    outs = {}
    for name, tool, ex in (("jax", j3, "tpu"), ("port", t3, "cpu")):
        bs, df = str(tmp_path / f"{name}.sperr"), str(tmp_path / f"{name}.f32")
        assert tool.run(args + ["--exec", ex, "--bitstream", bs]) == 0
        assert tool.run(["-d", bs, "--exec", ex, "--decomp_f", df]) == 0
        outs[name] = np.fromfile(df, np.float32)
        assert np.abs(outs[name] - vol.ravel()).max() <= 0.01
    diff = np.abs(outs["port"] - outs["jax"])
    # a flipped quantized value moves a decode by about q = 1.5 tol near it
    assert np.mean(diff <= 1e-5) >= 0.999
    assert diff.max() <= 0.02


@pytest.mark.parametrize("ndim", [2, 3])
def test_lowres_files_equal_the_jax_tool(ndim, tmp_path):
    tol = 0.01
    if ndim == 3:
        data = _vol3(64, 32, 32)
        tool_j, tool_t, dims = j3, t3, ["64", "32", "32", "--chunks", "32", "32", "32"]
    else:
        data = _field2d(64, 64)
        tool_j, tool_t, dims = j2, t2, ["64", "64"]
    inp = _write(tmp_path, "in.f32", data)
    bs = str(tmp_path / "s.sperr")
    assert tool_t.run(["-c", inp, "--exec", "cpu", "--dims", *dims, "--pwe", str(tol),
                       "--bitstream", bs]) == 0
    for name, tool, extra in (("j", tool_j, []), ("t", tool_t, ["--exec", "cpu"])):
        os.mkdir(tmp_path / name)
        assert tool.run(["-d", bs, "--decomp_lowres_f", str(tmp_path / name / "lr"),
                         "--decomp_lowres_d", str(tmp_path / name / "ld")] + extra) == 0
    files = sorted(os.listdir(tmp_path / "j"))
    assert len(files) >= 4 and sorted(os.listdir(tmp_path / "t")) == files
    for f in files:
        dt = np.float32 if f.startswith("lr") else np.float64
        a = np.fromfile(tmp_path / "t" / f, dt)
        b = np.fromfile(tmp_path / "j" / f, dt)
        assert a.shape == b.shape and np.abs(a.astype(np.float64) - b).max() <= tol


def test_trunc_equals_the_jax_tool(tmp_path, capsys):
    inp = _write(tmp_path, "in.f32", _vol3())
    bs = str(tmp_path / "v.sperr")
    assert t3.run(["-c", inp, "--exec", "host", "--dims", "40", "30", "20", "--chunks", "16", "16",
                   "16", "--pwe", "0.01", "--bitstream", bs]) == 0
    outs = {}
    for name, tool in (("jax", j_trunc), ("port", t_trunc)):
        tb = str(tmp_path / f"{name}.t")
        capsys.readouterr()
        assert tool.run([bs, "--pct", "30", "--bitstream", tb, "--compare_f", inp]) == 0
        outs[name] = (_read(tb), capsys.readouterr().out)
    assert outs["port"] == outs["jax"] and "Bitrate" in outs["port"][1]


def _raw_cases(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 5, 4)).astype(np.float32)
    vol = _write(tmp_path, "vol.f32", a)
    vol2 = _write(tmp_path, "vol2.f32", a + np.float32(0.001))
    img = _write(tmp_path, "img.f32", np.arange(20, dtype=np.float32).reshape(4, 5))
    small = _write(tmp_path, "small.f32", np.zeros((3, 2, 2), np.float32))
    return {
        "compare": ["compare", vol, vol2, "--ftype", "32"],
        "crop2d": ["crop2d", img, "{out}", "--dims", "5", "4", "--x0", "1", "--x1", "4", "--y0",
                   "2", "--y1", "4"],
        "crop3d": ["crop3d", vol, "{out}", "--dims", "4", "5", "6", "--x0", "1", "--x1", "3",
                   "--y0", "0", "--y1", "2", "--z0", "2", "--z1", "5"],
        "putback3d": ["putback3d", "{big}", small, "--dims", "4", "5", "6", "--small_dims", "2",
                      "2", "3", "--x0", "1", "--y0", "0", "--z0", "2"],
        "convert": ["convert", vol, "{out}", "--ftype", "32"],
        "generate_ball": ["generate", "{out}", "--kind", "ball", "-n", "10"],
        "generate_smooth": ["generate", "{out}", "--kind", "smooth", "-n", "8"],
    }


@pytest.mark.parametrize("case", ["compare", "crop2d", "crop3d", "putback3d", "convert",
                                  "generate_ball", "generate_smooth"])
def test_raw_tools_equal_jax(case, tmp_path, capsys):
    argv = _raw_cases(tmp_path)[case]
    outs = {}
    for name, tool in (("jax", j_raw), ("port", t_raw)):
        out, big = str(tmp_path / f"{name}.out"), str(tmp_path / f"{name}.big")
        with open(big, "wb") as f:
            f.write(_read(tmp_path / "vol.f32"))
        assert tool.run([a.format(out=out, big=big) for a in argv]) == 0
        text = capsys.readouterr().out.replace(out, "OUT")
        outs[name] = (text, _read(out) if os.path.exists(out) else None, _read(big))
    assert outs["port"] == outs["jax"] and outs["port"][0]


def test_show_version(capsys):
    assert j_version.run([]) == 0
    j = capsys.readouterr().out.splitlines()
    assert t_version.run([]) == 0
    t = capsys.readouterr().out.splitlines()
    assert t[0] == j[0].replace("sperr_tpu version", "sperr_tpu_torch version")
    assert t[1:] == j[1:] and "format major version 0" in t[1]


@pytest.mark.parametrize("tool,argv", [
    ("sperr3d", ["-c", "{inp}", "--dims", "40", "30", "20", "--pwe", "0.01"]),
    ("sperr3d", ["-c", "{inp}", "--exec", "cuda", "--dims", "40", "30", "20", "--pwe", "0.01"]),
    ("sperr3d", ["-d", "{bs}", "--decomp_f", "{out}"]),
    ("sperr2d", ["-c", "{inp2}", "--dims", "64", "48", "--pwe", "0.01"]),
    ("sperr2d", ["-d", "{bs2}", "--exec", "cuda", "--decomp_f", "{out}"]),
])
def test_cuda_is_the_default_and_raises_without_a_gpu(tool, argv, tmp_path, monkeypatch):
    files = dict(inp=_write(tmp_path, "in.f32", _vol3()), inp2=_write(tmp_path, "in2.f32", _field2d()),
                 bs=str(tmp_path / "v.sperr"), bs2=str(tmp_path / "f.sperr"), out=str(tmp_path / "o"))
    assert t3.run(["-c", files["inp"], "--exec", "host", "--dims", "40", "30", "20", "--pwe",
                   "0.01", "--bitstream", files["bs"]]) == 0
    assert t2.run(["-c", files["inp2"], "--exec", "host", "--dims", "64", "48", "--pwe", "0.01",
                   "--bitstream", files["bs2"]]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"sperr3d": t3.run, "sperr2d": t2.run}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run([a.format(**files) for a in argv])
    assert not os.path.exists(files["out"])


def test_dq_needs_exec_host(tmp_path, capsys):
    inp = _write(tmp_path, "in.f32", _vol3())
    with pytest.raises(SystemExit):
        t3.run(["-c", inp, "--exec", "cpu", "--dims", "40", "30", "20", "--dq", "0.01"])
    assert "--dq needs --exec host" in capsys.readouterr().err


@pytest.mark.parametrize("exec_mode", ["cpu", "cuda"])
@pytest.mark.parametrize("op", ["-c", "-d"])
def test_precision_32_needs_exec_host(op, exec_mode, tmp_path, capsys):
    """--precision 32 is the host engine's: the other engines refuse it
    rather than ignore it, for compression and decompression alike."""
    inp = _write(tmp_path, "in.f32", _vol3())
    argv = ["-c", inp, "--dims", "40", "30", "20", "--pwe", "0.01"] if op == "-c" else ["-d", inp]
    with pytest.raises(SystemExit):
        t3.run(argv + ["--exec", exec_mode, "--precision", "32"])
    assert "--precision 32 needs --exec host" in capsys.readouterr().err
