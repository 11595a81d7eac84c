"""The port's quantizer and PSNR search (sperr_tpu_torch/ops/quantize.py)
against sperr_tpu's.

On the CPU the port runs the plain versions of kernels K1 and K16; the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py.  K16's rounds are emulated in numpy here."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sperr_tpu.ops import pallas_kernels as pk
from sperr_tpu.ops import quantize_jax as qzj
from sperr_tpu_torch import kernels
from sperr_tpu_torch.ops import quantize as qz


def _coeffs_with_ties(seed):
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(scale=100.0, size=(4, 4096)).astype(np.float32)
    q = (np.abs(rng.normal(scale=0.5, size=4)) + 0.01).astype(np.float32)
    # row 3 at q = 0.5: c = k + 0.25 lands on 2k + 0.5 exactly, a rounding
    # tie; half to even sends it to 2k.  Zeros and -0.0 have a positive sign.
    k = rng.integers(-500, 500, size=4096).astype(np.float32)
    coeffs[3] = k + np.float32(0.25)
    coeffs[3, :4] = [0.0, -0.0, -0.25, 0.25]
    q[3] = 0.5
    return coeffs, q


@pytest.mark.parametrize("seed", [5, 11])
def test_plain_k1_equals_jax_and_pallas(seed):
    coeffs, q = _coeffs_with_ties(seed)
    ours = qz.midtread_quantize_batched_best(torch.from_numpy(coeffs), torch.from_numpy(q))
    ref = qzj.midtread_quantize_batched(jnp.asarray(coeffs), jnp.asarray(q))
    pal = pk.quantize_pallas(jnp.asarray(coeffs), jnp.asarray(q), interpret=True)
    for a, b, c in zip(ours, ref, pal):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    mags, signs, _ = ours
    # the ties went to even, and zero coefficients are positive
    ll = np.where(signs[3].numpy(), 1, -1) * mags[3].numpy()
    k = (coeffs[3, 4:] - np.float32(0.25)).astype(np.int64)
    np.testing.assert_array_equal(ll[4:], 2 * k)
    # 0.0, -0.0, -0.25 and 0.25 quantize to +-0.0, all with a positive sign
    assert signs[3, :4].all() and not mags[3, :4].any()


@pytest.mark.parametrize("mag_dtype", [np.int16, np.int32])
def test_inv_quantize_equals_jax(mag_dtype):
    rng = np.random.default_rng(3)
    mags = rng.integers(0, 30000, size=(3, 1000)).astype(mag_dtype)
    signs = rng.random((3, 1000)) < 0.5
    q = (rng.random(3) + 0.1).astype(np.float32)
    ours = qz.midtread_inv_quantize_batched(
        torch.from_numpy(mags), torch.from_numpy(signs), torch.from_numpy(q)
    )
    ref = qzj.midtread_inv_quantize_batched(
        jnp.asarray(mags), jnp.asarray(signs), jnp.asarray(q)
    )
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("psnr", [40.0, 80.0])
def test_estimate_q_psnr_matches_jax(psnr):
    rng = np.random.default_rng(int(psnr))
    coeffs = rng.normal(scale=3.0, size=(3, 8192)).astype(np.float32)
    data_range = (np.abs(rng.normal(size=3)) * 10 + 1).astype(np.float32)
    ours = qz.estimate_q_psnr_batched(
        torch.from_numpy(coeffs), torch.from_numpy(data_range), psnr
    )
    ref = qzj.estimate_q_psnr_batched(jnp.asarray(coeffs), jnp.asarray(data_range), psnr)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


def test_rate_constant_matches_jax():
    assert qz.RATE_MAX_MAG_DEVICE == qzj.RATE_MAX_MAG_DEVICE


# ---------------------------------------------------------------------------
# K16, the PSNR search: the plain version's f64 MSE and its stop, the batch,
# and a numpy emulation of the kernel's rounds (kernels/quantize.cu psnr_q)
# ---------------------------------------------------------------------------
@pytest.fixture
def one_thread():
    """The searches' many small ops wait for threads that the other test
    workers hold; one thread keeps a search to its own time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal_row(seed, n=65536):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(scale=100.0, size=(1, n)).astype(np.float32))


def _loop_q(c: np.ndarray, q0: np.float32, t_mse: np.float32):
    """The search as a plain loop in numpy: (q, evaluations)."""
    shrink = np.float32(kernels.PSNR_SHRINK)
    q, evals = np.float32(q0), 0
    while True:  # q past f32's range gives inf and nan, as in the kernel
        evals += 1
        d = c - q * np.rint(c * (np.float32(1.0) / q))
        if not np.sum(d.astype(np.float64) ** 2) / c.size > np.float64(t_mse):
            return q, evals
        q = np.float32(q * shrink)


def test_psnr_search_raises_where_f32_cannot_reach_the_target(one_thread):
    """PSNR 120 on normal(scale 100) coefficients with a data range of 1:
    q shrinks to a subnormal that no longer moves; the loop would not end."""
    c = _normal_row(0)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match=r"row 0: .*cannot be reached in f32"):
        qz.estimate_q_psnr_batched(c, torch.ones(1), 120.0)
    assert time.perf_counter() - t0 < 10.0


def test_psnr_search_takes_the_loops_q_after_seven_evaluations(one_thread):
    c = _normal_row(0)
    q = qz.estimate_q_psnr_batched(c, torch.ones(1), 110.0)
    t_mse, q0 = qz.psnr_start(torch.ones(1), 110.0)
    want, evals = _loop_q(c[0].numpy(), q0.numpy()[0], t_mse.numpy()[0])
    assert evals == 7
    assert q.dtype == torch.float32 and q.numpy()[0] == want == np.float32(3.8729836e-06)


def test_psnr_search_row_alone_equals_row_in_a_batch():
    """The dense front searches the whole batch at once: each chunk's q is
    the one it gets alone."""
    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.parallel import batched as tb

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(3, 12, 16, 16)).astype(np.float32) * np.float32([1, 40, 0.01])[:, None, None, None])
    for psnr in (60.0, 95.0):
        batch = tb._dense_encode_rows(x, "psnr", psnr, "none", cdf97.dwt3d, cdf97.idwt3d_)["q"]
        alone = torch.cat([tb._dense_encode_rows(x[b:b + 1], "psnr", psnr, "none", cdf97.dwt3d,
                                                 cdf97.idwt3d_)["q"] for b in range(3)])
        np.testing.assert_array_equal(batch.numpy(), alone.numpy())


def _emulate_psnr_kernel(c: np.ndarray, q0: np.ndarray, t_mse: np.ndarray, launches=kernels.PSNR_ROUND):
    """kernels/quantize.cu psnr_q's rounds in numpy: a round is two
    launches, the second queued behind the first with no host wait; each
    launch takes every row whose status is 0 (every row in the first
    launch of the call), its blocks' f64 sums over their share of the row
    (16-byte loads by grid stride where n % 4 == 0), the last block's parts
    of the blocks in order (the slots of PSNR_CANDIDATES candidates
    whatever the launch tests), the first met of its J candidates; a row it
    leaves open resumes at its q_J in the next launch.  The host reads the
    status words once a round.  Returns (q, rounds, the rows each launch
    ran) or raises as the kernel's wrapper does."""
    B, n = c.shape
    blocks = kernels.psnr_blocks(n)
    parts = 256 // kernels.PSNR_CANDIDATES
    shrink = np.float32(kernels.PSNR_SHRINK)
    # which block takes each element: vector v (4 floats) or element i, by grid stride
    unit = np.arange(n) // 4 if n % 4 == 0 else np.arange(n)
    blk = (unit % (blocks * 256)) // 256
    q_out = np.zeros(B, np.float32)
    start = q0.astype(np.float32).copy()
    status = np.full(B, 7, np.int32)  # not yet written: the call's first launch reads no status
    rounds, ran, first = 0, [], True
    while True:
        rounds += 1
        for J in launches:
            rows = np.arange(B) if first else np.flatnonzero(status == 0)
            ran.append(rows.tolist())
            first = False
            for b in rows:
                qs = [start[b]]
                for _ in range(J):
                    qs.append(np.float32(qs[-1] * shrink))
                met = -1
                for j in range(J):
                    d = c[b] - qs[j] * np.rint(c[b] * (np.float32(1.0) / qs[j]))
                    sq = d.astype(np.float64) ** 2
                    per_block = np.bincount(blk, weights=sq, minlength=blocks)
                    total = sum(sum(per_block[p::parts]) for p in range(parts))
                    if not total / n > np.float64(t_mse[b]):
                        met = j
                        break
                if met >= 0:
                    q_out[b], status[b] = qs[met], 1
                else:
                    start[b] = qs[J]
                    status[b] = 2 if qs[J] == qs[J - 1] else 0
        stuck = np.flatnonzero(status == 2)  # the round's one host read
        if stuck.size:
            raise ValueError(kernels.psnr_unreachable(int(stuck[0]), float(t_mse[stuck[0]]),
                                                      float(start[stuck[0]])))
        if not (status == 0).any():
            return q_out, rounds, ran


def _round_of(J):
    """The round that J names in the tests: the lean launch takes at most
    PSNR_LEAN candidates, the full one J (8: the default round)."""
    return min(J, kernels.PSNR_LEAN), J


@pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")
@pytest.mark.parametrize("J", [8, 2, 1])
@pytest.mark.parametrize("n", [4096, 3001])
def test_psnr_kernel_rounds_emulated_equal_plain(J, n, one_thread):
    """Rows that need 1 to 7 evaluations, several rounds where J is small,
    and the rows met early take no part in later launches."""
    rng = np.random.default_rng(n + J)
    c = rng.normal(scale=100.0, size=(4, n)).astype(np.float32)
    c[3] *= np.float32(1e-3)
    data_range = np.float32([1.0, 3.0, 1.0, 50.0])
    launches = _round_of(J)
    for psnr in (80.0, 105.0, 110.0):
        t_mse, q0 = qz.psnr_start(torch.from_numpy(data_range), psnr)
        want = qz.psnr_q_ref(torch.from_numpy(c), q0, t_mse).numpy()
        got, rounds, ran = _emulate_psnr_kernel(c, q0.numpy(), t_mse.numpy(), launches)
        np.testing.assert_array_equal(got, want)
        evals = [_loop_q(c[b], q0.numpy()[b], t_mse.numpy()[b])[1] for b in range(4)]
        assert rounds == -(-max(evals) // sum(launches))
        # a row takes part in the launches up to the one that meets it
        for b, e in enumerate(evals):
            k, left = 0, e
            while left > launches[k % 2]:
                left -= launches[k % 2]
                k += 1
            assert [b in rows for rows in ran] == [i <= k for i in range(len(ran))]
    assert max(evals) > 2  # the J = 1 and 2 cases took more than one round
    t_mse, q0 = qz.psnr_start(torch.ones(4), 120.0)
    with pytest.raises(ValueError, match="cannot be reached") as plain:
        qz.psnr_q_ref(torch.from_numpy(c[:1]), q0[:1], t_mse[:1])
    with pytest.raises(ValueError, match="cannot be reached") as emulated:
        _emulate_psnr_kernel(c[:1], q0.numpy()[:1], t_mse.numpy()[:1], launches)
    assert str(plain.value) == str(emulated.value)


def _mse_chain(c: np.ndarray, q0: np.float32, k: int):
    """The loop's first k candidates from q0 and each one's f64 MSE."""
    shrink = np.float32(kernels.PSNR_SHRINK)
    qs, mse = [np.float32(q0)], []
    for _ in range(k):
        q = qs[-1]
        d = c - q * np.rint(c * (np.float32(1.0) / q))
        mse.append(np.sum(d.astype(np.float64) ** 2) / c.size)
        qs.append(np.float32(q * shrink))
    return qs[:k], mse


# where row 0 first meets its target: the candidate index (shrinks from q0)
_MEETS = {"candidate 0": 0, "lean launch's last": kernels.PSNR_LEAN - 1,
          "full launch's first": kernels.PSNR_LEAN, "a later round": sum(kernels.PSNR_ROUND) + 1}


@pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")
@pytest.mark.parametrize("where", list(_MEETS) + ["stuck in the lean launch"])
def test_psnr_round_meets_at_each_candidate(where, one_thread):
    """The default round (lean launch of PSNR_LEAN candidates, full launch
    of PSNR_CANDIDATES) on rows whose target is met at a chosen candidate:
    q equal to the plain version's and the plain loop's, each row in the
    launches up to the one that meets it; a row stuck in the lean launch
    (q0 the least subnormal, which no longer shrinks) is skipped by the
    full launch and raises as the plain version does."""
    rng = np.random.default_rng(len(where))
    c = rng.normal(scale=100.0, size=(3, 4096)).astype(np.float32)
    q0 = np.float32([2.0, 1.0, 4.0])
    t_mse = np.zeros(3, np.float32)
    for b, j in enumerate((_MEETS.get(where, 0), 0, 1)):
        _, mse = _mse_chain(c[b], q0[b], j + 1)
        t = np.float32(mse[j])
        t_mse[b] = t if np.float64(t) >= mse[j] else np.nextafter(t, np.float32(np.inf))
        assert all(m > np.float64(t_mse[b]) for m in mse[:j])  # met first at j
    if where == "stuck in the lean launch":
        q0[0] = np.float32(1e-45)
        t_mse[0] = np.float32(1e-30)
        with pytest.raises(ValueError, match="row 0: .*cannot be reached") as plain:
            qz.psnr_q_ref(torch.from_numpy(c), torch.from_numpy(q0), torch.from_numpy(t_mse))
        with pytest.raises(ValueError, match="row 0: .*cannot be reached") as emulated:
            _emulate_psnr_kernel(c, q0, t_mse)
        assert str(plain.value) == str(emulated.value)
        return
    want = qz.psnr_q_ref(torch.from_numpy(c), torch.from_numpy(q0), torch.from_numpy(t_mse)).numpy()
    got, rounds, ran = _emulate_psnr_kernel(c, q0, t_mse)
    np.testing.assert_array_equal(got, want)
    loop = [_loop_q(c[b], q0[b], t_mse[b]) for b in range(3)]
    np.testing.assert_array_equal(got, np.float32([q for q, _ in loop]))
    j0 = _MEETS[where]
    assert loop[0][1] == j0 + 1
    lean, full = kernels.PSNR_ROUND
    assert rounds == 1 + j0 // (lean + full)
    launches0 = 2 * (j0 // (lean + full)) + (1 if j0 % (lean + full) < lean else 2)
    assert [0 in rows for rows in ran] == [i < launches0 for i in range(len(ran))]
    assert ran[1] == ([0] if launches0 > 1 else [])  # rows 1 and 2 meet in the lean launch


def _smooth_coeffs(seed: int, N: int = 32):
    """A smooth_field_3d chunk's CDF 9/7 coefficients (the port's plain
    transform, as the dense front makes them), one row, and its data range."""
    from sperr_tpu_torch.ops import cdf97
    from sperr_tpu_torch.utils.testdata import smooth_field_3d

    x = torch.from_numpy(smooth_field_3d(N, seed=seed)[None])
    rng = (x.max() - x.min()).reshape(1)
    return cdf97.dwt3d(x - x.mean()).reshape(1, -1), rng


@pytest.mark.parametrize("psnr", [60.0, 80.0, 100.0])
def test_psnr_round_on_smooth_coefficients_equals_jax(psnr, one_thread):
    """The default round, emulated, on seeded smooth_field_3d coefficients
    at three PSNR targets: q equal to the plain version's and to sperr_tpu's
    estimate_q_psnr_batched, met within the lean launch (the shrink counts
    that set PSNR_LEAN)."""
    rows = [_smooth_coeffs(seed) for seed in (3, 7, 11)]
    c = torch.cat([r[0] for r in rows])
    data_range = torch.cat([r[1] for r in rows])
    t_mse, q0 = qz.psnr_start(data_range, psnr)
    want = qz.psnr_q_ref(c, q0, t_mse).numpy()
    got, rounds, ran = _emulate_psnr_kernel(c.numpy(), q0.numpy(), t_mse.numpy())
    np.testing.assert_array_equal(got, want)
    theirs = np.asarray(qzj.estimate_q_psnr_batched(jnp.asarray(c.numpy()), jnp.asarray(data_range.numpy()), psnr))
    np.testing.assert_array_equal(got, theirs)
    shrinks = [_loop_q(c[b].numpy(), q0.numpy()[b], t_mse.numpy()[b])[1] - 1 for b in range(3)]
    assert max(shrinks) < kernels.PSNR_LEAN and rounds == 1 and ran[1] == []


def test_psnr_kernel_constants_match_the_source():
    import os
    import re

    src = open(os.path.join(os.path.dirname(kernels.__file__), "quantize.cu")).read()
    assert int(re.search(r"constexpr int kPsnrCand = (\d+);", src).group(1)) == kernels.PSNR_CANDIDATES >= 8
    assert int(re.search(r"constexpr int kPsnrLean = (\d+);", src).group(1)) == kernels.PSNR_LEAN
    assert kernels.PSNR_ROUND == (kernels.PSNR_LEAN, kernels.PSNR_CANDIDATES)
    assert "template <int kCand>" in src and "psnr_q_kernel<kPsnrLean>" in src
    shrink = re.search(r"constexpr float kShrink = ([0-9.]+)f;", src).group(1)
    assert np.float32(shrink) == np.float32(kernels.PSNR_SHRINK) == np.float32(1.0 / 2.0**0.25)
    assert float(shrink) == kernels.PSNR_SHRINK  # the f32 value written out exactly
    assert kernels.psnr_blocks(1) == 1 and kernels.psnr_blocks(256**3) == 1024
    assert "psnr_q" in kernels.launches


def test_psnr_search_cpu_tensors_never_load_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    qz.estimate_q_psnr_batched(_normal_row(1, 1024), torch.ones(1), 80.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.psnr_q(_normal_row(1, 1024), torch.ones(1), torch.ones(1))
    with pytest.raises(ValueError, match="no PSNR search for tensors on meta"):
        qz.estimate_q_psnr_batched(torch.zeros((1, 8), device="meta"), torch.ones(1, device="meta"), 80.0)
