"""The field generator repeats from its seed."""

import numpy as np
import pytest
import torch

from portbench import fields


@pytest.mark.parametrize("shape, slope", [((24, 20, 16), -11 / 3), ((30, 48), -8 / 3)])
def test_same_seed_same_fields(shape, slope):
    seed = 2**31 + 12345  # past 32 signed bits, as a run's seed may be
    a = fields.make_fields(shape, 3, slope, 0.125, seed, "cpu")
    b = fields.make_fields(shape, 3, slope, 0.125, seed, "cpu")
    c = fields.make_fields(shape, 3, slope, 0.125, seed + 1, "cpu")
    assert a.dtype == np.float32 and a.shape == (3, *shape)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])  # the fields of one run differ
    for f in a:
        assert f.min() == 0.0 and f.max() == 1.0


def test_spectrum():
    """The mean power falls with k as the slope says (between the largest
    scales and the cut-off)."""
    n = 128
    f = fields.make_fields((n, n), 8, -8 / 3, 0.125, 7, "cpu").astype(np.float64)
    p = (np.abs(np.fft.rfft2(f - f.mean(axis=(1, 2), keepdims=True))) ** 2).mean(axis=0)
    ky = np.fft.fftfreq(n)[:, None]
    kx = np.fft.rfftfreq(n)[None, :]
    k = np.hypot(ky, kx)
    lo = p[(k > 0.02) & (k < 0.03)].mean()
    hi = p[(k > 0.04) & (k < 0.06)].mean()
    ratio = np.log(hi / lo) / np.log(0.05 / 0.025)
    want = -8 / 3 + (0.05**2 - 0.025**2) / 0.125**2 * -2 / np.log(2)
    assert abs(ratio - want) < 0.6


def test_amplitude_zero_mean():
    amp = fields._amplitude((8, 8, 8), -11 / 3, 0.125, "cpu")
    assert amp.shape == (8, 8, 5) and float(amp[0, 0, 0]) == 0.0 and torch.all(amp[1:] > 0)
