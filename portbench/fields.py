"""The benchmark's field generator: random fields with a power-law spectrum
and a Gaussian dissipation cut-off, made on the device from a seed.

A field of shape ``shape`` (z slowest, x fastest) has, at every wavenumber
k (cycles per sample), the amplitude sqrt(P(k)) with

    P(k) = k**slope * exp(-(k / k_c)**2),   P(0) = 0,

and a random phase: the phases of the Fourier transform of white noise, its
magnitudes dropped.  With the amplitudes fixed, every seed gives a field of
the same spectrum and variance, and so about the same work: with Gaussian
amplitudes the few largest-scale modes, which set the range, vary from
seed to seed, and with the range the bits a tolerance costs.  The field is
then scaled to a value range of 1 (minimum 0, maximum 1), so that a
point-wise tolerance of rel times the range is rel.  Kolmogorov turbulence
has slope -11/3 in 3D (energy spectrum k**-5/3); a 2D section of the
atmosphere's mesoscale has -8/3.  The noise comes from one
``torch.Generator`` seeded once, in one call per field, so the same seed on
the same kind of device gives the same fields.
"""

from __future__ import annotations

import numpy as np
import torch


def _amplitude(shape, slope: float, k_cut: float, device) -> torch.Tensor:
    """sqrt(P(k)) on the rfftn grid of ``shape`` (float32)."""
    axes = [torch.fft.fftfreq(n, device=device, dtype=torch.float64) for n in shape[:-1]]
    axes.append(torch.fft.rfftfreq(shape[-1], device=device, dtype=torch.float64))
    k2 = torch.zeros((), dtype=torch.float64, device=device)
    for i, f in enumerate(axes):
        view = [1] * len(shape)
        view[i] = f.numel()
        k2 = k2 + (f * f).reshape(view)
    # sqrt(k**slope * exp(-k**2 / k_c**2)), with k**slope = (k**2)**(slope / 2)
    amp = torch.exp(0.25 * slope * torch.log(k2.clamp_min(1e-300)) - 0.5 * k2 / (k_cut * k_cut))
    amp.reshape(-1)[0] = 0.0
    return amp.to(torch.float32)


def make_fields(shape, count: int, slope: float, k_cut: float, seed: int, device) -> np.ndarray:
    """``count`` fields of ``shape`` as one float32 host array (count, *shape)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    amp = _amplitude(tuple(shape), slope, k_cut, device)
    dims = tuple(range(-len(shape), 0))
    out = np.empty((count, *shape), dtype=np.float32)
    for i in range(count):
        noise = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
        c = torch.fft.rfftn(noise, dim=dims)
        del noise
        c = c / c.abs().clamp_min(1e-30)
        f = torch.fft.irfftn(c * amp, s=tuple(shape), dim=dims)
        del c
        lo, hi = f.min(), f.max()
        f = (f - lo) / (hi - lo)
        out[i] = f.cpu().numpy()
        del f
    return out
