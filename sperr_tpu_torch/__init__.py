"""sperr_tpu_torch: the PyTorch/CUDA port of sperr_tpu for NVIDIA Hopper.

The dense codec paths (condition -> CDF 9/7 -> midtread quantize -> PWE
residual, and the matching decode) and the device SPECK encoders (3D and
2D) run on a torch device, with hand-written CUDA kernels for sm_90a on the GPU
(``kernels/``) and their plain PyTorch versions on the CPU.  The host layers
(SPECK entropy coding in C++, the container format, the outlier coder, the
exact f64 decoders) are the port's own copies of sperr_tpu's
(``codec/``, ``ops/*_np.py``, ``ops/condition.py``, ``runtime/``,
``stream/``, ``utils/``): the package imports neither jax nor sperr_tpu.

Entry points: ``sperr_tpu_torch.parallel.batched.TorchCompressor3D`` and
``TorchDecompressor3D``; ``parallel.batched2d.TorchCompressor2D`` and
``TorchDecompressor2D``.  Each runs on the card (``device="cuda"``) unless
the caller names the CPU, or splits its batches over ``devices=[...]``.
Several processes compress one volume through
``parallel.distributed.compress_distributed`` (torch.distributed, gloo).
"""

__version__ = "0.1.0"

# Container format major version, matching the reference (SperrConfig: 0.8.5).
SPERR_VERSION_MAJOR = 0
