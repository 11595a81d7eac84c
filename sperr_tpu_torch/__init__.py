"""sperr_tpu_torch: the PyTorch/CUDA port of sperr_tpu for NVIDIA Hopper.

The dense 3D codec path (condition -> CDF 9/7 -> midtread quantize -> PWE
residual, and the matching decode) runs on a torch device, with hand-written
CUDA kernels for sm_90a on the GPU (``kernels/``) and their plain PyTorch
versions on the CPU.  SPECK entropy coding, the container format and the
outlier coder come from sperr_tpu's framework-neutral layers, which this
package imports as they are; it never imports jax.

Entry points: ``sperr_tpu_torch.parallel.batched.TorchCompressor3D`` and
``TorchDecompressor3D``.
"""

__version__ = "0.1.0"
