"""PyTorch / CUDA port of the PAM serving system.

The JAX package ``repro`` is the reference; this package mirrors its
module names and sub-layout. It imports ``torch`` and numpy only, never
``jax`` and nothing of ``repro``. Hand-written Hopper kernels live under
``repro_torch.kernels`` (CUDA C++ in ``kernels/csrc``), each beside a
plain PyTorch version that CPU tensors use.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
