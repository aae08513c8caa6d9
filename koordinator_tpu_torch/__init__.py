"""PyTorch/CUDA port of the batched Koordinator scheduler backend.

The JAX package ``koordinator_tpu`` is the reference; this package re-states
what it needs in PyTorch, with the Assign cycle run by hand-written CUDA
kernels on an NVIDIA H100 (``solver/cycle_cuda.cu``, the per-pod cycle in
int64 and in int32; ``solver/cycle_wide_cuda.cu``, the wave-batched int32
cycle).  It imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and never
``koordinator_tpu`` — so it runs where JAX is absent.

Host-side arithmetic is exact int64, like the reference's x64 mode: every
snapshot tensor is ``torch.int64`` (or ``bool``/``int32`` for flags and ids)
and divisions are floor divisions on int64.

Entry points take an explicit ``device``.  With none given they use CUDA,
and raise when CUDA is absent: the port never drops to the CPU on its own.
The CPU path (the kernel's plain PyTorch version) runs only when the caller
asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.

    Raises ``RuntimeError`` when no device is given and CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "koordinator_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch path explicitly"
        )
    return torch.device("cuda")
