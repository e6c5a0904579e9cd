"""PyTorch/CUDA port of ``repro`` (HO-SGD, Algorithm 1).

Mirrors the module tree of the JAX package: ``repro_torch.core.directions``
is the counterpart of ``repro.core.directions``, and so on.  The package
imports ``torch`` and never ``jax`` or ``repro``.  Entry points take
``device=`` (default ``"cuda"``) and raise when no GPU is present unless the
caller passes ``device="cpu"`` explicitly.
"""
from repro_torch.device import resolve_device  # noqa: F401
