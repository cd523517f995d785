"""PyTorch / CUDA port of the PS-consistency simulator (``repro``).

Mirrors the JAX package's layout (``core/``, ``kernels/``, ``apps/``,
``psrun/``), imports ``torch`` and never ``jax`` or ``repro``.  Entry
points take an explicit ``device`` and default to ``cuda``
(:func:`repro_torch.device.resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
