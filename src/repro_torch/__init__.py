"""PyTorch / CUDA port of the PS-consistency simulator (``repro``).

Mirrors the JAX package's layout (``core/``, ``kernels/``, ``apps/``,
``psrun/``), imports ``torch`` and never ``jax`` or ``repro``.  Entry
points take an explicit ``device`` and default to ``cuda``
(:func:`repro_torch.device.resolve_device`).  Importing the package
itself loads nothing (``repro_torch.analysis`` runs without ``torch``).
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
