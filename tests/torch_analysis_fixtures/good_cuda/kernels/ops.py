"""Fixture: dispatch by device, a plain version beside each kernel, no
fallback."""
from . import ref


def _on_cuda(t) -> bool:
    return t.device.type == "cuda"


def doubled(x):
    if _on_cuda(x):
        from . import fake
        return fake.doubled(x)
    return ref.doubled(x)
