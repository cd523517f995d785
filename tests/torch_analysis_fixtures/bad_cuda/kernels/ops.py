"""Fixture: a dispatch that falls back, one without a plain version, one
whose plain version does not exist."""
from . import ref


def _on_cuda(t) -> bool:
    return t.device.type == "cuda"


def doubled(x):
    if _on_cuda(x):
        from . import fake
        try:
            return fake.doubled(x)
        except RuntimeError:  # VIOLATION: cuda-fallback
            return ref.doubled(x)
    return ref.doubled(x)


def halved(x):
    from . import fake
    return fake.halved(x)


def tripled(x):
    if _on_cuda(x):
        from . import fake
        return fake.doubled(x) * 1.5
    return ref.tripled(x)  # VIOLATION: cuda-ref
