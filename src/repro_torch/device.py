"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device.
Without a GPU, asking for the default raises: nothing moves quietly to
the CPU.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev
