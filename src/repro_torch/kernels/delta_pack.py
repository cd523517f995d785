"""Launch wrapper of the hand-written CUDA kernel in ``csrc/delta_pack.cu``.

It replaces the Pallas kernel of ``repro/kernels/delta_pack.py``: the comm
substrate's shipment pack (top-k mask, f32/bf16/int8 quantization and the
error-feedback residual in one pass).  The wrapper checks device, dtype,
shape and contiguity, allocates both outputs, launches on the current
stream, raises on a non-zero ``cudaError_t`` and counts the launch in
``launch.launches``.  The plain version is ``ref.delta_pack``;
``ops.delta_pack`` picks between the two by the tensor's device.

Limits: ``1 <= P <= 65535`` (one grid row per producer) and any ``d >= 1``
(the ragged tail is masked; ``d % 4 == 0`` with 16-byte aligned rows takes
the float4 path).  The Pallas kernel took only ``d % 128 == 0`` and
``P <= 128``.
"""
from __future__ import annotations

import ctypes

import torch

from .launch import check, launches, load_lib, raise_on, require_cuda, stream

MAX_P = 65535
QUANT_IDS = {"f32": 0, "bf16": 1, "int8": 2}

_vp = ctypes.c_void_p
_ARGTYPES = {"dp_delta_pack": [_vp, _vp, _vp, _vp, _vp, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_int, _vp]}


def delta_pack(delta, thresh, scale, quant: str = "f32"):
    """``(wire, residual)`` of ``delta [P, d]`` under the per-row
    ``thresh [P]`` and ``scale [P]``, on the card; contract of
    ``ref.delta_pack``."""
    require_cuda(delta)
    if quant not in QUANT_IDS:
        raise ValueError(f"unknown quant {quant!r}")
    if delta.dim() != 2:
        raise ValueError(f"delta must be [P, d], got {tuple(delta.shape)}")
    P, d = delta.shape
    if not (1 <= P <= MAX_P and d >= 1):
        raise ValueError(f"delta [P={P}, d={d}] is outside the kernel's "
                         f"limits 1 <= P <= {MAX_P}, d >= 1")
    dev = delta.device
    check("delta", delta, torch.float32, (P, d), dev)
    check("thresh", thresh, torch.float32, (P,), dev)
    check("scale", scale, torch.float32, (P,), dev)
    wire = torch.empty((P, d), dtype=torch.float32, device=dev)
    res = torch.empty((P, d), dtype=torch.float32, device=dev)
    lib = load_lib("delta_pack", _ARGTYPES, "dp_error_string")
    with torch.cuda.device(dev):
        err = lib.dp_delta_pack(delta.data_ptr(), thresh.data_ptr(),
                                scale.data_ptr(), wire.data_ptr(),
                                res.data_ptr(), P, d, QUANT_IDS[quant],
                                stream(dev))
    raise_on(lib, err, "delta_pack")
    launches["delta_pack"] += 1
    return wire, res
