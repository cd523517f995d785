"""Launch wrappers of the hand-written CUDA kernels in ``csrc/ps_view.cu``.

They replace the Pallas kernels of ``repro/kernels/ps_view.py``:
``ring_view`` (masked ring-buffer view materialization) and
``vap_suffix_norms`` (per-producer suffix-aggregate inf-norms).  Each
wrapper checks device, dtype, shape and contiguity, allocates its output,
launches on the current stream, raises on a non-zero ``cudaError_t`` and
counts the launch in :data:`launches`.  The plain versions are in
``ref.py``; ``ops.py`` picks between the two by the tensor's device.

Limits: ``P <= 64`` (one 64-bit reader mask per ring row) and
``W <= 64`` (the largest register-resident window); ``d`` is any size
(the ragged tail is masked).  The Pallas kernels took only
``d % 128 == 0``, ``P <= 128`` and ``W <= 64``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_P = 64
MAX_W = 64

# Launches per kernel since the last reset_launches(): one per call that
# reached its kernel, counted where the kernel is launched and nowhere else.
launches = {"ring_view": 0, "vap_suffix_norms": 0}

_vp = ctypes.c_void_p
_ARGTYPES = {
    "ps_ring_view": [_vp, _vp, _vp, _vp, _vp, ctypes.c_int, ctypes.c_int,
                     ctypes.c_longlong, _vp],
    "ps_vap_suffix_norms": [_vp, _vp, ctypes.c_int, _vp, ctypes.c_int,
                            ctypes.c_int, ctypes.c_longlong, _vp],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    global _LIB
    if _LIB is None:
        lib = build.load("ps_view")
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ps_error_string.argtypes = [ctypes.c_int]
        lib.ps_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ring(uring, uclock):
    if uring.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got "
                         f"{uring.device}")
    if uring.dim() != 3:
        raise ValueError(f"uring must be [W, P, d], got {tuple(uring.shape)}")
    W, P, d = uring.shape
    if not (1 <= P <= MAX_P and 1 <= W <= MAX_W and d >= 1):
        raise ValueError(f"ring [W={W}, P={P}, d={d}] is outside the "
                         f"kernels' limits W <= {MAX_W}, P <= {MAX_P}")
    _check("uring", uring, torch.float32, (W, P, d), uring.device)
    _check("uclock", uclock, torch.int32, (W,), uring.device)
    return W, P, d


def _raise_on(lib, err: int, what: str):
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({lib.ps_error_string(err).decode()})")


def ring_view(base, uring, uclock, cview):
    """``view[r] = base + Σ_{w,q: RING_INVALID < uclock[w] <= cview[r,q]}
    uring[w,q]``, on the card; contract of ``ref.ring_view``."""
    W, P, d = _check_ring(uring, uclock)
    _check("base", base, torch.float32, (d,), uring.device)
    _check("cview", cview, torch.int32, (P, P), uring.device)
    out = torch.empty((P, d), dtype=torch.float32, device=uring.device)
    lib = _lib()
    with torch.cuda.device(uring.device):
        stream = torch.cuda.current_stream(uring.device).cuda_stream
        err = lib.ps_ring_view(base.data_ptr(), uring.data_ptr(),
                               uclock.data_ptr(), cview.data_ptr(),
                               out.data_ptr(), W, P, d, stream)
    _raise_on(lib, err, "ring_view")
    launches["ring_view"] += 1
    return out


def vap_suffix_norms(uring, uclock, c: int):
    """``norms[k,q] = ||Σ_{j=1..k} u_q(c-j)||_inf`` ([W+1, P], row 0 is
    0), on the card; contract of ``ref.vap_suffix_norms``."""
    W, P, d = _check_ring(uring, uclock)
    out = torch.zeros((W + 1, P), dtype=torch.float32, device=uring.device)
    lib = _lib()
    with torch.cuda.device(uring.device):
        stream = torch.cuda.current_stream(uring.device).cuda_stream
        err = lib.ps_vap_suffix_norms(uring.data_ptr(), uclock.data_ptr(),
                                      int(c), out.data_ptr(), W, P, d,
                                      stream)
    _raise_on(lib, err, "vap_suffix_norms")
    launches["vap_suffix_norms"] += 1
    return out
