"""Launch wrappers of the hand-written CUDA kernels in ``csrc/ps_view.cu``.

They replace the Pallas kernels of ``repro/kernels/ps_view.py``:
``ring_view`` (masked ring-buffer view materialization) and
``vap_suffix_norms`` (per-producer suffix-aggregate inf-norms).  Each
wrapper checks device, dtype, shape and contiguity, allocates its output,
launches on the current stream, raises on a non-zero ``cudaError_t`` and
counts the launch in :data:`launches` (shared with every kernel, see
``launch.py``).  The plain versions are in ``ref.py``; ``ops.py`` picks
between the two by the tensor's device.

Limits: ``R <= P <= 64`` (one 64-bit reader mask per ring row) and
``W <= 64`` (the largest window of ``vap_suffix_norms``'s register
instance, and of its shared-memory maxima); ``d`` is any size (the ragged
tail is masked).  The Pallas kernels took only ``d % 128 == 0``,
``P <= 128`` and ``W <= 64``.

``vap_suffix_norms`` streams a ring whose rows are 16-byte aligned
(``d % 4 == 0`` and an aligned start) through shared memory in work items of
:data:`VAP_TILE` columns of one producer (bulk copies); other rings take
its register instance.  The tile's seams are where a dropped column would
hide, so ``ref.vap_spiked_ring`` plants its spikes there.
"""
from __future__ import annotations

import ctypes

import torch

from .launch import check, launches, load_lib, raise_on, require_cuda, \
    reset_launches, stream

__all__ = ["MAX_P", "MAX_W", "VAP_TILE", "launches", "reset_launches",
           "ring_view", "vap_suffix_norms"]

MAX_P = 64
MAX_W = 64
# Columns of one work item of vap_suffix_norms's bulk-copy kernel (VAP_TILE
# in csrc/ps_view.cu).
VAP_TILE = 2048

_vp = ctypes.c_void_p
_ARGTYPES = {
    "ps_ring_view": [_vp, _vp, _vp, _vp, _vp, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, _vp],
    "ps_vap_suffix_norms": [_vp, _vp, ctypes.c_int, _vp, ctypes.c_int,
                            ctypes.c_int, ctypes.c_longlong, _vp],
}


def _lib() -> ctypes.CDLL:
    return load_lib("ps_view", _ARGTYPES, "ps_error_string")


def _check_ring(uring, uclock):
    require_cuda(uring)
    if uring.dim() != 3:
        raise ValueError(f"uring must be [W, P, d], got {tuple(uring.shape)}")
    W, P, d = uring.shape
    if not (1 <= P <= MAX_P and 1 <= W <= MAX_W and d >= 1):
        raise ValueError(f"ring [W={W}, P={P}, d={d}] is outside the "
                         f"kernels' limits W <= {MAX_W}, P <= {MAX_P}")
    check("uring", uring, torch.float32, (W, P, d), uring.device)
    check("uclock", uclock, torch.int32, (W,), uring.device)
    return W, P, d


def ring_view(base, uring, uclock, cview):
    """``view[r] = base + Σ_{w,q: RING_INVALID < uclock[w] <= cview[r,q]}
    uring[w,q]``, on the card, for the ``R <= P`` readers of ``cview
    [R, P]`` -> ``[R, d]``; contract of ``ref.ring_view``.  Each element's
    adds run in one order whatever ``R``, ``d`` and the block's column
    offset, so a shard's views equal the same rows of the whole matrix's
    bit for bit."""
    W, P, d = _check_ring(uring, uclock)
    check("base", base, torch.float32, (d,), uring.device)
    R = cview.shape[0] if cview.dim() == 2 else -1
    if not 1 <= R <= P:
        raise ValueError(f"cview must be [R, {P}] with 1 <= R <= {P}, got "
                         f"{tuple(cview.shape)}")
    check("cview", cview, torch.int32, (R, P), uring.device)
    out = torch.empty((R, d), dtype=torch.float32, device=uring.device)
    lib = _lib()
    with torch.cuda.device(uring.device):
        err = lib.ps_ring_view(base.data_ptr(), uring.data_ptr(),
                               uclock.data_ptr(), cview.data_ptr(),
                               out.data_ptr(), W, P, R, d,
                               stream(uring.device))
    raise_on(lib, err, "ring_view")
    launches["ring_view"] += 1
    return out


def vap_suffix_norms(uring, uclock, c: int):
    """``norms[k,q] = ||Σ_{j=1..k} u_q(c-j)||_inf`` ([W+1, P], row 0 is
    0), on the card; contract of ``ref.vap_suffix_norms``."""
    W, P, d = _check_ring(uring, uclock)
    out = torch.zeros((W + 1, P), dtype=torch.float32, device=uring.device)
    lib = _lib()
    with torch.cuda.device(uring.device):
        err = lib.ps_vap_suffix_norms(uring.data_ptr(), uclock.data_ptr(),
                                      int(c), out.data_ptr(), W, P, d,
                                      stream(uring.device))
    raise_on(lib, err, "vap_suffix_norms")
    launches["vap_suffix_norms"] += 1
    return out
