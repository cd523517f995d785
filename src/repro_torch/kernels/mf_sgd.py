"""Launch wrapper of the hand-written CUDA kernel in ``csrc/mf_sgd.cu``.

It replaces the Pallas kernel of ``repro/kernels/mf_sgd.py``: one MF-SGD
step over a dense block of ratings (the masked residual, ``dL``, ``dR``
and the loss).  The wrapper checks device, dtype, shape and contiguity,
allocates the outputs and the scratch (R^T, the mask packed into 64-bit
words by rows and by columns, dR^T, and the rows' loss terms and counts:
every size a function of the shape, so the wrapper never reads the mask
and never syncs with the card), launches on the current stream, raises
on a non-zero ``cudaError_t`` and counts the call in
``launch.launches`` (one count per call; the call runs the mask's
packing, the two passes and the epilogues).  The plain version is
``ref.mf_sgd_block``; ``ops.mf_sgd_block`` picks between the two by the
tensor's device.

Limits: ``1 <= K <= 256`` (the JAX kernel's docstring sizes K up to 256)
and any ``N, M >= 1`` (ragged tails are masked in the kernel, and rows
of any alignment are read); the kernel works only on the observed
entries, at any density.  The Pallas
kernel took only ``K % 8 == 0``, ``N % 8 == 0`` and ``M % 128 == 0``, and
the JAX dispatch fell back to its reference elsewhere; this wrapper does
not.
"""
from __future__ import annotations

import ctypes

import torch

from .launch import check, launches, load_lib, raise_on, require_cuda, stream

MAX_K = 256

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"mf_sgd_block": [_vp] * 14 + [_i] * 3 + [_f, _f, _vp]}


def _lib():
    return load_lib("mf_sgd", _ARGTYPES, "mf_error_string")


def mf_sgd_block(L, R, D, mask, gamma, lam):
    """``(dL [N,K], dR [K,M], loss [])`` of one MF-SGD step over the dense
    block ``D [N,M]`` observed where ``mask`` is set, on the card; contract
    of ``ref.mf_sgd_block``."""
    require_cuda(L)
    if L.dim() != 2 or R.dim() != 2:
        raise ValueError("L must be [N, K] and R [K, M]")
    N, K = L.shape
    M = R.shape[1]
    if not (N >= 1 and M >= 1 and 1 <= K <= MAX_K):
        raise ValueError(f"L [N={N}, K={K}], R [K, M={M}] is outside the "
                         f"kernel's limits N, M >= 1, 1 <= K <= {MAX_K}")
    dev = L.device
    check("L", L, torch.float32, (N, K), dev)
    check("R", R, torch.float32, (K, M), dev)
    check("D", D, torch.float32, (N, M), dev)
    check("mask", mask, torch.bool, (N, M), dev)
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    rt = torch.empty((M, K), **f32)
    rowbits = torch.empty((N, (M + 63) // 64), **i64)   # the mask as bits
    colbits = torch.empty((M, (N + 63) // 64), **i64)
    drt = torch.empty((M, K), **f32)
    lossp = torch.empty((N,), **f32)
    cnt_r = torch.empty((N,), **i32)
    cnt_c = torch.empty((M,), **i32)
    dL = torch.empty((N, K), **f32)
    dR = torch.empty((K, M), **f32)
    loss = torch.empty((), **f32)
    with torch.cuda.device(dev):
        err = lib.mf_sgd_block(
            L.data_ptr(), R.data_ptr(), D.data_ptr(), mask.data_ptr(),
            rt.data_ptr(), rowbits.data_ptr(), colbits.data_ptr(),
            drt.data_ptr(), lossp.data_ptr(), cnt_r.data_ptr(),
            cnt_c.data_ptr(), dL.data_ptr(), dR.data_ptr(), loss.data_ptr(),
            N, M, K, float(gamma), float(lam), stream(dev))
    raise_on(lib, err, "mf_sgd_block")
    launches["mf_sgd_block"] += 1
    return dL, dR, loss
