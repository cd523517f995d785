"""Launch wrapper of the hand-written CUDA kernel in ``csrc/mf_sgd.cu``.

It replaces the Pallas kernel of ``repro/kernels/mf_sgd.py``: one MF-SGD
step over a dense block of ratings (the masked residual, ``dL``, ``dR``
and the loss).  The wrapper checks device, dtype, shape and contiguity,
asks the library for the launch plan (how far each of its two passes is
split to fill the card, cached per shape and device), allocates the
outputs and the scratch of the split partial sums, launches on the
current stream, raises on a non-zero ``cudaError_t`` and counts the call
in ``launch.launches`` (one count per call; the call runs the two passes
and the epilogue).  The plain version is ``ref.mf_sgd_block``;
``ops.mf_sgd_block`` picks between the two by the tensor's device.

Limits: ``1 <= K <= 256`` (the JAX kernel's docstring sizes K up to 256)
and any ``N, M >= 1`` (ragged tails are masked in the kernel, and rows
of any alignment are read).  The Pallas
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
_ARGTYPES = {
    "mf_plan": [_i, _i, _i, _vp],
    "mf_sgd_block": [_vp] * 12 + [_i] * 5 + [_f, _f, _vp],
}
_PLANS: dict[tuple, tuple[int, int, int, int]] = {}


def _lib():
    return load_lib("mf_sgd", _ARGTYPES, "mf_error_string")


def plan(N: int, M: int, K: int, device) -> tuple[int, int, int, int]:
    """``(split_rows, split_cols, tile, loss_partials)`` of the launch on
    ``device`` (its SM count and the passes' occupancy decide the
    splits)."""
    key = (N, M, K, device)
    if key not in _PLANS:
        lib, out = _lib(), (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            raise_on(lib, lib.mf_plan(N, M, K, ctypes.addressof(out)),
                     "mf_sgd_block plan")
        _PLANS[key] = tuple(out)
    return _PLANS[key]


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
    split_r, split_c, _, n_loss = plan(N, M, K, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    part_l = torch.empty((split_r, N, K), **f32)
    cnt_r = torch.empty((split_r, N), **i32)
    lossp = torch.empty((n_loss,), **f32)
    part_r = torch.empty((split_c, K, M), **f32)
    cnt_c = torch.empty((split_c, M), **i32)
    dL = torch.empty((N, K), **f32)
    dR = torch.empty((K, M), **f32)
    loss = torch.empty((), **f32)
    with torch.cuda.device(dev):
        err = lib.mf_sgd_block(
            L.data_ptr(), R.data_ptr(), D.data_ptr(), mask.data_ptr(),
            part_l.data_ptr(), cnt_r.data_ptr(), lossp.data_ptr(),
            part_r.data_ptr(), cnt_c.data_ptr(), dL.data_ptr(),
            dR.data_ptr(), loss.data_ptr(), N, M, K, split_r, split_c,
            float(gamma), float(lam), stream(dev))
    raise_on(lib, err, "mf_sgd_block")
    launches["mf_sgd_block"] += 1
    return dL, dR, loss
