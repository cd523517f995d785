"""What every launch wrapper of the port's CUDA kernels shares.

- :data:`launches`, the one launch counter of all kernels: a wrapper adds
  one to its kernel's entry where it launches it, and nowhere else, so a
  run can show that its path went through the kernels (``mf_sgd_block``
  counts one per call: its two passes and the epilogue are one launch of
  the library's entry point; so do ``flash_attention_bwd`` and
  ``ssd_bwd``, three kernels each);
- :func:`load_lib`, the built library of one ``csrc/*.cu`` source with
  its entry points' C signatures declared;
- :func:`check`, the device, dtype, shape and (unless told otherwise)
  contiguity check of one argument;
- :func:`stream`, the caller's current stream as a handle, and
  :func:`raise_on`, which turns a non-zero ``cudaError_t`` into an
  exception.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Launches per kernel since the last reset_launches().
launches = {"ring_view": 0, "vap_suffix_norms": 0, "delta_pack": 0,
            "flash_attention": 0, "flash_attention_bwd": 0, "ssd": 0,
            "ssd_bwd": 0, "mf_sgd_block": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def load_lib(name: str, argtypes: dict, error_fn: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (``build.load`` builds it
    once and caches it); each entry point of ``argtypes`` returns an int
    (a ``cudaError_t``), and ``error_fn`` names its
    ``cudaGetErrorString``."""
    lib = build.load(name)
    if not hasattr(lib, "error_string"):
        for fn, args in argtypes.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, error_fn).argtypes = [ctypes.c_int]
        getattr(lib, error_fn).restype = ctypes.c_char_p
        lib.error_string = getattr(lib, error_fn)
    return lib


def check(name, t, dtype, shape, device, contiguous=True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got "
                         f"{t.device}")


def stream(device) -> int:
    """The current stream of ``device``, as the handle the kernels take."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(lib, err: int, what: str):
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({lib.error_string(err).decode()})")
