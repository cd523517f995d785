"""Checkpointing: a state tree to and from ``.npz`` with path-encoded keys.

The port of ``repro/checkpoint/io.py``, with its file layout: one array
per leaf under the leaf's path name (``utils.tree.named_leaves``:
``.clock``, ``.uring``, ``.local/ii``, ``.comm/acc``), bfloat16 leaves
stored as float32 under ``name||bf16``.  ``save_runtime`` /
``restore_runtime`` round-trip the sharded runtime's mid-run `PSState`
(``psrun.runtime``): the clock, the base, the update ring, the
per-channel clocks, the worker locals, the rng key and the comm state
with, under a lossy wire, the whole ARQ state.  Restoring and continuing
with ``run_from`` reproduces the uninterrupted run bit for bit, because
the state is everything the clock step carries.

The state's rng key is stored as the JAX package's ``uint32 [2]`` (the
port keeps it in int64 words) and its clock as an int32 scalar, so a
file written by the JAX package's ``save_runtime`` restores in the port
with equal leaves, and the other way round, wherever the two runtimes
share the padded layout (one model shard: ``dpad == d``).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..utils.tree import flatten_path, named_leaves

_SEP = "||"


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().float().cpu().numpy(), True
        return leaf.detach().cpu().numpy(), False
    return np.asarray(leaf), False


def save(path: str, tree) -> None:
    """Save a state tree of tensors and numbers to ``path`` (.npz)."""
    flat = {}
    for name, leaf in named_leaves(tree):
        arr, bf16 = _host(leaf)
        flat[name + _SEP + "bf16" if bf16 else name] = arr
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def restore(path: str, like):
    """Restore into the structure of ``like``: each tensor leaf comes back
    with ``like``'s dtype on ``like``'s device, each number as a number."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    return _rebuild(like, (), arrays)


def _rebuild(like, path, arrays):
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), path + (f".{f.name}",),
                             arrays)
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _rebuild(v, path + (k,), arrays) for k, v in like.items()}
    name = flatten_path(path)
    if name in arrays:
        arr = arrays[name]
    elif name + _SEP + "bf16" in arrays:
        arr = arrays[name + _SEP + "bf16"]
    else:
        raise KeyError(f"checkpoint missing {name}")
    want = tuple(getattr(like, "shape", ()))
    if tuple(arr.shape) != want:
        raise ValueError(f"{name}: shape {arr.shape} != {want}")
    if isinstance(like, torch.Tensor):
        host = (torch.float32 if like.dtype == torch.bfloat16
                else like.dtype)
        np_dtype = torch.empty((), dtype=host).numpy().dtype
        return torch.from_numpy(np.array(arr, dtype=np_dtype)).to(
            device=like.device, dtype=like.dtype)
    return type(like)(arr.item())                      # a number


def save_runtime(path: str, state) -> None:
    """Save a mid-run `PSState` (psrun or pods runtime) to ``path``: every
    leaf the clock step carries, the key as the JAX package's uint32 pair
    and the clock as an int32 scalar."""
    save(path, dataclasses.replace(
        state, clock=np.int32(state.clock),
        rng=state.rng.detach().cpu().numpy().astype(np.uint32)))


def restore_runtime(path: str, like):
    """Restore a `PSState` saved by :func:`save_runtime` (by either
    package).  ``like`` gives the structure, dtypes and device: use
    ``runtime.init_state(app, cfg)`` (any seed: every leaf is
    overwritten).  Continuing with ``runtime.run_from`` reproduces the
    uninterrupted run bit for bit."""
    return restore(path, like)
