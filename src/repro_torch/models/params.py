"""Parameter-spec trees: one source of truth for init and shapes.

A model is described by a nested dict of `ParamSpec`s (the JAX package's
``models/params.py``, without its sharding helpers: the port runs on one
card).  `init_params` materializes a tree of tensors, drawing each leaf
from ``repro_torch.rng`` under the key ``fold_in(rng, crc(path))``, as the
JAX package does; the draws agree with JAX's to a few ulp (see
``rng.truncated_normal``), and the tests carry JAX's weights across
instead (``convert.model_params_from_jax``).
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

from .. import rng as trng

Axes = tuple  # tuple[str | None, ...]


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple
    axes: Axes                    # logical axis name per dim (None = replicated)
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # stddev override; default fan-in scaled
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")


def spec(shape, axes, init="normal", scale=None,
         dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, scale,
                     dtype)


def _fan_in(shape) -> int:
    # last-but-one dim heuristic: weights are [..., in, out]
    return int(shape[-2]) if len(shape) >= 2 else int(shape[-1])


def _init_one(ps: ParamSpec, key) -> torch.Tensor:
    dev = key.device
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=ps.dtype, device=dev)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=ps.dtype, device=dev)
    # each leaf drawn in float32, scaled and rounded to its dtype a chunk
    # at a time straight into the output (qwen3-moe's wi_gate, 9.66 B
    # values, would stand at 38.7 GB as one float32 draw)
    if ps.init == "embed":
        std = ps.scale if ps.scale is not None else 1.0
        return trng.normal(key, ps.shape, scale=std, dtype=ps.dtype)
    # normal / scaled: truncated-normal, fan-in scaled
    std = (ps.scale if ps.scale is not None
           else 1.0 / math.sqrt(max(1, _fan_in(ps.shape))))
    return trng.truncated_normal(key, -2.0, 2.0, ps.shape, scale=std,
                                 dtype=ps.dtype)


def map_specs(fn: Callable[[str, ParamSpec], Any], tree, prefix=""):
    """Apply ``fn(path, spec)`` to every leaf; paths are ``/a/b/c``."""
    if isinstance(tree, ParamSpec):
        return fn(prefix, tree)
    if isinstance(tree, Mapping):
        return {k: map_specs(fn, v, f"{prefix}/{k}") for k, v in tree.items()}
    raise TypeError(f"unexpected node at {prefix}: {type(tree)}")


def path_crc(path: str) -> int:
    return zlib.crc32(path.encode()) & 0x7FFFFFFF


def init_params(specs, key):
    """Materialize a spec tree on ``key``'s device; the key is folded per
    path for determinism."""
    return map_specs(lambda path, ps: _init_one(
        ps, trng.fold_in(key, path_crc(path))), specs)


def param_count(specs) -> int:
    total = 0

    def count(_path, ps):
        nonlocal total
        total += math.prod(ps.shape)
    map_specs(count, specs)
    return total
