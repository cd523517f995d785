"""Shared neural-net building blocks (pure functions + ParamSpec builders).

Every cast sits where the JAX package's ``models/layers.py`` puts it, so
bfloat16 compute rounds at the same points: the norms go up to float32
and back once, ``rope`` computes in float32 and rounds once, a product
``x @ w`` of bfloat16 operands is bfloat16.  The JAX package's sharding
hint ``shd`` has no counterpart on one card and is dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ref import acc_dtype
from .params import spec


def rmsnorm_spec(d, dtype=torch.float32):
    return {"scale": spec((d,), ("embed",), init="ones", dtype=dtype)}


def rmsnorm(p, x, eps=1e-5):
    dt = x.dtype
    xf = x.to(acc_dtype(dt))
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(xf.dtype)).to(dt)


def head_rmsnorm(scale, x, eps=1e-5):
    """qwen3-style per-head q/k norm: x [..., H, Dh], scale [Dh]."""
    dt = x.dtype
    xf = x.to(acc_dtype(dt))
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(xf.dtype)).to(dt)


def rope(x, positions, theta=10000.0):
    """Apply rotary embedding. x: [..., S, H, Dh], positions: [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    ft = acc_dtype(x.dtype)
    expo = torch.arange(0, half, dtype=ft, device=x.device)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which rounds otherwise than JAX's division
    freq = torch.pow(float(theta), -expo / torch.full((), half, dtype=ft,
                                                      device=x.device))
    ang = positions[..., :, None].to(ft) * freq             # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                    # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_spec(d, ff, act="swiglu", dtype=torch.float32):
    if act == "swiglu":
        return {
            "wi_gate": spec((d, ff), ("embed", "mlp"), dtype=dtype),
            "wi_up": spec((d, ff), ("embed", "mlp"), dtype=dtype),
            "wo": spec((ff, d), ("mlp", "embed"), dtype=dtype),
        }
    return {
        "wi": spec((d, ff), ("embed", "mlp"), dtype=dtype),
        "wo": spec((ff, d), ("mlp", "embed"), dtype=dtype),
    }


def mlp(p, x, act="swiglu"):
    """swiglu: ``(silu(x W_gate) * (x W_up)) W_o``; gelu: ``gelu(x W_i)
    W_o`` with the tanh approximation (``jax.nn.gelu``'s default); in x's
    dtype."""
    cdt = x.dtype
    if act == "swiglu":
        h = F.silu(x @ p["wi_gate"].to(cdt)) * (x @ p["wi_up"].to(cdt))
    else:
        h = F.gelu(x @ p["wi"].to(cdt), approximate="tanh")
    return h @ p["wo"].to(cdt)


def embed_spec(vocab, d, dtype=torch.float32):
    return {"embedding": spec((vocab, d), ("vocab", "embed"),
                              init="embed", scale=1.0, dtype=dtype)}


def embed(p, tokens, cdtype):
    # gather the rows first, then cast: the same values as casting the
    # whole table first, without a full-size temporary
    return p["embedding"][tokens].to(cdtype)


def unembed(p, x):
    return x @ p["embedding"].to(x.dtype).T
