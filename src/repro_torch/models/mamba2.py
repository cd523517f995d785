"""Mamba-2 block (SSD — state-space duality form, arXiv:2405.21060).

Forward path: in_proj -> short causal conv (x, B, C streams) -> SSD scan
(chunked dual form; the CUDA ``ssd`` kernel on the card) -> gated RMSNorm
-> out_proj.  Decode path: a one-token recurrence with the carried conv
window and SSM state.  The JAX package's ``models/mamba2.py``.

Cache layout: {"conv": [B, W-1, d_conv], "ssm": [B, H, P, N], "pos": [B]}.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import MambaConfig
from ..kernels import ops
from ..kernels.ref import acc_dtype
from .params import spec


def dims(cfg: MambaConfig, d_model: int):
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.headdim
    n_groups = max(1, n_heads // 8)  # B/C groups
    d_conv = d_inner + 2 * n_groups * cfg.d_state
    return d_inner, n_heads, n_groups, d_conv


def mamba_spec(cfg: MambaConfig, d_model: int, dtype=torch.float32):
    d_inner, H, G, d_conv = dims(cfg, d_model)
    return {
        # projections for [z (gate), x, B, C, dt]
        "in_proj": spec((d_model, 2 * d_inner + 2 * G * cfg.d_state + H),
                        ("embed", "mlp"), dtype=dtype),
        "conv_w": spec((cfg.conv_width, d_conv), (None, "mlp"),
                       scale=0.3, dtype=dtype),
        "conv_b": spec((d_conv,), ("mlp",), init="zeros", dtype=dtype),
        "a_log": spec((H,), ("heads",), init="ones", dtype=torch.float32),
        "dt_bias": spec((H,), ("heads",), init="zeros", dtype=torch.float32),
        "d_skip": spec((H,), ("heads",), init="ones", dtype=torch.float32),
        "norm_scale": spec((d_inner,), ("mlp",), init="ones", dtype=dtype),
        "out_proj": spec((d_inner, d_model), ("mlp", "embed"), dtype=dtype),
    }


def _split(cfg: MambaConfig, d_model: int, zxbcdt):
    d_inner, H, G, _ = dims(cfg, d_model)
    n = cfg.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, G * n, G * n, H], dim=-1)


def _gated_norm(p, y, z, eps=1e-5):
    """Mamba-2's RMSNorm(y * silu(z)) with learned scale."""
    h = y * F.silu(z)
    hf = h.to(acc_dtype(h.dtype))
    var = torch.mean(torch.square(hf), dim=-1, keepdim=True)
    out = hf * torch.rsqrt(var + eps) * p["norm_scale"].to(hf.dtype)
    return out.to(y.dtype)


def conv_ssd(p, cfg: MambaConfig, d_model: int, x):
    """The forward up to and through the SSD scan: returns
    ``(y [B,S,d_inner] before the gated norm, z, state, xbc)`` with xbc the
    pre-conv activations (the decode cache's conv window)."""
    B, S, _ = x.shape
    d_inner, H, G, d_conv = dims(cfg, d_model)
    n = cfg.d_state
    cdt = x.dtype

    zxbcdt = x @ p["in_proj"].to(cdt)
    z, xin, Braw, Craw, dt = _split(cfg, d_model, zxbcdt)

    # short causal conv over the (x, B, C) streams
    xbc = torch.cat([xin, Braw, Craw], dim=-1)              # [B,S,d_conv]
    w = p["conv_w"].to(cdt)                                  # [W, d_conv]
    pad = cfg.conv_width - 1
    xbc_p = F.pad(xbc, (0, 0, pad, 0))
    conv = xbc_p[:, 0:S] * w[0]
    for i in range(1, cfg.conv_width):
        conv = conv + xbc_p[:, i:i + S] * w[i]
    conv = F.silu(conv + p["conv_b"].to(cdt))
    xin, Braw, Craw = torch.split(conv, [d_inner, G * n, G * n], dim=-1)

    xh = xin.reshape(B, S, H, cfg.headdim)
    Bm = Braw.reshape(B, S, G, n)
    Cm = Craw.reshape(B, S, G, n)
    dt = F.softplus(dt.to(acc_dtype(cdt)) + p["dt_bias"])    # [B,S,H]
    A = -torch.exp(p["a_log"])                               # [H], negative

    y, state = ops.ssd(xh.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                       Cm.contiguous(), chunk=cfg.chunk)
    y = y + p["d_skip"].to(cdt)[None, None, :, None] * xh
    return y.reshape(B, S, d_inner), z, state, xbc


def mamba_forward(p, cfg: MambaConfig, d_model: int, x):
    """x [B, S, d_model] -> [B, S, d_model]; any S (the SSD scan masks a
    ragged last chunk)."""
    y, z, _, _ = conv_ssd(p, cfg, d_model, x)
    return _gated_norm(p, y, z) @ p["out_proj"].to(x.dtype)


def mamba_init_cache(cfg: MambaConfig, d_model: int, batch: int, dtype,
                     device):
    d_inner, H, G, d_conv = dims(cfg, d_model)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_conv), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, cfg.headdim, cfg.d_state), dtype=dtype,
                           device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mamba_decode(p, cfg: MambaConfig, d_model: int, x, cache):
    """Single-token recurrent step. x [B,1,d_model]."""
    B = x.shape[0]
    d_inner, H, G, d_conv = dims(cfg, d_model)
    n = cfg.d_state
    cdt = x.dtype

    zxbcdt = x[:, 0] @ p["in_proj"].to(cdt)
    z, xin, Braw, Craw, dt = _split(cfg, d_model, zxbcdt)

    xbc = torch.cat([xin, Braw, Craw], dim=-1)              # [B, d_conv]
    hist = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # [B,W,d_conv]
    w = p["conv_w"].to(cdt)
    conv = torch.einsum("bwd,wd->bd", hist, w)
    conv = F.silu(conv + p["conv_b"].to(cdt))
    xin, Braw, Craw = torch.split(conv, [d_inner, G * n, G * n], dim=-1)

    xh = xin.reshape(B, H, cfg.headdim)
    Bm = Braw.reshape(B, G, n)
    Cm = Craw.reshape(B, G, n)
    dt = F.softplus(dt.to(acc_dtype(cdt)) + p["dt_bias"])    # [B,H]
    A = -torch.exp(p["a_log"])

    y, ssm = ops.ssd_decode(xh, dt, A, Bm, Cm, cache["ssm"])
    y = y + p["d_skip"].to(cdt)[None, :, None] * xh
    y = y.reshape(B, d_inner).to(cdt)
    y = _gated_norm(p, y, z)
    out = (y @ p["out_proj"].to(cdt))[:, None]
    new_cache = {"conv": hist[:, 1:].to(cache["conv"].dtype),
                 "ssm": ssm.to(cache["ssm"].dtype),
                 "pos": cache["pos"] + 1}
    return out, new_cache
