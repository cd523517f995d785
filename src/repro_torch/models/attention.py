"""GQA attention (+qk-norm, sliding window): specs, a full-sequence forward
through the blocked attention kernel, and a one-token decode against a
ring-buffer KV cache.

The JAX package's ``models/attention.py``, GQA part; MLA and
cross-attention wait for the families that use them (ROADMAP queue 1,
item 16), and so does ``causal_mask``, which only they use.  Cache
layout: ``{"k": [B, C, Hkv, Dh], "v": [B, C, Hkv, Dh], "pos": [B]
int32}`` with ``C = min(max_len, window or max_len)``.  Unlike
JAX, the cache is updated in place (``index_put_``), so a decode step or
a prefill does not copy the whole cache.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import AttnConfig
from ..kernels import ops
from .layers import head_rmsnorm, rope
from .params import spec

NEG_INF = -1e30


def _sdpa(q, k, v, mask, scale):
    """q [B,Sq,H,Dh], k/v [B,Sk,Hkv,Dh] with GQA head repetition; the
    logits are rounded to q's dtype before the float32 softmax, as the
    JAX package's einsum does."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, Dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * scale
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(B, Sq, H, Dh)


def head_dim(a: AttnConfig, d_model: int) -> int:
    return a.head_dim if a.head_dim is not None else d_model // a.n_heads


def gqa_spec(a: AttnConfig, d_model: int, dtype=torch.float32):
    dh = head_dim(a, d_model)
    p = {
        "wq": spec((d_model, a.n_heads, dh), ("embed", "heads", "head_dim"),
                   dtype=dtype),
        "wk": spec((d_model, a.n_kv_heads, dh),
                   ("embed", "kv_heads", "head_dim"), dtype=dtype),
        "wv": spec((d_model, a.n_kv_heads, dh),
                   ("embed", "kv_heads", "head_dim"), dtype=dtype),
        "wo": spec((a.n_heads, dh, d_model), ("heads", "head_dim", "embed"),
                   dtype=dtype),
    }
    if a.qk_norm:
        p["q_norm"] = spec((dh,), ("head_dim",), init="ones", dtype=dtype)
        p["k_norm"] = spec((dh,), ("head_dim",), init="ones", dtype=dtype)
    return p


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` in x's dtype."""
    d, heads, dh = w.shape
    return (x @ w.to(x.dtype).reshape(d, heads * dh)).unflatten(-1,
                                                                (heads, dh))


def _out_proj(o, w, dtype):
    """``einsum("bshk,hkd->bsd")`` in ``dtype``."""
    heads, dh, d = w.shape
    return o.flatten(-2) @ w.to(dtype).reshape(heads * dh, d)


def _project_qkv(p, a: AttnConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if a.qk_norm:
        q = head_rmsnorm(p["q_norm"], q)
        k = head_rmsnorm(p["k_norm"], k)
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)
    return q, k, v


def _attend(p, a: AttnConfig, x, q, k, v, positions):
    out = ops.attention(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]),
                        q_pos=positions, kv_pos=positions, causal=a.causal,
                        window=a.window)
    return _out_proj(out, p["wo"], x.dtype)


def gqa_forward(p, a: AttnConfig, x, positions):
    """Full-sequence attention through the blocked kernel (never
    materializes S x S logits); ``positions`` is int32 [B, S]."""
    q, k, v = _project_qkv(p, a, x, positions)
    return _attend(p, a, x, q, k, v, positions)


def gqa_init_cache(a: AttnConfig, d_model, batch, max_len, dtype, device):
    dh = head_dim(a, d_model)
    C = min(max_len, a.window) if a.window else max_len
    return {"k": torch.zeros((batch, C, a.n_kv_heads, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, C, a.n_kv_heads, dh), dtype=dtype,
                             device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def gqa_decode(p, a: AttnConfig, x, cache):
    """Single-token decode. x: [B,1,d]; returns (out [B,1,d], cache), the
    cache updated in place.

    The cache is a ring buffer of size C (= window when sliding): slot
    ``pos % C`` is overwritten; visibility is decided by true positions.
    """
    B = x.shape[0]
    pos = cache["pos"]                                     # [B]
    q, k, v = _project_qkv(p, a, x, pos[:, None])
    C = cache["k"].shape[1]
    slot = torch.remainder(pos, C).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    # true position of every cache slot given the ring write pattern
    slots = torch.arange(C, dtype=torch.int32, device=x.device)[None, :]
    wraps = torch.div(pos[:, None] - slots + C, C, rounding_mode="floor")
    slot_pos = slots + wraps * C - C                        # last write position
    slot_pos = torch.where(slot_pos == pos[:, None], pos[:, None], slot_pos)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if a.window:
        valid = valid & (slot_pos > (pos[:, None] - a.window))
    out = _sdpa(q, cache["k"], cache["v"], valid[:, None, :],
                1.0 / math.sqrt(q.shape[-1]))
    cache["pos"] = pos + 1
    return _out_proj(out, p["wo"], x.dtype), cache


def _fill_cache(cache, k, v, positions):
    """Write the last C positions' K/V into their ring slots (no sliding
    rewrap), in place; ``pos`` becomes the next position."""
    B, S = positions.shape
    C = cache["k"].shape[1]
    take = min(S, C)
    slots = torch.remainder(positions[:, -take:], C).long()
    bidx = torch.arange(B, device=k.device)[:, None]
    cache["k"][bidx, slots] = k[:, -take:].to(cache["k"].dtype)
    cache["v"][bidx, slots] = v[:, -take:].to(cache["v"].dtype)
    cache["pos"] = positions[:, -1] + 1
    return cache


def gqa_prefill(p, a: AttnConfig, x, positions, cache):
    """`gqa_forward` that also fills the cache (in place): the JAX
    package's ``gqa_prefill_cache`` and ``gqa_forward`` with one q/k/v
    projection where JAX makes two, of the same values."""
    q, k, v = _project_qkv(p, a, x, positions)
    cache = _fill_cache(cache, k, v, positions)
    return _attend(p, a, x, q, k, v, positions), cache
