"""GQA attention (+qk-norm, sliding window), MLA and cross-attention:
specs, a full-sequence forward through the blocked attention kernel, and
a one-token decode against a ring-buffer cache (cross-attention: against
the memory's K/V, projected once).

The JAX package's ``models/attention.py``, without ``causal_mask``,
which nothing there calls.  Cache layouts: GQA ``{"k": [B, C, Hkv, Dh],
"v": [B, C, Hkv, Dh], "pos": [B] int32}``, MLA ``{"ckv": [B, C, R],
"krope": [B, C, Dr], "pos": [B]}`` (the compressed latent is cached and
decompressed per read), with ``C = min(max_len, window or max_len)``.
Unlike JAX, a cache is updated in place (``index_put_``), so a decode
step or a prefill does not copy the whole cache.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import AttnConfig, MLAConfig
from ..kernels import ops
from ..kernels.ref import acc_dtype
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
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k)
    logits = logits.to(acc_dtype(logits.dtype)) * scale
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
    valid = _ring_valid(a, pos, C)
    out = _sdpa(q, cache["k"], cache["v"], valid[:, None, :],
                1.0 / math.sqrt(q.shape[-1]))
    cache["pos"] = pos + 1
    return _out_proj(out, p["wo"], x.dtype), cache


def _fill_cache(cache, new: dict, positions):
    """Write the last C positions of each ``new[name]`` (``[B, S, ...]``)
    into ``cache[name]``'s ring slots (no sliding rewrap), in place;
    ``pos`` becomes the next position."""
    B, S = positions.shape
    C = cache[next(iter(new))].shape[1]
    take = min(S, C)
    slots = torch.remainder(positions[:, -take:], C).long()
    bidx = torch.arange(B, device=positions.device)[:, None]
    for name, t in new.items():
        cache[name][bidx, slots] = t[:, -take:].to(cache[name].dtype)
    cache["pos"] = positions[:, -1] + 1
    return cache


def gqa_prefill(p, a: AttnConfig, x, positions, cache):
    """`gqa_forward` that also fills the cache (in place): the JAX
    package's ``gqa_prefill_cache`` and ``gqa_forward`` with one q/k/v
    projection where JAX makes two, of the same values."""
    q, k, v = _project_qkv(p, a, x, positions)
    cache = _fill_cache(cache, {"k": k, "v": v}, positions)
    return _attend(p, a, x, q, k, v, positions), cache


# ==========================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# ==========================================================================
def mla_spec(a: AttnConfig, d_model: int, dtype=torch.float32):
    m: MLAConfig = a.mla
    H = a.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": spec((d_model, H, qd), ("embed", "heads", "head_dim"),
                   dtype=dtype),
        "w_dkv": spec((d_model, m.kv_lora_rank), ("embed", "kv_lora"),
                      dtype=dtype),
        "w_krope": spec((d_model, m.qk_rope_head_dim), ("embed", None),
                        dtype=dtype),
        "kv_norm": spec((m.kv_lora_rank,), ("kv_lora",), init="ones",
                        dtype=dtype),
        "w_uk": spec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                     ("kv_lora", "heads", "head_dim"), dtype=dtype),
        "w_uv": spec((m.kv_lora_rank, H, m.v_head_dim),
                     ("kv_lora", "heads", "head_dim"), dtype=dtype),
        "wo": spec((H, m.v_head_dim, d_model), ("heads", "head_dim", "embed"),
                   dtype=dtype),
    }


def _mla_project(p, a: AttnConfig, x, positions):
    m = a.mla
    cdt = x.dtype
    q = _proj(x, p["wq"])                                    # [B,S,H,qd]
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, a.rope_theta)
    ckv = head_rmsnorm(p["kv_norm"], x @ p["w_dkv"].to(cdt))  # [B,S,R]
    krope = x @ p["w_krope"].to(cdt)                          # [B,S,Dr]
    krope = rope(krope[..., None, :], positions, a.rope_theta)[..., 0, :]
    return q_nope, q_rope, ckv, krope


def _absorb_uk(q_nope, w_uk):
    """``einsum("bshk,rhk->bshr")``: W_uk absorbed into the query."""
    return torch.einsum("bshk,rhk->bshr", q_nope, w_uk.to(q_nope.dtype))


def _mla_out(ctx, p, cdt):
    """The latent context [B,S,H,R] through W_uv and W_o -> [B,S,d]."""
    out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"].to(cdt))
    return _out_proj(out, p["wo"], cdt)


def _mla_scale(m: MLAConfig) -> float:
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _mla_attend(p, a: AttnConfig, q_nope, q_rope, ckv, krope, mask):
    """Latent-space attention with plain products and a softmax (the
    decode path, as JAX computes it outside its kernel): scores from the
    W_uk-absorbed query against the latent and the rope keys, values from
    the latent.  ``mask`` [B, S, T]."""
    cdt = q_nope.dtype
    q_lat = _absorb_uk(q_nope, p["w_uk"])
    scores = torch.einsum("bshr,btr->bhst", q_lat, ckv)
    scores = scores + torch.einsum("bshk,btk->bhst", q_rope, krope)
    logits = scores.to(acc_dtype(cdt)) * _mla_scale(a.mla)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(cdt)
    ctx = torch.einsum("bhst,btr->bshr", w, ckv)              # latent context
    return _mla_out(ctx, p, cdt)


def _mla_blocked(p, a: AttnConfig, q_nope, q_rope, ckv, krope, positions):
    """MLA as MQA through the blocked kernel: key ``[c_kv ; k_rope]`` and
    value ``c_kv`` shared by every head, queries ``[W_uk-absorbed q_nope ;
    q_rope]`` (Dk = R + Dr = 576, Dv = R = 512 at published width).  The
    value is passed as the key's first R columns (a view of ``k_cat``), so
    the kernel reads it from its K tiles."""
    cdt = q_nope.dtype
    q_cat = torch.cat([_absorb_uk(q_nope, p["w_uk"]), q_rope], dim=-1)
    k_cat = torch.cat([ckv, krope], dim=-1)[:, :, None, :]
    ctx = ops.attention(q_cat, k_cat, k_cat[..., :ckv.shape[-1]],
                        scale=_mla_scale(a.mla), q_pos=positions,
                        kv_pos=positions, causal=a.causal, window=a.window)
    return _mla_out(ctx, p, cdt)


def mla_forward(p, a: AttnConfig, x, positions):
    """Full-sequence MLA through the blocked kernel; ``positions`` is
    int32 [B, S]."""
    q_nope, q_rope, ckv, krope = _mla_project(p, a, x, positions)
    return _mla_blocked(p, a, q_nope, q_rope, ckv, krope, positions)


def mla_init_cache(a: AttnConfig, batch, max_len, dtype, device):
    m = a.mla
    C = min(max_len, a.window) if a.window else max_len
    return {
        "ckv": torch.zeros((batch, C, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, C, m.qk_rope_head_dim), dtype=dtype,
                             device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _ring_valid(a: AttnConfig, pos, C: int):
    """[B, C] visibility of each ring slot at position ``pos`` [B]: the
    true position of every slot given the ring write pattern."""
    slots = torch.arange(C, dtype=torch.int32, device=pos.device)[None, :]
    wraps = torch.div(pos[:, None] - slots + C, C, rounding_mode="floor")
    slot_pos = slots + wraps * C - C                        # last write position
    slot_pos = torch.where(slot_pos == pos[:, None], pos[:, None], slot_pos)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if a.window:
        valid = valid & (slot_pos > (pos[:, None] - a.window))
    return valid


def mla_decode(p, a: AttnConfig, x, cache):
    """Single-token MLA decode. x: [B,1,d]; returns (out [B,1,d], cache),
    the cache updated in place."""
    B = x.shape[0]
    pos = cache["pos"]
    q_nope, q_rope, ckv, krope = _mla_project(p, a, x, pos[:, None])
    C = cache["ckv"].shape[1]
    slot = torch.remainder(pos, C).long()
    bidx = torch.arange(B, device=x.device)
    cache["ckv"][bidx, slot] = ckv[:, 0].to(cache["ckv"].dtype)
    cache["krope"][bidx, slot] = krope[:, 0].to(cache["krope"].dtype)
    out = _mla_attend(p, a, q_nope, q_rope, cache["ckv"], cache["krope"],
                      _ring_valid(a, pos, C)[:, None, :])
    cache["pos"] = pos + 1
    return out, cache


def mla_prefill(p, a: AttnConfig, x, positions, cache):
    """`mla_forward` that also fills the cache, in place (no sliding
    rewrap: the last C positions land in their ring slots), with one
    projection where JAX's ``mla_prefill_cache`` and ``mla_forward`` make
    two of the same values."""
    q_nope, q_rope, ckv, krope = _mla_project(p, a, x, positions)
    cache = _fill_cache(cache, {"ckv": ckv, "krope": krope}, positions)
    return _mla_blocked(p, a, q_nope, q_rope, ckv, krope, positions), cache


# ==========================================================================
# cross-attention (VLM image layers, enc-dec)
# ==========================================================================
def cross_attn_spec(a: AttnConfig, d_model: int, dtype=torch.float32):
    dh = head_dim(a, d_model)
    return {
        "wq": spec((d_model, a.n_heads, dh), ("embed", "heads", "head_dim"),
                   dtype=dtype),
        "wk": spec((d_model, a.n_kv_heads, dh),
                   ("embed", "kv_heads", "head_dim"), dtype=dtype),
        "wv": spec((d_model, a.n_kv_heads, dh),
                   ("embed", "kv_heads", "head_dim"), dtype=dtype),
        "wo": spec((a.n_heads, dh, d_model), ("heads", "head_dim", "embed"),
                   dtype=dtype),
    }


def cross_attn_kv(p, mem):
    """K/V ``([B,M,Hkv,Dh], [B,M,Hkv,Dh])`` of the encoder or vision
    memory ``mem [B,M,d]``, in its dtype: projected once per layer, then
    cached for the decode steps."""
    return _proj(mem, p["wk"]), _proj(mem, p["wv"])


def cross_attn(p, _a: AttnConfig, x, mem_kv):
    """x ``[B,S,d]`` attends to the precomputed memory K/V, every key
    visible and no positional encoding.

    With more than one query (a prefill) it goes through the blocked
    kernel (``causal=False``, no window: every pair visible); the JAX
    package computes the same function with its plain ``_sdpa``, whose
    logits at llama-3.2-vision's prefill would stand at 3.4 GB in float32
    per tensor.  This follows JAX's function, not its rounding points: in
    bfloat16 ``_sdpa`` rounds the logits to bfloat16 before the softmax,
    the kernel keeps them in float32.  A one-token step (decode) takes
    ``_sdpa``, as ``gqa_decode`` does."""
    k, v = mem_kv
    q = _proj(x, p["wq"])
    B, S = q.shape[:2]
    M = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if S == 1:
        mask = torch.ones((B, S, M), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, scale)
    else:
        def pos(n):
            return torch.arange(n, dtype=torch.int32,
                                device=x.device).expand(B, n).contiguous()
        out = ops.attention(q, k, v, scale=scale, q_pos=pos(S),
                            kv_pos=pos(M), causal=False, window=None)
    return _out_proj(out, p["wo"], x.dtype)
