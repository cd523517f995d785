"""Whisper-style encoder-decoder backbone.

The JAX package's ``models/encdec.py``.  The audio frontend (mel + conv
downsampling) is stubbed: ``frames`` are precomputed frame embeddings
``[B, n_ctx, d_model]`` (``data.synthetic.modality_stub``).  A
non-causal encoder turns them into the memory; a causal decoder
cross-attends to it in every layer.  The decode path runs against the
self-attention caches and the memory's K/V, projected once by the
prefill.  The caches are ``{"self": {"k", "v", "pos"}, "cross_k",
"cross_v"}`` with a leading layers axis, updated in place.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from . import attention as attn_mod
from .layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from .params import spec
from .transformer import (_attn_cache, _attn_decode, _attn_fwd,
                          _attn_prefill, _scan_blocks, _scan_blocks_cache,
                          stack_specs, stacked_zeros)


def encoder_layer_spec(cfg: ModelConfig, dtype):
    return {
        "ln1": rmsnorm_spec(cfg.d_model, dtype),
        "attn": attn_mod.gqa_spec(cfg.attn, cfg.d_model, dtype),
        "ln2": rmsnorm_spec(cfg.d_model, dtype),
        "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def decoder_layer_spec(cfg: ModelConfig, dtype):
    s = encoder_layer_spec(cfg, dtype)
    s["lnx"] = rmsnorm_spec(cfg.d_model, dtype)
    s["xattn"] = attn_mod.cross_attn_spec(cfg.attn, cfg.d_model, dtype)
    return s


def encdec_specs(cfg: ModelConfig, dtype):
    return {
        "enc_pos": spec((cfg.encoder.n_ctx, cfg.d_model), (None, "embed"),
                        init="embed", scale=0.02, dtype=dtype),
        "encoder": stack_specs(cfg.encoder.n_layers,
                               encoder_layer_spec(cfg, dtype)),
        "enc_norm": rmsnorm_spec(cfg.d_model, dtype),
        "decoder": stack_specs(cfg.n_layers, decoder_layer_spec(cfg, dtype)),
    }


def encode(p, cfg: ModelConfig, frames):
    """frames ``[B, n_ctx, d_model]`` (the stub frontend's output, in the
    compute dtype) -> memory: non-causal self-attention at rope positions
    ``arange(n_ctx)``, through the blocked kernel."""
    x = frames + p["enc_pos"].to(frames.dtype)[None]
    a_nc = dataclasses.replace(cfg.attn, causal=False, window=None)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(
        B, S).contiguous()

    def layer(pl, x):
        x = x + attn_mod.gqa_forward(pl["attn"], a_nc,
                                     rmsnorm(pl["ln1"], x, cfg.norm_eps),
                                     positions)
        x = x + mlp(pl["ffn"], rmsnorm(pl["ln2"], x, cfg.norm_eps), cfg.act)
        return x, 0.0

    x, _ = _scan_blocks(layer, p["encoder"], x)
    return rmsnorm(p["enc_norm"], x, cfg.norm_eps)


def _cross_mlp(pl, cfg: ModelConfig, x, mem_kv):
    """A decoder layer after its self-attention: cross-attention to the
    memory's K/V, then the MLP, each a residual."""
    x = x + attn_mod.cross_attn(pl["xattn"], cfg.attn,
                                rmsnorm(pl["lnx"], x, cfg.norm_eps), mem_kv)
    return x + mlp(pl["ffn"], rmsnorm(pl["ln2"], x, cfg.norm_eps), cfg.act)


def decoder_forward(p, cfg: ModelConfig, x, positions, memory):
    """Causal decoder over token embeddings x, cross-attending to
    memory."""
    def layer(pl, x):
        x = x + _attn_fwd(pl["attn"], cfg,
                          rmsnorm(pl["ln1"], x, cfg.norm_eps), positions)
        mem_kv = attn_mod.cross_attn_kv(pl["xattn"], memory)
        return _cross_mlp(pl, cfg, x, mem_kv), 0.0

    x, _ = _scan_blocks(layer, p["decoder"], x)
    return x


def decoder_cache(cfg: ModelConfig, batch, max_len, dtype, device):
    """Zeroed decoder caches with a leading layers axis."""
    memkv = torch.empty((batch, cfg.encoder.n_ctx, cfg.attn.n_kv_heads,
                         cfg.head_dim), dtype=dtype, device="meta")
    one = {"self": _attn_cache(cfg, batch, max_len, dtype, "meta"),
           "cross_k": memkv, "cross_v": memkv}
    return stacked_zeros(one, cfg.n_layers, device)


def decoder_decode_step(p, cfg: ModelConfig, x, caches):
    """One decoder token against the stacked caches (cross K/V
    precomputed), updated in place."""
    def layer(pl, x, cl):
        h, c_new = _attn_decode(pl["attn"], cfg,
                                rmsnorm(pl["ln1"], x, cfg.norm_eps),
                                cl["self"])
        x = _cross_mlp(pl, cfg, x + h, (cl["cross_k"], cl["cross_v"]))
        return x, dict(cl, self=c_new)

    return _scan_blocks_cache(layer, p["decoder"], caches, x)


def decoder_prefill(p, cfg: ModelConfig, x, positions, caches, memory):
    """The decoder on the prompt, filling the self caches (one q/k/v
    projection, where JAX makes two) and the memory's K/V, in place."""
    def layer(pl, x, cl):
        h, c_new = _attn_prefill(pl["attn"], cfg,
                                 rmsnorm(pl["ln1"], x, cfg.norm_eps),
                                 positions, cl["self"])
        mem_k, mem_v = attn_mod.cross_attn_kv(pl["xattn"], memory)
        x = _cross_mlp(pl, cfg, x + h, (mem_k, mem_v))
        return x, dict(cl, self=c_new, cross_k=mem_k, cross_v=mem_v)

    return _scan_blocks_cache(layer, p["decoder"], caches, x)
