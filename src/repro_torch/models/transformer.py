"""Decoder stacks of the ported families (dense and ssm), built from
stacked ParamSpec trees and run layer after layer.

The JAX package's ``models/transformer.py``: its ``lax.scan`` over the
stacked ``layers`` axis is a plain loop here (`_scan_blocks`,
`_scan_blocks_cache`), and ``remat`` has no counterpart in serving.  The
MoE FFN, the hybrid (Jamba) groups and the VLM groups raise
``NotImplementedError`` (ROADMAP queue 1, item 16).
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import mamba2
from .layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from .params import map_specs

NOT_PORTED = ("{} is not ported yet (ROADMAP queue 1, item 16: the MoE "
              "FFN, MLA, hybrid, VLM and audio families)")


def stack_specs(n: int, tree):
    """Prepend a ``layers`` axis of size n to every spec in the tree."""
    return map_specs(lambda _p, ps: dataclasses.replace(
        ps, shape=(n,) + ps.shape, axes=("layers",) + ps.axes), tree)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _scan_blocks(block_fn, stacked_params, x):
    """Run x through stacked blocks; block_fn(p_layer, x) -> x."""
    for i in range(n_layers(stacked_params)):
        x = block_fn(layer(stacked_params, i), x)
    return x


def _scan_blocks_cache(block_fn, stacked_params, caches, x):
    """Decode/prefill through stacked blocks threading per-layer caches.

    block_fn(p_layer, x, cache_layer) -> (x, new_cache_layer).  A layer's
    cache is a view into the stacked ``caches``; an entry the block
    replaces (rather than updating in place) is copied back into it."""
    for i in range(n_layers(stacked_params)):
        views = {k: v[i] for k, v in caches.items()}
        x, c_new = block_fn(layer(stacked_params, i), x, dict(views))
        for k, v in c_new.items():
            if v is not views[k]:
                views[k].copy_(v)
    return x, caches


def _check_attn(cfg: ModelConfig):
    if cfg.attn.mla is not None:
        raise NotImplementedError(NOT_PORTED.format("MLA"))


# ---- standard transformer block (dense ffn) --------------------------------
def block_spec(cfg: ModelConfig, dtype):
    if cfg.moe is not None:
        raise NotImplementedError(NOT_PORTED.format("the MoE FFN"))
    _check_attn(cfg)
    return {
        "ln1": rmsnorm_spec(cfg.d_model, dtype),
        "attn": attn_mod.gqa_spec(cfg.attn, cfg.d_model, dtype),
        "ln2": rmsnorm_spec(cfg.d_model, dtype),
        "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def block_fwd(p, cfg: ModelConfig, x, positions):
    x = x + attn_mod.gqa_forward(p["attn"], cfg.attn,
                                 rmsnorm(p["ln1"], x, cfg.norm_eps), positions)
    return x + mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def block_decode(p, cfg: ModelConfig, x, cache):
    h, cache = attn_mod.gqa_decode(p["attn"], cfg.attn,
                                   rmsnorm(p["ln1"], x, cfg.norm_eps), cache)
    x = x + h
    return x + mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps)), cache


def block_prefill(p, cfg: ModelConfig, x, positions, cache):
    h, cache = attn_mod.gqa_prefill(p["attn"], cfg.attn,
                                    rmsnorm(p["ln1"], x, cfg.norm_eps),
                                    positions, cache)
    x = x + h
    return x + mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps)), cache


# ---- mamba block -------------------------------------------------------------
def mamba_block_spec(cfg: ModelConfig, dtype):
    return {
        "ln": rmsnorm_spec(cfg.d_model, dtype),
        "mixer": mamba2.mamba_spec(cfg.mamba, cfg.d_model, dtype),
    }


def mamba_block_fwd(p, cfg: ModelConfig, x):
    return x + mamba2.mamba_forward(p["mixer"], cfg.mamba, cfg.d_model,
                                    rmsnorm(p["ln"], x, cfg.norm_eps))


def mamba_block_decode(p, cfg: ModelConfig, x, cache):
    h, cache = mamba2.mamba_decode(p["mixer"], cfg.mamba, cfg.d_model,
                                   rmsnorm(p["ln"], x, cfg.norm_eps), cache)
    return x + h, cache


def _mamba_forward_with_state(p, cfg: ModelConfig, x):
    """mamba_forward that also returns the final SSM state (in x's dtype)
    and, in the same pass, what the JAX package's ``_mamba_conv_tail``
    computes again: the last ``conv_width - 1`` pre-conv activations."""
    m = cfg.mamba
    y, z, state, xbc = mamba2.conv_ssd(p, m, cfg.d_model, x)
    out = mamba2._gated_norm(p, y, z) @ p["out_proj"].to(x.dtype)
    return out, state.to(x.dtype), xbc[:, -(m.conv_width - 1):]


def mamba_block_prefill(p, cfg: ModelConfig, x, positions, cache):
    h, state, conv = _mamba_forward_with_state(
        p["mixer"], cfg, rmsnorm(p["ln"], x, cfg.norm_eps))
    cache = dict(cache, conv=conv, ssm=state, pos=positions[:, -1] + 1)
    return x + h, cache
