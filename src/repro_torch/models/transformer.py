"""Decoder stacks of every family of the JAX package (dense, moe, ssm,
hybrid and vlm; the audio decoder is ``encdec.py``), built from stacked
ParamSpec trees and run layer after layer.

The JAX package's ``models/transformer.py``: its ``lax.scan`` over the
stacked ``layers`` axis is a plain loop here (`_scan_blocks`,
`_scan_blocks_cache`), its ``remat`` (``jax.checkpoint`` of each block)
is ``torch.utils.checkpoint`` of each block of a forward that trains,
and the sharding hints have no counterpart on one card.  A block's
attention is GQA or MLA and its FFN the dense MLP or the MoE layer
(``_attn_*``, ``_ffn_*``).  A hybrid
(Jamba) group is ``attn_every - 1`` mamba sublayers and one attention
sublayer, each followed by an FFN sublayer, dense and MoE in turn.  A VLM
group is ``cross_attn_every - 1`` self-attention blocks and one gated
cross-attention block over the image embeddings.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import mamba2
from . import moe as moe_mod
from .layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from .params import map_specs, spec

# Raised for a family the JAX package does not have either.
NOT_PORTED = "{} is not a family of the JAX package's model zoo"


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


def stacked_zeros(tree, n: int, device):
    """Zeros of every tensor of ``tree`` (a cache, made on ``"meta"``) with
    a leading axis of ``n``, on ``device``."""
    if isinstance(tree, dict):
        return {k: stacked_zeros(v, n, device) for k, v in tree.items()}
    return torch.zeros((n,) + tuple(tree.shape), dtype=tree.dtype,
                       device=device)


def _unbind(tree):
    """The layers of a stacked tree as a list of trees of views: one
    ``torch.unbind`` a leaf, whose backward is one ``stack`` of the
    layers' gradients.  (Indexing layer ``i`` of a leaf that requires grad
    would give each layer's gradient a whole ``[L, ...]`` zero tensor in
    the backward: ``L`` full-size gradients a step.)"""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return torch.unbind(tree, 0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _with_leaves(tree, it):
    if isinstance(tree, dict):
        return {k: _with_leaves(v, it) for k, v in tree.items()}
    return next(it)


def _scan_blocks(block_fn, stacked_params, x, remat: bool = False):
    """Run x through stacked blocks; block_fn(p_layer, x) -> (x, aux).
    Returns x and the blocks' aux losses summed.

    The layers' parameters come from `_unbind`.  With ``remat`` and grad
    enabled, each block runs under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` of the block): its activations are
    recomputed in the backward instead of kept, and the results are the
    same bits."""
    aux = 0.0
    remat = remat and torch.is_grad_enabled()
    for p_i in _unbind(stacked_params):
        if remat:
            leaves = _leaves(p_i)
            x, a = torch.utils.checkpoint.checkpoint(
                lambda x, *ls, p_i=p_i: block_fn(
                    _with_leaves(p_i, iter(ls)), x),
                x, *leaves, use_reentrant=False)
        else:
            x, a = block_fn(p_i, x)
        aux = aux + a
    return x, aux


def _dicts(tree):
    """A copy of the tree's dicts over the same tensors."""
    if isinstance(tree, dict):
        return {k: _dicts(v) for k, v in tree.items()}
    return tree


def _copy_back(views, new):
    """Copy every tensor of ``new`` that is not the view at its path in
    ``views`` into that view."""
    for k, v in new.items():
        if isinstance(v, dict):
            _copy_back(views[k], v)
        elif v is not views[k]:
            views[k].copy_(v)


def _scan_blocks_cache(block_fn, stacked_params, caches, x):
    """Decode/prefill through stacked blocks threading per-layer caches.

    block_fn(p_layer, x, cache_layer) -> (x, new_cache_layer).  A layer's
    cache is a tree of views into the stacked ``caches`` (nested dicts
    allowed: a VLM group's ``"self"`` caches have a second layers axis);
    an entry the block replaces (rather than updating in place) is copied
    back into it."""
    for i in range(n_layers(stacked_params)):
        views = layer(caches, i)
        x, c_new = block_fn(layer(stacked_params, i), x, _dicts(views))
        _copy_back(views, c_new)
    return x, caches


# ---- attention and FFN dispatch -----------------------------------------------
def _attn_spec(cfg: ModelConfig, dtype):
    a = cfg.attn
    if a.mla is not None:
        return attn_mod.mla_spec(a, cfg.d_model, dtype)
    return attn_mod.gqa_spec(a, cfg.d_model, dtype)


def _attn_fwd(p, cfg: ModelConfig, x, positions):
    a = cfg.attn
    if a.mla is not None:
        return attn_mod.mla_forward(p, a, x, positions)
    return attn_mod.gqa_forward(p, a, x, positions)


def _attn_decode(p, cfg: ModelConfig, x, cache):
    a = cfg.attn
    if a.mla is not None:
        return attn_mod.mla_decode(p, a, x, cache)
    return attn_mod.gqa_decode(p, a, x, cache)


def _attn_cache(cfg: ModelConfig, batch, max_len, dtype, device):
    a = cfg.attn
    if a.mla is not None:
        return attn_mod.mla_init_cache(a, batch, max_len, dtype, device)
    return attn_mod.gqa_init_cache(a, cfg.d_model, batch, max_len, dtype,
                                   device)


def _attn_prefill(p, cfg: ModelConfig, x, positions, cache):
    """The attention's output and the cache filled in place: JAX's
    ``_attn_prefill`` and ``_attn_fwd`` with one projection."""
    a = cfg.attn
    if a.mla is not None:
        return attn_mod.mla_prefill(p, a, x, positions, cache)
    return attn_mod.gqa_prefill(p, a, x, positions, cache)


def _ffn_spec(cfg: ModelConfig, dtype, use_moe: bool | None = None):
    """The MoE layer's specs where ``use_moe`` (by default: where the
    config has one), else the dense MLP's."""
    if cfg.moe is not None if use_moe is None else use_moe:
        return moe_mod.moe_spec(cfg.moe, cfg.d_model, dtype)
    return mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype)


def _ffn_fwd(p, cfg: ModelConfig, x, use_moe: bool | None = None):
    """``(y, aux)``: the MoE layer's aux loss, 0.0 for the dense MLP;
    ``use_moe`` as in `_ffn_spec`."""
    if cfg.moe is not None if use_moe is None else use_moe:
        return moe_mod.moe_forward(p, cfg.moe, x)
    return mlp(p, x, cfg.act), 0.0


# ---- standard transformer block (dense or MoE ffn) -----------------------
def block_spec(cfg: ModelConfig, dtype):
    return {
        "ln1": rmsnorm_spec(cfg.d_model, dtype),
        "attn": _attn_spec(cfg, dtype),
        "ln2": rmsnorm_spec(cfg.d_model, dtype),
        "ffn": _ffn_spec(cfg, dtype),
    }


def block_fwd(p, cfg: ModelConfig, x, positions):
    """One block on the full sequence: ``(x, aux)``."""
    x = x + _attn_fwd(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                      positions)
    h, aux = _ffn_fwd(p["ffn"], cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, aux


def block_decode(p, cfg: ModelConfig, x, cache):
    h, cache = _attn_decode(p["attn"], cfg,
                            rmsnorm(p["ln1"], x, cfg.norm_eps), cache)
    x = x + h
    h, _ = _ffn_fwd(p["ffn"], cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, cache


def block_prefill(p, cfg: ModelConfig, x, positions, cache):
    h, cache = _attn_prefill(p["attn"], cfg,
                             rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
                             cache)
    x = x + h
    h, _ = _ffn_fwd(p["ffn"], cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, cache


# ---- mamba block -------------------------------------------------------------
def mamba_block_spec(cfg: ModelConfig, dtype):
    return {
        "ln": rmsnorm_spec(cfg.d_model, dtype),
        "mixer": mamba2.mamba_spec(cfg.mamba, cfg.d_model, dtype),
    }


def mamba_block_fwd(p, cfg: ModelConfig, x):
    return x + mamba2.mamba_forward(p["mixer"], cfg.mamba, cfg.d_model,
                                    rmsnorm(p["ln"], x, cfg.norm_eps)), 0.0


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


# ---- hybrid (Jamba) group -------------------------------------------------
# One group = `attn_every` sublayers: (attn_every - 1) mamba and the
# attention last, each followed by an FFN sublayer, the dense MLP on the
# even sublayer indices and the MoE on the odd ones (Jamba's
# every-other-layer MoE).
def hybrid_group_spec(cfg: ModelConfig, dtype):
    period = cfg.attn_every
    n_moe = period // 2
    return {
        "mamba": stack_specs(period - 1, mamba_block_spec(cfg, dtype)),
        "attn": {
            "ln1": rmsnorm_spec(cfg.d_model, dtype),
            "attn": _attn_spec(cfg, dtype),
        },
        "mlp": stack_specs(period - n_moe, {
            "ln": rmsnorm_spec(cfg.d_model, dtype),
            "ffn": _ffn_spec(cfg, dtype, use_moe=False)}),
        "moe": stack_specs(n_moe, {
            "ln": rmsnorm_spec(cfg.d_model, dtype),
            "ffn": _ffn_spec(cfg, dtype, use_moe=True)}),
    }


def _hybrid_sublayers(cfg: ModelConfig):
    """The group's sublayers in order, as ``((mixer, i), (ffn, j))``:
    the mixer ``"mamba"`` (its ``i``-th) or ``"attn"``, the FFN ``"mlp"``
    or ``"moe"`` (its ``j``-th).  The order of prefill and decode."""
    period = cfg.attn_every
    plan = []
    i_mamba = i_mlp = i_moe = 0
    for i in range(period):
        if i == period - 1:
            mixer = ("attn", 0)
        else:
            mixer = ("mamba", i_mamba)
            i_mamba += 1
        if i % 2 == 1:
            ffn = ("moe", i_moe)
            i_moe += 1
        else:
            ffn = ("mlp", i_mlp)
            i_mlp += 1
        plan.append((mixer, ffn))
    return plan


def _hybrid_forward_order(cfg: ModelConfig):
    """The JAX package's forward order: ``attn_every // 2 - 1`` pairs
    (mamba + mlp, mamba + moe), then mamba + mlp and attn + moe.  It is
    `_hybrid_sublayers` at an even ``attn_every``; at an odd one it skips
    mamba sublayer ``attn_every - 2`` and the last MLP, and puts the MoE
    after the attention, as the JAX forward does."""
    n_pairs = cfg.attn_every // 2 - 1
    plan = []
    for i in range(n_pairs):
        plan += [(("mamba", 2 * i), ("mlp", i)),
                 (("mamba", 2 * i + 1), ("moe", i))]
    return plan + [(("mamba", 2 * n_pairs), ("mlp", n_pairs)),
                   (("attn", 0), ("moe", n_pairs))]


def _hybrid_ffn(p, cfg: ModelConfig, x, ffn):
    """``x`` plus the FFN sublayer ``ffn`` (``(kind, j)``), and its aux."""
    kind, j = ffn
    pf = layer(p[kind], j)
    h, aux = _ffn_fwd(pf["ffn"], cfg, rmsnorm(pf["ln"], x, cfg.norm_eps),
                      use_moe=kind == "moe")
    return x + h, aux


def hybrid_group_fwd(p, cfg: ModelConfig, x, positions):
    """One group on the full sequence, in `_hybrid_forward_order`:
    ``(x, aux)``."""
    aux = 0.0
    for (mixer, i), ffn in _hybrid_forward_order(cfg):
        if mixer == "mamba":
            x, _ = mamba_block_fwd(layer(p["mamba"], i), cfg, x)
        else:
            pa = p["attn"]
            x = x + _attn_fwd(pa["attn"], cfg,
                              rmsnorm(pa["ln1"], x, cfg.norm_eps), positions)
        x, a = _hybrid_ffn(p, cfg, x, ffn)
        aux = aux + a
    return x, aux


def hybrid_group_cache(cfg: ModelConfig, batch, max_len, dtype, device):
    """One group's zeroed caches: the mamba sublayers' stacked on a
    leading axis, and the attention's."""
    m = mamba2.mamba_init_cache(cfg.mamba, cfg.d_model, batch, dtype, "meta")
    return {"mamba": stacked_zeros(m, cfg.attn_every - 1, device),
            "attn": _attn_cache(cfg, batch, max_len, dtype, device)}


def _hybrid_cached(p, cfg: ModelConfig, x, cache, mamba_fn, attn_fn):
    """The group's sublayers in `_hybrid_sublayers` order over its cache:
    ``mamba_fn(p_i, x, cache_i) -> (x, cache_i)`` (the new cache copied
    into the stacked one), ``attn_fn(p_attn, xn, cache) -> (h, cache)``."""
    for (mixer, i), ffn in _hybrid_sublayers(cfg):
        if mixer == "mamba":
            views = layer(cache["mamba"], i)
            x, c = mamba_fn(layer(p["mamba"], i), x, _dicts(views))
            _copy_back(views, c)
        else:
            pa = p["attn"]
            h, ca = attn_fn(pa["attn"], rmsnorm(pa["ln1"], x, cfg.norm_eps),
                            cache["attn"])
            cache = dict(cache, attn=ca)
            x = x + h
        x, _ = _hybrid_ffn(p, cfg, x, ffn)
    return x, cache


def hybrid_group_decode(p, cfg: ModelConfig, x, cache):
    return _hybrid_cached(
        p, cfg, x, cache,
        lambda pm, x, c: mamba_block_decode(pm, cfg, x, c),
        lambda pa, xn, c: _attn_decode(pa, cfg, xn, c))


def hybrid_group_prefill(p, cfg: ModelConfig, x, positions, cache):
    """The group on the prompt, filling the attention's KV cache and the
    mamba sublayers' conv windows and SSM states: one projection each,
    where JAX makes two."""
    return _hybrid_cached(
        p, cfg, x, cache,
        lambda pm, x, c: mamba_block_prefill(pm, cfg, x, positions, c),
        lambda pa, xn, c: _attn_prefill(pa, cfg, xn, positions, c))


# ---- VLM group (Llama-3.2-Vision style) -----------------------------------
def vlm_group_spec(cfg: ModelConfig, dtype):
    n_self = cfg.vision.cross_attn_every - 1
    return {
        "self": stack_specs(n_self, block_spec(cfg, dtype)),
        "cross": {
            "ln1": rmsnorm_spec(cfg.d_model, dtype),
            "xattn": attn_mod.cross_attn_spec(cfg.attn, cfg.d_model, dtype),
            "gate": spec((1,), (None,), init="zeros", dtype=dtype),
            "ln2": rmsnorm_spec(cfg.d_model, dtype),
            "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype),
        },
    }


def _vlm_cross(pc, cfg: ModelConfig, x, mem_kv):
    """The gated cross-attention block: ``x + tanh(gate) * xattn(x)``,
    then the MLP."""
    h = attn_mod.cross_attn(pc["xattn"], cfg.attn,
                            rmsnorm(pc["ln1"], x, cfg.norm_eps), mem_kv)
    x = x + torch.tanh(pc["gate"].to(x.dtype)) * h
    return x + mlp(pc["ffn"], rmsnorm(pc["ln2"], x, cfg.norm_eps), cfg.act)


def vlm_group_fwd(p, cfg: ModelConfig, x, positions, image_embeds):
    """One group on the full sequence: ``(x, aux)``."""
    x, aux = _scan_blocks(lambda pl, x: block_fwd(pl, cfg, x, positions),
                          p["self"], x)
    pc = p["cross"]
    mem_kv = attn_mod.cross_attn_kv(pc["xattn"], image_embeds)
    return _vlm_cross(pc, cfg, x, mem_kv), aux


def vlm_group_cache(cfg: ModelConfig, batch, max_len, dtype, device):
    """One group's zeroed caches: the self blocks' stacked on a leading
    axis, and the image memory's K/V."""
    a = _attn_cache(cfg, batch, max_len, dtype, "meta")
    memkv = (batch, cfg.vision.n_image_tokens, cfg.attn.n_kv_heads,
             cfg.head_dim)
    return {"self": stacked_zeros(a, cfg.vision.cross_attn_every - 1,
                                  device),
            "cross_k": torch.zeros(memkv, dtype=dtype, device=device),
            "cross_v": torch.zeros(memkv, dtype=dtype, device=device)}


def vlm_group_decode(p, cfg: ModelConfig, x, cache):
    x, new_self = _scan_blocks_cache(
        lambda pl, x, c: block_decode(pl, cfg, x, c), p["self"],
        cache["self"], x)
    x = _vlm_cross(p["cross"], cfg, x, (cache["cross_k"], cache["cross_v"]))
    return x, dict(cache, self=new_self)


def vlm_group_prefill(p, cfg: ModelConfig, x, positions, cache,
                      image_embeds):
    """The group on the prompt, filling its caches: the self blocks'
    (one q/k/v projection each, where JAX makes two) and the image
    memory's K/V."""
    x, new_self = _scan_blocks_cache(
        lambda pl, x, c: block_prefill(pl, cfg, x, positions, c), p["self"],
        cache["self"], x)
    pc = p["cross"]
    mem_k, mem_v = attn_mod.cross_attn_kv(pc["xattn"], image_embeds)
    x = _vlm_cross(pc, cfg, x, (mem_k, mem_v))
    return x, dict(cache, self=new_self, cross_k=mem_k, cross_v=mem_v)
