"""Top-level model API: specs, forward, prefill and decode for every
family of the JAX package (dense, moe, ssm, hybrid, vlm and audio).

`build_model(cfg, seed, device)` returns a `Model`, an ``nn.Module`` whose
parameters keep the JAX parameter tree's paths with ``.`` for ``/`` and
the stacked leading ``layers`` axis (``blocks.attn.wq`` is
``[L, d, H, Dh]``), so carrying JAX weights across is a copy name for
name (``convert.model_params_from_jax``).  Its methods take token tensors
(``[B, S]`` for ``forward``/``prefill``, ``[B, 1]`` for ``decode_step``)
instead of the JAX package's batch dicts, and the modality stubs as
keywords: ``frames`` ``[B, n_ctx, d]`` for the audio family,
``image_embeds`` ``[B, n_image_tokens, d]`` for the vlm family (cast to
the compute dtype, as JAX does).  Caches are (nested) dicts of tensors
with a leading layers axis (groups, for the hybrid and vlm families;
a group's mamba sublayers, or a VLM group's self blocks, add a second),
updated in place; a decode step reads the memory's K/V from them.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import rng
from ..configs.base import ModelConfig
from ..device import resolve_device
from . import encdec, mamba2
from . import transformer as tf
from .layers import embed, embed_spec, rmsnorm, rmsnorm_spec, unembed
from .params import init_params, param_count, spec

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the modality stub each family takes, by its keyword
MEMORY = {"audio": "frames", "vlm": "image_embeds"}


def _n_outer(cfg: ModelConfig) -> int:
    """The length of the stacked ``blocks`` axis: groups for hybrid and
    vlm."""
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.attn_every == 0
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "vlm":
        assert cfg.n_layers % cfg.vision.cross_attn_every == 0
        return cfg.n_layers // cfg.vision.cross_attn_every
    return cfg.n_layers


def model_specs(cfg: ModelConfig):
    """The parameter-spec tree of ``cfg`` (the JAX ``build_model``'s)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(tf.NOT_PORTED.format(
            f"the {cfg.family!r} family"))
    dtype = cfg.pdtype
    n_outer = _n_outer(cfg)
    if cfg.family == "audio":
        body = encdec.encdec_specs(cfg, dtype)
    elif cfg.family == "hybrid":
        body = {"blocks": tf.stack_specs(n_outer,
                                         tf.hybrid_group_spec(cfg, dtype))}
    elif cfg.family == "vlm":
        body = {"blocks": tf.stack_specs(n_outer,
                                         tf.vlm_group_spec(cfg, dtype))}
    elif cfg.family == "ssm":
        body = {"blocks": tf.stack_specs(n_outer,
                                         tf.mamba_block_spec(cfg, dtype))}
    else:
        body = {"blocks": tf.stack_specs(n_outer, tf.block_spec(cfg, dtype))}
    specs = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model, dtype),
        **body,
        "final_norm": rmsnorm_spec(cfg.d_model, dtype),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = spec((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), dtype=dtype)
    return specs


def _module(tree) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _tree(m: nn.Module) -> dict:
    out = {k: _tree(c) for k, c in m.named_children()}
    out.update(m.named_parameters(recurse=False))
    return out


class Model(nn.Module):
    """A served model of a ported family (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.param_specs = model_specs(cfg)
        for k, v in params.items():
            if isinstance(v, dict):
                self.add_module(k, _module(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    @property
    def params(self) -> dict:
        """The parameter tree as nested dicts (the JAX tree's layout)."""
        return _tree(self)

    @property
    def n_params(self) -> int:
        return param_count(self.param_specs)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device).expand(
            B, S).contiguous()

    def _logits(self, p, x):
        x = rmsnorm(p["final_norm"], x, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return unembed(p["embed"], x)
        return x @ p["lm_head"].to(x.dtype)

    def _memory(self, frames, image_embeds):
        """The family's modality stub in the compute dtype (``None`` for
        the text-only families); raises when it is missing."""
        cfg = self.cfg
        name = MEMORY.get(cfg.family)
        if name is None:
            return None
        t = {"frames": frames, "image_embeds": image_embeds}[name]
        if t is None:
            raise ValueError(f"the {cfg.family} family needs {name!r} "
                             f"(data.synthetic.modality_stub)")
        return t.to(cfg.cdtype)

    def forward(self, tokens, *, frames=None, image_embeds=None,
                params=None):
        """Full-sequence logits ``[B, S, V]`` in the compute dtype, and the
        auxiliary loss: the MoE layers' load-balance losses summed (a
        float32 scalar), 0.0 for the other families.

        ``params`` (the `params` tree by default) is the tree the forward
        reads: training passes leaves that require grad (the module's own
        parameters do not), and the forward then builds the autograd
        graph, each block under ``torch.utils.checkpoint`` when
        ``cfg.remat`` is on (the JAX package's ``remat``).  Without such
        leaves, or under ``torch.no_grad()``, it builds none."""
        cfg = self.cfg
        p = self.params if params is None else params
        mem = self._memory(frames, image_embeds)
        B, S = tokens.shape
        x = embed(p["embed"], tokens, cfg.cdtype)
        pos = self._positions(B, S)
        if cfg.family == "audio":
            memory = encdec.encode(p, cfg, mem)
            x, aux = encdec.decoder_forward(p, cfg, x, pos, memory), 0.0
        elif cfg.family == "hybrid":
            x, aux = tf._scan_blocks(
                lambda pl, x: tf.hybrid_group_fwd(pl, cfg, x, pos),
                p["blocks"], x, cfg.remat)
        elif cfg.family == "vlm":
            x, aux = tf._scan_blocks(
                lambda pl, x: tf.vlm_group_fwd(pl, cfg, x, pos, mem),
                p["blocks"], x, cfg.remat)
        elif cfg.family == "ssm":
            x, aux = tf._scan_blocks(
                lambda pl, x: tf.mamba_block_fwd(pl, cfg, x), p["blocks"], x,
                cfg.remat)
        else:
            x, aux = tf._scan_blocks(
                lambda pl, x: tf.block_fwd(pl, cfg, x, pos), p["blocks"], x,
                cfg.remat)
        return self._logits(p, x), aux

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """Zeroed caches with a leading layers axis, in ``dtype`` (the
        compute dtype by default)."""
        cfg = self.cfg
        dt = dtype or cfg.cdtype
        if cfg.family == "audio":
            return encdec.decoder_cache(cfg, batch, max_len, dt, self.device)
        if cfg.family == "hybrid":
            one = tf.hybrid_group_cache(cfg, batch, max_len, dt, "meta")
        elif cfg.family == "vlm":
            one = tf.vlm_group_cache(cfg, batch, max_len, dt, "meta")
        elif cfg.family == "ssm":
            one = mamba2.mamba_init_cache(cfg.mamba, cfg.d_model, batch, dt,
                                          "meta")
        else:
            one = tf._attn_cache(cfg, batch, max_len, dt, "meta")
        return tf.stacked_zeros(one, _n_outer(cfg), self.device)

    @torch.no_grad()
    def prefill(self, tokens, cache, *, frames=None, image_embeds=None):
        """Run the prompt ``[B, S]``, filling ``cache`` in place; returns
        the last position's logits ``[B, 1, V]`` and the cache."""
        cfg, p = self.cfg, self.params
        mem = self._memory(frames, image_embeds)
        B, S = tokens.shape
        pos = self._positions(B, S)
        x = embed(p["embed"], tokens, cfg.cdtype)
        if cfg.family == "audio":
            memory = encdec.encode(p, cfg, mem)
            x, cache = encdec.decoder_prefill(p, cfg, x, pos, cache, memory)
            return self._logits(p, x[:, -1:]), cache
        if cfg.family == "hybrid":
            fn = lambda pl, x, c: tf.hybrid_group_prefill(pl, cfg, x, pos, c)
        elif cfg.family == "vlm":
            fn = lambda pl, x, c: tf.vlm_group_prefill(pl, cfg, x, pos, c,
                                                       mem)
        elif cfg.family == "ssm":
            fn = lambda pl, x, c: tf.mamba_block_prefill(pl, cfg, x, pos, c)
        else:
            fn = lambda pl, x, c: tf.block_prefill(pl, cfg, x, pos, c)
        x, cache = tf._scan_blocks_cache(fn, p["blocks"], cache, x)
        return self._logits(p, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One token ``[B, 1]`` per sequence; returns logits ``[B, 1, V]``
        and the cache, updated in place (the memory's K/V come from it)."""
        cfg, p = self.cfg, self.params
        x = embed(p["embed"], tokens, cfg.cdtype)
        if cfg.family == "audio":
            x, cache = encdec.decoder_decode_step(p, cfg, x, cache)
            return self._logits(p, x), cache
        if cfg.family == "hybrid":
            fn = lambda pl, x, c: tf.hybrid_group_decode(pl, cfg, x, c)
        elif cfg.family == "vlm":
            fn = lambda pl, x, c: tf.vlm_group_decode(pl, cfg, x, c)
        elif cfg.family == "ssm":
            fn = lambda pl, x, c: tf.mamba_block_decode(pl, cfg, x, c)
        else:
            fn = lambda pl, x, c: tf.block_decode(pl, cfg, x, c)
        x, cache = tf._scan_blocks_cache(fn, p["blocks"], cache, x)
        return self._logits(p, x), cache


def build_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A `Model` of ``cfg`` with parameters drawn from ``seed`` (the JAX
    launcher's ``model.init(PRNGKey(seed))``; see ``params.init_params``)
    on ``device`` (the card unless the caller asks for another)."""
    dev = resolve_device(device)
    params = init_params(model_specs(cfg), rng.PRNGKey(seed, device=dev))
    return Model(cfg, params)
