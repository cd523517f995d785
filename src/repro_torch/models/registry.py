"""Top-level model API: specs, forward, prefill and decode for the dense,
moe and ssm families.

`build_model(cfg, seed, device)` returns a `Model`, an ``nn.Module`` whose
parameters keep the JAX parameter tree's paths with ``.`` for ``/`` and
the stacked leading ``layers`` axis (``blocks.attn.wq`` is
``[L, d, H, Dh]``), so carrying JAX weights across is a copy name for
name (``convert.model_params_from_jax``).  Its methods take token tensors
(``[B, S]`` for ``forward``/``prefill``, ``[B, 1]`` for ``decode_step``)
instead of the JAX package's batch dicts; caches are dicts of tensors with
a leading layers axis, updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import rng
from ..configs.base import ModelConfig
from ..device import resolve_device
from . import mamba2
from . import transformer as tf
from .layers import embed, embed_spec, rmsnorm, rmsnorm_spec, unembed
from .params import init_params, param_count, spec

FAMILIES = ("dense", "moe", "ssm")


def model_specs(cfg: ModelConfig):
    """The parameter-spec tree of ``cfg`` (the JAX ``build_model``'s)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(tf.NOT_PORTED.format(
            f"the {cfg.family!r} family"))
    dtype = cfg.pdtype
    if cfg.family == "ssm":
        block = tf.mamba_block_spec(cfg, dtype)
    else:
        block = tf.block_spec(cfg, dtype)
    specs = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model, dtype),
        "blocks": tf.stack_specs(cfg.n_layers, block),
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
    """A served model of the dense, moe or ssm family (see module
    docstring)."""

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

    @torch.no_grad()
    def forward(self, tokens):
        """Full-sequence logits ``[B, S, V]`` in the compute dtype, and the
        auxiliary loss: the MoE layers' load-balance losses summed (a
        float32 scalar), 0.0 for the dense and ssm families."""
        cfg, p = self.cfg, self.params
        B, S = tokens.shape
        x = embed(p["embed"], tokens, cfg.cdtype)
        if cfg.family == "ssm":
            x, aux = tf._scan_blocks(
                lambda pl, x: tf.mamba_block_fwd(pl, cfg, x), p["blocks"], x)
        else:
            pos = self._positions(B, S)
            x, aux = tf._scan_blocks(
                lambda pl, x: tf.block_fwd(pl, cfg, x, pos), p["blocks"], x)
        return self._logits(p, x), aux

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """Zeroed caches with a leading layers axis, in ``dtype`` (the
        compute dtype by default)."""
        cfg = self.cfg
        dt = dtype or cfg.cdtype
        if cfg.family == "ssm":
            one = mamba2.mamba_init_cache(cfg.mamba, cfg.d_model, batch, dt,
                                          "meta")
        else:
            one = tf._attn_cache(cfg, batch, max_len, dt, "meta")
        return {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                               dtype=v.dtype, device=self.device)
                for k, v in one.items()}

    @torch.no_grad()
    def prefill(self, tokens, cache):
        """Run the prompt ``[B, S]``, filling ``cache`` in place; returns
        the last position's logits ``[B, 1, V]`` and the cache."""
        cfg, p = self.cfg, self.params
        B, S = tokens.shape
        pos = self._positions(B, S)
        x = embed(p["embed"], tokens, cfg.cdtype)
        if cfg.family == "ssm":
            fn = lambda pl, x, c: tf.mamba_block_prefill(pl, cfg, x, pos, c)
        else:
            fn = lambda pl, x, c: tf.block_prefill(pl, cfg, x, pos, c)
        x, cache = tf._scan_blocks_cache(fn, p["blocks"], cache, x)
        return self._logits(p, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One token ``[B, 1]`` per sequence; returns logits ``[B, 1, V]``
        and the cache, updated in place."""
        cfg, p = self.cfg, self.params
        x = embed(p["embed"], tokens, cfg.cdtype)
        if cfg.family == "ssm":
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
