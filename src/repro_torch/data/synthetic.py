"""Deterministic synthetic token streams, bit-equal to the JAX package's
``data/synthetic.py::token_batch``, the training batches
(``token_batches``) and the audio and vlm families' modality stubs
(``modality_stub``).

Each sequence draws a hidden affine rule ``next = (a * cur + b) mod V_eff``
plus noise.  The draws go through ``repro_torch.rng`` (bit-equal to
``jax.random``); the recurrence is integer arithmetic, taken here by
doubling (``x_{t+m} = A_m x_t + B_m mod v``) in log2(S) steps instead of
one step per position.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import rng
from ..device import resolve_device


@dataclass(frozen=True)
class TokenGenConfig:
    vocab_size: int
    seq_len: int
    batch: int
    v_eff: int = 256        # active vocabulary slice
    noise: float = 0.05     # per-token corruption probability
    seed: int = 0


def token_batch(cfg: TokenGenConfig, step: int, device=None):
    """One [batch, seq_len] int32 batch, deterministic in (seed, step)."""
    dev = resolve_device(device)
    key = rng.fold_in(rng.PRNGKey(cfg.seed, device=dev), step)
    k_a, k_b, k_s, k_n, k_m = rng.split(key, 5)
    v = min(cfg.v_eff, cfg.vocab_size)
    B, S = cfg.batch, cfg.seq_len
    a = (2 * rng.randint(k_a, (B, 1), 1, v // 2) + 1).long()  # odd multiplier
    b = rng.randint(k_b, (B, 1), 0, v).long()
    x0 = rng.randint(k_s, (B, 1), 0, v).long()
    toks = torch.empty((B, S), dtype=torch.int64, device=dev)
    toks[:, :1] = x0
    # toks[:, :m] is filled; (A, Bc) maps x_t to x_{t+m}
    m, A, Bc = 1, a, b
    while m < S:
        n = min(m, S - m)
        toks[:, m:m + n] = (A * toks[:, :n] + Bc) % v
        A, Bc = (A * A) % v, (A * Bc + Bc) % v
        m += n
    noise = rng.bernoulli(k_n, cfg.noise, (B, S))
    rand = rng.randint(k_m, (B, S), 0, v)
    return torch.where(noise, rand, toks.to(torch.int32))


def token_batches(cfg: TokenGenConfig, n_steps: int | None = None,
                  extra: dict | None = None, device=None):
    """Iterator of training batches: ``{"tokens": token_batch(cfg, step)}``
    for step 0, 1, ... (``n_steps`` of them, or without end), each with
    the entries of ``extra`` (the audio and vlm families' stub,
    `modality_stub`) merged in."""
    step = 0
    while n_steps is None or step < n_steps:
        batch = {"tokens": token_batch(cfg, step, device=device)}
        if extra:
            batch.update(extra)
        yield batch
        step += 1


def modality_stub(cfg_model, batch: int, device=None) -> dict:
    """Frame or patch embeddings for the audio and vlm families (their
    frontends are stubbed): ``{"frames": [batch, n_ctx, d_model]}`` or
    ``{"image_embeds": [batch, n_image_tokens, d_model]}``, float32 ``0.1 *
    normal(PRNGKey(7))`` as the JAX package draws it by default (within 2
    ulp, ``rng.normal``); ``{}`` for the other families."""
    key = rng.PRNGKey(7, device=resolve_device(device))
    if cfg_model.family == "audio":
        name, n = "frames", cfg_model.encoder.n_ctx
    elif cfg_model.family == "vlm":
        name, n = "image_embeds", cfg_model.vision.n_image_tokens
    else:
        return {}
    return {name: rng.normal(key, (batch, n, cfg_model.d_model), scale=0.1)}
