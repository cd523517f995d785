"""Batched serving: prefill, then greedy decode against the caches.

The JAX package's ``serve/decode.py``.  The decode loop keeps every token
on the device and makes no host sync: each step's argmax feeds the next
step as a tensor.
"""
from __future__ import annotations

import torch

from ..models.registry import Model


def greedy_sample(logits):
    """The argmax of the last position's logits ``[B]``."""
    return torch.argmax(logits[:, -1], dim=-1)


def prefill(model: Model, prompt_tokens, max_len: int):
    """Fresh caches for ``max_len`` positions, filled from the prompt;
    returns the last prompt position's logits ``[B, 1, V]`` and the
    caches."""
    cache = model.init_cache(prompt_tokens.shape[0], max_len)
    return model.prefill(prompt_tokens, cache)


def decode_loop(model: Model, tok, cache, n_steps: int):
    """``n_steps`` greedy decode steps from token ``tok [B]``; returns the
    tokens they produce, ``[B, n_steps]``."""
    out = torch.empty((tok.shape[0], n_steps), dtype=tok.dtype,
                      device=tok.device)
    for t in range(n_steps):
        logits, cache = model.decode_step(tok[:, None], cache)
        tok = greedy_sample(logits)
        out[:, t] = tok
    return out


def generate_scan(model: Model, prompt_tokens, max_new: int,
                  max_len: int | None = None):
    """Greedy generation in one loop: the prefill, then ``max_new - 1``
    decode steps.  Returns ``[B, max_new]`` int32 token ids."""
    S = prompt_tokens.shape[1]
    logits, cache = prefill(model, prompt_tokens, max_len or (S + max_new))
    tok = greedy_sample(logits)
    rest = decode_loop(model, tok, cache, max_new - 1)
    return torch.cat([tok[:, None], rest], dim=1).to(torch.int32)


# The JAX package's ``generate``, greedy: the tokens of `generate_scan`.
# Sampling at a temperature waits for ``categorical`` in
# ``repro_torch.rng`` (ROADMAP queue 1, item 1).
generate = generate_scan
