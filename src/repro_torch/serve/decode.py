"""Batched serving: prefill, then decode against the caches.

The JAX package's ``serve/decode.py``.  The decode loop keeps every token
on the device and makes no host sync: each step's token feeds the next
step as a tensor.  Sampling at a temperature draws JAX's key stream
through ``rng.categorical``, with its noise in the logits' dtype.
``extra_inputs`` carries the audio and vlm families' modality stubs
(``{"frames": ...}`` or ``{"image_embeds": ...}``) to the prefill; the
decode steps read the memory's K/V from the caches.
"""
from __future__ import annotations

import torch

from .. import rng as jrng
from ..models.registry import Model


def greedy_sample(logits, rng=None, temperature: float = 0.0):
    """The last position's token ``[B]``: its argmax, or a draw at
    ``temperature`` under the key ``rng`` when both are given."""
    last = logits[:, -1]
    if temperature and rng is not None:
        # a tensor divisor: on CUDA a Python one is a reciprocal multiply
        t = torch.full((), temperature, dtype=last.dtype, device=last.device)
        return jrng.categorical(rng, last / t).long()
    return torch.argmax(last, dim=-1)


def prefill(model: Model, prompt_tokens, max_len: int,
            extra_inputs: dict | None = None):
    """Fresh caches for ``max_len`` positions, filled from the prompt (and
    the modality stub in ``extra_inputs``); returns the last prompt
    position's logits ``[B, 1, V]`` and the caches."""
    cache = model.init_cache(prompt_tokens.shape[0], max_len)
    return model.prefill(prompt_tokens, cache, **(extra_inputs or {}))


def decode_loop(model: Model, tok, cache, n_steps: int, keys=None,
                temperature: float = 0.0):
    """``n_steps`` decode steps from token ``tok [B]``, step ``t`` drawn at
    ``temperature`` under ``keys[t]`` (greedy when either is unset);
    returns the tokens they produce, ``[B, n_steps]``."""
    out = torch.empty((tok.shape[0], n_steps), dtype=tok.dtype,
                      device=tok.device)
    for t in range(n_steps):
        logits, cache = model.decode_step(tok[:, None], cache)
        tok = greedy_sample(logits, None if keys is None else keys[t],
                            temperature)
        out[:, t] = tok
    return out


def generate(model: Model, prompt_tokens, max_new: int,
             max_len: int | None = None, temperature: float = 0.0,
             rng=None, extra_inputs: dict | None = None):
    """Prefill on the prompt, then decode ``max_new`` tokens: greedy at
    temperature 0, else drawn with JAX's key stream (``rng`` defaults to
    ``PRNGKey(0)``; the first token takes ``split(rng)[1]``, step ``t``
    ``split(split(rng)[0], max_new)[t]``).  ``extra_inputs`` carries the
    modality stub of the audio and vlm families.  Returns ``[B, max_new]``
    int32 token ids."""
    S = prompt_tokens.shape[1]
    logits, cache = prefill(model, prompt_tokens, max_len or (S + max_new),
                            extra_inputs)
    k0 = keys = None
    if temperature:
        if rng is None:
            rng = jrng.PRNGKey(0, prompt_tokens.device)
        rng, k0 = jrng.split(rng).unbind(0)
        keys = jrng.split(rng, max_new)
    tok = greedy_sample(logits, k0, temperature)
    rest = decode_loop(model, tok, cache, max_new - 1, keys, temperature)
    return torch.cat([tok[:, None], rest], dim=1).to(torch.int32)


def generate_scan(model: Model, prompt_tokens, max_new: int,
                  max_len: int | None = None,
                  extra_inputs: dict | None = None):
    """Greedy generation: ``generate`` at temperature 0."""
    return generate(model, prompt_tokens, max_new, max_len,
                    extra_inputs=extra_inputs)
