"""Fixture: key reuse on repro_torch.rng -- the decode/correlation bugs."""
import torch
from repro_torch import rng as jr


def double_sample(rng):
    a = jr.normal(rng, (4,))
    b = jr.uniform(rng, (4,))  # VIOLATION: rng-reuse
    return a + b


def split_after_use(rng):
    tok = jr.categorical(rng, torch.zeros((2, 8)))
    keys = jr.split(rng, 4)  # VIOLATION: rng-reuse
    return tok, keys


def loop_reuse(rng, n):
    out = 0.0
    for _ in range(n):
        out = out + jr.normal(rng, ())  # VIOLATION: rng-reuse
    return out
