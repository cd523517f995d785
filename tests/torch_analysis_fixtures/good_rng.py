"""Fixture: disciplined key handling -- no findings."""
from repro_torch import rng as jr


def double_sample(rng):
    k_a, k_b = jr.split(rng)
    a = jr.normal(k_a, (4,))
    b = jr.uniform(k_b, (4,))
    return a + b


def per_step_streams(rng, n):
    out = 0.0
    for i in range(n):
        k = jr.fold_in(rng, i)
        out = out + jr.normal(k, ())
    return out


def loop_over_split(rng, n):
    out = 0.0
    for k in jr.split(rng, n):
        out = out + jr.normal(k, ())
    return out


def branch_separated(rng, kind):
    if kind == "a":
        return jr.normal(rng, ())
    return jr.uniform(rng, ())


def clock_loop(key, n):
    # the simulator's idiom: one split per clock, unbound into fresh keys;
    # a string's split is no key derivation
    out = []
    for _c in range(n):
        key, k_upd = jr.split(key, 2).unbind(0)
        out.append(jr.normal(k_upd, ()))
    return out, "a,b".split(",")
