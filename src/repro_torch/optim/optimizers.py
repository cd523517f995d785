"""Optimizers: SGD, momentum and AdamW, and the learning-rate schedules.

The JAX package's ``optim/optimizers.py`` (its minimal optax API) on
trees of tensors (nested dicts): ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (updates, state)``, where the
updates are additive deltas (the PS "INC" convention) that
`apply_updates` adds to the parameters.  Each update takes JAX's
operations in JAX's order with its float32 casts; the step is an int32
tensor on the parameters' device, so a schedule is evaluated there, and
every division by a number divides by a tensor filled on the device (on
CUDA, ``tensor / python_scalar`` is a multiply by the reciprocal, which
rounds otherwise).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def _device(tree):
    return tree_leaves(tree)[0].device


def _div(x, n):
    """``x / n`` for a number ``n``, as a true division on any device."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _schedule(lr):
    return lr if callable(lr) else (lambda step: lr)


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def sgd(lr: float | Callable = 1e-2) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, _params=None):
        step = state["step"]
        g = sched(step)
        upd = tree_map(lambda gr: -g * gr.float(), grads)
        return upd, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr: float | Callable = 1e-2, beta: float = 0.9) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        return {"step": _step0(params),
                "mu": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, _params=None):
        step = state["step"]
        mu = tree_map(lambda m, gr: beta * m + gr.float(), state["mu"], grads)
        g = sched(step)
        upd = tree_map(lambda m: -g * m, mu)
        return upd, {"step": step + 1, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: float | Callable = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_dtype=torch.float32) -> Optimizer:
    """AdamW.  ``state_dtype=torch.bfloat16`` halves the optimizer's
    memory (the JAX package uses it for the 398B config).  With
    ``weight_decay`` 0 the decay term (``0 * p``, which adds nothing) is
    left out.  ``update`` writes the new ``m`` and ``v`` into the state's
    tensors, leaf by leaf, with JAX's roundings (float32 state: the same
    products and sums in place; bf16 state: the float32 value rounded
    into it), and returns the same state: a step holds one leaf's
    temporaries beside the state, not a second copy of ``m`` and ``v``
    (16 bytes a bf16 parameter with the float32 updates, not 24)."""
    sched = _schedule(lr)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"step": _step0(params), "m": tree_map(z, params),
                "v": tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        sf = step.float()
        c1 = 1.0 - torch.pow(b1, sf)
        c2 = 1.0 - torch.pow(b2, sf)

        def upd_m(m, gr):
            if m.dtype == torch.float32:    # b1 m + (1 - b1) g, in place
                return m.mul_(b1).add_(gr.float().mul(1 - b1))
            return m.copy_(b1 * m.float() + (1 - b1) * gr.float())

        def upd_v(v, gr):
            g32 = gr.float()
            if v.dtype == torch.float32:    # b2 v + ((1 - b2) g) g
                return v.mul_(b2).add_(g32.mul(1 - b2).mul_(g32))
            return v.copy_(b2 * v.float() + (1 - b2) * g32 * g32)

        m = tree_map(upd_m, state["m"], grads)
        v = tree_map(upd_v, state["v"], grads)
        g = sched(state["step"])

        def delta(mm, vv, pp):
            mhat = mm.float() / c1
            vhat = vv.float() / c2
            d = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                d = d + weight_decay * pp.float()
            return -g * d

        upd = tree_map(delta, m, v, params)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """params <- params + updates, in place (PS INC semantics;
    dtype-preserving: ``(p.f32 + u.f32).to(p.dtype)``); returns
    ``params``."""
    def one(p, u):
        if p.dtype == torch.float32:
            p.add_(u.float())
        else:
            p.copy_((p.float() + u.float()).to(p.dtype))
    tree_map(one, params, updates)
    return params


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    def sched(step):
        s = step.float()
        warm = torch.clamp(_div(s + 1.0, max(1, warmup)), max=1.0)
        prog = torch.clamp(_div(s - warmup, max(1, total - warmup)), 0.0,
                           1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return base_lr * warm * cos
    return sched


def inv_sqrt_schedule(base_lr: float, t0: float = 1.0):
    """The paper's eta_t = eta / sqrt(t) schedule (SGD theory sections)."""
    def sched(step):
        r = torch.sqrt(t0 + step.float())
        return torch.full_like(r, base_lr) / r
    return sched
