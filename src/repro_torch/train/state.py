"""Train state and step construction (consistency-aware): the JAX
package's ``train/state.py``.

The state's ``params`` are the model's own parameter tensors, updated in
place under ``no_grad`` (``optim.apply_updates``): the model and the
state stay one.  A step takes the gradient of the loss with respect to
leaves that share those tensors' storage (`value_and_grad`: JAX's
``jax.value_and_grad``), syncs it (`psdist.grad_sync`), lets the
optimizer make the updates, scales them by ``apply_scale`` (0 during
SSP's warm-up) and applies them.  The step counter is an int32 tensor on
the parameters' device; nothing in a step reads a number back to the
host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..models.registry import MEMORY, Model
from ..optim.optimizers import (Optimizer, apply_updates, tree_leaves,
                                tree_map)
from ..psdist.grad_sync import GradSync, init_fifo, sync_gradients
from .losses import shift_labels, softmax_xent


@dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    fifo: Any            # SSP gradient FIFO (None for BSP/ESSP s=0)
    step: torch.Tensor   # int32, on the parameters' device


def init_state(model: Model, opt: Optimizer,
               sync: GradSync = GradSync()) -> TrainState:
    """The state of ``model``'s parameters (drawn by ``build_model`` from
    its seed: the JAX package's ``model.init(rng)``)."""
    params = model.params
    return TrainState(params=params, opt_state=opt.init(params),
                      fifo=init_fifo(sync, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def make_loss_fn(model: Model):
    """``loss_fn(params, batch)``: the mean next-token cross entropy (and
    z-loss) of ``batch["tokens"]`` (or of ``batch["labels"]``) plus the
    model's auxiliary loss; the audio and vlm families read their stub
    from the batch."""
    stub = MEMORY.get(model.cfg.family)

    def loss_fn(params, batch):
        extra = {stub: batch[stub]} if stub else {}
        logits, aux = model.forward(batch["tokens"], params=params, **extra)
        labels = batch["labels"] if "labels" in batch else shift_labels(
            batch["tokens"])
        return softmax_xent(logits, labels) + aux
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss detached
    and a tree of gradients in the parameters' dtypes (zeros for a leaf
    the loss does not reach)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    swap = dict(zip(map(id, leaves), live, strict=True))
    with torch.enable_grad():
        loss = loss_fn(tree_map(lambda p: swap[id(p)], params), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    got = {id(p): torch.zeros_like(p) if g is None else g
           for p, g in zip(leaves, grads, strict=True)}
    return loss.detach(), tree_map(lambda p: got[id(p)], params)


def grad_norm(grads):
    """The global L2 norm, float32, summed over the leaves in the JAX
    package's order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def _apply(state: TrainState, opt: Optimizer, grads, fifo, scale):
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    # SSP warm-up: the FIFO not yet full -> apply nothing this step
    tree_map(lambda u: u.mul_(scale), updates)
    apply_updates(state.params, updates)
    return TrainState(params=state.params, opt_state=opt_state, fifo=fifo,
                      step=state.step + 1)


def make_train_step(model: Model, opt: Optimizer,
                    sync: GradSync = GradSync(), data_axes=()):
    """The train step ``(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "grad_norm", "apply_scale"}`` as device scalars (the norm
    of the gradients applied: under SSP, the stale ones)."""
    loss_fn = make_loss_fn(model)

    def train_step(state: TrainState, batch):
        loss, grads = value_and_grad(loss_fn, state.params, batch)
        grads, fifo, scale = sync_gradients(sync, grads, state.fifo,
                                            data_axes)
        gnorm = grad_norm(grads)
        state = _apply(state, opt, grads, fifo, scale)
        return state, {"loss": loss, "grad_norm": gnorm,
                       "apply_scale": scale}

    return train_step


def make_accum_train_step(model: Model, opt: Optimizer,
                          sync: GradSync = GradSync(), accum: int = 1,
                          data_axes=(), accum_dtype=torch.float32):
    """Gradient-accumulation variant: batch leaves have a leading
    microbatch axis ``[accum, ...]``, taken in order; the paper's "update
    coalescing" (INCs summed locally before they reach the server).
    ``accum_dtype=torch.bfloat16`` halves the accumulator."""
    if accum == 1:
        return make_train_step(model, opt, sync, data_axes)
    loss_fn = make_loss_fn(model)

    def train_step(state: TrainState, batch):
        dev = state.step.device
        n = torch.full((), accum, dtype=torch.float32, device=dev)
        na = torch.full((), accum, dtype=accum_dtype, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                               device=p.device),
                         state.params)
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            lo, g = value_and_grad(loss_fn, state.params, mb)
            grads = tree_map(lambda a, gr: a + gr.to(accum_dtype) / na,
                             grads, g)
            loss = loss + lo / n
        grads, fifo, scale = sync_gradients(sync, grads, state.fifo,
                                            data_axes)
        state = _apply(state, opt, grads, fifo, scale)
        return state, {"loss": loss, "apply_scale": scale}

    return train_step
