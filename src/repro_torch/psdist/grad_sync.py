"""The paper's consistency models as gradient-synchronization policies
for training: the part of the JAX package's ``psdist/grad_sync.py`` that
one card runs.

- BSP    — the gradient of the step is applied at once.
- SSP(s) — *delayed gradient application*: the train state carries a FIFO
  of ``s`` gradient trees; step ``t`` applies the gradient of step
  ``t - s`` and enqueues the fresh one (during the first ``s`` steps it
  applies nothing).  ``s = 0`` is BSP.
- ESSP   — eager bucketed collectives: the same FIFO, with the gradients
  reduced over the data axes in ``n_buckets`` collectives.

Both knobs live on `GradSync`: ``staleness`` (the FIFO's depth) and
``n_buckets`` (the collectives' granularity).  With one card there is no
data axis: `sync_gradients` runs at ``data_axes=()`` and raises for any
other; the bucketed mean over ``torch.distributed`` (the JAX package's
``psum_mean_bucketed``) and ``schedules.py`` are ROADMAP item 16.4b.
`bucket_assignment` is kept: it decides which leaves share a bucket.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.consistency import ConsistencyConfig
from ..optim.optimizers import tree_leaves, tree_map


@dataclass(frozen=True)
class GradSync:
    model: str = "bsp"            # bsp | ssp | essp
    staleness: int = 0            # SSP FIFO depth (0 = synchronous apply)
    n_buckets: int = 1            # ESSP: number of eager collective buckets

    @classmethod
    def from_consistency(cls, c: ConsistencyConfig, n_buckets: int = 8):
        if c.model == "bsp":
            return cls("bsp", 0, 1)
        if c.model == "ssp":
            return cls("ssp", c.staleness, 1)
        if c.model == "essp":
            return cls("essp", c.staleness, n_buckets)
        raise ValueError(f"{c.model} has no pod-side realization "
                         "(VAP is simulator-only; see DESIGN.md)")


def bucket_assignment(grads, n_buckets: int) -> list[int]:
    """Greedy size-balanced assignment of the leaves (in the JAX package's
    order) to buckets: the largest leaf first, each to the least loaded
    bucket."""
    sizes = [int(leaf.numel()) for leaf in tree_leaves(grads)]
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    loads = [0] * n_buckets
    assign = [0] * len(sizes)
    for i in order:
        b = loads.index(min(loads))
        assign[i] = b
        loads[b] += sizes[i]
    return assign


def init_fifo(sync: GradSync, params):
    """Gradient FIFO of depth ``staleness`` (``None`` at 0): each leaf
    stacked float32 ``[staleness, *shape]`` and a fill count."""
    if sync.staleness == 0:
        return None
    leaves = tree_leaves(params)
    return {"buf": tree_map(lambda p: torch.zeros(
        (sync.staleness,) + tuple(p.shape), dtype=torch.float32,
        device=p.device), params),
            "filled": torch.zeros((), dtype=torch.int32,
                                  device=leaves[0].device)}


def push_pop(fifo, grads):
    """Push fresh grads, pop the stalest entry.

    Returns ``(stale_grads, new_fifo, valid)``: ``valid`` is 0 during the
    warm-up (the FIFO not yet full: apply nothing, as SSP guarantees
    nothing visible in its first ``s`` clocks), else 1."""
    s = tree_leaves(fifo["buf"])[0].shape[0]
    popped = tree_map(lambda b: b[0], fifo["buf"])
    pushed = tree_map(lambda b, g: torch.cat([b[1:], g.float()[None]]),
                      fifo["buf"], grads)
    filled = torch.clamp(fifo["filled"] + 1, max=s)
    valid = (fifo["filled"] >= s).float()
    return popped, {"buf": pushed, "filled": filled}, valid


def sync_gradients(sync: GradSync, grads, fifo, data_axes=()):
    """One step's consistency pipeline: ``(grads_to_apply, new_fifo,
    apply_scale)``, ``apply_scale`` 0 or 1 (float32, on the gradients'
    device).  One card has no data axis: ``data_axes`` must be empty."""
    if data_axes:
        raise NotImplementedError(
            f"gradient collectives over {tuple(data_axes)} are ROADMAP item "
            f"16.4b (psdist on torch.distributed)")
    if sync.staleness == 0 or fifo is None:
        dev = tree_leaves(grads)[0].device
        return grads, fifo, torch.ones((), dtype=torch.float32, device=dev)
    return push_pop(fifo, grads)
