"""Host-side training loop with logging and checkpointing: the JAX
package's ``train/loop.py``.  A step's metrics stay on the device except
on the steps that log (one read each)."""
from __future__ import annotations

import time
from typing import Callable, Iterable


def train(train_step, state, batches: Iterable, n_steps: int,
          log_every: int = 10, checkpoint_fn: Callable | None = None,
          checkpoint_every: int = 0, log_fn=print):
    """Run ``train_step`` over ``n_steps`` batches; returns the state and
    the history of the logged steps (step 1 and every ``log_every``-th):
    each step's metrics as floats with ``step``, ``wall_s`` and
    ``tok_per_s`` (tokens seen over the host time since the start)."""
    history = []
    t0 = time.time()
    tokens_seen = 0
    for i, batch in enumerate(batches):
        if i >= n_steps:
            break
        state, metrics = train_step(state, batch)
        tokens_seen += batch["tokens"].numel()
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            m.update(step=i + 1, wall_s=round(dt, 2),
                     tok_per_s=round(tokens_seen / max(dt, 1e-9)))
            history.append(m)
            log_fn(f"step {i+1:5d}  loss {m['loss']:.4f}  "
                   f"tok/s {m['tok_per_s']:.0f}  wall {m['wall_s']:.1f}s")
        if (checkpoint_fn and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            checkpoint_fn(state, i + 1)
    return state, history
