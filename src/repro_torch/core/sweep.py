"""Consistency-model sweep engine: every (config × seed) of a figure.

The port of ``repro/core/sweep.py``.  The paper's empirical claims (C1–C6)
are sweeps across consistency models, staleness bounds, delivery rates
and seeds.  The JAX engine ``vmap``s ``simulate`` over the whole (config ×
seed) batch of a config *family* and compiles once per family.  The
port's ``simulate`` is a Python clock loop over kernels whose shapes carry
no batch axis, so this engine runs each (config, seed) in turn on the
device of ``app.x0``, config-major and seed-minor, and keeps the JAX
engine's contract:

- configs are grouped by ``cfg.family`` (the static structure the JAX
  engine compiles per group), and within a family the ring window is
  *harmonized* to the largest ``effective_window``: ``trace(i, j)``
  equals ``simulate(app, harmonized[i], n_clocks, seeds[j])`` bit for bit;
- ``post(trace, cfg, seed, cfg_idx)`` runs on each trace where it lies
  (on the card), before anything moves to the host; with
  ``keep_traces=False`` only its outputs are kept;
- ``traces[i]`` holds every `Trace` field batched with a leading
  ``[n_seeds]`` axis, and ``posts[i]`` the post outputs likewise.

The JAX result's ``n_compiles`` has no counterpart: nothing is compiled
per family here (the kernels are built once per process, at their first
launch).  ``n_runs`` counts the ``simulate`` runs the sweep made, one per
(config, seed) (two with ``timeit``), and ``families`` the groups.
Batching ``simulate`` itself, or capturing its clock in a CUDA graph, so
that a family shares its launches, is ROADMAP queue 2 work.

``obs`` (an `obs.ObsSpec`) threads the telemetry accumulators through
every run; each trace's ``obs`` comes back batched like its other fields.
Sharding the batch over several devices (``devices``, ``mesh``,
``mesh_axis``) raises ``NotImplementedError``: it is ROADMAP queue 1,
item 14b (the sharded runtimes it would run on, ``psrun`` and ``pods``,
are ported).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Any, Sequence

import numpy as np
import torch

from .consistency import ConsistencyConfig
from .ps import PSApp, Trace, simulate


def family_window(configs: Sequence[ConsistencyConfig]) -> int:
    """Harmonized ring window for one family: the max effective window."""
    return max(c.effective_window for c in configs)


def _stack(items: list):
    """Stack a list of like trees (tensors, dicts, `Trace`s, None) along a
    new leading axis."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, Trace):
        return Trace(**{f.name: _stack([getattr(it, f.name) for it in items])
                        for f in fields(Trace)})
    return torch.stack(items)


def _index(tree, j: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    if isinstance(tree, Trace):
        return Trace(**{f.name: _index(getattr(tree, f.name), j)
                        for f in fields(Trace)})
    return tree[j]


@dataclass
class SweepResult:
    """Per-config batched traces plus run and timing evidence.

    ``traces[i]`` has every `Trace` field batched with a leading
    ``[n_seeds]`` axis, aligned with ``configs[i]``.  ``harmonized[i]`` is
    ``configs[i]`` with its family's shared ring window: a standalone
    ``simulate(app, harmonized[i], n_clocks, seed)`` reproduces
    ``trace(i, j)`` exactly.
    """

    configs: list
    harmonized: list
    seeds: np.ndarray
    traces: list
    n_runs: int               # simulate runs made (no compile counterpart)
    t_first_s: float          # the first pass over every (config, seed)
    t_exec_s: float | None    # a second pass (timeit=True)
    families: dict = field(default_factory=dict)
    posts: list = field(default_factory=list)   # per-config batched post out

    def trace(self, i: int, seed_idx: int = 0) -> Trace:
        """Unbatched `Trace` for config ``i`` at seed index ``seed_idx``.

        Unavailable when the sweep ran with ``keep_traces=False``."""
        if self.traces[i] is None:
            raise ValueError("sweep ran with keep_traces=False; only `posts` "
                             "outputs were kept")
        return _index(self.traces[i], seed_idx)

    def post(self, i: int, seed_idx: int | None = None):
        """Post-callback output for config ``i`` (one seed, or batched)."""
        if not self.posts or self.posts[i] is None:
            raise ValueError("sweep ran without a post callback")
        if seed_idx is None:
            return self.posts[i]
        return _index(self.posts[i], seed_idx)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, "
        f"{item}); run it on the JAX package")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sweep(app: PSApp, configs: Sequence[ConsistencyConfig], n_clocks: int,
          seeds: int | Sequence[int] = 1, record_views: bool = False,
          devices=None, timeit: bool = False, post=None,
          keep_traces: bool = True, mesh=None,
          mesh_axis: str | None = None, obs=None) -> SweepResult:
    """Run every (config, seed) pair, on the device of ``app.x0``.

    Args:
      app: the PS application.
      configs: any mix of consistency configs; they are grouped by
        ``cfg.family``, and each group shares its largest ring window.
      n_clocks: clocks to simulate.
      seeds: seed count (``k`` → seeds 0..k-1) or explicit seed values.
      record_views: record worker-0 views per clock (`Trace.views0`).
      timeit: run every pair a second time and report that pass's time
        (`t_exec_s`) apart from the first (`t_first_s`, which includes
        loading the kernels).
      post: optional ``post(trace, cfg, seed, cfg_idx) -> tree of tensors``
        applied to each run's trace on its device (``cfg`` is the
        harmonized config, ``cfg_idx`` its index in ``configs``, e.g. for
        `TimeModel` key folding).  Outputs land in ``SweepResult.posts``,
        batched per config like ``traces``.
      keep_traces: when False (requires ``post``), drop each trace once its
        post has run and keep only the post outputs.
      obs: an `obs.ObsSpec`: collect telemetry in every run
        (``Trace.obs``); ``None`` leaves every other field bit-equal.
      devices, mesh, mesh_axis: the JAX engine's multi-device sharding,
        which raises here (ROADMAP queue 1, item 14b).
    """
    if devices is not None or mesh is not None or mesh_axis is not None:
        _not_ported("a sweep sharded over devices (devices=, mesh=, "
                    "mesh_axis=)",
                    "item 14b")
    if not keep_traces and post is None:
        raise ValueError("keep_traces=False requires a post callback")
    configs = list(configs)
    if isinstance(seeds, (int, np.integer)):
        seeds = np.arange(seeds)
    seeds = np.asarray(seeds, np.uint32)
    dev = app.x0.device

    groups: dict[tuple, list[int]] = {}
    for i, c in enumerate(configs):
        groups.setdefault(c.family, []).append(i)

    traces: list[Any] = [None] * len(configs)
    posts: list[Any] = [None] * len(configs)
    harmonized: list[Any] = [None] * len(configs)
    fam_info = {}
    for fam, idxs in groups.items():
        W = family_window([configs[i] for i in idxs])
        for i in idxs:
            harmonized[i] = configs[i].replace(window=W)
        fam_info[fam] = {"configs": len(idxs), "window": W}

    def one_pass():
        for i in range(len(configs)):
            runs, outs = [], []
            for sd in seeds:
                tr = simulate(app, harmonized[i], n_clocks, seed=int(sd),
                              record_views=record_views, obs=obs)
                if post is not None:
                    outs.append(post(tr, harmonized[i], int(sd), i))
                if keep_traces:
                    runs.append(tr)
            traces[i] = _stack(runs) if keep_traces else None
            posts[i] = _stack(outs) if post is not None else None

    t0 = time.perf_counter()
    one_pass()
    _sync(dev)
    t_first = time.perf_counter() - t0
    t_exec = None
    if timeit:
        t0 = time.perf_counter()
        one_pass()
        _sync(dev)
        t_exec = time.perf_counter() - t0

    return SweepResult(configs=configs, harmonized=harmonized, seeds=seeds,
                       traces=traces,
                       n_runs=len(configs) * len(seeds) * (2 if timeit
                                                           else 1),
                       t_first_s=t_first, t_exec_s=t_exec,
                       families=fam_info, posts=posts)
