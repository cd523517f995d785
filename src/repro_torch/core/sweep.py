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

With ``mesh`` (or ``devices``) the runs shard over one dimension of a
``DeviceMesh``, one rank per mesh point, where the JAX engine
``shard_map``s its batch: per family the runs are flattened config-major
and seed-minor, padded to a multiple of the shard count by repeating the
first run, and each shard runs a contiguous block.  After the runs every
Trace field and ``post`` leaf is gathered over the shard group
(``all_gather_into_tensor`` per leaf), so that every rank holds the whole
result, and the padding is sliced off.  Ranks that differ only in the
other dimensions run the same block (the JAX engine replicates its batch
over them).  The sharded result is bit-equal to the unsharded one when
each rank runs on the same kind of device with the same intra-op thread
count.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, fields
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .consistency import ConsistencyConfig
from .ps import PSApp, Trace, simulate


def family_window(configs: Sequence[ConsistencyConfig]) -> int:
    """Harmonized ring window for one family: the max effective window."""
    return max(c.effective_window for c in configs)


def _stack(items: list):
    """Stack a list of like trees (tensors, dicts, `Trace`s, None) along a
    new leading axis; a leaf that is no tensor stays a list."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, Trace):
        return Trace(**{f.name: _stack([getattr(it, f.name) for it in items])
                        for f in fields(Trace)})
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return list(items)


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
    n_runs: int               # simulate runs made here (no compile
                              # counterpart; sharded: this rank's)
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
        return _map(self.traces[i], lambda t: t[seed_idx])

    def post(self, i: int, seed_idx: int | None = None):
        """Post-callback output for config ``i`` (one seed, or batched)."""
        if not self.posts or self.posts[i] is None:
            raise ValueError("sweep ran without a post callback")
        if seed_idx is None:
            return self.posts[i]
        return _map(self.posts[i], lambda t: t[seed_idx])


def _map(tree, fn):
    """``fn`` on every leaf of a tree of dicts, `Trace`s and None, in the
    tree's order (the same on every rank)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, Trace):
        return Trace(**{f.name: _map(getattr(tree, f.name), fn)
                        for f in fields(Trace)})
    return fn(tree)


def _shard_group(mesh, mesh_axis: str | None):
    """The process group of ``mesh``'s dimension ``mesh_axis`` (its only
    dimension when ``None``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if mesh_axis is None:
        if len(names) != 1:
            raise ValueError(f"the mesh has dimensions {names}; name the one "
                             f"to shard the runs over (mesh_axis=)")
        mesh_axis = names[0]
    if mesh_axis not in names:
        raise ValueError(f"mesh_axis={mesh_axis!r} is not a dimension of the "
                         f"mesh {names}")
    return mesh.get_group(mesh_axis)


def _gather_leaf(t, group, n_shards: int):
    """A shard's ``[b, ...]`` leaf gathered over ``group`` into ``[n_shards
    * b, ...]``, in group-rank order; a leaf that is no tensor (a list of
    ``b`` values) through ``all_gather_object``."""
    if not isinstance(t, torch.Tensor):
        parts = [None] * n_shards
        dist.all_gather_object(parts, list(t), group=group)
        return [v for p in parts for v in p]
    src = t.contiguous()
    if src.dtype == torch.bool:      # bools travel as their bytes
        src = src.view(torch.uint8)
    out = torch.empty((n_shards * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    with warnings.catch_warnings():   # renamed all_gather_single in newer torch
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    return out.view(torch.bool) if t.dtype == torch.bool else out


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
      mesh, mesh_axis: shard the runs over the dimension ``mesh_axis`` of
        a ``DeviceMesh`` (its only dimension when ``None``; e.g.
        ``mesh=make_pods_mesh(), mesh_axis="pod"``), replicated over the
        other dimensions.  Every rank of the mesh must make the same call,
        and gets the whole result.  A mesh of one rank runs the sharded
        path too.  A failed collective raises.
      devices: one device per rank of the world: ``sweep`` shards over
        ``launch.mesh.make_batch_mesh(devices)`` (ignored when ``mesh`` is
        given).

    ``devices=None, mesh=None`` runs everything in this process.  Under
    sharding ``n_runs`` counts this rank's ``simulate`` runs, its padding
    included, and the times are taken between two barriers of the shard
    group.
    """
    if not keep_traces and post is None:
        raise ValueError("keep_traces=False requires a post callback")
    configs = list(configs)
    if isinstance(seeds, (int, np.integer)):
        seeds = np.arange(seeds)
    seeds = np.asarray(seeds, np.uint32)
    dev = app.x0.device
    group = None
    if mesh is None and devices is not None:
        from ..launch.mesh import make_batch_mesh
        mesh = make_batch_mesh(devices)
    if mesh is not None:
        group = _shard_group(mesh, mesh_axis)
        if mesh.device_type != dev.type:
            raise ValueError(f"the app lives on {dev}, the mesh on "
                             f"{mesh.device_type}")
    elif mesh_axis is not None:
        raise ValueError("mesh_axis names a dimension of a mesh: pass mesh= "
                         "(or devices=)")
    n_shards = 1 if group is None else dist.get_world_size(group)
    shard = 0 if group is None else dist.get_rank(group)

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

    def run(i, sd):
        tr = simulate(app, harmonized[i], n_clocks, seed=int(sd),
                      record_views=record_views, obs=obs)
        out = post(tr, harmonized[i], int(sd), i) if post is not None \
            else None
        return (tr if keep_traces else None), out

    def one_pass():
        if group is None:
            for i in range(len(configs)):
                runs = [run(i, sd) for sd in seeds]
                traces[i] = _stack([r for r, _ in runs]) if keep_traces \
                    else None
                posts[i] = _stack([o for _, o in runs]) if post is not None \
                    else None
            return len(configs) * len(seeds)
        made = 0
        for idxs in groups.values():
            # config-major, seed-minor; padded with the first run
            flat = [(i, sd) for i in idxs for sd in seeds]
            n = len(flat)
            flat += [flat[0]] * ((-n) % n_shards)
            b = len(flat) // n_shards
            runs = [run(i, sd) for i, sd in flat[shard * b:(shard + 1) * b]]
            made += b
            # the gather, after every clock loop of the block
            block = _stack([{"trace": r, "post": o} for r, o in runs])
            whole = _map(block, lambda t: _gather_leaf(t, group, n_shards))
            S = len(seeds)
            for j, i in enumerate(idxs):
                sl = slice(j * S, (j + 1) * S)
                traces[i] = _map(whole["trace"], lambda t: t[sl])
                posts[i] = _map(whole["post"], lambda t: t[sl])
        return made

    def timed_pass():
        if group is not None:
            dist.barrier(group=group)
        t0 = time.perf_counter()
        made = one_pass()
        _sync(dev)
        if group is not None:
            dist.barrier(group=group)
        return made, time.perf_counter() - t0

    n_runs, t_first = timed_pass()
    t_exec = None
    if timeit:
        made, t_exec = timed_pass()
        n_runs += made

    return SweepResult(configs=configs, harmonized=harmonized, seeds=seeds,
                       traces=traces, n_runs=n_runs,
                       t_first_s=t_first, t_exec_s=t_exec,
                       families=fam_info, posts=posts)
