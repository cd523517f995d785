"""Sweep-driven consistency auto-tuner: loss against *modeled wall-clock*.

The port of ``repro/core/tune.py``.  The right consistency knob is the one
that reaches the solution fastest in wall-clock terms (paper Fig 2, claim
C6), so each point of a (knob grid × seed) batch is scored on two axes,
computed by a sweep ``post`` on the trace's device through the `TimeModel`:

- ``final_loss``: the mean training loss over the last ``tail`` clocks;
- ``wall_to_threshold``: modeled wall seconds until the loss first drops
  below a threshold (``inf`` if it never does).  The threshold defaults to
  ``best_final + threshold_frac * (initial - best_final)``.

``frontier`` returns the Pareto-optimal points under (final_loss,
wall_to_threshold) and every scored point; ``refine_rounds`` re-grid
around the frontier with halved knob steps.

``loss_at_budget`` is the loss soft-indexed at a fixed wall budget
(softmin weights over clocks by ``|cum_wall - budget|``), and
``grad_knobs`` its gradient with respect to config knobs and `TimeModel`
constants.  The simulator reads the config knobs (``push_prob``, ``v0``)
only through comparisons (``uniform < p``, ``norms <= v_t``), so their
pathwise gradients are exactly 0 in the JAX package; what is not zero
flows through the time model and the softmin.  The port therefore runs
``simulate`` on plain floats and takes ``torch.autograd`` through the
time model and the softmin only, and reports a config knob the graph does
not reach as ``0.0``, as JAX does (its tests hold the port to JAX's own
gradients, config knobs included).  The dense grid stays the primary
tuner.

What changed in the port: each sweep runs its (config, seed) pairs in
turn (``core.sweep``), so ``history`` records ``n_runs`` where the JAX
package records ``n_compiles``; ``devices`` (a sharded sweep) waits for
ROADMAP queue 1, item 14b.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from .consistency import INT_KNOBS, KNOB_BOUNDS, ConsistencyConfig
from .ps import PSApp, simulate
from .sweep import SweepResult, sweep
from .timemodel import TimeModel


def grid_configs(bases: ConsistencyConfig | Sequence[ConsistencyConfig],
                 knob_grids: dict[str, Sequence] | None
                 ) -> list[ConsistencyConfig]:
    """Cartesian product of ``knob_grids`` applied over each base config
    (knob names in sorted order, bases outermost)."""
    if isinstance(bases, ConsistencyConfig):
        bases = [bases]
    if not knob_grids:
        return list(bases)
    names = sorted(knob_grids)
    out = []
    for base in bases:
        for combo in itertools.product(*(knob_grids[n] for n in names)):
            out.append(base.replace(**dict(zip(names, combo, strict=True))))
    return out


@dataclass
class FrontierResult:
    """Scored grid and Pareto frontier of a `frontier` run.

    ``points[i]`` holds the config and its per-seed and seed-mean metrics;
    ``frontier_idx`` indexes the Pareto-optimal subset (sorted by
    final_loss); ``threshold`` is the loss level ``wall_to_threshold``
    measures against; ``time_model`` the constants every wall figure is
    conditioned on."""

    points: list[dict]
    frontier_idx: list[int]
    threshold: float
    time_model: TimeModel
    sweep_result: SweepResult | None = None
    history: list[dict] = field(default_factory=list)

    @property
    def frontier(self) -> list[dict]:
        return [self.points[i] for i in self.frontier_idx]

    def best(self, key: str = "wall_to_threshold") -> dict:
        """Frontier point minimizing ``key`` (ties -> lower final loss)."""
        pts = [p for p in self.frontier if np.isfinite(p[key])] or self.frontier
        return min(pts, key=lambda p: (p[key], p["final_loss"]))

    def summary(self) -> dict:
        def describe(p):
            c = p["config"]
            return {"model": c.model, "staleness": int(c.staleness),
                    "push_prob": float(c.push_prob),
                    "final_loss": p["final_loss"],
                    "wall_to_threshold": p["wall_to_threshold"]}
        return {"threshold": self.threshold,
                "n_points": len(self.points),
                "frontier": [describe(p) for p in self.frontier],
                "best": describe(self.best())}


def pareto_indices(xs: np.ndarray, ys: np.ndarray) -> list[int]:
    """Indices of the Pareto-minimal points of (xs, ys), sorted by xs.  A
    point is dominated if another is <= on both axes and < on one; NaNs
    never join the frontier, +inf can."""
    n = len(xs)
    keep = []
    for i in range(n):
        if not (np.isfinite(xs[i]) or np.isfinite(ys[i])):
            continue
        if np.isnan(xs[i]) or np.isnan(ys[i]):
            continue
        dominated = False
        for j in range(n):
            if j == i:
                continue
            if (xs[j] <= xs[i] and ys[j] <= ys[i]
                    and (xs[j] < xs[i] or ys[j] < ys[i])):
                dominated = True
                break
        if not dominated:
            keep.append(i)
    keep.sort(key=lambda i: (xs[i], ys[i]))
    return keep


def metrics_post(time_model: TimeModel, tail: int = 10,
                 loss_field: str = "loss_ref"):
    """Sweep ``post`` computing the tuner's per-point metrics on the
    trace's device: the loss curve, the cumulative modeled wall clock
    (`TimeModel` folded over ``(cfg_idx, seed)``, the config riding in so
    hierarchical points are charged their wire time) and the tail-mean
    final loss."""
    def post(trace, cfg, seed, cfg_idx):
        wall = time_model.wall_time(trace, cfg.model, fold=(cfg_idx, seed),
                                    cfg=cfg)
        loss = getattr(trace, loss_field)
        return {"loss": loss, "cum_wall": wall,
                "final_loss": loss[-tail:].mean()}
    return post


def _wall_to_threshold(loss: np.ndarray, wall: np.ndarray,
                       threshold: float) -> np.ndarray:
    """First-crossing wall seconds over leading axes (``inf`` where the
    loss never reaches the threshold)."""
    hit = loss <= threshold                       # [..., T]
    first = np.argmax(hit, axis=-1)               # 0 if never hit
    t_hit = np.take_along_axis(wall, first[..., None], axis=-1)[..., 0]
    return np.where(hit.any(axis=-1), t_hit, np.inf)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def score(app: PSApp, configs: Sequence[ConsistencyConfig], n_clocks: int,
          time_model: TimeModel, seeds: int | Sequence[int] = 2,
          threshold: float | None = None, threshold_frac: float = 0.05,
          tail: int = 10, devices=None) -> tuple[list[dict], float,
                                                 SweepResult]:
    """Run the grid through one sweep and score every (config, seed)."""
    res = sweep(app, configs, n_clocks, seeds=seeds, devices=devices,
                post=metrics_post(time_model, tail=tail), keep_traces=False)
    loss = np.stack([_host(res.posts[i]["loss"])
                     for i in range(len(configs))])       # [N, S, T]
    wall = np.stack([_host(res.posts[i]["cum_wall"])
                     for i in range(len(configs))])       # [N, S, T]
    final = np.stack([_host(res.posts[i]["final_loss"])
                      for i in range(len(configs))])      # [N, S]
    if threshold is None:
        best = float(final.mean(axis=1).min())
        init = float(loss[..., 0].mean())
        threshold = best + threshold_frac * max(init - best, 0.0)
    tts = _wall_to_threshold(loss, wall, threshold)       # [N, S]
    points = []
    for i, cfg in enumerate(configs):
        points.append({
            "config": cfg,
            "final_loss": float(final[i].mean()),
            "wall_to_threshold": float(tts[i].mean()),
            "final_loss_per_seed": final[i].tolist(),
            "wall_to_threshold_per_seed": tts[i].tolist(),
            "wall_total": float(wall[i, :, -1].mean()),
        })
    return points, threshold, res


def frontier(app: PSApp, bases, knob_grids: dict[str, Sequence] | None = None,
             *, time_model: TimeModel | None = None, n_clocks: int = 150,
             seeds: int | Sequence[int] = 2, threshold: float | None = None,
             threshold_frac: float = 0.05, tail: int = 10,
             refine_rounds: int = 0,
             refine_knobs: Sequence[str] = ("push_prob",),
             devices=None) -> FrontierResult:
    """Dense-grid auto-tune: the Pareto frontier of (final loss, modeled
    wall seconds to threshold) over ``knob_grids`` × ``bases``, with
    optional ``refine_rounds`` of coarse-to-fine re-gridding around the
    running frontier (each round sweeps the new points only)."""
    time_model = time_model or TimeModel()
    configs = grid_configs(bases, knob_grids)
    points, threshold, res = score(
        app, configs, n_clocks, time_model, seeds=seeds, threshold=threshold,
        threshold_frac=threshold_frac, tail=tail, devices=devices)
    fr = pareto_indices(np.asarray([p["final_loss"] for p in points]),
                        np.asarray([p["wall_to_threshold"] for p in points]))
    out = FrontierResult(points=points, frontier_idx=fr, threshold=threshold,
                         time_model=time_model, sweep_result=res)
    out.history.append({"round": 0, "n_points": len(points),
                        "n_runs": res.n_runs})

    steps = _grid_steps(knob_grids, refine_knobs)
    for r in range(refine_rounds):
        steps = {k: v / 2.0 for k, v in steps.items()}
        proposals = _propose_refinements(out, refine_knobs, steps)
        if not proposals:
            break
        new_points, _, res_r = score(
            app, proposals, n_clocks, time_model, seeds=seeds,
            threshold=threshold, tail=tail, devices=devices)
        out.points.extend(new_points)
        out.frontier_idx = pareto_indices(
            np.asarray([p["final_loss"] for p in out.points]),
            np.asarray([p["wall_to_threshold"] for p in out.points]))
        out.history.append({"round": r + 1, "n_points": len(proposals),
                            "n_runs": res_r.n_runs})
    return out


def _grid_steps(knob_grids, refine_knobs) -> dict[str, float]:
    """Initial refinement step per knob: the coarse grid spacing (or a
    quarter of the value range for single-point grids)."""
    steps = {}
    for k in refine_knobs:
        vals = sorted(set(float(v) for v in (knob_grids or {}).get(k, [])))
        if len(vals) >= 2:
            steps[k] = min(b - a for a, b in zip(vals, vals[1:], strict=False))
        else:
            steps[k] = max(abs(vals[0]) * 0.5, 0.1) if vals else 0.1
    return steps


def _propose_refinements(result: FrontierResult, refine_knobs,
                         steps: dict[str, float]) -> list[ConsistencyConfig]:
    """± half-step neighbours of each frontier config, deduplicated against
    everything already scored."""
    seen = {_cfg_key(p["config"]) for p in result.points}
    proposals = []
    for p in result.frontier:
        cfg = p["config"]
        for k in refine_knobs:
            step = steps.get(k, 0.1)
            for sign in (-1.0, 1.0):
                v = getattr(cfg, k) + sign * step
                lo, hi = KNOB_BOUNDS.get(k, (None, None))
                if k in INT_KNOBS:
                    v = int(round(v))
                if lo is not None:
                    v = max(lo, v)
                if hi is not None:
                    v = min(hi, v)
                cand = cfg.replace(**{k: v})
                key = _cfg_key(cand)
                if key not in seen:
                    seen.add(key)
                    proposals.append(cand)
    return proposals


def _cfg_key(cfg: ConsistencyConfig) -> tuple:
    vals = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        vals.append(round(float(v), 9) if isinstance(v, float) else v)
    return tuple(vals)


# --------------------------------------------------------------------------
# the gradient at a wall budget
# --------------------------------------------------------------------------

def _soft_loss(trace, cfg: ConsistencyConfig, time_model: TimeModel,
               budget: float, temp: float, fold) -> torch.Tensor:
    """The softmin-weighted loss at ``budget``, differentiable in the time
    model's tensor constants."""
    wall = time_model.wall_time(trace, cfg.model, fold=fold, cfg=cfg)
    t_comp = time_model.t_comp
    if isinstance(t_comp, torch.Tensor):
        scale = temp * t_comp.to(wall.device)
    else:   # the product in float64, rounded once, as JAX folds it
        scale = torch.full((), temp * t_comp, dtype=torch.float32,
                           device=wall.device)
    scale = torch.clamp(scale, min=1e-9)
    w = torch.softmax(-(wall - budget).abs() / scale, dim=0)
    return (w * trace.loss_ref).sum()


def loss_at_budget(app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
                   time_model: TimeModel, budget: float, seed=0,
                   temp: float = 2.0, fold=(0,)) -> torch.Tensor:
    """Loss at a fixed modeled wall budget: the per-clock loss soft-indexed
    at the clock whose cumulative wall time is nearest ``budget``, weights
    ``softmax(-|cum_wall - budget| / (temp * t_comp))``.  A 0-d tensor on
    the app's device."""
    tr = simulate(app, cfg, n_clocks, seed=seed)
    return _soft_loss(tr, cfg, time_model, budget, temp, fold)


def grad_knobs(app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
               time_model: TimeModel, budget: float,
               knobs: Sequence[str] = ("push_prob",),
               tm_knobs: Sequence[str] = ("t_comp",), seed=0,
               temp: float = 2.0) -> dict[str, Any]:
    """The gradient of `loss_at_budget` with respect to config knobs and
    `TimeModel` constants: ``{"value": float, "grads": {name: float}}``.

    ``simulate`` runs once on plain floats; ``torch.autograd`` runs
    through the time model and the softmin, with the ``tm_knobs`` as
    float32 tensors.  The config ``knobs`` reach the loss only through
    comparisons, so the graph does not reach them and their gradients are
    ``0.0`` (as JAX's are)."""
    cfg = cfg.replace(window=cfg.effective_window)
    tr = simulate(app, cfg, n_clocks, seed=seed)
    dev = tr.loss_ref.device
    theta = {k: torch.full((), float(getattr(time_model, k)),
                           dtype=torch.float32, device=dev,
                           requires_grad=True) for k in tm_knobs}
    tm = dataclasses.replace(time_model, **theta)
    value = _soft_loss(tr, cfg, tm, budget, temp, fold=(0,))
    grads = dict.fromkeys(knobs, 0.0)
    if theta:
        got = torch.autograd.grad(value, list(theta.values()),
                                  allow_unused=True)
        grads.update({k: 0.0 if g is None else float(g)
                      for k, g in zip(theta, got, strict=True)})
    return {"value": float(value.detach()), "grads": grads}
