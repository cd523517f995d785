"""Rank-side scenarios of the sharded sweep's CPU tests.

Every rank of a world runs ``sweep_scenarios`` through
``repro_torch.launch.worlds.run_world``, or the test process runs it
itself as a world of one rank.  It imports the port only (no JAX): each
scenario runs the sweep sharded over a mesh dimension on every rank, and
rank 0 also runs the unsharded sweep and each run's ``simulate`` in the
same world (so the thread count is the sharded runs'), holds them to the
sharded result bit for bit and returns the verdicts.  Every rank returns
its sharded results as numpy, which the tests hold to each other and to
the JAX package's sweep.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch_psrun_worlds import quad_app

from repro_torch.core import consistency as cc
from repro_torch.core import ps, sweep, tune
from repro_torch.core.timemodel import TimeModel
from repro_torch.launch.mesh import make_batch_mesh, make_pods_mesh

T = 10
P, D = 4, 16
# Three configs of two families, three seeds: 6 and 3 runs, so both
# families pad on a batch mesh of 4 (and the essp family on 2 pods).
SEEDS = [0, 3, 5]
TUNE_SEEDS = [0, 1]
TUNE_GRID = {"push_prob": [0.5, 1.0]}


def configs(m):
    return [m.ssp(2), m.essp(3), m.ssp(4)]


def tune_bases(m):
    return [m.ssp(2), m.essp(2)]


def breakdown_post(seed: int = 3):
    """The time model's breakdown folded over (config index, seed), so a
    padded run's ``post`` must see its own index and seed."""
    tm = TimeModel(seed=seed)

    def post(trace, cfg, sd, cfg_idx):
        return tm.breakdown_traced(trace, cfg.model, fold=(cfg_idx, sd))
    return post


def lean_post(seed: int = 3):
    """`breakdown_post` plus a leaf that is no tensor: the run's own
    ``(cfg_idx, seed)``, which the sharded sweep gathers as an object."""
    post = breakdown_post(seed)

    def both(trace, cfg, sd, cfg_idx):
        return {**post(trace, cfg, sd, cfg_idx), "run": (cfg_idx, sd)}
    return both


def _np(tree):
    if tree is None or isinstance(tree, list):
        return tree
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, ps.Trace):
        return {f: _np(getattr(tree, f)) for f in tree.__dataclass_fields__}
    return tree.detach().cpu().numpy()


def _equal(a, b) -> bool:
    """Exact equality of two trees of tensors (None, dicts, `Trace`s)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, ps.Trace):
        return all(_equal(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    if not isinstance(a, torch.Tensor):
        return a == b
    return a.dtype == b.dtype and torch.equal(a, b)


def _result(res) -> dict:
    return {"traces": [_np(t) for t in res.traces],
            "posts": [_np(p) for p in res.posts],
            "windows": [h.window for h in res.harmonized],
            "n_runs": res.n_runs}


def _verdict(app, cfgs, res, flat, **kw) -> dict:
    """Rank 0's holding of a sharded result: the unsharded sweep's and
    each (config, seed)'s ``simulate`` and ``post``, bit for bit."""
    want = flat(app, cfgs)
    out = {"unsharded_traces": all(_equal(g, w) for g, w
                                   in zip(res.traces, want.traces,
                                          strict=True)),
           "unsharded_posts": all(_equal(g, w) for g, w
                                  in zip(res.posts, want.posts,
                                         strict=True))}
    post = kw.get("post")
    sim, posts = True, True
    for i in range(len(cfgs)):
        for j, sd in enumerate(SEEDS):
            tr = ps.simulate(app, res.harmonized[i], T, seed=sd)
            if res.traces[i] is not None:
                sim &= _equal(res.trace(i, j), tr)
            if post is not None:
                posts &= _equal(res.post(i, j),
                                post(tr, res.harmonized[i], sd, i))
    out["simulate"] = sim
    out["post"] = posts
    return out


def _frontier(fr) -> dict:
    return {"points": [(p["config"].model, float(p["config"].push_prob),
                        p["final_loss"], p["wall_to_threshold"],
                        p["final_loss_per_seed"],
                        p["wall_to_threshold_per_seed"], p["wall_total"])
                       for p in fr.points],
            "frontier_idx": list(fr.frontier_idx),
            "threshold": fr.threshold}


def sweep_scenarios() -> dict:
    """Every sharded-sweep scenario on this rank's world: a 1-D batch mesh
    (with ``timeit``), the pod dimension of a pods mesh, ``post`` with
    ``keep_traces=False``, and ``tune.frontier(devices=...)``."""
    n, rank = dist.get_world_size(), dist.get_rank()
    batch = make_batch_mesh(["cpu"] * n)
    pods = (make_pods_mesh(2, 2, 1, device="cpu") if n == 4
            else make_pods_mesh(1, 1, 1, device="cpu"))
    app = quad_app(P, D)
    cfgs = configs(cc)
    post, lean = breakdown_post(), lean_post()
    out = {"world": n, "rank": rank, "batch_mesh": list(batch.shape),
           "pods_mesh": list(pods.shape), "results": {}, "verdicts": {}}

    cases = {
        "batch": (dict(mesh=batch, post=post, timeit=True),
                  dict(post=post)),
        "pods": (dict(mesh=pods, mesh_axis="pod"), {}),
        "lean": (dict(mesh=batch, post=lean, keep_traces=False),
                 dict(post=lean, keep_traces=False)),
    }
    for name, (kw, flat_kw) in cases.items():
        res = sweep.sweep(app, cfgs, T, seeds=SEEDS, **kw)
        out["results"][name] = _result(res)
        if rank == 0:
            out["verdicts"][name] = _verdict(
                app, cfgs, res,
                lambda a, c, fkw=flat_kw: sweep.sweep(a, c, T, seeds=SEEDS,
                                                      **fkw),
                **flat_kw)

    tm = TimeModel(seed=1)
    got = tune.frontier(app, tune_bases(cc), TUNE_GRID, time_model=tm,
                        n_clocks=T, seeds=TUNE_SEEDS,
                        devices=["cpu"] * n)
    out["results"]["frontier"] = _frontier(got)
    if rank == 0:
        want = tune.frontier(app, tune_bases(cc), TUNE_GRID, time_model=tm,
                             n_clocks=T, seeds=TUNE_SEEDS)
        out["verdicts"]["frontier"] = {
            "equal": _frontier(got) == _frontier(want)}
    return out
