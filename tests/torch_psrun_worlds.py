"""Rank-side scenarios of the sharded runtimes' CPU tests.

Every rank of a world runs one of these functions (``psrun_scenarios``,
``pods_scenarios``) through ``repro_torch.launch.worlds.run_world``, or
the test process runs it itself as a world of one rank.  It imports the
port only (no JAX), builds the apps from the numpy arrays it is given,
runs each scenario through the runtime and the oracle on its own CPU,
and returns plain data: the checks' verdicts and the runtime's traces as
numpy, which the tests hold to the port's ``simulate`` and to the JAX
package.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert, rng
from repro_torch.apps import matfact as tmf
from repro_torch.checkpoint import io as ckpt
from repro_torch.comm import wire
from repro_torch.core import consistency as cc
from repro_torch.core import delays, ps
from repro_torch.launch.mesh import make_pods_mesh, make_ps_mesh
from repro_torch.obs import ObsSpec
from repro_torch.pods import (PodsRuntime, cross_validate_pods,
                              run_with_pod_rejoin)
from repro_torch.psrun import PSRuntime, cross_validate
from repro_torch.psrun import validate as tval
from repro_torch.utils.tree import named_leaves

T = 12
QUAD_P, QUAD_D = 8, 16
OUTAGES = ((1, 3, 8), (6, 5, 10))
FAULTS = dict(seed=5, drop_rate=0.35, dup_rate=0.25, delay_rate=0.3,
              max_delay=1, max_retries=2, bursts=((6, 9, 0.9),))
MODELS = {
    "bsp": lambda m: m.bsp(),
    "ssp": lambda m: m.ssp(2),
    "essp": lambda m: m.essp(2),
    "vap": lambda m: m.vap(0.3),
    "async": lambda m: m.ConsistencyConfig(model="async"),
}


def wired(m):
    """Two pods, int8 values of the top half every 2 clocks."""
    return m.compressed(m.podded(m.essp(2), 2, s_xpod=1), agg_clocks=2,
                        topk_frac=0.5, quant="int8")


def quad_app(P=QUAD_P, d=QUAD_D, noisy=True):
    """The quad app of ``tests/conftest.py`` in the port; it takes any
    ``R <= P`` rows of workers."""
    eta = torch.tensor(0.3, dtype=torch.float32)

    def worker_update(views, local, _wids, clock, keys):
        g = views + 0.05 * rng.normal(keys, (d,)) if noisy else views
        step = eta / torch.sqrt(torch.tensor(1.0 + clock,
                                             dtype=torch.float32))
        return -step * g / P, local

    return ps.PSApp(name="quad", dim=d, n_workers=P,
                    x0=torch.ones((d,)) * 2.0,
                    local0={"_": torch.zeros((P, 1))},
                    worker_update=worker_update,
                    loss=lambda x, _l: torch.sum(torch.square(x)))


def _host(tr):
    return convert.trace_to_numpy(tr)


def _verdict(res):
    """A cross-validation result without its trace, as plain data."""
    return {k: v for k, v in res.items() if k != "trace"}


def _equal_traces(a, b, views=False) -> dict:
    """Per-field exact equality of two traces (and of ``obs``)."""
    out = {f: torch.equal(getattr(a, f), getattr(b, f))
           for f in tval.TRACE_FIELDS}
    if views:
        out["views0"] = torch.equal(a.views0, b.views0)
    if a.obs is not None or b.obs is not None:
        out["obs"] = (a.obs is not None and b.obs is not None
                      and all(torch.equal(a.obs[k], b.obs[k])
                              for k in b.obs))
    return out


def _ckpt_path(name: str) -> str:
    rank = dist.get_rank()
    return os.path.join(tempfile.mkdtemp(prefix="psrun_ckpt_"),
                        f"{name}_rank{rank}.npz")


def _resume(rt, app, cfg, n, cut, seed, **kw) -> dict:
    """Save at ``cut``, restore, run the rest: bit-equal to one run?"""
    flt = kw.get("faults")
    full, _ = rt.run_from(app, cfg, n, rt.init_state(app, cfg, seed=seed,
                                                     faults=flt), **kw)
    tr1, mid = rt.run_from(app, cfg, cut, rt.init_state(
        app, cfg, seed=seed, faults=flt), **kw)
    path = _ckpt_path("resume")
    ckpt.save_runtime(path, mid)
    restored = ckpt.restore_runtime(path, rt.init_state(app, cfg, seed=0,
                                                        faults=flt))
    same_state = {}
    for (name, a), (_, b) in zip(named_leaves(mid), named_leaves(restored),
                                 strict=True):
        same_state[name] = (a == b if isinstance(a, int)
                            else torch.equal(a, b))
    tr2, _ = rt.run_from(app, cfg, n - cut, restored, **kw)
    stitched = {}
    for f in tval.TRACE_FIELDS:
        a = getattr(full, f)
        b = (torch.cat([getattr(tr1, f), getattr(tr2, f)])
             if f != "x_final" else getattr(tr2, f))
        stitched[f] = torch.equal(a, b)
    busy = bool((mid.comm["pend_clock"] >= 0).any()) if flt is not None \
        else None
    return {"state_round_trip": same_state, "stitched": stitched,
            "in_flight_at_cut": busy}


def psrun_scenarios(mf_cfg: dict, mf_state: dict, mesh_shape=None) -> dict:
    """Every psrun scenario on this rank's world (``mesh_shape`` (data,
    model), or ``make_ps_mesh``'s default)."""
    mesh = make_ps_mesh(*(mesh_shape or ()), device="cpu")
    rt = PSRuntime(mesh)
    quad = quad_app()
    mf = convert.mf_app_from_state(tmf.MFConfig(**mf_cfg), mf_state["x0"],
                                   mf_state["local0"], device="cpu")
    out = {"world": dist.get_world_size(), "mesh": list(mesh.shape),
           "cross": {}, "traces": {}}

    for name, make in MODELS.items():
        res = cross_validate(quad, make(cc), T, runtime=rt, seed=3,
                             return_trace=True)
        out["cross"][f"quad_{name}"] = _verdict(res)
        out["traces"][f"quad_{name}"] = _host(res["trace"])
    for name in ("bsp", "essp", "vap"):
        res = cross_validate(mf, MODELS[name](cc), T, runtime=rt, seed=1,
                             return_trace=True)
        out["cross"][f"mf_{name}"] = _verdict(res)
        out["traces"][f"mf_{name}"] = _host(res["trace"])

    # the comm substrate, fleet churn, the lossy wire
    res = cross_validate(quad, wired(cc), T, runtime=rt, seed=3,
                         return_trace=True)
    out["cross"]["quad_wired"] = _verdict(res)
    out["traces"]["quad_wired"] = _host(res["trace"])
    for drop in (False, True):
        sched = delays.make_churn(T, QUAD_P, worker_outages=OUTAGES,
                                  drop_inflight=drop)
        res = cross_validate(quad, cc.ssp(2), T, runtime=rt, seed=3,
                             schedule=sched, return_trace=True)
        key = f"quad_churn_{'drop' if drop else 'drain'}"
        out["cross"][key] = _verdict(res)
        out["traces"][key] = _host(res["trace"])
    flt = wire.make_faults(T, QUAD_P, **FAULTS)
    wcfg = wired(cc).replace(window=wire.required_window(wired(cc), flt))
    pod_out = delays.make_churn(T, QUAD_P, n_pods=2,
                                pod_outages=((1, 4, 9),), drop_inflight=True)
    res = cross_validate(quad, wcfg, T, runtime=rt, seed=3, faults=flt,
                         schedule=pod_out, return_trace=True)
    out["cross"]["quad_wired_faults_churn"] = _verdict(res)
    out["traces"]["quad_wired_faults_churn"] = _host(res["trace"])
    res = cross_validate(mf, wired(cc), T, runtime=rt, seed=1,
                         return_trace=True)
    out["cross"]["mf_wired"] = _verdict(res)
    out["traces"]["mf_wired"] = _host(res["trace"])

    # telemetry and the recorded views
    for name, cfg, kw in (("essp", cc.essp(2), {}),
                          ("wired_faults", wcfg, dict(faults=flt))):
        got = rt.run(quad, cfg, T, seed=3, record_views=True, obs=ObsSpec(),
                     **kw)
        want = ps.simulate(quad, cfg, T, seed=3, record_views=True,
                           obs=ObsSpec(), **kw)
        out[f"obs_views_{name}"] = _equal_traces(got, want, views=True)
        out["traces"][f"obs_{name}"] = _host(got)

    # resume from a checkpoint, dense and mid-retransmit on a lossy wire
    out["resume_essp"] = _resume(rt, quad, cc.essp(2), T, 5, seed=3)
    heavy = wire.make_faults(14, QUAD_P, **dict(FAULTS, drop_rate=0.6))
    hcfg = wired(cc).replace(window=wire.required_window(wired(cc), heavy))
    out["resume_mid_retransmit"] = _resume(rt, quad, hcfg, 14, 7, seed=3,
                                           faults=heavy)

    # the guards
    guards = {}
    try:
        rt.run_fn(quad, cc.essp(2), T)(0, cc.essp(2).replace(window=9))
        guards["window"] = None
    except ValueError as e:
        guards["window"] = str(e)
    data = mesh.size(0)
    guards["workers"] = None
    if data > 1:                # P = data + 1 does not divide
        try:
            rt.run(quad_app(P=data + 1), cc.essp(2), 2)
        except ValueError as e:
            guards["workers"] = str(e)
    out["guards"] = guards
    return out


def pods_scenarios(mesh_shape=(2, 2, 1)) -> dict:
    """Every pods scenario on a ``("pod","data","model")`` world."""
    rt = PodsRuntime(make_pods_mesh(*mesh_shape, device="cpu"))
    quad = quad_app()
    out = {"world": dist.get_world_size(), "cross": {}, "traces": {}}
    for name, make in MODELS.items():
        cfg = cc.podded(make(cc), 2, s_xpod=2, t_net_xpod=4.0)
        res = cross_validate_pods(quad, cfg, T, runtime=rt, seed=3)
        out["cross"][name] = res
    res = cross_validate_pods(quad, wired(cc), T, runtime=rt, seed=3)
    out["cross"]["wired"] = res
    sched = delays.make_churn(T, QUAD_P, n_pods=2, pod_outages=((1, 3, 8),))
    out["cross"]["essp_pod_outage"] = cross_validate_pods(
        quad, cc.podded(cc.essp(2), 2, s_xpod=2), T, runtime=rt, seed=3,
        schedule=sched)

    rejoin = {}
    for name, cfg, drop in (("essp", cc.podded(cc.essp(2), 2, s_xpod=2),
                             False),
                            ("wired_drain", wired(cc), False),
                            ("wired_drop", wired(cc), True)):
        r = run_with_pod_rejoin(rt, quad, cfg, T, pod=1, drop_clock=4,
                                rejoin_clock=9, seed=3, drop_inflight=drop)
        whole = _host(ps.simulate(quad, cfg, T, seed=3,
                                  schedule=r["schedule"]))
        rejoin[name] = {
            "splice_exact": r["splice_exact"],
            "staleness_post": r["staleness_post"],
            "equal_to_uninterrupted": {
                f: bool(np.array_equal(getattr(r["trace"], f),
                                       getattr(whole, f)))
                for f in tval.TRACE_FIELDS}}
    out["rejoin"] = rejoin
    try:
        rt.run(quad, cc.podded(cc.essp(2), 4, s_xpod=1), 2)
        out["n_pods_guard"] = None
    except ValueError as e:
        out["n_pods_guard"] = str(e)
    return out
