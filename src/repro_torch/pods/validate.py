"""Oracle contract of the hierarchical runtime.

The port of ``repro/pods/validate.py``: ``core.ps.simulate`` with the
same hierarchical config is the oracle, held by
``psrun.validate.cross_validate`` (its staleness check is two-tier, and
widens by ``agg_clocks - 1`` under the comm substrate).  On top of it the
replica layer: pods' visible prefixes must stay within the
reconciliation bound (`pods.reconcile.replica_divergence`), and for the
models with no clock bound (async, VAP) within its value analogue
(`pods.reconcile.replica_value_divergence`: under ``2 v_t`` for VAP,
reported only for async).
"""
from __future__ import annotations

from ..core.consistency import ConsistencyConfig
from ..core.ps import PSApp
from ..psrun.validate import cross_validate
from .reconcile import (reconcile_stats, replica_divergence,
                        replica_value_divergence)


def cross_validate_pods(app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
                        runtime=None, seed=0, schedule=None,
                        faults=None) -> dict:
    """Run both engines and check the hierarchical oracle contract;
    returns the evidence dict with an overall ``ok``.  Under a
    ``schedule`` every layer re-derives over the live set; under
    ``faults`` only the bit-identity layer applies (the clock-divergence
    layers assume every shipment lands on time)."""
    from .runtime import PodsRuntime
    runtime = runtime or PodsRuntime(device=app.x0.device)
    out = cross_validate(app, cfg, n_clocks, runtime=runtime, seed=seed,
                         return_trace=True, schedule=schedule,
                         faults=faults)
    tr = out.pop("trace")          # reuse: do not run again
    if faults is not None:
        return out
    div = replica_divergence(tr, cfg)
    out["replica_divergence"] = {k: v for k, v in div.items()
                                 if k != "per_clock"}
    if div["ok"] is not None:
        out["ok"] = out["ok"] and div["ok"]
    if cfg.model in ("async", "vap"):
        vdiv = replica_value_divergence(tr, cfg)
        out["replica_value_divergence"] = {k: v for k, v in vdiv.items()
                                           if k != "per_clock"}
        if vdiv["ok"] is not None:
            out["ok"] = out["ok"] and vdiv["ok"]
    out["reconcile"] = reconcile_stats(tr, cfg, dim=app.dim)
    return out
