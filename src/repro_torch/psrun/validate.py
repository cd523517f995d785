"""Cross-validation of the sharded runtime against the simulator oracle,
and the trace comparisons it rests on.

The port of ``repro/psrun/validate.py``.  Levels of contract, matched to
what each consistency model promises:

- **bsp, ssp, essp**: a seeded run is *bit-identical* to the port's
  ``core.ps.simulate`` on the same device, every `Trace` field, every
  float; ssp and essp also keep the (two-tier) staleness bound at read
  time, ``-(s_eff+1) <= cview[r,q] - c <= -1``;
- **vap**: the value-bound condition of paper eq. 1
  (``core.valuebound.check_condition``), integer decisions
  (staleness/forced/delivered) exactly equal to the oracle, floats within
  ``VAP_ULP_BUDGET`` ulp of each field's scale (``trace_max_ulp``);
- **async**: finite traces.

The comparison helpers take any trace whose fields are numpy arrays, CPU
or CUDA tensors, or JAX arrays, so the port's traces can also be held
against the JAX package's and a card run against a CPU run.  The JAX
package's caveats about compiled programs (a batch-of-one worker shard
compiling to other fused arithmetic, multi-device codegen drift of VAP
floats) have no counterpart here; the runtime keeps two or more workers a
shard (``runtime.default_mesh``), where every batched worker update runs
the simulator's arithmetic row for row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.consistency import ConsistencyConfig
from ..core.delays import staleness_bound_matrix
from ..core.ps import PSApp, simulate

TRACE_FIELDS = ("loss_ref", "loss_view", "staleness", "forced", "delivered",
                "u_l2", "intransit_inf", "ship_floats", "live", "x_final")
INT_FIELDS = ("staleness", "forced", "delivered", "live")
FLOAT_FIELDS = tuple(f for f in TRACE_FIELDS if f not in INT_FIELDS)

# Float drift budget, in float32 ulp of each field's scale
# (:func:`trace_max_ulp`).  The JAX package set it for its own engines;
# the port is held to the same number against the JAX simulator, between
# the card and the CPU, where reduction orders differ, and for VAP's
# floats between the runtime and the simulator.
VAP_ULP_BUDGET = 128.0


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trace_max_diff(got, want) -> dict:
    """Max absolute difference per `Trace` field (0.0 everywhere == exact)."""
    out = {}
    for name in TRACE_FIELDS:
        a = _np(getattr(got, name)).astype(np.float64)
        b = _np(getattr(want, name)).astype(np.float64)
        out[name] = float(np.abs(a - b).max()) if a.size else 0.0
    return out


def trace_max_ulp(got, want) -> dict:
    """Max drift per field, in float32 ulp *of the field's scale*:
    ``max|a-b| / spacing(max(|a|, |b|))``, so "a few ulp" means the same
    for a loss of 1e-3 and of 1e3."""
    out = {}
    for name in TRACE_FIELDS:
        a = _np(getattr(got, name)).astype(np.float64)
        b = _np(getattr(want, name)).astype(np.float64)
        if not a.size:
            out[name] = 0.0
            continue
        scale = np.float32(max(np.abs(b).max(), np.abs(a).max(), 1e-30))
        out[name] = float(np.abs(a - b).max() / np.spacing(scale))
    return out


def check_staleness_bound(trace, cfg: ConsistencyConfig,
                          retry_budget: int = 0) -> dict:
    """SSP/ESSP invariant: every read by a live worker is at most
    ``s_eff+1`` clocks stale and never fresher than the barrier (``-1``);
    ``s_eff`` is the per-channel two-tier bound."""
    st = _np(trace.staleness)
    P = st.shape[-1]
    readers = np.arange(st.shape[-2])
    s_eff = _np(staleness_bound_matrix(cfg, readers, P,
                                       retry_budget=retry_budget))
    live = _np(trace.live) if trace.live is not None else None
    if live is not None and live.shape[-1] == st.shape[-2]:
        live_r = live[:, :, None]                   # mask dead reader rows
    else:
        live_r = np.ones_like(st, dtype=bool)
    viol_old = int(((st < -(s_eff + 1)) & live_r).sum())
    viol_fresh = int(((st > -1) & live_r).sum())
    st_live = st[np.broadcast_to(live_r, st.shape)]
    return {"violations": viol_old + viol_fresh,
            "min": int(st_live.min()), "max": int(st_live.max()),
            "bound": -(int(np.max(s_eff)) + 1),
            "live_frac": float(np.broadcast_to(live_r, st.shape).mean())}


def cross_validate(app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
                   runtime=None, seed=0, return_trace: bool = False,
                   schedule=None, faults=None) -> dict:
    """Run both engines and check the model's oracle contract (see the
    module doc and :func:`contract`).  Every rank of the runtime's mesh
    calls it; each runs the oracle, ``simulate``, on its own device.

    Returns a dict with ``ok`` plus the per-model evidence;
    ``return_trace=True`` adds the runtime's `Trace` under ``"trace"``.
    ``schedule`` (fleet churn) and ``faults`` (a lossy wire) run both
    engines under the same schedule."""
    from .runtime import PSRuntime
    runtime = runtime or PSRuntime(device=app.x0.device)
    tr = runtime.run(app, cfg, n_clocks, seed=seed, schedule=schedule,
                     faults=faults)
    want = (simulate(app, cfg, n_clocks, seed=seed, schedule=schedule,
                     faults=faults) if cfg.model != "async" else None)
    out = contract(tr, want, cfg, faults=faults)
    if return_trace:
        out["trace"] = tr
    return out


def contract(tr, want, cfg: ConsistencyConfig, faults=None) -> dict:
    """The oracle contract of a runtime trace ``tr`` against the
    simulator's ``want`` on the same inputs (``None`` for async): bsp,
    ssp and essp bit-identical, ssp and essp without ``faults`` also in
    the staleness bound; vap in the value bound with exact decisions and
    floats within the budget; async finite.  Returns the evidence with
    ``ok``."""
    from ..core import valuebound      # it reads this module's helpers
    out: dict = {"model": cfg.model}
    if cfg.model in ("bsp", "ssp", "essp"):
        diffs = trace_max_diff(tr, want)
        out["max_diff"] = diffs
        out["ok"] = all(v == 0.0 for v in diffs.values())
        if cfg.model in ("ssp", "essp") and faults is None:
            chk = check_staleness_bound(tr, cfg)
            out.update(chk)
            out["ok"] = out["ok"] and chk["violations"] == 0
    elif cfg.model == "vap":
        chk = valuebound.check_condition(tr, float(cfg.v0))
        out.update(chk)
        decisions_ok = all(
            np.array_equal(_np(getattr(tr, name)), _np(getattr(want, name)))
            for name in ("staleness", "forced", "delivered"))
        ulps = trace_max_ulp(tr, want)
        out["decisions_exact"] = decisions_ok
        out["max_ulp"] = ulps
        out["ok"] = (chk["violations"] == 0 and decisions_ok
                     and max(ulps.values()) <= VAP_ULP_BUDGET)
    else:  # async has no bound to check; just require finite traces
        out["ok"] = bool(np.isfinite(_np(tr.loss_ref)).all())
    return out
