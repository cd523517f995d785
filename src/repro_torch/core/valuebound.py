"""VAP value-bound schedules and condition checking.

The port's copy of ``repro/core/valuebound.py`` (numpy only; a trace's
fields may be numpy arrays or tensors).  The enforcement itself lives in
``ps.simulate``; this module holds the schedule definitions and the
post-hoc verification (paper eq. 1 and Theorem 1's ``v_t = v0/sqrt(t)``).
"""
from __future__ import annotations

import numpy as np

from ..psrun.validate import _np


def v_schedule(v0: float, kind: str = "inv_sqrt"):
    """Returns v_t as a function of the clock (0-indexed).

    - ``inv_sqrt``: the paper's v0/sqrt(t+1) (Theorem 1's decreasing bound);
    - ``constant``: fixed threshold (no convergence guarantee as updates
      shrink);
    - ``inv_t``: faster decay (stress case: forces ~full synchronization).
    """
    if kind == "inv_sqrt":
        return lambda t: v0 / np.sqrt(t + 1.0)
    if kind == "constant":
        return lambda t: v0
    if kind == "inv_t":
        return lambda t: v0 / (t + 1.0)
    raise ValueError(kind)


def check_condition(trace, v0: float, kind: str = "inv_sqrt",
                    tol: float = 1e-6) -> dict:
    """Verify ``intransit_inf[t] <= v_t`` over a simulation trace: reads at
    clock c check the in-transit aggregate accumulated through c-1 against
    the bound at c-1."""
    it = _np(trace.intransit_inf)
    sched = v_schedule(v0, kind)
    vt = np.array([sched(t) for t in range(len(it))])
    viol = it[1:] > vt[:-1] + tol
    return {
        "violations": int(viol.sum()),
        "violation_frac": float(viol.mean()) if len(viol) else 0.0,
        "max_intransit": float(it.max()),
        "bound_final": float(vt[-1]),
    }


def sync_cost(trace) -> dict:
    """Forced synchronous deliveries — the paper's impracticality metric."""
    forced = _np(trace.forced)
    T, P, _ = forced.shape
    per_clock = forced.sum(axis=(1, 2))
    return {
        "forced_total": int(forced.sum()),
        "forced_per_clock": float(per_clock.mean()),
        "full_sync_fraction": float(
            (per_clock >= P * (P - 1) * 0.9).mean()),
    }
