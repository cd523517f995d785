"""Trace comparison and staleness-contract checks.

The port's copy of the parity helpers of ``repro/psrun/validate.py`` (the
sharded runtime itself waits for a later slice).  They take any trace
whose fields are numpy arrays, CPU or CUDA tensors, or JAX arrays, so the
port's traces can be held against the JAX package's and a card run
against a CPU run.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.consistency import ConsistencyConfig
from ..core.delays import staleness_bound_matrix

TRACE_FIELDS = ("loss_ref", "loss_view", "staleness", "forced", "delivered",
                "u_l2", "intransit_inf", "ship_floats", "live", "x_final")
INT_FIELDS = ("staleness", "forced", "delivered", "live")
FLOAT_FIELDS = tuple(f for f in TRACE_FIELDS if f not in INT_FIELDS)

# Float drift budget, in float32 ulp of each field's scale
# (:func:`trace_max_ulp`).  The JAX package set it for its own engines;
# the port is held to the same number against the JAX simulator and
# between the card and the CPU, where reduction orders differ.
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
