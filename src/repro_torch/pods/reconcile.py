"""Replica-level readouts of the cross-pod reconciliation channel.

The port's copy of ``repro/pods/reconcile.py``: numpy readouts of a trace
whose fields are numpy arrays or tensors.  Each pod's replica state with
respect to producer ``q`` is summarized by the replica clock

    rep[g, q] = min_{live r in pod g} cview[r, q]

and the channel by two quantities of any `Trace`:

- **replica divergence** ``max_g rep[g, q] - min_g rep[g, q]``, bounded
  under SSP/ESSP by ``s + s_xpod`` (``+ agg_clocks - 1`` under the comm
  substrate);
- **reconciliation traffic** (`reconcile_stats`): eager deliveries and
  clock-gated pulls on cross-pod channels, and floats on the wire, both
  as a dense-equivalent count and as the bits-weighted count that
  ``Trace.ship_floats`` records under the comm substrate
  (``wire_floats``, ``wire_compression``);
- **replica value divergence** (`replica_value_divergence`), the checked
  value-bound analogue for the unbounded-clock models (async/VAP): two
  pods' visible prefixes of one producer differ by a sub-range of some
  reader's in-transit aggregate, so their divergence is at most
  ``2 x intransit_inf``, which VAP bounds by ``2 v_t``.
"""
from __future__ import annotations

import numpy as np

from ..core.consistency import ConsistencyConfig
from ..core.delays import pod_of, same_pod_mask
from ..core.valuebound import v_schedule
from ..psrun.validate import _np


def xpod_channel_mask(cfg: ConsistencyConfig, P: int) -> np.ndarray:
    """[reader, producer] bool: True where the channel crosses pods."""
    return ~same_pod_mask(P, cfg.n_pods).numpy()


REPLICA_DEAD = np.iinfo(np.int64).max
"""Sentinel `replica_clock` value for a pod with no live reader at a clock
(its frozen rows say nothing about the replica's guarantees)."""


def replica_clock(trace, cfg: ConsistencyConfig) -> np.ndarray:
    """Per-clock replica clocks ``rep[t, g, q]`` relative to the barrier:
    the staleness of pod ``g``'s weakest *live* reader of producer ``q``
    (``-1`` means "replica g has everything through the barrier from
    q"); `REPLICA_DEAD` where pod ``g`` has no live reader."""
    st = _np(trace.staleness).astype(np.int64)          # [T, P, P]
    P = st.shape[-1]
    pods = pod_of(P, cfg.n_pods).numpy()
    live = (_np(trace.live) if trace.live is not None
            else np.ones(st.shape[:2], bool))           # [T, P(r)]
    stm = np.where(live[:, :, None], st, REPLICA_DEAD)
    return np.stack([stm[:, pods == g, :].min(axis=1)
                     for g in range(cfg.n_pods)], axis=1)   # [T, G, P]


def replica_divergence(trace, cfg: ConsistencyConfig) -> dict:
    """Max drift between pods' visible prefixes, against the two-tier bound.

    Returns ``{max, bound, ok, per_clock}``; ``bound`` is ``s + s_xpod``
    (``+ agg_clocks - 1`` under the comm substrate) for SSP/ESSP and 0 for
    BSP.  Async/VAP have no clock bound: ``bound`` and ``ok`` are None."""
    rep = replica_clock(trace, cfg)                     # [T, G, P]
    valid = rep != REPLICA_DEAD
    # divergence only where >= 2 pods have live readers
    rmax = np.where(valid, rep, np.iinfo(np.int64).min).max(axis=1)
    rmin = np.where(valid, rep, REPLICA_DEAD).min(axis=1)
    div = np.where(valid.sum(axis=1) >= 2, rmax - rmin, 0)   # [T, P]
    out = {"max": int(div.max()) if div.size else 0,
           "per_clock": div.max(axis=-1)}
    if cfg.model == "bsp":
        out["bound"] = 0
    elif cfg.model in ("ssp", "essp"):
        out["bound"] = int(cfg.staleness) + int(cfg.s_xpod)
        if cfg.comm_active:
            out["bound"] += int(cfg.agg_clocks) - 1
    else:
        out["bound"] = None
    out["ok"] = None if out["bound"] is None else out["max"] <= out["bound"]
    return out


def reconcile_stats(trace, cfg: ConsistencyConfig,
                    dim: int | None = None) -> dict:
    """Cross-pod reconciliation traffic of one run.

    Counts eager deliveries and clock-gated forced pulls on cross-pod
    channels and, when ``dim`` is given, floats on the wire two ways:

    - **dense-equivalent**: one ``d``-float delta per event
      (``delta_floats``) against a full ``W x P x d`` replica transfer
      (``dense_equiv_compression``);
    - **bits-weighted**: per cross-pod channel, the sum of
      ``Trace.ship_floats`` over every shipment that became visible there
      (``wire_floats``; dense pull-based SSP, which ships nothing, counts
      one ``d``-float delta per gated pull).  ``wire_compression`` is the
      dense count of the same visibility trajectory (``dense_floats``)
      over it.
    """
    delivered = _np(trace.delivered)                    # [T, P, P]
    forced = _np(trace.forced)
    st = _np(trace.staleness)
    T, _, P = delivered.shape
    x = xpod_channel_mask(cfg, P)
    eager = int(delivered[:, x].sum())
    gated = int(forced[:, x].sum())
    out = {"xpod_channels": int(x.sum()),
           "n_clocks": T,
           "eager_deliveries": eager,
           "gated_pulls": gated,
           "eager_per_clock": eager / max(T, 1),
           "gated_per_clock": gated / max(T, 1)}
    if dim is not None:
        W = cfg.effective_window
        events = eager + gated
        delta_floats = events * dim
        out["delta_floats"] = delta_floats
        out["dense_equiv_compression"] = (events * W * P * dim / delta_floats
                                          if delta_floats else None)
        if x.any():
            # each shipment of producer q crosses channel (r, q) once, when
            # it becomes visible there; the last read's visible prefix
            # says which shipments those were
            ship = _np(trace.ship_floats)               # [T, P]
            cum = np.concatenate([np.zeros((1, P), ship.dtype),
                                  np.cumsum(ship, axis=0)])  # [T+1, P]
            vis = np.clip(st[-1] + (T - 1) + 1, 0, T)   # shipments seen
            per_chan = cum[vis, np.arange(P)[None, :]]  # [P(r), P(q)]
            if cfg.model == "ssp" and not cfg.comm_active:
                wire = dense = float(gated * dim)
            else:
                wire = float(per_chan[x].sum())
                dense = float(vis[x].sum() * dim)
            out["wire_floats"] = wire
            out["dense_floats"] = dense
            out["wire_compression"] = dense / wire if wire else None
    return out


def replica_value_divergence(trace, cfg: ConsistencyConfig) -> dict:
    """Checked *value*-bound analogue of `replica_divergence` for async and
    VAP.  The trace's measured envelope ``2 x intransit_inf`` bounds the
    inf-norm gap between any two pods' visible prefixes of a producer
    (triangle inequality on in-transit suffixes); under VAP it is checked
    against ``2 v_t`` (``v_t = v0/sqrt(t+1)``, one clock behind, as
    `core.valuebound.check_condition` reads it).  For every other model
    ``bound_final``, ``violations`` and ``ok`` are None."""
    envelope = 2.0 * _np(trace.intransit_inf)           # [T]
    out = {"max_envelope": float(envelope.max()) if envelope.size else 0.0,
           "per_clock": envelope}
    if cfg.model == "vap":
        sched = v_schedule(float(cfg.v0))
        vt = np.array([2.0 * sched(t) for t in range(len(envelope))])
        viol = envelope[1:] > vt[:-1] + 1e-6
        out["bound_final"] = float(vt[-1]) if len(vt) else None
        out["violations"] = int(viol.sum())
        out["ok"] = bool(viol.sum() == 0)
    else:
        out["bound_final"] = None
        out["violations"] = None
        out["ok"] = None
    return out
