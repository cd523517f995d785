"""Versioned, schema-checked JSONL event stream of one PS run.

The port of ``repro/obs/events.py`` (the same schema, version 1.2).
``collect_events`` turns a `Trace` (of tensors on any device, or of numpy
arrays) into a flat list of event dicts on the modeled timebase of
`core.timemodel.TimeModel.timeline_np`: every timestamp and duration is
in modeled seconds from run start.

Stream layout (one JSON object per line, ``write_jsonl``/``read_jsonl``):

- ``run_start``: schema version (``v``, ``vm``), run name, model, config
  family, fleet shape, clock count, the declared staleness ``bound`` and,
  under a lossy wire, its ``retry_budget``;
- per clock ``t``: one ``clock`` summary, a ``worker_span`` per live
  worker, a ``shipment`` per producer that put floats on the cross-pod
  wire (hierarchical runs), a ``stale_read`` per reader whose bound
  tripped, and a ``churn`` transition per worker that died or rejoined
  entering this clock;
- ``metrics``: one snapshot of a `MetricsRegistry` (when given);
- ``run_end``: totals.

``validate_events`` checks a stream against ``SCHEMA``: known types,
required fields with the right types, the major version, header and
terminator placement, and non-decreasing clock order.  A minor version
bump is additive only: unknown fields are always accepted, unknown event
types only from a newer minor.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .metrics import MetricsRegistry

SCHEMA_VERSION = 1          # major: compatibility-breaking changes
SCHEMA_MINOR = 2            # minor: additive fields / event types

# required fields per event type (beyond "type"); values document the
# expected JSON type and are checked by validate_events.
SCHEMA = {
    "run_start": {"v": int, "run": str, "model": str, "family": str,
                  "n_workers": int, "n_pods": int, "n_clocks": int,
                  "ts": float},
    "clock": {"t": int, "ts": float, "dur": float, "loss_ref": float,
              "forced": int, "delivered": int, "live": int,
              "ship_floats": float},
    "worker_span": {"t": int, "worker": int, "ts": float, "dur": float,
                    "comp_s": float, "sync_s": float},
    "shipment": {"t": int, "worker": int, "ts": float, "dur": float,
                 "floats": float},
    "stale_read": {"t": int, "worker": int, "ts": float, "n_forced": int,
                   "max_lag": int},
    "churn": {"t": int, "worker": int, "ts": float, "event": str},
    "metrics": {"ts": float, "registry": dict},
    "slo_violation": {"t": int, "ts": float, "slo": str, "window": int,
                      "value": float, "limit": float},
    "recovery_action": {"t": int, "ts": float, "action": str},
    "run_end": {"ts": float, "wall_s": float, "comp_s": float,
                "comm_s": float, "wire_s": float, "clocks": int},
}

# optional fields per event type (type-checked when present, never
# required): the minor-version extension surface.  Anything *not* listed
# here is still accepted — a newer minor may carry fields this build has
# never heard of — but what we do know about must have the right type.
SCHEMA_OPTIONAL = {
    "run_start": {"vm": int, "bound": int, "retry_budget": int},
    "clock": {"lag_p99": float, "lag_max": int},
    "recovery_action": {"worker": int, "pod": int, "reason": str,
                        "quant": str, "agg_clocks": int, "clocks": int},
}


class SchemaError(ValueError):
    """An event stream violating the versioned schema."""


def declared_bound(cfg, retry_budget: int = 0) -> int | None:
    """The run's declared worst-case read lag in clocks, or ``None`` for
    families without a clock bound (async; VAP is value-bounded).

    The two-tier contract of `core.delays.staleness_bound_matrix`:
    ``s`` intra-pod, widened to ``s + s_xpod + agg_clocks - 1`` on
    cross-pod channels, plus ``retry_budget`` under a lossy wire
    (`comm.wire.WireFaults.retry_budget` — 0 on a perfect wire).
    Stamped on ``run_start`` so stream consumers (the SLO monitor)
    check the contract the producer actually declared rather than
    re-deriving it from a config they don't have.
    """
    if cfg.model not in ("bsp", "ssp", "essp"):
        return None
    bound = int(cfg.staleness)
    if int(cfg.n_pods) > 1:
        bound += int(cfg.s_xpod)
        if cfg.comm_active:
            bound += int(cfg.agg_clocks) - 1 + int(retry_budget)
    return bound


def clock_lag_stats(staleness_t, live_t) -> tuple[float, int] | None:
    """One clock's live-reader read-lag stats ``(lag_p99, lag_max)``.

    ``staleness_t`` is the clock's ``[P, P]`` staleness rows, ``live_t``
    its ``[P]`` liveness mask; dead readers perform no read and are
    excluded.  Shared by the producer (``collect_events``) and any
    consumer-side ground truth, so "SLO verdicts agree with the Trace"
    is one computation.  ``None`` when no reader is live.
    """
    lag = -1 - _np(staleness_t)
    rows = lag[_np(live_t).astype(bool)]
    if rows.size == 0:
        return None
    return _r(np.percentile(rows, 99)), int(rows.max())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _r(x) -> float:
    """Timestamps/durations rounded to ns so streams are byte-stable
    across platforms (the goldens pin the JSON text)."""
    return round(float(x), 9)


def collect_events(trace, cfg, tm, model: str | None = None, fold=(),
                   schedule=None, run: str = "run",
                   registry: MetricsRegistry | None = None,
                   faults=None) -> list[dict]:
    """Flatten one run into the event stream (see module doc).

    ``trace`` must be unbatched (one run, clock axis leading); ``cfg`` is
    the run's `ConsistencyConfig` and ``tm`` the port's `TimeModel`, whose
    ``timeline_np`` provides the timebase (computed on the trace's
    device).  ``model`` defaults to ``cfg.model``.  ``faults`` (a
    `comm.wire.WireFaults`) widens the declared bound by its retry budget
    and stamps ``run_start.retry_budget``.
    """
    model = cfg.model if model is None else model
    tl = tm.timeline_np(trace, model, fold=fold, cfg=cfg,
                        schedule=schedule)
    staleness = _np(trace.staleness)                 # [T, P, P]
    forced = _np(trace.forced)
    delivered = _np(trace.delivered)
    ship = _np(trace.ship_floats)                    # [T, P]
    live = _np(trace.live)                           # [T, P]
    loss_ref = _np(trace.loss_ref)
    T, P, _ = staleness.shape
    tiered = cfg.n_pods > 1

    head = {
        "type": "run_start", "v": SCHEMA_VERSION, "vm": SCHEMA_MINOR,
        "run": run, "model": model, "family": str(cfg.family),
        "n_workers": P, "n_pods": int(cfg.n_pods), "n_clocks": T,
        "ts": 0.0,
    }
    retry_budget = 0 if faults is None else int(faults.retry_budget)
    bound = declared_bound(cfg, retry_budget=retry_budget)
    if bound is not None:
        head["bound"] = bound
    if retry_budget:
        head["retry_budget"] = retry_budget
    ev: list[dict] = [head]
    prev_live = np.ones((P,), bool)
    for t in range(T):
        ts, dur = _r(tl["start"][t]), _r(tl["wall"][t])
        for p in np.flatnonzero(live[t] != prev_live):
            ev.append({"type": "churn", "t": t, "worker": int(p), "ts": ts,
                       "event": "up" if live[t, p] else "down"})
        prev_live = live[t]
        clock = {
            "type": "clock", "t": t, "ts": ts, "dur": dur,
            "loss_ref": float(loss_ref[t]),
            "forced": int(forced[t].sum()), "delivered": int(delivered[t].sum()),
            "live": int(live[t].sum()), "ship_floats": float(ship[t].sum()),
        }
        stats = clock_lag_stats(staleness[t], live[t])
        if stats is not None:
            clock["lag_p99"], clock["lag_max"] = stats
        ev.append(clock)
        for p in range(P):
            if not live[t, p]:
                continue
            ev.append({
                "type": "worker_span", "t": t, "worker": p, "ts": ts,
                "dur": _r(tl["comp"][t, p] + tl["sync"][t, p]),
                "comp_s": _r(tl["comp"][t, p]),
                "sync_s": _r(tl["sync"][t, p]),
            })
            n_forced = int(forced[t, p].sum())
            if n_forced:
                lag = -1 - staleness[t, p]
                ev.append({
                    "type": "stale_read", "t": t, "worker": p, "ts": ts,
                    "n_forced": n_forced,
                    "max_lag": int(lag.max()),
                })
        if tiered and ship[t].any():
            # allocate the clock's wire seconds across the shipping
            # producers in proportion to their floats
            tot = ship[t].sum()
            for p in np.flatnonzero(ship[t] > 0):
                ev.append({
                    "type": "shipment", "t": t, "worker": int(p), "ts": ts,
                    "dur": _r(tl["wire"][t] * ship[t, p] / tot),
                    "floats": float(ship[t, p]),
                })
    if registry is not None:
        ev.append({"type": "metrics", "ts": _r(tl["end"][-1]),
                   "registry": registry.to_dict()})
    ev.append({
        "type": "run_end", "ts": _r(tl["end"][-1]),
        "wall_s": _r(tl["wall"].sum()), "comp_s": _r(tl["comp_clock"].sum()),
        "comm_s": _r(tl["comm_clock"].sum()), "wire_s": _r(tl["wire"].sum()),
        "clocks": T,
    })
    return ev


def check_version(events: list[dict]) -> tuple[int, int]:
    """The stream's ``(major, minor)``; `SchemaError` on major mismatch.

    Consumers (`obs.monitor`, `ctrl.recover`) call this before reading
    anything else: same major means every event type and field
    they know keeps its meaning; a newer minor only ever *adds*.
    """
    if not events:
        raise SchemaError("empty event stream")
    if events[0].get("type") != "run_start":
        raise SchemaError(f"stream must open with run_start, got "
                          f"{events[0].get('type')!r}")
    v = events[0].get("v")
    if v != SCHEMA_VERSION:
        raise SchemaError(f"major schema version {v!r} != {SCHEMA_VERSION} "
                          f"— incompatible stream")
    return v, events[0].get("vm", 0)


def _check_fields(e: dict, spec: dict, optional: dict, i: int,
                  etype: str) -> None:
    for field in spec:
        if field not in e:
            raise SchemaError(f"event {i} ({etype}): missing {field!r}")
    for field, ftype in [*spec.items(), *optional.items()]:
        if field not in e:
            continue                      # optional and absent
        v = e[field]
        ok = (isinstance(v, (int, float)) and not isinstance(v, bool)
              if ftype is float else isinstance(v, ftype))
        if not ok:
            raise SchemaError(f"event {i} ({etype}): {field}="
                              f"{v!r} is not {ftype.__name__}")


def validate_events(events: list[dict]) -> None:
    """Raise `SchemaError` unless ``events`` is a valid major-version-1
    stream (any minor — see the module's forward-compatibility policy)."""
    _, minor = check_version(events)
    if events[-1].get("type") != "run_end":
        raise SchemaError(f"stream must close with run_end, got "
                          f"{events[-1].get('type')!r}")
    n_clocks = events[0]["n_clocks"]
    last_t = -1
    for i, e in enumerate(events):
        etype = e.get("type")
        spec = SCHEMA.get(etype)
        if spec is None:
            if minor > SCHEMA_MINOR:
                continue    # a newer producer's additive event type
            raise SchemaError(f"event {i}: unknown type {etype!r} in a "
                              f"v{SCHEMA_VERSION}.{minor} stream (ours is "
                              f".{SCHEMA_MINOR})")
        _check_fields(e, spec, SCHEMA_OPTIONAL.get(etype, {}), i, etype)
        if "ts" in e and e["ts"] < 0:
            raise SchemaError(f"event {i} ({etype}): negative ts")
        if "t" in e:
            if not (0 <= e["t"] < n_clocks):
                raise SchemaError(f"event {i} ({etype}): clock {e['t']} "
                                  f"outside [0, {n_clocks})")
            if e["t"] < last_t:
                raise SchemaError(f"event {i} ({etype}): clock order "
                                  f"regressed ({e['t']} after {last_t})")
            last_t = e["t"]
        if i > 0 and etype == "run_start":
            raise SchemaError(f"event {i}: duplicate run_start")


def write_jsonl(events: list[dict], path) -> None:
    """One event per line; validates before writing."""
    validate_events(events)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e, sort_keys=True) + "\n")


def read_jsonl(path) -> list[dict]:
    """Load and re-validate a stream written by ``write_jsonl``."""
    with open(path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    validate_events(events)
    return events
