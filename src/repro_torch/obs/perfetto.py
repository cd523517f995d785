"""Chrome/Perfetto ``trace_event`` export of an obs event stream.

The port's copy of ``repro/obs/perfetto.py`` (JSON only, no JAX).
``from_events`` renders the JSONL stream of `obs.events` into the
trace-event JSON that ``ui.perfetto.dev`` (or ``chrome://tracing``) opens
directly:

- **process 0 — the run**: one ``clock`` lane (complete ``X`` spans, one
  per clock with loss/fleet args) above a lane per worker carrying its
  per-clock step spans (modeled compute + blocking-fetch seconds),
  ``stale_read`` instants where the staleness bound tripped, and
  ``outage`` spans covering churn windows (death → rejoin, or run end);
  ``live_workers`` and ``loss_ref`` ride as counter tracks;
- **process 1 — the cross-pod wire**: a lane per producer with one
  ``ship`` span per shipment (duration = that producer's share of the
  clock's modeled wire seconds, args = floats on the wire).

Timestamps are the stream's modeled seconds converted to µs (the
trace-event unit) — the common `TimeModel` timebase, so lanes line up
with the wall-second benchmark claims.  Output is deterministic for a
given stream (events ordered as emitted, keys sorted by the writer), and
byte-equal to the JAX package's on the same stream;
``tests/golden/perfetto_small.json`` pins a small golden.
"""
from __future__ import annotations

import json

# trace-event phase codes: X complete span, i instant, C counter, M metadata
_PID_RUN = 0
_PID_WIRE = 1


def _us(seconds: float) -> float:
    return round(float(seconds) * 1e6, 3)


def from_events(events: list[dict]) -> dict:
    """Build the Perfetto/Chrome trace dict for one validated stream."""
    head = events[0]
    if head.get("type") != "run_start":
        raise ValueError("event stream must open with run_start "
                         "(run it through events.validate_events)")
    P = head["n_workers"]
    run = head["run"]
    te: list[dict] = []

    def meta(pid, name, args, tid=None):
        e = {"ph": "M", "pid": pid, "name": name, "args": args}
        if tid is not None:
            e["tid"] = tid
        te.append(e)

    meta(_PID_RUN, "process_name", {"name": f"ps-run:{run} ({head['model']})"})
    meta(_PID_RUN, "thread_name", {"name": "clocks"}, tid=0)
    for p in range(P):
        meta(_PID_RUN, "thread_name", {"name": f"worker {p}"}, tid=p + 1)
    if head["n_pods"] > 1:
        meta(_PID_WIRE, "process_name",
             {"name": f"xpod-wire:{run} ({head['n_pods']} pods)"})
        for p in range(P):
            meta(_PID_WIRE, "thread_name", {"name": f"producer {p}"},
                 tid=p + 1)

    down_since: dict[int, float] = {}     # worker -> outage start (s)
    end_ts = events[-1]["ts"] if events[-1].get("type") == "run_end" else 0.0

    for e in events:
        t = e.get("type")
        if t == "clock":
            te.append({"ph": "X", "pid": _PID_RUN, "tid": 0,
                       "ts": _us(e["ts"]), "dur": _us(e["dur"]),
                       "name": f"clock {e['t']}", "cat": "clock",
                       "args": {"loss_ref": e["loss_ref"],
                                "forced": e["forced"],
                                "delivered": e["delivered"],
                                "live": e["live"],
                                "ship_floats": e["ship_floats"]}})
            te.append({"ph": "C", "pid": _PID_RUN, "tid": 0,
                       "ts": _us(e["ts"]), "name": "live_workers",
                       "args": {"live": e["live"]}})
            te.append({"ph": "C", "pid": _PID_RUN, "tid": 0,
                       "ts": _us(e["ts"]), "name": "loss_ref",
                       "args": {"loss": e["loss_ref"]}})
        elif t == "worker_span":
            te.append({"ph": "X", "pid": _PID_RUN, "tid": e["worker"] + 1,
                       "ts": _us(e["ts"]), "dur": _us(e["dur"]),
                       "name": "step", "cat": "worker",
                       "args": {"t": e["t"], "comp_s": e["comp_s"],
                                "sync_s": e["sync_s"]}})
        elif t == "stale_read":
            te.append({"ph": "i", "pid": _PID_RUN, "tid": e["worker"] + 1,
                       "ts": _us(e["ts"]), "s": "t",
                       "name": f"stale_read lag={e['max_lag']}",
                       "cat": "staleness",
                       "args": {"t": e["t"], "n_forced": e["n_forced"],
                                "max_lag": e["max_lag"]}})
        elif t == "shipment":
            te.append({"ph": "X", "pid": _PID_WIRE, "tid": e["worker"] + 1,
                       "ts": _us(e["ts"]), "dur": _us(e["dur"]),
                       "name": "ship", "cat": "wire",
                       "args": {"t": e["t"], "floats": e["floats"]}})
        elif t == "churn":
            if e["event"] == "down":
                down_since.setdefault(e["worker"], e["ts"])
            else:
                start = down_since.pop(e["worker"], None)
                if start is not None:
                    te.append(_outage(e["worker"], start, e["ts"]))
    # workers still down at run end: close their outage window at the end
    for p, start in sorted(down_since.items()):
        te.append(_outage(p, start, end_ts))

    return {"traceEvents": te, "displayTimeUnit": "ms",
            "otherData": {"schema": f"repro.obs v{head['v']}", "run": run}}


def _outage(worker: int, start_s: float, end_s: float) -> dict:
    return {"ph": "X", "pid": _PID_RUN, "tid": worker + 1,
            "ts": _us(start_s), "dur": _us(end_s - start_s),
            "name": "outage", "cat": "churn",
            "args": {"worker": worker}}


def write_trace(events: list[dict], path) -> dict:
    """Export ``events`` to a ``.perfetto.json`` file; returns the dict."""
    trace = from_events(events)
    with open(path, "w") as f:
        json.dump(trace, f, sort_keys=True, separators=(",", ":"))
    return trace
