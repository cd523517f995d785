"""Detect -> act: a recovery controller over the observability stream.

The port's copy of ``repro/ctrl/recover.py``: the controller turns the
verdicts and windowed ``slo_violation`` events of `obs.monitor` into
typed ``recovery_action`` events (schema 1.2), keyed on the stream's
schema version, with no hook inside the simulator.

  stream  --monitor_stream-->  verdicts + violations  --plan_recovery-->
  ``recovery_action`` events

Action catalog:

``refresh_burst``
    A worker rejoined (``worker_up``): ``policy.refresh_clocks`` clocks
    of full-prefix refresh for it.
``pod_restore``
    A pod went dark (``pod_down``): restore the pod's replica from its
    latest checkpoint (the pods runtime's rejoin path).
``degrade_comm``
    An SLO kind stayed in violation for ``policy.sustained_windows``
    consecutive windows: step down the quantization ladder (f32 -> bf16
    -> int8), then multiply ``agg_clocks`` by ``policy.agg_step`` (capped
    at ``policy.max_agg``).

Actions come only from verdicts and violations: a neutral stream yields
none.  numpy and stdlib only.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..obs.events import check_version
from ..obs.monitor import DetectorParams, SLOParams, monitor_stream


@dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for `plan_recovery` (see module doc for the action catalog).

    ``quant_ladder`` orders wire formats from heaviest to lightest; each
    sustained-violation streak advances one rung, and once the ladder is
    exhausted further streaks multiply ``agg_clocks`` by ``agg_step``
    up to ``max_agg``.
    """

    sustained_windows: int = 2        # consecutive violating windows
    quant_ladder: tuple = ("f32", "bf16", "int8")
    agg_step: int = 2                 # agg_clocks multiplier per rung
    max_agg: int = 8                  # agg_clocks ceiling
    refresh_clocks: int = 2           # forced-refresh burst length

    def __post_init__(self):
        if self.sustained_windows < 1:
            raise ValueError("sustained_windows must be >= 1")
        if len(self.quant_ladder) < 1:
            raise ValueError("quant_ladder must be non-empty")


def _action(t, ts, action, **extra) -> dict:
    ev = {"type": "recovery_action", "t": int(t), "ts": float(ts),
          "action": str(action)}
    ev.update({k: v for k, v in extra.items() if v is not None})
    return ev


def plan_recovery(events, detector: DetectorParams | None = None,
                  slo: SLOParams | None = None,
                  policy: RecoveryPolicy | None = None):
    """Map one event stream to the recovery actions it warrants.

    Checks the stream's schema version, runs the failure detector + SLO
    monitors (`obs.monitor.monitor_stream`), and translates their
    verdicts/violations through ``policy`` into ``recovery_action``
    event dicts (sorted by clock).  Returns ``(actions, result)`` where
    ``result`` is the underlying `MonitorResult` — callers that already
    have one can use `plan_from_result` instead.
    """
    events = list(events)
    check_version(events)        # keyed on the stream schema version
    result = monitor_stream(events, detector=detector, slo=slo)
    return plan_from_result(result, policy=policy), result


def plan_from_result(result, policy: RecoveryPolicy | None = None) -> list:
    """`plan_recovery` without re-running the monitors: map an existing
    `MonitorResult`'s verdicts + violations to recovery actions."""
    policy = policy or RecoveryPolicy()
    actions = []

    for v in result.verdicts:
        if v.get("kind") == "worker_up":
            actions.append(_action(
                v["t"], v["ts"], "refresh_burst", worker=v.get("worker"),
                clocks=policy.refresh_clocks, reason="worker rejoined"))
        elif v.get("kind") == "pod_down":
            actions.append(_action(
                v["t"], v["ts"], "pod_restore", pod=v.get("pod"),
                reason="pod down: restore from checkpoint via "
                       "pods.elastic.run_with_pod_rejoin"))

    # sustained-violation streaks, per SLO kind: a streak of
    # >= policy.sustained_windows *consecutive* violating windows
    # (window-closing clocks exactly one SLO window apart) escalates
    # one degradation rung; the streak resets after each emission.
    window = None
    for viol in result.violations:
        window = viol.get("window", window)
    streak: dict[str, list] = {}
    rung = 0
    n_quant = len(policy.quant_ladder)
    for viol in sorted(result.violations, key=lambda e: e["t"]):
        kind = viol.get("slo", "?")
        run = streak.setdefault(kind, [])
        w = viol.get("window", window) or 1
        if run and viol["t"] - run[-1]["t"] > w:
            run.clear()              # gap: not consecutive windows
        run.append(viol)
        if len(run) < policy.sustained_windows:
            continue
        rung += 1
        extra = {"reason": f"sustained {kind} violation "
                           f"({len(run)} windows)"}
        if rung < n_quant:
            extra["quant"] = policy.quant_ladder[rung]
        else:
            extra["quant"] = policy.quant_ladder[-1]
            mult = policy.agg_step ** (rung - n_quant + 1)
            extra["agg_clocks"] = min(mult, policy.max_agg)
        actions.append(_action(viol["t"], viol["ts"], "degrade_comm",
                               **extra))
        run.clear()                  # streak resets after emission
    actions.sort(key=lambda a: (a["t"], a["ts"]))
    return actions


def apply_actions(cfg, actions):
    """Fold ``degrade_comm`` actions into a `ConsistencyConfig`.

    Returns ``cfg`` rebuilt with the last action's quantization and its
    ``agg_clocks`` multiplier applied (capped by the multiplier value
    itself — `RecoveryPolicy.max_agg` already bounded it).  Non-comm
    actions (``refresh_burst``/``pod_restore``) don't change the config;
    they route through the engines' existing forced-refresh and
    `pods.elastic` checkpoint paths.
    """
    quant, mult = None, 1
    for a in actions:
        if a.get("action") != "degrade_comm":
            continue
        quant = a.get("quant", quant)
        mult = max(mult, int(a.get("agg_clocks", 1)))
    if quant is None and mult == 1:
        return cfg
    kw = {}
    if quant is not None:
        kw["quant"] = quant
    if mult > 1:
        kw["agg_clocks"] = max(cfg.agg_clocks, 1) * mult
    return cfg.replace(**kw)


def unrecovered_violations(violations, actions) -> list:
    """Violations no action answered: every ``slo_violation`` whose
    clock is later than the last recovery action's clock (or all of
    them, when the controller never fired).  The CLI's ``--actions``
    mode exits nonzero when this is non-empty."""
    last_t = max((a["t"] for a in actions), default=None)
    if last_t is None:
        return list(violations)
    return [v for v in violations if v["t"] > last_t]


def attach_actions(events, actions) -> list:
    """Splice ``recovery_action`` events into a stream at their clocks
    (after any same-clock events, before ``run_end``), keeping the
    result a valid schema-v1.x stream for replay/audit."""
    events = list(events)
    out, pending = [], sorted(actions, key=lambda a: (a["t"], a["ts"]))
    for ev in events:
        if ev.get("type") == "run_end":
            out.extend(pending)
            pending = []
        while pending and "t" in ev and ev.get("type") != "run_start" \
                and pending[0]["t"] < ev["t"]:
            out.append(pending.pop(0))
        out.append(ev)
    out.extend(pending)
    return out
