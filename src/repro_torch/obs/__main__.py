"""``python -m repro_torch.obs`` — one entry point over JSONL stream files.

The port of ``python -m repro.obs``: the same subcommands, arguments,
output and exit codes (``monitor --score`` reads the port's
`core.delays.score_detections`):

- ``tail FILE``      pretty-print a stream, newest-last; ``--type`` /
                     ``--worker`` filter, ``-n`` bounds the line count.
- ``validate FILE``  schema-check (`events.validate_events`); exit 1 on
                     the first violation.
- ``report FILE...`` markdown report over one or more streams
                     (`monitor.stream_summary` rows through
                     `report.render_report`).
- ``monitor FILE``   run the failure detector + SLO monitors
                     (`monitor.monitor_stream`); ``--score`` grades the
                     verdicts against the stream's own churn events as
                     oracle (`core.delays.score_detections` over
                     `monitor.live_from_events`); ``--actions`` runs the
                     recovery controller (`ctrl.recover.plan_recovery`)
                     and prints its decisions; ``--emit OUT`` writes
                     the stream with ``slo_violation`` (and, under
                     ``--actions``, ``recovery_action``) events spliced
                     in.  Exit 1 on ``--fail-on-false-alarm`` (scored
                     false alarm or missed outage), ``--fail-on-alarm``
                     (any worker_down — the neutral-artifact CI gate),
                     or, under ``--actions``, on any SLO violation the
                     controller left unrecovered.
- ``diff BASE CUR``  regression attribution (`obs.diff`):
                     ``BENCH_*.json`` pairs via ``diff_bench``, JSONL
                     pairs via ``diff_streams``; ``--markdown`` renders
                     `report.attribution_table` instead of plain lines.
- ``prom FILE``      OpenMetrics text from the stream's ``metrics``
                     registry snapshot (`promtext.render`).
"""
from __future__ import annotations

import argparse
import json
import sys

from . import diff as obs_diff
from . import promtext
from .events import SchemaError, validate_events
from .monitor import (DetectorParams, SLOParams, live_from_events,
                      monitor_stream, stream_summary)


def _load(path: str) -> list:
    """Parse a JSONL stream without validating — ``validate`` is its own
    subcommand, and the analysis paths check the version themselves."""
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        raise SystemExit(2) from e


def cmd_tail(args) -> int:
    ev = _load(args.file)
    if args.type:
        ev = [e for e in ev if e.get("type") == args.type]
    if args.worker is not None:
        ev = [e for e in ev if e.get("worker") == args.worker]
    for e in ev[-args.n:]:
        ts = e.get("ts")
        stamp = "        —" if ts is None else f"{ts:9.4f}"
        rest = {k: v for k, v in e.items() if k not in ("type", "ts")}
        if e.get("type") == "metrics":
            rest = {"registry": f"<{len(e['registry'].get('counters', {}))}"
                                f" counters, ...>"}
        body = " ".join(f"{k}={v}" for k, v in rest.items())
        print(f"{stamp}  {e.get('type', '?'):13s} {body}")
    return 0


def cmd_validate(args) -> int:
    ev = _load(args.file)
    try:
        validate_events(ev)
    except SchemaError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(f"OK: {len(ev)} events, schema v{ev[0]['v']}"
          f".{ev[0].get('vm', 0)}")
    return 0


def cmd_report(args) -> int:
    from .report import render_report

    rows = [stream_summary(_load(p)) for p in args.files]
    print(render_report(args.title, rows))
    return 0


def _monitor_params(args):
    det = DetectorParams(timeout_clocks=args.timeout)
    slo = SLOParams(window=args.window,
                    staleness_bound=args.staleness_bound,
                    min_clocks_per_s=args.min_clocks_per_s,
                    max_floats_per_clock=args.max_floats_per_clock)
    return det, slo


def cmd_monitor(args) -> int:
    from ..core.delays import score_detections

    ev = _load(args.file)
    det, slo = _monitor_params(args)
    res = monitor_stream(ev, det, slo)
    for v in res.verdicts:
        print(f"t={v['t']:4d}  {v['kind']:12s} "
              + " ".join(f"{k}={v[k]}" for k in ("worker", "pod", "missed",
                                                 "phi") if k in v))
    for v in res.violations:
        print(f"t={v['t']:4d}  slo:{v['slo']:9s} value={v['value']:g} "
              f"limit={v['limit']:g} window={v['window']}")
    print(json.dumps({"health": res.health}, indent=2, default=str))

    failed = False
    actions = None
    if args.actions:
        from ..ctrl.recover import (attach_actions, plan_from_result,
                                    unrecovered_violations)

        actions = plan_from_result(res)
        for a in actions:
            print(f"t={a['t']:4d}  act:{a['action']:13s} "
                  + " ".join(f"{k}={a[k]}" for k in ("worker", "pod",
                                                     "quant", "agg_clocks",
                                                     "clocks", "reason")
                             if k in a))
        unrec = unrecovered_violations(res.violations, actions)
        if unrec:
            print(f"UNRECOVERED: {len(unrec)} slo_violation(s) after the "
                  f"last recovery action", file=sys.stderr)
            failed = True
        res.events = attach_actions(res.events, actions)
    if args.score:
        live = live_from_events(ev)
        score = score_detections(live, res.verdicts, args.budget)
        print(json.dumps({"score": score}, indent=2, default=str))
        if args.fail_on_false_alarm and (score["n_false_alarms"] > 0
                                         or score["n_missed"] > 0):
            failed = True
    elif args.fail_on_false_alarm:
        print("warning: --fail-on-false-alarm needs --score (oracle "
              "churn events) — gating on any alarm instead",
              file=sys.stderr)
        failed = failed or res.health["n_worker_down"] > 0
    if args.fail_on_alarm and res.health["n_worker_down"] > 0:
        failed = True
    if args.emit:
        from .events import write_jsonl

        write_jsonl(res.events, args.emit)
    return 1 if failed else 0


def cmd_diff(args) -> int:
    if args.base.endswith(".json") and args.cur.endswith(".json"):
        with open(args.base) as f:
            base = json.load(f)
        with open(args.cur) as f:
            cur = json.load(f)
        d = obs_diff.diff_bench(base, cur)
    else:
        d = obs_diff.diff_streams(_load(args.base), _load(args.cur),
                                  loss_thresh=args.loss_thresh)
    if args.markdown:
        from .report import attribution_table

        print(attribution_table(d))
    else:
        for line in obs_diff.explain(d, top=args.top):
            print(line)
    return 0


def cmd_prom(args) -> int:
    ev = _load(args.file)
    snap = None
    for e in ev:
        if e.get("type") == "metrics":
            snap = e["registry"]
    if snap is None:
        print("error: stream carries no metrics event", file=sys.stderr)
        return 1
    sys.stdout.write(promtext.render(snap))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("tail", help="pretty-print / filter a stream")
    p.add_argument("file")
    p.add_argument("--type", help="keep only this event type")
    p.add_argument("--worker", type=int, help="keep only this worker")
    p.add_argument("-n", type=int, default=40, help="max lines")
    p.set_defaults(fn=cmd_tail)

    p = sub.add_parser("validate", help="schema-check a stream")
    p.add_argument("file")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("report", help="markdown report over streams")
    p.add_argument("files", nargs="+")
    p.add_argument("--title", default="obs stream report")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("monitor", help="failure detector + SLO monitors")
    p.add_argument("file")
    p.add_argument("--timeout", type=int, default=2,
                   help="missed-clock verdict trigger")
    p.add_argument("--window", type=int, default=8, help="SLO window")
    p.add_argument("--staleness-bound", type=int, default=None,
                   help="override the stream's declared bound")
    p.add_argument("--min-clocks-per-s", type=float, default=None)
    p.add_argument("--max-floats-per-clock", type=float, default=None)
    p.add_argument("--score", action="store_true",
                   help="grade verdicts against the stream's churn "
                        "events as oracle")
    p.add_argument("--budget", type=int, default=4,
                   help="clocks-to-detect budget for --score")
    p.add_argument("--fail-on-false-alarm", action="store_true",
                   help="exit 1 on a scored false alarm or missed outage")
    p.add_argument("--fail-on-alarm", action="store_true",
                   help="exit 1 on any worker_down (neutral artifacts)")
    p.add_argument("--actions", action="store_true",
                   help="run the recovery controller, print its "
                        "decisions; exit 1 on unrecovered violations")
    p.add_argument("--emit", help="write stream + slo_violation events")
    p.set_defaults(fn=cmd_monitor)

    p = sub.add_parser("diff", help="regression attribution")
    p.add_argument("base", help="baseline stream .jsonl or BENCH .json")
    p.add_argument("cur", help="current stream .jsonl or BENCH .json")
    p.add_argument("--loss-thresh", type=float, default=None,
                   help="attribute clocks-to-this-loss (streams only)")
    p.add_argument("--top", type=int, default=2,
                   help="components to explain")
    p.add_argument("--markdown", action="store_true")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("prom", help="OpenMetrics text from the stream's "
                                    "metrics snapshot")
    p.add_argument("file")
    p.set_defaults(fn=cmd_prom)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
