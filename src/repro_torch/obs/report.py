"""Markdown run reports: staleness / throughput / wire tables per family.

The port's copy of ``repro/obs/report.py`` (numpy over a trace whose
fields are tensors or arrays).  The human-facing end of the telemetry
substrate: ``trace_summary`` reduces one run (`Trace` + config + `TimeModel`) to a flat row of
headline telemetry — read-lag stats, tier-split forced refreshes, floats
on the cross-pod wire, modeled wall/compute/comm seconds —
``render_report`` lays a list of such rows out as a markdown document
(one row per consistency family/scenario), and ``churn_grid_table``
renders the robustness benchmark's family × failure-scenario grid.
"""
from __future__ import annotations

import numpy as np

from ..core.delays import same_pod_mask
from .metrics import MetricsRegistry, _np


def fmt(v) -> str:
    """One table cell: compact numbers, em-dash for missing."""
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        if v == 0:
            return "0"
        a = abs(v)
        if a >= 1e5 or a < 1e-3:
            return f"{v:.3g}"
        return f"{v:.3f}".rstrip("0").rstrip(".")
    return str(v)


def md_table(headers, rows) -> str:
    """GitHub-flavored markdown table (cells formatted via ``fmt``)."""
    head = "| " + " | ".join(str(h) for h in headers) + " |"
    sep = "|" + "|".join(" --- " for _ in headers) + "|"
    body = ["| " + " | ".join(fmt(c) for c in row) + " |" for row in rows]
    return "\n".join([head, sep, *body])


def trace_summary(trace, cfg, tm, label: str | None = None,
                  model: str | None = None, fold=(),
                  schedule=None) -> dict:
    """One run → one flat row of headline telemetry (host-side numpy).

    Works on any Trace producer's output, with or without ``Trace.obs``
    (the row is derived from the per-clock arrays; the on-device
    accumulators exist so *hot* paths don't need these arrays at all).
    """
    model = cfg.model if model is None else model
    staleness = _np(trace.staleness)                 # [T, P, P]
    forced = _np(trace.forced)
    live = _np(trace.live)                           # [T, P]
    loss_ref = _np(trace.loss_ref)
    T, P, _ = staleness.shape
    tl = tm.timeline_np(trace, model, fold=fold, cfg=cfg,
                        schedule=schedule)

    lag = -1 - staleness                             # read lag in clocks
    reader_live = np.broadcast_to(live[:, :, None], lag.shape)
    lags = lag[reader_live]
    in_pod = np.broadcast_to(
        _np(same_pod_mask(P, cfg.n_pods))[None], forced.shape)
    f_live = forced & reader_live
    wall_s = float(tl["wall"].sum())
    return {
        "label": model if label is None else label,
        "model": model, "family": str(cfg.family), "clocks": T,
        "loss_final": float(loss_ref[-1]),
        "lag_mean": float(lags.mean()) if lags.size else None,
        "lag_p99": (float(np.percentile(lags, 99)) if lags.size else None),
        "lag_max": int(lags.max()) if lags.size else None,
        "forced_intra": int((f_live & in_pod).sum()),
        "forced_xpod": int((f_live & ~in_pod).sum()),
        "delivered": int((_np(trace.delivered) & reader_live).sum()),
        "ship_floats": float(_np(trace.ship_floats).sum()),
        "dead_worker_clocks": int((~live).sum()),
        "wall_s": wall_s, "comp_s": float(tl["comp_clock"].sum()),
        "comm_s": float(tl["comm_clock"].sum()),
        "wire_s": float(tl["wire"].sum()),
        "clocks_per_s": (T / wall_s) if wall_s > 0 else None,
    }


def render_report(title: str, summaries: list[dict],
                  registry: MetricsRegistry | None = None,
                  notes=()) -> str:
    """Markdown report over one or more ``trace_summary`` rows."""
    parts = [f"# {title}", ""]
    for note in notes:
        parts += [f"> {note}", ""]
    parts += ["## Staleness", "", md_table(
        ["run", "lag mean", "lag p99", "lag max", "forced intra",
         "forced xpod", "delivered"],
        [[s["label"], s["lag_mean"], s["lag_p99"], s["lag_max"],
          s["forced_intra"], s["forced_xpod"], s["delivered"]]
         for s in summaries]), ""]
    parts += ["## Throughput", "", md_table(
        ["run", "clocks", "wall s", "comp s", "comm s", "clocks/s",
         "final loss", "dead worker-clocks"],
        [[s["label"], s["clocks"], s["wall_s"], s["comp_s"], s["comm_s"],
          s["clocks_per_s"], s["loss_final"], s["dead_worker_clocks"]]
         for s in summaries]), ""]
    parts += ["## Wire", "", md_table(
        ["run", "floats shipped", "wire s"],
        [[s["label"], s["ship_floats"], s["wire_s"]]
         for s in summaries]), ""]
    if registry is not None:
        flat = registry.flat()
        parts += ["## Metrics", "", md_table(
            ["metric", "value"],
            [[k, flat[k]] for k in sorted(flat)]), ""]
    return "\n".join(parts)


def attribution_table(diff: dict) -> str:
    """One `obs.diff` result -> markdown attribution section.

    Stream diffs render the component share table plus the exact wall
    split; BENCH diffs render the ranked component/driver table.  Either
    way the table answers "which subsystem moved" — `benchmarks.compare`
    prints the same content as plain lines (`obs.diff.explain`).
    """
    if diff["kind"] == "streams":
        head = [f"## Attribution: {diff['base_run']} -> "
                f"{diff['cur_run']}", ""]
        d = diff["target_delta"]
        if d is not None:
            head += [f"> {diff['target']}: {fmt(diff['target_base'])} -> "
                     f"{fmt(diff['target_cur'])} ({d:+g})", ""]
        comp_tbl = md_table(
            ["component", "indicator", "base", "cur", "share"],
            [[name, c["indicator"], c["base"], c["cur"],
              f"{c['share']:.0%}"]
             for name in diff["ranked"]
             for c in [diff["components"][name]]])
        wall_tbl = md_table(
            ["seconds", "base", "cur", "delta"],
            [[k, w["base"], w["cur"], w["delta"]]
             for k, w in diff["wall"].items()])
        return "\n".join([*head, comp_tbl, "", "### Wall split (exact)",
                          "", wall_tbl])
    rows = []
    for name, comp in diff["flipped_claims"]:
        rows.append([comp, f"claim {name}", "True", "False", "flipped"])
    for name in diff["ranked"]:
        c = diff["components"][name]
        if c["driver"] is not None:
            rows.append([name, c["driver"], None, None,
                         f"{c['driver_rel']:+.1%}"])
    return "\n".join([
        f"## Attribution: BENCH_{diff.get('bench')}", "",
        md_table(["component", "driver", "base", "cur", "moved"],
                 rows or [["—", "no attributable movement", None, None,
                           "—"]])])


def churn_cell(row: dict) -> str:
    """One grid cell: ``clocks (+lost)``, ∞ for never-recovered, ``DIV``
    appended on divergence."""
    c = row.get("clocks_to_thresh")
    cell = "∞" if c is None else str(c)
    lost = row.get("lost_clocks")
    if lost is not None and lost != 0:
        cell += f" ({lost:+d})"
    if row.get("diverged"):
        cell += " DIV"
    return cell


def churn_grid_table(grid: dict, scenarios=None) -> str:
    """The robustness family × scenario matrix as one markdown table.

    ``grid[family][scenario]`` rows carry ``clocks_to_thresh`` /
    ``lost_clocks`` / ``diverged`` (see `benchmarks.robustness`).
    """
    fams = list(grid)
    if scenarios is None:
        scenarios = list(grid[fams[0]])
    return md_table(
        ["family \\ scenario", *scenarios],
        [[f, *[churn_cell(grid[f][s]) for s in scenarios]] for f in fams])
