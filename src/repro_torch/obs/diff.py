"""Regression attribution: explain *why* two runs differ, not just that
they do.

The port's copy of ``repro/obs/diff.py``.
`benchmarks.compare` flags a tripped perf gate; this module answers the
follow-up question.  Two inputs, one vocabulary:

- **Streams** (`run_profile` / `diff_streams`): reduce each run's JSONL
  event stream to a component profile, then attribute the headline delta
  (clocks-to-loss when a threshold is given, modeled wall seconds
  otherwise) across four components:

  - ``staleness`` — mean per-clock p99 read lag (``clock.lag_p99``),
    falling back to forced-refresh counts when the stream predates the
    lag fields;
  - ``straggler`` — worker-span spread (mean over clocks of
    ``max dur / mean dur`` across that clock's spans): regime shifts
    widen the spread without moving the mean much;
  - ``wire`` — floats shipped per clock (``clock.ship_floats``),
    falling back to ``run_end.wire_s``;
  - ``churn`` — dead worker-clock *fraction* (an absolute delta — the
    baseline is usually churn-free, so a relative delta is undefined).

  The wall-second split is exact — ``Δwall = Δcomp + Δcomm`` holds to
  rounding because ``run_end`` decomposes wall that way — while the
  component *shares* are indicator-scored: each component's share of the
  attributed delta is its normalized indicator movement, an honest
  heuristic (reported as shares, never as seconds) for pointing a human
  at the right subsystem first.

- **BENCH records** (`diff_bench`): map each ``BENCH_*.json`` metric to
  a component by name, score components by their largest relative metric
  movement, and rank.  `benchmarks.compare` calls this to annotate every
  regressed record with the likely component and its driver metric.

`repro_torch.obs.report.attribution_table` renders either result as
markdown.  Stdlib only.
"""
from __future__ import annotations

COMPONENTS = ("staleness", "straggler", "wire", "churn")

# BENCH metric-name fragments -> component (first match wins, in order).
_BENCH_PATTERNS = (
    ("churn", ("churn", "dead", "recover", "lost", "detect", "outage",
               "false_alarm", "alarm")),
    ("wire", ("floats", "wire", "bytes", "compress", "ship", "quant",
              "topk")),
    ("straggler", ("straggler", "comp_s", "span", "slowdown")),
    ("staleness", ("lag", "stale", "forced", "bound", "refresh")),
)


def component_of(metric: str) -> str:
    """Component a BENCH metric name belongs to (``"other"`` if none)."""
    low = metric.lower()
    for comp, toks in _BENCH_PATTERNS:
        if any(tok in low for tok in toks):
            return comp
    return "other"


def _rel(base, cur):
    """Relative delta, ``None`` when undefined (missing / zero base)."""
    if base is None or cur is None:
        return None
    if not isinstance(base, (int, float)) or isinstance(base, bool):
        return None
    if not isinstance(cur, (int, float)) or isinstance(cur, bool):
        return None
    if base == 0:
        return None
    return (cur - base) / abs(base)


# ------------------------------------------------------------- streams

def run_profile(events, loss_thresh: float | None = None) -> dict:
    """One event stream -> the flat component profile ``diff_profiles``
    consumes.  ``loss_thresh`` adds ``clocks_to_loss`` (first clock whose
    ``loss_ref`` reaches the threshold; ``None`` if never)."""
    from .events import check_version

    events = list(events)
    check_version(events)
    head = events[0]
    T, P = head["n_clocks"], head["n_workers"]
    clocks = [e for e in events if e.get("type") == "clock"]
    end = events[-1] if events[-1].get("type") == "run_end" else None

    spans_by_t: dict = {}
    for e in events:
        if e.get("type") == "worker_span":
            spans_by_t.setdefault(e["t"], []).append(e["dur"])
    spreads = [max(durs) / (sum(durs) / len(durs))
               for durs in spans_by_t.values()
               if durs and sum(durs) > 0]

    clocks_to_loss = None
    if loss_thresh is not None:
        for c in clocks:
            if c["loss_ref"] <= loss_thresh:
                clocks_to_loss = c["t"] + 1
                break

    lag_p99s = [c["lag_p99"] for c in clocks if "lag_p99" in c]
    wall_s = end["wall_s"] if end else sum(c["dur"] for c in clocks)
    n = len(clocks) or 1
    return {
        "run": head["run"], "model": head["model"], "clocks": T,
        "n_workers": P,
        "loss_final": clocks[-1]["loss_ref"] if clocks else None,
        "loss_thresh": loss_thresh, "clocks_to_loss": clocks_to_loss,
        "wall_s": wall_s,
        "comp_s": end["comp_s"] if end else None,
        "comm_s": end["comm_s"] if end else None,
        "wire_s": end["wire_s"] if end else None,
        "clocks_per_s": (len(clocks) / wall_s if wall_s else None),
        "lag_p99_mean": (sum(lag_p99s) / len(lag_p99s)
                         if lag_p99s else None),
        "lag_p99_max": max(lag_p99s) if lag_p99s else None,
        "forced_per_clock": sum(c["forced"] for c in clocks) / n,
        "ship_floats_per_clock": (sum(c["ship_floats"]
                                      for c in clocks) / n),
        "span_spread": (sum(spreads) / len(spreads) if spreads else None),
        "dead_frac": sum(P - c["live"] for c in clocks) / (n * P),
    }


def _indicators(base: dict, cur: dict) -> dict:
    """Per-component indicator movement between two profiles.

    Each entry: ``{indicator, base, cur, rel}`` where ``rel`` is the
    relative delta (churn uses the absolute dead-fraction delta — the
    baseline fraction is usually exactly 0).
    """
    def pick(names):
        for name in names:
            if base.get(name) is not None and cur.get(name) is not None:
                return name
        return names[0]

    out = {}
    k = pick(("lag_p99_mean", "forced_per_clock"))
    out["staleness"] = {"indicator": k, "base": base.get(k),
                        "cur": cur.get(k), "rel": _rel(base.get(k),
                                                       cur.get(k))}
    k = pick(("span_spread", "comp_s"))
    out["straggler"] = {"indicator": k, "base": base.get(k),
                        "cur": cur.get(k), "rel": _rel(base.get(k),
                                                        cur.get(k))}
    k = pick(("ship_floats_per_clock", "wire_s"))
    out["wire"] = {"indicator": k, "base": base.get(k),
                   "cur": cur.get(k), "rel": _rel(base.get(k),
                                                  cur.get(k))}
    b, c = base.get("dead_frac"), cur.get("dead_frac")
    out["churn"] = {"indicator": "dead_frac", "base": b, "cur": c,
                    "rel": (None if b is None or c is None else c - b)}
    return out


def diff_profiles(base: dict, cur: dict) -> dict:
    """Attribute the headline delta between two `run_profile` rows.

    Picks clocks-to-loss as the attributed quantity when both profiles
    carry one, modeled wall seconds otherwise.  Component shares are the
    normalized absolute indicator movements (`_indicators`); the wall
    split (``Δwall = Δcomp + Δcomm``) is exact.
    """
    if (base.get("clocks_to_loss") is not None
            and cur.get("clocks_to_loss") is not None):
        target = "clocks_to_loss"
    else:
        target = "wall_s"
    t_base, t_cur = base.get(target), cur.get(target)
    t_delta = (None if t_base is None or t_cur is None
               else t_cur - t_base)

    comps = _indicators(base, cur)
    weights = {k: abs(v["rel"]) if v["rel"] is not None else 0.0
               for k, v in comps.items()}
    total = sum(weights.values())
    for k, v in comps.items():
        v["share"] = (weights[k] / total) if total > 0 else 0.0

    wall = {key: {"base": base.get(key), "cur": cur.get(key),
                  "delta": (None if base.get(key) is None
                            or cur.get(key) is None
                            else cur[key] - base[key])}
            for key in ("wall_s", "comp_s", "comm_s", "wire_s")}
    ranked = sorted(comps, key=lambda k: -comps[k]["share"])
    return {
        "kind": "streams", "base_run": base.get("run"),
        "cur_run": cur.get("run"), "target": target,
        "target_base": t_base, "target_cur": t_cur,
        "target_delta": t_delta, "components": comps,
        "ranked": ranked, "wall": wall,
    }


def diff_streams(base_events, cur_events,
                 loss_thresh: float | None = None) -> dict:
    """`run_profile` + `diff_profiles` over two event streams."""
    return diff_profiles(run_profile(base_events, loss_thresh),
                         run_profile(cur_events, loss_thresh))


# ------------------------------------------------------- BENCH records

def diff_bench(base: dict, cur: dict) -> dict:
    """Attribute a ``BENCH_*.json`` pair's movement across components.

    Every shared non-``meta.`` metric gets a relative delta and a
    component (`component_of`); each component is scored by its largest
    absolute relative movement, whose metric becomes the component's
    ``driver``.  Claims that flipped True -> False are listed with their
    component — a flipped claim pins its component to the top of the
    ranking even when the metric movements are small.
    """
    bm, cm = base.get("metrics", {}), cur.get("metrics", {})
    comps: dict = {c: {"score": 0.0, "driver": None, "driver_rel": None,
                       "metrics": []} for c in (*COMPONENTS, "other")}
    for name in sorted(set(bm) & set(cm)):
        if name.startswith("meta."):
            continue
        rel = _rel(bm[name], cm[name])
        if rel is None:
            continue
        comp = comps[component_of(name)]
        comp["metrics"].append((name, bm[name], cm[name], rel))
        if abs(rel) > comp["score"]:
            comp["score"] = abs(rel)
            comp["driver"], comp["driver_rel"] = name, rel

    flipped = []
    for name, was in _flat_claims(base.get("claim", {})).items():
        now = _flat_claims(cur.get("claim", {})).get(name)
        if was is True and now is False:
            flipped.append((name, component_of(name)))
            comps[component_of(name)]["score"] = float("inf")

    ranked = sorted((c for c in comps if comps[c]["score"] > 0),
                    key=lambda c: -comps[c]["score"])
    return {"kind": "bench", "bench": cur.get("bench"),
            "components": comps, "ranked": ranked,
            "flipped_claims": flipped}


def _flat_claims(claim, prefix: str = "") -> dict:
    out: dict = {}
    if isinstance(claim, dict):
        for k, v in claim.items():
            out.update(_flat_claims(v, f"{prefix}.{k}" if prefix else
                                    str(k)))
    elif isinstance(claim, bool):
        out[prefix] = claim
    return out


def explain(diff: dict, top: int = 2) -> list[str]:
    """Human-readable attribution lines for either diff kind."""
    lines = []
    if diff["kind"] == "streams":
        d = diff["target_delta"]
        if d is not None:
            lines.append(
                f"{diff['target']}: {diff['target_base']:g} -> "
                f"{diff['target_cur']:g} ({d:+g})")
        for name in diff["ranked"][:top]:
            c = diff["components"][name]
            if c["share"] <= 0:
                continue
            rel = c["rel"]
            moved = "" if rel is None else f" ({rel:+.1%})"
            lines.append(f"{name}: share {c['share']:.0%} via "
                         f"{c['indicator']} {c['base']} -> "
                         f"{c['cur']}{moved}")
    else:
        for name, comp in diff["flipped_claims"]:
            lines.append(f"claim {name} flipped -> component {comp}")
        for name in diff["ranked"][:top]:
            c = diff["components"][name]
            if c["driver"] is None:
                continue
            lines.append(f"{name}: driver {c['driver']} "
                         f"({c['driver_rel']:+.1%})")
    return lines or ["no attributable movement"]
