"""OpenMetrics/Prometheus text exporter for `MetricsRegistry`.

The port's copy of ``repro/obs/promtext.py``.  The scrape-side sibling
of the Perfetto exporter: ``render`` lays a
registry (or its ``to_dict()`` snapshot — what a stream's ``metrics``
event carries) out as OpenMetrics text, byte-deterministically
(sorted metric names, canonical number formatting), so the golden test
can pin the exact bytes the same way ``tests/golden/perfetto_small.json``
pins the trace export.

Mapping: counters become ``<name>_total`` counter families, gauges map
1:1, histograms become classic cumulative-``le`` bucket families with
``_count`` and a bucket-center-weighted ``_sum`` (the registry keeps
integer bucket counts, not raw samples — the sum is the standard
center-of-bucket estimate, exact for integer-valued histograms such as
``ps/staleness_lag``).  ``/``-separated registry paths are sanitized to
the OpenMetrics charset (``ps/forced_xpod`` -> ``ps_forced_xpod``); a
bucket label that does not parse as a number (the ``"15+"`` overflow) is
the ``+Inf`` bucket.  Output ends with the mandatory ``# EOF``.
Numpy/stdlib only.
"""
from __future__ import annotations

import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _name(raw: str) -> str:
    name = _NAME_RE.sub("_", raw)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _num(v) -> str:
    """Canonical OpenMetrics number: integral values render as integers."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _le(label: str) -> str:
    """Bucket upper bound from a registry bucket label (non-numeric
    labels — the trailing ``"15+"`` overflow — are the +Inf bucket)."""
    try:
        return _num(float(label))
    except ValueError:
        return "+Inf"


def render(registry) -> str:
    """Registry (or ``MetricsRegistry.to_dict()`` dict) -> OpenMetrics
    text, byte-deterministic."""
    snap = registry if isinstance(registry, dict) else registry.to_dict()
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    hists = snap.get("hists", {})
    lines: list[str] = []

    for raw in sorted(counters):
        name = _name(raw)
        if name.endswith("_total"):     # family name must not carry the
            name = name[:-len("_total")]  # sample suffix (OpenMetrics)
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}_total {_num(counters[raw])}")
    for raw in sorted(gauges):
        name = _name(raw)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_num(gauges[raw])}")
    for raw in sorted(hists):
        name = _name(raw)
        h = hists[raw]
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        total = sum(h["counts"])
        seen_inf = False
        for label, count in zip(h["buckets"], h["counts"]):
            cum += count
            le = _le(str(label))
            seen_inf = seen_inf or le == "+Inf"
            lines.append(f'{name}_bucket{{le="{le}"}} {_num(cum)}')
        if not seen_inf:
            lines.append(f'{name}_bucket{{le="+Inf"}} {_num(total)}')
        lines.append(f"{name}_count {_num(total)}")
        centers = [_center(str(b)) for b in h["buckets"]]
        sum_est = sum(c * n for c, n in zip(centers, h["counts"]))
        lines.append(f"{name}_sum {_num(sum_est)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _center(label: str) -> float:
    """Bucket-center estimate backing ``_sum`` (overflow labels such as
    ``"15+"`` contribute their threshold)."""
    try:
        return float(label)
    except ValueError:
        digits = re.sub(r"[^0-9.eE+-]", "", label).rstrip("+-")
        try:
            return float(digits)
        except ValueError:
            return 0.0


def write(path, registry) -> None:
    with open(path, "w") as f:
        f.write(render(registry))
