"""Streaming health layer: online failure detection and SLO monitoring.

The port's copy of ``repro/obs/monitor.py`` (it imports neither JAX nor
the JAX package, so it reads the port's streams and the JAX package's
alike).  ``monitor_stream`` checks a v1 stream's version
(:func:`events.check_version`) and runs two engines over it in one pass:

**Failure detector** (:class:`FailureDetector`).  Liveness is scored from
cadence only (``clock`` events are the server's heartbeat,
``worker_span`` events the workers'), never from the stream's ``churn``
events, which are ground truth reserved for scoring
(`core.delays.score_detections`).  ``missed``, the whole clocks since a
worker's last span, is the verdict trigger: ``missed >= timeout_clocks``
raises ``worker_down`` (and ``pod_down`` once every worker of a pod is
suspected); the first span from a suspected worker raises ``worker_up``.
``phi`` is a phi-accrual suspicion score on the modeled-seconds axis,
normalized by the current clock wall: evidence, not the trigger.

**SLO monitors** (:class:`SLOMonitor`).  Tumbling ``window``-clock
checks emitting ``slo_violation`` events back into the stream:
``staleness`` (the window's worst per-clock p99 read lag against the
declared bound), ``throughput`` (clocks per modeled second against a
floor) and ``wire`` (mean floats on the wire per clock against a budget).

numpy and stdlib only.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass

PHI_CAP = 40.0          # -log10 of the smallest probability we resolve


@dataclass(frozen=True)
class DetectorParams:
    """Failure-detector knobs (see module doc for the two signals)."""

    timeout_clocks: int = 2     # missed-clock verdict trigger
    phi_window: int = 12        # recent heartbeat gaps kept per worker
    phi_min_samples: int = 3    # gaps needed before phi is scored
    phi_sigma_floor: float = 0.1  # std floor (normalized clock units)

    def __post_init__(self):
        if self.timeout_clocks < 1:
            raise ValueError("timeout_clocks must be >= 1")


@dataclass(frozen=True)
class SLOParams:
    """Windowed SLO thresholds; ``None`` disables a check.

    ``staleness_bound=None`` falls back to the stream's declared
    contract (``run_start.bound``) when the header carries one.
    """

    window: int = 8
    staleness_bound: int | None = None
    min_clocks_per_s: float | None = None
    max_floats_per_clock: float | None = None


@dataclass
class MonitorResult:
    verdicts: list        # worker_down / worker_up / pod_down / pod_up
    violations: list      # slo_violation event dicts (also in .events)
    health: dict          # run-level summary (see monitor_stream doc)
    events: list          # input stream + slo_violation events, in order


def _phi_normal(elapsed: float, mu: float, sigma: float,
                sigma_floor: float = 0.1) -> float:
    sigma = max(sigma, sigma_floor)
    p_later = 0.5 * math.erfc((elapsed - mu) / (sigma * math.sqrt(2.0)))
    if p_later <= 10.0 ** -PHI_CAP:
        return PHI_CAP
    return -math.log10(p_later)


class FailureDetector:
    """Per-worker / per-pod liveness scoring from stream cadence.

    Feed it ``run_start`` / ``clock`` / ``worker_span`` events in stream
    order (``observe``); it appends verdicts to ``self.verdicts``.  The
    churn events of the stream must *not* be fed — the detector's whole
    point is to reconstruct them from cadence (``score_detections``
    checks how well).
    """

    def __init__(self, params: DetectorParams | None = None):
        self.p = params or DetectorParams()
        self.verdicts: list = []
        self.max_healthy_phi = 0.0      # noisiest live worker ever scored
        self._started = False

    def _start(self, head: dict) -> None:
        P, n_pods = head["n_workers"], head["n_pods"]
        self.P, self.n_pods = P, n_pods
        self.pod = [p // (P // n_pods) for p in range(P)]
        self.last_clock = [-1] * P      # clock of the last span seen
        self.last_arrival = [0.0] * P   # modeled-seconds heartbeat time
        self.gaps = [deque(maxlen=self.p.phi_window) for _ in range(P)]
        self.suspected = [False] * P
        self.pod_suspected = [False] * n_pods
        self.prev_clock_ts: float | None = None
        self.last_wall = 0.0            # gap between the last two clocks
        self._started = True

    # ------------------------------------------------------------ scoring
    def _score(self, worker: int, now_ts: float, wall: float) -> float:
        """Phi of the worker's current silence, normalized by the current
        clock wall (``wall`` = the last clock-event gap)."""
        gaps = self.gaps[worker]
        if len(gaps) < self.p.phi_min_samples or wall <= 0.0:
            return 0.0
        elapsed = (now_ts - self.last_arrival[worker]) / wall
        mu = sum(gaps) / len(gaps)
        var = sum((g - mu) ** 2 for g in gaps) / len(gaps)
        return _phi_normal(elapsed, mu, math.sqrt(var),
                           self.p.phi_sigma_floor)

    def _evaluate(self, t: int, ts: float, wall: float) -> None:
        """Liveness pass at clock event ``t`` (all spans of ``t-1`` have
        been observed; spans of ``t`` have not)."""
        for w in range(self.P):
            if self.suspected[w]:
                continue
            missed = (t - 1) - self.last_clock[w]
            phi = self._score(w, ts, wall)
            if missed >= self.p.timeout_clocks:
                self.suspected[w] = True
                self.verdicts.append({
                    "kind": "worker_down", "worker": w, "t": t, "ts": ts,
                    "missed": missed, "phi": phi})
            else:
                self.max_healthy_phi = max(self.max_healthy_phi, phi)
        for g in range(self.n_pods):
            down = all(self.suspected[w] for w in range(self.P)
                       if self.pod[w] == g)
            if down and not self.pod_suspected[g]:
                self.pod_suspected[g] = True
                self.verdicts.append({"kind": "pod_down", "pod": g,
                                      "t": t, "ts": ts})

    # ----------------------------------------------------------- ingest
    def observe(self, e: dict) -> None:
        etype = e.get("type")
        if etype == "run_start":
            self._start(e)
            return
        if not self._started:
            raise ValueError("stream must open with run_start")
        if etype == "clock":
            self.last_wall = (0.0 if self.prev_clock_ts is None
                              else e["ts"] - self.prev_clock_ts)
            if e["t"] > 0:
                self._evaluate(e["t"], e["ts"], self.last_wall)
            self.prev_clock_ts = e["ts"]
        elif etype == "worker_span":
            w = e["worker"]
            arrival = e["ts"] + e["dur"]
            if self.suspected[w]:
                self.suspected[w] = False
                self.verdicts.append({"kind": "worker_up", "worker": w,
                                      "t": e["t"], "ts": arrival})
                g = self.pod[w]
                if self.pod_suspected[g]:
                    self.pod_suspected[g] = False
                    self.verdicts.append({"kind": "pod_up", "pod": g,
                                          "t": e["t"], "ts": arrival})
                # the outage gap is not a heartbeat interval: resume the
                # phi statistics from the rejoin heartbeat instead
            elif self.last_clock[w] >= 0 and self.last_wall > 0.0:
                self.gaps[w].append(
                    (arrival - self.last_arrival[w]) / self.last_wall)
            self.last_clock[w] = e["t"]
            self.last_arrival[w] = arrival


class SLOMonitor:
    """Tumbling-window SLO checks over the clock events (module doc)."""

    def __init__(self, params: SLOParams | None = None,
                 declared_bound: int | None = None):
        self.p = params or SLOParams()
        self.bound = (self.p.staleness_bound
                      if self.p.staleness_bound is not None
                      else declared_bound)
        self.violations: list = []
        self._win: list = []            # buffered clock events

    def observe(self, e: dict) -> None:
        if e.get("type") != "clock":
            return
        self._win.append(e)
        if len(self._win) >= self.p.window:
            self._close()

    def finish(self) -> None:
        """Evaluate the final partial window (if any clocks are buffered)."""
        if self._win:
            self._close()

    def _close(self) -> None:
        win, self._win = self._win, []
        last = win[-1]
        t, ts = last["t"], last["ts"] + last["dur"]
        n = len(win)

        def violate(slo: str, value: float, limit: float) -> None:
            self.violations.append({
                "type": "slo_violation", "t": t, "ts": round(ts, 9),
                "slo": slo, "window": n, "value": round(float(value), 9),
                "limit": round(float(limit), 9)})

        if self.bound is not None:
            p99s = [c["lag_p99"] for c in win if "lag_p99" in c]
            if p99s and max(p99s) > self.bound:
                violate("staleness", max(p99s), self.bound)
        if self.p.min_clocks_per_s is not None:
            dur = sum(c["dur"] for c in win)
            rate = n / dur if dur > 0 else float("inf")
            if rate < self.p.min_clocks_per_s:
                violate("throughput", rate, self.p.min_clocks_per_s)
        if self.p.max_floats_per_clock is not None:
            mean_floats = sum(c["ship_floats"] for c in win) / n
            if mean_floats > self.p.max_floats_per_clock:
                violate("wire", mean_floats, self.p.max_floats_per_clock)


def live_from_events(events) -> "list[list[bool]]":
    """Reconstruct the oracle ``live[T][P]`` mask from the stream's
    ``churn`` transitions — the scoring ground truth when the original
    `ChurnSchedule` is not at hand (the CLI's ``monitor --score``)."""
    head = events[0]
    T, P = head["n_clocks"], head["n_workers"]
    live = [[True] * P for _ in range(T)]
    for e in events:
        if e.get("type") == "churn":
            alive = e["event"] == "up"
            for t in range(e["t"], T):
                live[t][e["worker"]] = alive
    return live


def monitor_stream(events, detector: DetectorParams | None = None,
                   slo: SLOParams | None = None) -> MonitorResult:
    """Run the failure detector + SLO monitors over one event stream.

    ``events`` is a list or iterator of event dicts opening with
    ``run_start`` (major version checked).  Returns a `MonitorResult`
    whose ``events`` is the input with ``slo_violation`` events spliced
    in at their window-closing clocks, and whose ``health`` summarizes:
    verdict/violation counts, final suspected set, and the phi evidence
    (``max_healthy_phi``, ``min_alarm_phi``) the detection-quality claim
    is scored on.
    """
    from .events import check_version

    events = list(events)
    check_version(events)
    det = FailureDetector(detector)
    slo_mon = SLOMonitor(slo, declared_bound=events[0].get("bound"))
    for e in events:
        if e.get("type") in ("run_start", "clock", "worker_span"):
            det.observe(e)
        slo_mon.observe(e)
    slo_mon.finish()

    out, by_clock = [], {}
    for v in slo_mon.violations:
        by_clock.setdefault(v["t"], []).append(v)
    for e in events:                     # splice violations after their clock
        out.append(e)
        if e.get("type") == "clock":
            out.extend(by_clock.pop(e["t"], []))
    for t in sorted(by_clock):           # defensive: never drop a verdict
        out[-1:-1] = by_clock[t]

    alarms = [v for v in det.verdicts if v["kind"] == "worker_down"]
    health = {
        "n_worker_down": len(alarms),
        "n_worker_up": sum(v["kind"] == "worker_up" for v in det.verdicts),
        "n_pod_down": sum(v["kind"] == "pod_down" for v in det.verdicts),
        "n_slo_violations": len(slo_mon.violations),
        "violations_by_slo": _count_by(slo_mon.violations, "slo"),
        "suspected_at_end": [w for w, s in enumerate(det.suspected) if s],
        "max_healthy_phi": det.max_healthy_phi,
        "min_alarm_phi": (min(v["phi"] for v in alarms) if alarms
                          else None),
    }
    return MonitorResult(verdicts=det.verdicts,
                         violations=slo_mon.violations,
                         health=health, events=out)


def _count_by(items, key) -> dict:
    out: dict = {}
    for it in items:
        out[it[key]] = out.get(it[key], 0) + 1
    return out


def stream_summary(events) -> dict:
    """One stream -> a run-summary row (the shape of the JAX package's
    ``obs.report.trace_summary``), derived from events alone (no `Trace`,
    no `TimeModel`): what a report renders for a JSONL artifact.  Fields the
    stream cannot carry (e.g. ``lag_mean`` — only per-clock p99s are
    streamed) are ``None``; the tier split of forced refreshes comes
    from the ``metrics`` registry snapshot when one rode along.
    """
    from .events import check_version

    events = list(events)
    check_version(events)
    head = events[0]
    clocks = [e for e in events if e.get("type") == "clock"]
    end = events[-1] if events[-1].get("type") == "run_end" else None
    counters = {}
    for e in events:
        if e.get("type") == "metrics":
            counters = e["registry"].get("counters", {})
    P = head["n_workers"]
    lag_p99s = [c["lag_p99"] for c in clocks if "lag_p99" in c]
    lag_maxs = [c["lag_max"] for c in clocks if "lag_max" in c]
    wall_s = end["wall_s"] if end else sum(c["dur"] for c in clocks)
    return {
        "label": head["run"], "model": head["model"],
        "family": head["family"], "clocks": head["n_clocks"],
        "loss_final": clocks[-1]["loss_ref"] if clocks else None,
        "lag_mean": None,
        "lag_p99": max(lag_p99s) if lag_p99s else None,
        "lag_max": max(lag_maxs) if lag_maxs else None,
        "forced_intra": counters.get("ps/forced_intra"),
        "forced_xpod": counters.get("ps/forced_xpod"),
        "delivered": sum(c["delivered"] for c in clocks),
        "ship_floats": sum(c["ship_floats"] for c in clocks),
        "dead_worker_clocks": sum(P - c["live"] for c in clocks),
        "wall_s": wall_s,
        "comp_s": end["comp_s"] if end else None,
        "comm_s": end["comm_s"] if end else None,
        "wire_s": end["wire_s"] if end else None,
        "clocks_per_s": (len(clocks) / wall_s if wall_s else None),
    }
