"""Network-delay / straggler models for the PS simulator.

The port's copy of ``repro/core/delays.py``.  Delivery is a per-channel
Bernoulli trial each clock (geometric delays): a push crosses its network
tier within one clock with probability ``push_prob x producer_rate /
max(t_tier, 1)`` unless the channel is congested that clock
(``straggler_prob``).  With ``n_pods > 1`` the ``P`` workers form
contiguous pod blocks and cross-pod channels ride the slower tier
(``t_net_xpod``).  The draws replay ``jax.random`` through
:mod:`repro_torch.rng`, so the delivery matrices equal the JAX package's.

Fleet churn
-----------
:class:`ChurnSchedule` makes the fleet a per-clock axis: a worker liveness
mask (worker outages, whole-pod drop/rejoin windows), an optional mid-run
straggler-*regime* shift (per-clock ``straggler_workers`` /
``straggler_rate`` overriding the config's knobs) and an optional
per-clock ``bw_scale`` of ``bandwidth_xpod`` that only
`core.timemodel.TimeModel` reads.  ``simulate`` honors it as the JAX
package does: dead workers push nothing, their reader rows of ``cview``
freeze, and their in-flight updates keep draining to survivors (the
default) or drop at death (``drop_inflight=True``).  The schedule's
tensors live on the run's device and are indexed by absolute clock (a
Python int), so reading them never makes the host wait.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import rng as jrng
from .consistency import ConsistencyConfig


def _f32(x, device) -> torch.Tensor:
    # filled on the device: torch.tensor(x, device=cuda) copies from the
    # host and synchronizes the stream
    return torch.full((), x, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class ChurnSchedule:
    """Per-clock fleet churn, indexed by absolute clock.

    ``live[t, p]`` is worker ``p``'s liveness at clock ``t`` (clocks past
    the horizon clamp to the last row).  The optional regime tensors
    override the config's straggler knobs per clock; ``bw_scale``
    multiplies ``TimeModel.bandwidth_xpod`` per clock and never touches
    the traces.  ``drop_inflight`` picks the in-flight policy at death:
    False lets a dead worker's produced updates keep draining; True drops
    its ring rows (and, under the comm substrate, its unshipped
    accumulator, residual and wire rows) the clock it dies.
    """

    live: torch.Tensor              # [T, P] bool worker liveness per clock
    straggler_workers: Any = None   # [T] int32 per-clock slow-worker count
    straggler_rate: Any = None      # [T] float32 per-clock slow-worker rate
    bw_scale: Any = None            # [T] float32 bandwidth_xpod multiplier
    drop_inflight: bool = False

    @property
    def n_clocks(self) -> int:
        return self.live.shape[0]

    @property
    def n_workers(self) -> int:
        return self.live.shape[1]

    def to(self, device) -> "ChurnSchedule":
        """The same schedule with its tensors on ``device``."""
        mv = lambda t: None if t is None else t.to(device)
        return ChurnSchedule(live=mv(self.live),
                             straggler_workers=mv(self.straggler_workers),
                             straggler_rate=mv(self.straggler_rate),
                             bw_scale=mv(self.bw_scale),
                             drop_inflight=self.drop_inflight)


def no_churn(n_clocks: int, P: int, device=None) -> ChurnSchedule:
    """The neutral schedule: everyone live, no regime shift.  Running with
    it is bit-equal to running with no schedule at all."""
    return ChurnSchedule(live=torch.ones((n_clocks, P), dtype=torch.bool,
                                         device=device))


def make_churn(n_clocks: int, P: int, *, n_pods: int = 1,
               worker_outages=(), pod_outages=(), regime_shift=None,
               bw_drop=None, drop_inflight: bool = False,
               device=None) -> ChurnSchedule:
    """Build a `ChurnSchedule` from scenario primitives (the JAX package's
    masks, built in numpy and copied to ``device`` once).

    - ``worker_outages``: ``(worker, t0, t1)``, the worker dead on
      clocks ``[t0, t1)``;
    - ``pod_outages``: ``(pod, t0, t1)``, every worker of the pod dead on
      ``[t0, t1)``;
    - ``regime_shift``: ``(clock, n_workers, rate)``, from ``clock`` on
      the first ``n_workers`` producers push at ``rate`` of nominal;
    - ``bw_drop``: ``(t0, t1, scale)``, the cross-pod bandwidth multiplied
      by ``scale`` on ``[t0, t1)`` (TimeModel only).
    """
    live = np.ones((n_clocks, P), bool)
    for w, t0, t1 in worker_outages:
        live[t0:t1, w] = False
    pods = pod_of(P, n_pods).numpy()
    for g, t0, t1 in pod_outages:
        live[t0:t1, pods == g] = False
    sw = sr = bws = None
    if regime_shift is not None:
        t0, n_w, rate = regime_shift
        sw = np.zeros(n_clocks, np.int32)
        sw[t0:] = n_w
        sr = np.ones(n_clocks, np.float32)
        sr[t0:] = rate
    if bw_drop is not None:
        t0, t1, scale = bw_drop
        bws = np.ones(n_clocks, np.float32)
        bws[t0:t1] = scale
    on = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return ChurnSchedule(live=on(live), straggler_workers=on(sw),
                         straggler_rate=on(sr), bw_scale=on(bws),
                         drop_inflight=drop_inflight)


def churn_live(schedule: ChurnSchedule, c: int):
    """``(live_now[P], died[P])`` at absolute clock ``c`` (a Python int).

    ``died`` marks workers whose outage starts this clock (live at
    ``c - 1``, or ``c == 0``, and dead at ``c``), the edge the
    ``drop_inflight`` policy acts on.  Clocks past the schedule clamp to
    its last row.  Both are views or device ops on the schedule's tensor:
    no host sync."""
    T = schedule.live.shape[0]
    live_now = schedule.live[min(max(c, 0), T - 1)]
    if c <= 0:
        return live_now, ~live_now
    prev = schedule.live[min(c - 1, T - 1)]
    return live_now, prev & ~live_now


def churn_rates(_cfg: ConsistencyConfig, schedule: ChurnSchedule | None,
                P: int, c: int):
    """Per-producer rate multipliers ``[P]`` at clock ``c`` under the
    schedule's straggler regime, or ``None`` when it carries none (the
    config's static :func:`worker_rates` then apply)."""
    if schedule is None or schedule.straggler_workers is None:
        return None
    T = schedule.straggler_workers.shape[0]
    t = min(max(c, 0), T - 1)
    n = schedule.straggler_workers[t]
    rate = schedule.straggler_rate[t].to(torch.float32)
    ids = torch.arange(P, device=n.device)
    return torch.where(ids < n, rate, _f32(1.0, n.device))


def outage_windows(live) -> "list[tuple[int, int, int]]":
    """Oracle outages as ``(worker, t0, t1)``, dead on ``[t0, t1)``, from
    any ``[T, P]`` bool mask (a tensor, an array or nested lists).  An
    outage still open at the horizon closes at ``t1 = T``."""
    live = _bool_np(live)
    T, P = live.shape
    out = []
    for w in range(P):
        t0 = None
        for t in range(T):
            if not live[t, w] and t0 is None:
                t0 = t
            elif live[t, w] and t0 is not None:
                out.append((w, t0, t))
                t0 = None
        if t0 is not None:
            out.append((w, t0, T))
    return out


def score_detections(live, verdicts, budget_clocks: int) -> dict:
    """Score failure-detector verdicts against the oracle ``live`` mask.

    Only ``worker_down`` alarms are scored.  An alarm at clock ``t``
    claiming ``missed`` silent clocks asserts the worker was dead
    somewhere in ``[t - missed, t)``: a **false alarm** is one whose
    window holds no oracle-dead clock of that worker.  A true alarm's
    **latency** is ``t - t0`` clocks past the outage start; an outage is
    **detected in budget** when an alarm lands within ``budget_clocks``
    of its start."""
    live = _bool_np(live)
    T = live.shape[0]
    alarms = [v for v in verdicts if v.get("kind") == "worker_down"]
    windows = outage_windows(live)
    false_alarms, latencies = [], {}
    for v in alarms:
        w, t = v["worker"], v["t"]
        silence0 = t - v.get("missed", 1)
        hit = None
        for (ow, t0, t1) in windows:
            if ow == w and t0 < t and silence0 < t1:
                hit = (ow, t0, t1)
                break
        if hit is None:
            false_alarms.append(v)
        else:
            lat = t - hit[1]
            prev = latencies.get(hit)
            latencies[hit] = lat if prev is None else min(prev, lat)
    missed = [wd for wd in windows if wd not in latencies]
    in_budget = [wd for wd, lat in latencies.items()
                 if lat <= budget_clocks]
    return {
        "n_outages": len(windows),
        "n_alarms": len(alarms),
        "n_false_alarms": len(false_alarms),
        "false_alarms": false_alarms,
        "n_detected": len(latencies),
        "n_missed": len(missed),
        "missed": missed,
        "n_in_budget": len(in_budget),
        "budget_clocks": budget_clocks,
        "latencies": {f"w{w}@{t0}": lat
                      for (w, t0, _t1), lat in sorted(latencies.items())},
        "max_latency": (max(latencies.values()) if latencies else None),
        "all_detected_in_budget": (len(in_budget) == len(windows)
                                   and not false_alarms),
        "horizon": T,
    }


def _bool_np(live) -> np.ndarray:
    if isinstance(live, torch.Tensor):
        return live.detach().cpu().numpy().astype(bool)
    return np.asarray(live, bool)


def pod_of(P: int, n_pods: int, device=None) -> torch.Tensor:
    """Pod id of each worker: ``n_pods`` contiguous equal blocks ([P] i32)."""
    if P % n_pods:
        raise ValueError(f"n_workers={P} must divide by n_pods={n_pods}")
    return (torch.arange(P, dtype=torch.int32, device=device)
            // (P // n_pods)).to(torch.int32)


def same_pod_mask(P: int, n_pods: int, device=None) -> torch.Tensor:
    """[reader, producer] bool: True where the channel stays intra-pod."""
    pod = pod_of(P, n_pods, device)
    return pod[:, None] == pod[None, :]


def staleness_bound_matrix(cfg: ConsistencyConfig, reader_ids, P: int,
                           retry_budget: int = 0, device=None) -> torch.Tensor:
    """Per-channel SSP/ESSP staleness bound [readers, P(producer)], int32.

    ``cfg.staleness`` on intra-pod channels, ``+ s_xpod`` across pods (and,
    under the comm substrate, ``+ agg_clocks - 1 + retry_budget``)."""
    pods = pod_of(P, cfg.n_pods, device)
    reader_ids = torch.as_tensor(reader_ids, device=pods.device).long()
    same = pods[reader_ids][:, None] == pods[None, :]
    xpod_bound = cfg.staleness + cfg.s_xpod
    if cfg.comm_active:
        xpod_bound = xpod_bound + (cfg.agg_clocks - 1) + retry_budget
    return torch.where(same, cfg.staleness, xpod_bound).to(torch.int32)


def worker_rates(cfg: ConsistencyConfig, P: int, device=None) -> torch.Tensor:
    """Per-producer delivery-rate multipliers in (0, 1] (float32)."""
    ids = torch.arange(P, device=device)
    return torch.where(ids < cfg.straggler_workers,
                       _f32(cfg.straggler_rate, device), _f32(1.0, device))


def channel_push_prob(cfg: ConsistencyConfig, P: int, rates=None,
                      device=None) -> torch.Tensor:
    """Per-channel one-clock delivery probability [reader, producer]."""
    if rates is None:
        rates = worker_rates(cfg, P, device)
    device = rates.device
    p = _f32(cfg.push_prob, device) * rates[None, :]
    one = _f32(1.0, device)
    tier_i = one / torch.maximum(_f32(cfg.t_net_intra, device), one)
    tier_x = one / torch.maximum(_f32(cfg.t_net_xpod, device), one)
    same = same_pod_mask(P, cfg.n_pods, device)
    return p * torch.where(same, tier_i, tier_x)


def delivery_matrix(key, cfg: ConsistencyConfig, P: int,
                    rates=None) -> torch.Tensor:
    """Sample the end-of-clock delivery matrix [P(reader), P(producer)]:
    the push crosses its tier and the channel is not congested."""
    k1, k2 = jrng.split(key)
    p = channel_push_prob(cfg, P, rates, device=key.device)
    pushed = jrng.uniform(k1, (P, P)) < p
    congested = jrng.bernoulli(k2, cfg.straggler_prob, (P, P))
    return pushed & ~congested


def expected_delay(cfg: ConsistencyConfig, P: int,
                   device=None) -> torch.Tensor:
    """Analytic mean delivery delay per channel (geometric): 1/p clocks."""
    p = channel_push_prob(cfg, P, device=device) * _f32(
        1.0 - cfg.straggler_prob, device)
    return _f32(1.0, device) / torch.clamp(p, min=1e-6)
