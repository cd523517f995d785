"""On-device metrics accumulators and the host-side metrics registry.

The port of ``repro/obs/metrics.py``.  Two halves with one boundary:

- **device half**: a dict of accumulator tensors (:func:`device_init`)
  that ``core.ps.simulate`` folds once per clock (:func:`device_update`)
  from values the clock already computes (staleness at read, forced
  refreshes, deliveries, wire floats, liveness).  Nothing crosses to the
  host until the run returns, so the clock still makes the host wait for
  nothing.
- **host half**: a :class:`MetricsRegistry` of counters, gauges and
  histograms that :func:`drain_device` fills from ``Trace.obs``, plus the
  modeled seconds of :func:`record_timing`.

:func:`device_reduce` folds a sharded runtime's per-shard accumulators
over the worker ranks after the run, one ``all_reduce`` per reduced
leaf; the simulator holds the whole reader matrix and never calls it.
What has no counterpart here: ``record_compiles``
snapshots the JAX engines' compile counters; nothing in the port is
compiled per config family (the kernels are built once per process), so
there is no count to record and none is made up.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Buckets of the staleness-at-read lag histogram: lag k lands in bucket
# k, the last bucket is ">= n_buckets - 1".
DEFAULT_LAG_BUCKETS = 16


@dataclass(frozen=True)
class ObsSpec:
    """The simulator's ``obs=`` switch.  ``None`` or ``enabled=False`` (the
    default everywhere) collects nothing."""

    enabled: bool = True
    n_buckets: int = DEFAULT_LAG_BUCKETS

    def __post_init__(self):
        if self.n_buckets < 2:
            raise ValueError("n_buckets must be >= 2 (one lag bucket plus "
                             "the open tail)")


def obs_on(obs: ObsSpec | None) -> bool:
    """Whether a run collects telemetry."""
    return obs is not None and obs.enabled


# --------------------------------------------------------------------------
# device half
# --------------------------------------------------------------------------

def device_init(P: int, n_buckets: int = DEFAULT_LAG_BUCKETS,
                device=None) -> dict:
    """Zeroed accumulators for a run over ``P`` workers."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "clocks": z(),                      # clocks accumulated
        "lag_hist": z(n_buckets),           # staleness-at-read lags
        "lag_max": z(),                     # worst read lag seen
        "forced_intra": z(),                # blocking fetches, intra-pod
        "forced_xpod": z(),                 # blocking fetches, cross-pod
        "delivered": z(),                   # background deliveries
        "ship_floats": z(P, dtype=torch.float32),  # per-producer wire
        "dead_worker_clocks": z(),          # worker-clocks lost
    }


def device_update(acc: dict, *, staleness, forced, delivered, ship_floats,
                  live, live_rows, in_pod) -> dict:
    """Fold one clock's step values into ``acc`` (device ops only).

    ``staleness``/``forced``/``delivered`` are the ``[R, P]`` reader rows,
    ``ship_floats`` the clock's ``[P]`` wire floats, ``live`` (``[P]``)
    and ``live_rows`` (``[R]``) the liveness masks (dead readers read
    nothing and leave the lag statistics), ``in_pod`` the ``[R, P]``
    channel-tier mask."""
    i32 = torch.int32
    n_buckets = acc["lag_hist"].shape[0]
    # read lag in clocks: staleness is cview - c <= -1, so the clocks in
    # transit at read time are -1 - staleness >= 0
    lag = (-1 - staleness).to(i32)                            # [R, P]
    w = live_rows[:, None]
    lagc = torch.clamp(lag, 0, n_buckets - 1)
    buckets = torch.arange(n_buckets, dtype=i32, device=lag.device)
    onehot = (lagc[:, :, None] == buckets) & w[:, :, None]    # [R, P, NB]
    f = forced & w
    return {
        "clocks": acc["clocks"] + 1,
        "lag_hist": acc["lag_hist"] + onehot.sum(dim=(0, 1), dtype=i32),
        "lag_max": torch.maximum(
            acc["lag_max"], torch.where(w, lag, torch.zeros_like(lag)).amax()),
        "forced_intra": acc["forced_intra"] + (f & in_pod).sum(dtype=i32),
        "forced_xpod": acc["forced_xpod"] + (f & ~in_pod).sum(dtype=i32),
        "delivered": acc["delivered"] + (delivered & w).sum(dtype=i32),
        "ship_floats": acc["ship_floats"] + ship_floats,
        "dead_worker_clocks": acc["dead_worker_clocks"]
        + (live.shape[0] - live.sum(dtype=i32)),
    }


# The accumulators a worker shard folds over its own reader rows only; the
# others (clocks, ship_floats, dead_worker_clocks) are the same on every
# shard.
_REDUCE = {"lag_hist": "sum", "lag_max": "max", "forced_intra": "sum",
           "forced_xpod": "sum", "delivered": "sum"}


def device_reduce(acc: dict, group=None) -> dict:
    """Fold per-shard accumulators over the worker ranks of ``group`` (a
    ``torch.distributed`` process group; ``None`` is the world): one
    ``all_reduce`` (SUM or MAX) per reduced leaf, after the run.  The
    replicated leaves pass through."""
    import torch.distributed as dist
    out = dict(acc)
    for k, op in _REDUCE.items():
        t = acc[k].clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
        out[k] = t
    return out


# --------------------------------------------------------------------------
# host half
# --------------------------------------------------------------------------

class MetricsRegistry:
    """Counters, gauges and histograms on the host side of the boundary.

    Names are ``/``-separated paths (``ps/forced_xpod``); counters
    accumulate across ``counter_add`` calls, gauges keep the last value,
    histograms keep integer bucket counts with labeled buckets.
    ``flat()`` gives the flat metric dict of a ``BENCH_*.json``."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.hists: dict = {}

    def counter_add(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + _num(value)

    def gauge_set(self, name: str, value) -> None:
        self.gauges[name] = _num(value)

    def hist_add(self, name: str, counts, buckets=None) -> None:
        counts = [int(c) for c in np.asarray(counts).ravel()]
        h = self.hists.get(name)
        if h is None:
            if buckets is None:
                buckets = [str(i) for i in range(len(counts) - 1)] \
                    + [f"{len(counts) - 1}+"]
            self.hists[name] = {"buckets": [str(b) for b in buckets],
                                "counts": counts}
            return
        if len(h["counts"]) != len(counts):
            raise ValueError(f"histogram {name!r} bucket count changed: "
                             f"{len(h['counts'])} != {len(counts)}")
        h["counts"] = [a + b for a, b in zip(h["counts"], counts,
                                             strict=True)]

    def to_dict(self) -> dict:
        return {"counters": dict(self.counters), "gauges": dict(self.gauges),
                "hists": {k: {"buckets": list(v["buckets"]),
                              "counts": list(v["counts"])}
                          for k, v in self.hists.items()}}

    def flat(self) -> dict:
        """Flat numeric dict (histograms as mean/p50/p99/total)."""
        out = {}
        out.update(self.counters)
        out.update(self.gauges)
        for name, h in self.hists.items():
            counts = np.asarray(h["counts"], np.float64)
            total = counts.sum()
            out[f"{name}/total"] = float(total)
            if total > 0:
                centers = np.arange(len(counts), dtype=np.float64)
                out[f"{name}/mean"] = float((counts * centers).sum() / total)
                cum = np.cumsum(counts) / total
                out[f"{name}/p50"] = float(np.searchsorted(cum, 0.5))
                out[f"{name}/p99"] = float(np.searchsorted(cum, 0.99))
        return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _num(v):
    v = _np(v)
    v = v.item() if v.ndim == 0 else v
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return float(v)


def drain_device(reg: MetricsRegistry, acc, prefix: str = "ps") -> None:
    """Fold a returned accumulator dict (``Trace.obs``) into ``reg``."""
    if acc is None:
        raise ValueError("trace carries no obs accumulators — run the "
                         "engine with obs=ObsSpec() to collect them")
    get = lambda k: _np(acc[k])
    reg.gauge_set(f"{prefix}/clocks", get("clocks"))
    reg.hist_add(f"{prefix}/staleness_lag", get("lag_hist"))
    reg.gauge_set(f"{prefix}/lag_max", get("lag_max"))
    reg.counter_add(f"{prefix}/forced_intra", get("forced_intra"))
    reg.counter_add(f"{prefix}/forced_xpod", get("forced_xpod"))
    reg.counter_add(f"{prefix}/delivered", get("delivered"))
    reg.counter_add(f"{prefix}/ship_floats_total",
                    float(get("ship_floats").sum()))
    reg.counter_add(f"{prefix}/dead_worker_clocks",
                    get("dead_worker_clocks"))


# ``record_compiles`` has no counterpart: nothing in the port is compiled
# per config family (the kernels are built once per process), so there is
# no count to record.


def record_timing(reg: MetricsRegistry, trace, model: str, tm, fold=(),
                  cfg=None, schedule=None, prefix: str = "ps") -> None:
    """Fold a run's modeled seconds (`TimeModel`) into the registry: total,
    compute and comm seconds, the cross-pod wire seconds and each
    worker's modeled compute."""
    tl = tm.timeline_np(trace, model, fold=fold, cfg=cfg, schedule=schedule)
    reg.gauge_set(f"{prefix}/modeled_wall_s", tl["wall"].sum())
    reg.gauge_set(f"{prefix}/modeled_comp_s", tl["comp_clock"].sum())
    reg.gauge_set(f"{prefix}/modeled_comm_s", tl["comm_clock"].sum())
    reg.gauge_set(f"{prefix}/modeled_wire_s", tl["wire"].sum())
    for p, s in enumerate(tl["comp"].sum(axis=0)):
        reg.gauge_set(f"{prefix}/worker{p:02d}/modeled_comp_s", s)
