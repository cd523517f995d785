"""Parametric wall-clock model for the simulator (paper Fig 1-right, and the
time axis of Fig 2).

The port of ``repro/core/timemodel.py``.  The simulator advances in
lockstep clocks; real wall time per clock differs by consistency model
because of *synchronous* communication:

- computation: per worker, lognormal with mean ``t_comp`` (stragglers);
- BSP: a barrier every clock — the clock costs the *max* worker time plus a
  full model sync;
- SSP: forced cache refreshes are synchronous round-trips (the reader
  blocks); each refresh pays latency + (channel bytes)/bandwidth;
- ESSP: pushes ride in the background (overlapped with compute); only the
  rare forced refresh blocks.

Constants default to the paper's hardware class (1 GbE: ~100 MB/s, 0.5 ms
RTT).  Straggler draws are mean-corrected, ``exp(N(-σ²/2, σ²))``, and
seeded through ``rng.fold_in`` over a caller-supplied ``fold`` (config
index, seed, ...), so the draws are the JAX model's key stream.

The model runs on the device of the trace it is given (a `Trace` of
tensors, or of numpy arrays, which it reads on the CPU), so a sweep's
``post`` computes it on the card next to the trace.  The ``*_np`` shims
and ``breakdown``'s plain-float dict convert at the host boundary.

Passing the run's ``cfg`` (``n_pods > 1``) switches on the JAX model's
bytes-on-wire accounting of the cross-pod tier: forced fetches split by
tier, and the clock cannot close before its cross-pod shipments
(``Trace.ship_floats``) drain at ``bandwidth_xpod``.  A churn
``schedule`` with a ``bw_scale`` scales ``bandwidth_xpod`` per clock
(a transient cross-pod crunch): both the wire floor and the cross-pod
fetches ride the scaled tier.  Dead workers (``Trace.live``) draw no
compute and leave the slowest-worker max.

The constants may be 0-d tensors (``core.tune.grad_knobs`` passes them
with ``requires_grad``): the model is then differentiable in them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import rng as jrng
from .delays import same_pod_mask


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _trace_device(trace) -> torch.device:
    forced = trace.forced
    return forced.device if isinstance(forced, torch.Tensor) else \
        torch.device("cpu")


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):     # a differentiable constant
        return x.to(device=device, dtype=torch.float32)
    # filled on the device: torch.tensor(x, device=cuda) would synchronize
    return torch.full((), x, dtype=torch.float32, device=device)


def _quotient(a, b, device) -> torch.Tensor:
    """``a / b`` as float32 on ``device``: of two Python floats in float64,
    rounded once (the JAX model's constant folding), else tensor by
    tensor (a Python numerator over a tensor would be a reciprocal
    multiply in torch)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return _f32(a, device) / _f32(b, device)
    return _f32(a / b, device)


@dataclass(frozen=True)
class TimeModel:
    t_comp: float = 0.050          # mean compute seconds per clock per worker
    straggler_sigma: float = 0.3   # lognormal sigma of compute time
    rtt: float = 0.0005            # synchronous fetch round-trip (s)
    bandwidth: float = 100e6       # bytes/s (1 GbE, intra-pod tier)
    bytes_per_channel: float = 4e6  # bytes of one producer's row set
    barrier_overhead: float = 0.002
    bandwidth_xpod: float = 10e6   # bytes/s of the cross-pod tier, used
    #                                only when a hierarchical cfg is passed
    seed: int = 0

    # ------------------------------------------------------------------ rng
    def key(self, fold=(), device=None) -> torch.Tensor:
        """Key of this model, folded over the sweep coordinates ``fold``
        (Python ints, conventionally ``(config_index, seed)``)."""
        key = jrng.PRNGKey(self.seed, device)
        for f in fold:
            key = jrng.fold_in(key, int(f))
        return key

    def comp_draws(self, shape, fold=(), device=None) -> torch.Tensor:
        """Mean-corrected lognormal compute times: ``E[draw] == t_comp``."""
        sig = self.straggler_sigma
        z = jrng.normal(self.key(fold, device), shape)
        return self.t_comp * torch.exp(sig * z - 0.5 * sig * sig)

    # ------------------------------------------------------------- on device
    def _components(self, trace, fold=(), cfg=None, schedule=None):
        """Per-worker building blocks of the clock cost: ``comp[T, P]``
        straggler compute draws (live-masked), ``sync[T, P]`` blocking-fetch
        seconds (tier-split under a hierarchical ``cfg``), ``wire[T]``
        cross-pod shipment seconds on the thin tier (``None`` untiered),
        the intra-tier ``xfer`` constant and the ``tiered`` flag."""
        dev = _trace_device(trace)
        forced = _tensor(trace.forced, dev)             # [T, P, P]
        T, P, _ = forced.shape
        comp = self.comp_draws((T, P), fold, dev)       # [T, P]
        live = getattr(trace, "live", None)
        if live is not None:
            comp = torch.where(_tensor(live, dev).bool(), comp, 0.0)

        xfer = self.bytes_per_channel / self.bandwidth
        tiered = cfg is not None and cfg.n_pods > 1
        f = forced.float()
        if tiered:
            bw_x = _f32(self.bandwidth_xpod, dev)       # scalar, or [T]
            if schedule is not None and schedule.bw_scale is not None:
                bws = _tensor(schedule.bw_scale, dev)
                idx = torch.clamp(torch.arange(T, device=dev), 0,
                                  bws.shape[0] - 1)
                bw_x = bw_x * torch.clamp(bws[idx], min=1e-6)
                xfer_x = (_f32(self.bytes_per_channel, dev) / bw_x)[:, None]
            else:
                # JAX rounds bytes / bw_x to float32 first, then adds rtt
                xfer_x = _quotient(self.bytes_per_channel,
                                   self.bandwidth_xpod, dev)
            same = same_pod_mask(P, cfg.n_pods, dev)[None, :, :]
            sync = ((f * same).sum(dim=2) * (self.rtt + xfer)
                    + (f * ~same).sum(dim=2) * (self.rtt + xfer_x))
            # background shipments: bytes each producer put on the wire, to
            # every other pod's replica, through the thin tier (a tensor
            # divisor: on CUDA a Python one is a reciprocal multiply)
            ship = _tensor(trace.ship_floats, dev)
            wire = ((4.0 * (cfg.n_pods - 1)) * ship.sum(dim=1) / bw_x)  # [T]
        else:
            sync = f.sum(dim=2) * (self.rtt + xfer)
            wire = None
        return comp, sync, wire, xfer, tiered

    def per_clock(self, trace, model: str, fold=(), cfg=None, schedule=None):
        """Returns ``(wall[T], comp[T], comm[T])`` per-clock seconds.

        BSP pays a barrier (the slowest worker) plus a full sync; the other
        models take the slowest worker's compute plus its own blocking
        fetches.  Under a hierarchical ``cfg`` the clock is floored by its
        cross-pod shipments' wire time, the excess charged as comm."""
        return self._clock_split(model, *self._components(
            trace, fold, cfg=cfg, schedule=schedule))

    def _clock_split(self, model: str, comp, sync, wire, xfer, tiered):
        """``(wall[T], comp[T], comm[T])`` from `_components`' output."""
        T, P = comp.shape
        if model == "bsp":
            comp_clock = comp.amax(dim=1)
            comm_clock = _f32(self.barrier_overhead + (P - 1) * xfer
                              + self.rtt, comp.device).expand(T).contiguous()
        else:
            worst = torch.argmax(comp + sync, dim=1)[:, None]
            comp_clock = torch.gather(comp, 1, worst)[:, 0]
            comm_clock = torch.gather(sync, 1, worst)[:, 0]
        wall = comp_clock + comm_clock
        if tiered and model != "bsp":
            wall = torch.maximum(wall, wire)
            comm_clock = wall - comp_clock
        return wall, comp_clock, comm_clock

    def wall_time(self, trace, model: str, fold=(), cfg=None,
                  schedule=None) -> torch.Tensor:
        """Cumulative modeled wall seconds per clock."""
        wall, _, _ = self.per_clock(trace, model, fold, cfg=cfg,
                                    schedule=schedule)
        return torch.cumsum(wall, dim=0)

    def breakdown_traced(self, trace, model: str, fold=(),
                         cfg=None) -> dict:
        """Fig 1-right comm/comp split as 0-d tensors on the trace's device
        (for a sweep ``post``)."""
        wall, comp, comm = self.per_clock(trace, model, fold, cfg=cfg)
        tot = wall.sum()
        return {"total_s": tot, "comp_s": comp.sum(), "comm_s": comm.sum(),
                "comm_frac": comm.sum() / torch.clamp(tot, min=1e-12)}

    def timeline_np(self, trace, model: str, fold=(), cfg=None,
                    schedule=None) -> dict:
        """The run's observability timebase (numpy, host side):
        ``start``/``end``/``wall[T]`` clock windows, the
        ``comp_clock``/``comm_clock[T]`` split, and the per-worker
        ``comp[T, P]``, ``sync[T, P]`` and ``wire[T]`` (zeros untiered)."""
        parts = self._components(trace, fold, cfg=cfg, schedule=schedule)
        comp, sync, wire, _, _ = parts
        wall, comp_clock, comm_clock = self._clock_split(model, *parts)
        host = lambda t: t.detach().cpu().numpy()
        wall = host(wall)
        end = np.cumsum(wall)
        return {"start": end - wall, "end": end, "wall": wall,
                "comp_clock": host(comp_clock),
                "comm_clock": host(comm_clock),
                "comp": host(comp), "sync": host(sync),
                "wire": (np.zeros_like(wall) if wire is None
                         else np.broadcast_to(host(wire),
                                              wall.shape).copy())}

    # -------------------------------------------------- numpy-facing shims
    def per_clock_np(self, trace, model: str, fold=(), cfg=None,
                     schedule=None):
        return tuple(x.detach().cpu().numpy() for x in self.per_clock(
            trace, model, fold, cfg=cfg, schedule=schedule))

    def wall_time_np(self, trace, model: str, fold=(), cfg=None,
                     schedule=None) -> np.ndarray:
        return self.wall_time(trace, model, fold, cfg=cfg,
                              schedule=schedule).detach().cpu().numpy()

    def breakdown(self, trace, model: str, fold=(), cfg=None) -> dict:
        """Fig 1-right style comm/comp split over the whole run (floats)."""
        return {k: float(v) for k, v in
                self.breakdown_traced(trace, model, fold, cfg=cfg).items()}
