"""Elastic pod membership: drop a pod mid-run, rejoin it from a checkpoint.

The port of ``repro/pods/elastic.py``.  Fleet churn is a schedule the
engines read (`core.delays.ChurnSchedule`); this module runs what a
deployment does when a pod dies and later comes back:

1. run to ``drop_clock`` and snapshot the `PSState` with
   ``checkpoint.io.save_runtime`` (the pod's last consistent state);
2. run the outage ``[drop_clock, rejoin_clock)`` on the survivors (the
   schedule marks the pod dead: its workers push nothing, their reader
   rows freeze, their queued comm shipments drain per policy);
3. at ``rejoin_clock`` restore the snapshot and splice the dead pod's
   frozen leaves (its ``cview`` reader rows, its workers' local state and,
   drain policy on the substrate, its producers' unshipped ``acc``/``res``)
   into the survivors' state, then continue.

The engines froze exactly what the snapshot holds, so the spliced state
equals the live one bit for bit (checked leaf by leaf), and the three
segments' trace equals the uninterrupted churned run.  The ring, base,
key and clock always come from the survivors.  Every rank of the mesh
holds the whole state and writes its own snapshot file.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import io as ckpt_io
from ..core.consistency import ConsistencyConfig
from ..core.delays import ChurnSchedule, make_churn, pod_of
from ..core.ps import PSApp, Trace
from ..psrun.validate import check_staleness_bound
from ..utils.tree import named_leaves

# Time-axis Trace fields, in dataclass order (views0 apart).
_TIME_FIELDS = ("loss_ref", "loss_view", "staleness", "forced", "delivered",
                "u_l2", "intransit_inf", "ship_floats", "live")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x)


def concat_traces(traces) -> Trace:
    """Concatenate per-segment `Trace`s along the clock axis (numpy).

    ``x_final`` and ``locals_final`` come from the last segment;
    ``views0`` concatenates when every segment recorded it."""
    traces = list(traces)
    fields = {name: np.concatenate([_np(getattr(t, name)) for t in traces],
                                   axis=0)
              for name in _TIME_FIELDS}
    views0 = None
    if all(t.views0 is not None for t in traces):
        views0 = np.concatenate([_np(t.views0) for t in traces], axis=0)
    last = traces[-1]
    return Trace(views0=views0, x_final=_np(last.x_final),
                 locals_final=_np(last.locals_final), **fields)


def splice_rejoin_state(live_state, ckpt_state, cfg: ConsistencyConfig,
                        pod: int, drop_inflight: bool = False):
    """Rebuild the post-outage state from the survivors and the pod's
    snapshot: the dead pod's ``cview`` rows and ``local`` rows (and, drain
    policy on the substrate, its ``acc``/``res`` rows) from
    ``ckpt_state``, everything else from ``live_state``.  Returns
    ``(spliced_state, max_abs_diff)``, the diff of the spliced state
    against ``live_state`` per leaf: 0.0 everywhere when the engines froze
    exactly these leaves."""
    P = live_state.cview.shape[0]
    rows = pod_of(P, cfg.n_pods, live_state.cview.device) == pod    # [P]

    def rowwise(live_leaf, ckpt_leaf):
        m = rows.reshape((P,) + (1,) * (live_leaf.dim() - 1))
        return torch.where(m, ckpt_leaf.to(live_leaf.device), live_leaf)

    local = {k: rowwise(live_state.local[k], ckpt_state.local[k])
             for k in live_state.local}
    comm = live_state.comm
    if comm is not None and not drop_inflight:
        # drain policy: the pod's unshipped mass was held at its death
        comm = dict(comm, acc=rowwise(comm["acc"], ckpt_state.comm["acc"]),
                    res=rowwise(comm["res"], ckpt_state.comm["res"]))
    spliced = live_state.__class__(
        clock=live_state.clock, base=live_state.base,
        uring=live_state.uring, uclock=live_state.uclock,
        cview=rowwise(live_state.cview, ckpt_state.cview), local=local,
        rng=live_state.rng, comm=comm)
    diffs = {}
    for (name, a), (_, b) in zip(named_leaves(spliced),
                                 named_leaves(live_state), strict=True):
        a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
        diffs[name] = float(np.abs(a - b).max()) if a.size else 0.0
    return spliced, diffs


def run_with_pod_rejoin(runtime, app: PSApp, cfg: ConsistencyConfig,
                        n_clocks: int, *, pod: int, drop_clock: int,
                        rejoin_clock: int, seed=0,
                        ckpt_path: str | None = None,
                        drop_inflight: bool = False,
                        schedule: ChurnSchedule | None = None) -> dict:
    """Drop ``pod`` at ``drop_clock``, rejoin it from its snapshot at
    ``rejoin_clock``, and show the recovery exact.  Every rank calls it.

    Three ``run_from`` segments under one absolute-clock `ChurnSchedule`
    (built from the outage unless given).  Returns ``{"trace": the
    concatenated Trace, "state": the final PSState, "splice_max_diff":
    per leaf |spliced - live|, "splice_exact": bool, "staleness_post":
    the staleness check of the last segment (ssp/essp, else None),
    "ckpt_path": this rank's snapshot, "schedule"}``."""
    if not (0 < drop_clock < rejoin_clock <= n_clocks):
        raise ValueError(f"need 0 < drop_clock({drop_clock}) < "
                         f"rejoin_clock({rejoin_clock}) <= {n_clocks}")
    dev = app.x0.device
    if schedule is None:
        schedule = make_churn(n_clocks, app.n_workers, n_pods=cfg.n_pods,
                              pod_outages=((pod, drop_clock, rejoin_clock),),
                              drop_inflight=drop_inflight, device=dev)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if ckpt_path is None:
        ckpt_path = os.path.join(tempfile.mkdtemp(prefix="repro_rejoin_"),
                                 f"pod{pod}_clock{drop_clock}.npz")
    elif rank:
        root, ext = os.path.splitext(ckpt_path)
        ckpt_path = f"{root}_rank{rank}{ext}"

    # segment 1: the healthy fleet up to the drop; snapshot
    state = runtime.init_state(app, cfg, seed=seed)
    tr1, state = runtime.run_from(app, cfg, drop_clock, state,
                                  schedule=schedule)
    ckpt_io.save_runtime(ckpt_path, state)
    # segment 2: the outage (the pod's frozen leaves ride along)
    tr2, state = runtime.run_from(app, cfg, rejoin_clock - drop_clock,
                                  state, schedule=schedule)
    # segment 3: restore, splice, continue
    restored = ckpt_io.restore_runtime(
        ckpt_path, runtime.init_state(app, cfg, seed=seed))
    spliced, diffs = splice_rejoin_state(state, restored, cfg, pod,
                                         drop_inflight=drop_inflight)
    tr3, state = runtime.run_from(app, cfg, n_clocks - rejoin_clock,
                                  spliced, schedule=schedule)
    post = None
    if cfg.model in ("ssp", "essp"):
        post = check_staleness_bound(tr3, cfg)
    return {"trace": concat_traces((tr1, tr2, tr3)), "state": state,
            "splice_max_diff": diffs,
            "splice_exact": all(v == 0.0 for v in diffs.values()),
            "staleness_post": post, "ckpt_path": ckpt_path,
            "schedule": schedule}
