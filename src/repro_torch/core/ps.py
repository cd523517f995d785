"""Parameter-server simulator (the paper's ESSPTable), in PyTorch.

The port of ``repro/core/ps.py::simulate`` in its flat dense mode and its
hierarchical (``n_pods > 1``) mode without the comm substrate.  The
semantics are the JAX package's: the global model is a flat vector
``x ∈ R^d`` updated additively; the last ``W`` clocks of updates sit in a
ring buffer; the visibility of producer ``q``'s updates to reader ``r``
is the per-channel clock ``cview[r, q]``, and the reader's view is::

    view[r] = base + Σ_{q, c' ≤ cview[r,q]} u[q, c']

A consistency model is a policy for advancing ``cview``
(``consistency.py``); delivery is the seeded Bernoulli model of
``delays.py``.

What changed in the port:

- ``lax.scan`` over clocks is a Python loop in which the clock ``c`` is a
  Python int.  Every decision stays a tensor operation on the run's
  device, and every scalar is filled on the device (``torch.full``),
  never copied from the host, so a clock makes the host wait for nothing
  (``chip_smoke.py`` runs the loop under ``torch.cuda.set_sync_debug_mode``
  to show it).
- ``vmap`` of the worker update is a batched contract:
  ``PSApp.worker_update`` takes all ``P`` workers' views at once.
- The ring buffer is updated in place (``uring[slot] = u``), which saves a
  copy of the ``[W, P, d]`` ring per clock; nothing else holds it.
- The per-clock view materialization and the VAP suffix norms go through
  ``kernels.ops``: hand-written CUDA kernels on the card, their plain
  PyTorch versions on the CPU.

The Trace-producer contract holds: the same `Trace` fields with the clock
axis leading, and the same key stream (``split(rng, 3)`` per clock,
worker keys ``split(k_upd, P)``, delivery from ``k_net``), drawn through
:mod:`repro_torch.rng`, which is bit-equal to ``jax.random``.  Integer
fields match the JAX simulator exactly; float fields match to a stated
ulp budget (``psrun.validate.VAP_ULP_BUDGET``), because reduction orders
differ between the frameworks.

With ``cfg.comm_active`` (the comm substrate, :mod:`repro_torch.comm`)
the cross-pod wire stops being free, as in the JAX package: each producer
accumulates raw updates and ships one aggregated, top-k-sparsified,
quantized delta every ``agg_clocks`` clocks (the pack is the
``delta_pack`` kernel on the card), with an error-feedback residual;
cross-pod readers materialize their views from the shipped wire ring
while intra-pod readers keep reading raw (two ``ring_view`` launches per
clock); cross-pod visibility advances only to shipment boundaries; and
``Trace.ship_floats`` records the bits-weighted floats of each shipment.
The port packs only on boundary clocks (``comm.ship_now``, a test of the
host's clock), where the JAX package packs every clock and discards the
result; the state and the trace are the same.

``schedule`` (a `core.delays.ChurnSchedule`) makes the fleet churn: dead
workers' updates are zeroed before they enter the ring, their local
state and reader rows of ``cview`` freeze, they ship nothing, and with
``drop_inflight`` their ring, accumulator, residual and wire rows are
zeroed the clock they die; the key stream and every survivor channel are
the no-churn ones.  ``faults`` (a `comm.wire.WireFaults`, comm substrate
only) makes the cross-pod wire lossy: the ARQ of :mod:`comm.wire` runs
every clock (retransmits and arrivals land off the boundaries), a busy
producer skips its boundary, and cross-pod visibility is capped by what
has arrived (``wire_tip``).  Under churn or faults the shipping decision
is a ``[P]`` mask on the device, applied with ``torch.where`` to the
packed rows.  ``obs`` (an `obs.ObsSpec`) folds telemetry accumulators on
the device every clock and returns them as ``Trace.obs``.  A neutral
schedule (``no_churn``, ``wire.no_faults``) and ``obs`` on or off leave
every other Trace field bit-equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import rng as jrng
from ..comm import substrate as comm
from ..comm import wire
from ..kernels import ops
from ..kernels.ref import RING_EMPTY, RING_INVALID
from ..obs import metrics as obsm
from .consistency import ConsistencyConfig
from .delays import ChurnSchedule, churn_live, churn_rates, \
    delivery_matrix, pod_of, same_pod_mask, staleness_bound_matrix

# The per-clock functions (``repro_torch.analysis``'s clock-step scope: no
# host sync may run in them or in what they call).
CLOCK_STEP = ("simulate_with_state",)


@dataclass
class PSApp:
    """An ML application running against the simulated parameter server.

    Attributes:
      name: identifier.
      dim: size of the flat parameter vector ``d``.
      n_workers: number of PS workers ``P``.
      x0: initial parameters, float32 ``[d]``, on the run's device.
      local0: worker-local state, a dict of tensors whose leading axis is
        ``P``.
      worker_update: ``(views[P, d], local, worker_ids[P], clock, keys[P, 2])
        -> (u[P, d], local')`` — one clock of work for all ``P`` workers,
        batched over the leading axis; ``clock`` is a Python int and
        ``keys`` the workers' rng keys (``repro_torch.rng``).
      loss: ``(x[d], local) -> scalar`` global training objective.
    """

    name: str
    dim: int
    n_workers: int
    x0: torch.Tensor
    local0: Any
    worker_update: Callable
    loss: Callable


@dataclass(frozen=True)
class Trace:
    """Per-clock traces from a simulation (leading axis = clock)."""

    loss_ref: torch.Tensor        # [T] loss of the reference sequence x_t
    loss_view: torch.Tensor       # [T] loss of worker 0's (stale) view
    staleness: torch.Tensor       # [T, P, P] clock differential cview - c
    forced: torch.Tensor          # [T, P, P] synchronous (blocking) fetches
    delivered: torch.Tensor       # [T, P, P] background deliveries
    u_l2: torch.Tensor            # [T, P] l2 norm of each worker's update
    intransit_inf: torch.Tensor   # [T] max inf-norm of in-transit aggregates
    ship_floats: torch.Tensor     # [T, P] bits-weighted floats each
    #                               producer put on the cross-pod wire
    #                               (comm substrate: values + sparse indices
    #                               at shipment clocks, 0 otherwise; dense
    #                               path: d for push models, 0 for ssp)
    live: torch.Tensor            # [T, P] worker liveness (all True
    #                               without a ChurnSchedule)
    views0: torch.Tensor | None   # [T, d] worker-0 views (if record_views)
    x_final: torch.Tensor         # [d] final reference parameters
    locals_final: Any             # final worker-local state
    obs: Any = None               # telemetry accumulators (obs.metrics)
    #                               when the run collected them, else None


def enforce_vap(cfg: ConsistencyConfig, c: int, cview, norms, W: int):
    """Force delivery of the oldest in-transit updates so that each
    producer's aggregated in-transit update satisfies ``||.||_inf <= v_t``
    (paper eq. 1, ``v_t = v0/sqrt(t+1)``).

    ``norms[k, q]`` is the inf-norm of the suffix aggregate of producer
    q's newest ``k`` clocks; each channel keeps in transit the longest
    suffix that satisfies the bound and is not longer than what it has in
    transit now, and the rest is force-delivered.  ``cview`` may be the
    full ``[P, P]`` matrix or a block of reader rows."""
    dev = norms.device
    # filled on the device: torch.tensor(x, device=cuda) would synchronize
    v0 = torch.full((), cfg.v0, dtype=torch.float32, device=dev)
    v_t = v0 / torch.sqrt(torch.full((), float(c), dtype=torch.float32,
                                     device=dev) + 1.0)
    ok = norms <= v_t                                   # [W+1, P]
    ok[0] = True                                        # empty suffix
    kcur = torch.clamp(c - 1 - cview, 0, W)             # [r, q]
    ks = torch.arange(W + 1, dtype=torch.int32, device=dev)[:, None, None]
    cond = ok[:, None, :] & (ks <= kcur[None, :, :])    # [W+1, r, q]
    kbest = torch.where(cond, ks, -1).amax(dim=0)       # [r, q]
    required = c - 1 - kbest
    forced = cview < required
    return torch.maximum(cview, required).to(torch.int32), forced


def _x_ref(base, uring, uclock):
    """Reference parameters: base plus every stored (valid) ring slot,
    the producers summed first (the temporaries are ``[W, d]``, not the
    ring's ``[W, P, d]``), each sum in ``comm.sum_rows``'s fixed order."""
    valid = (uclock > RING_INVALID).to(uring.dtype)
    per_slot = comm.sum_rows(uring.transpose(0, 1))           # [W, d]
    return base + comm.sum_rows(per_slot * valid[:, None])


def _folded(base, cst, wired: bool):
    """Everything folded out of the ring: ``base``, plus on the comm
    substrate the per-pod folds of the raw ring."""
    return base + comm.sum_rows(cst["base_pod"]) if wired else base


def _select_local(mask, new, old):
    """Keep ``new`` worker-local state where ``mask [P]`` and ``old``
    elsewhere, leaf by leaf (a dict of tensors with a leading ``P`` axis,
    possibly nested)."""
    if isinstance(new, dict):
        return {k: _select_local(mask, new[k], old[k]) for k in new}
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


def simulate(app: PSApp, cfg: ConsistencyConfig, n_clocks: int, seed=0,
             record_views: bool = False,
             schedule: ChurnSchedule | None = None,
             obs: obsm.ObsSpec | None = None,
             faults: wire.WireFaults | None = None) -> Trace:
    """Run ``n_clocks`` of the app under the given consistency model, on
    the device of ``app.x0``.  Same contract as the JAX package's
    ``core.ps.simulate``: flat and two-tier, dense and under the comm
    substrate, with fleet churn (``schedule``), telemetry (``obs``) and
    the lossy wire (``faults``)."""
    return simulate_with_state(app, cfg, n_clocks, seed, record_views,
                               schedule=schedule, obs=obs, faults=faults)[0]


def simulate_with_state(app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
                        seed=0, record_views: bool = False,
                        schedule: ChurnSchedule | None = None,
                        obs: obsm.ObsSpec | None = None,
                        faults: wire.WireFaults | None = None):
    """`simulate`, also returning the final comm state (``None`` off the
    comm substrate): ``acc``, ``res``, the wire ring and, under
    ``faults``, the ARQ state with its counters (``n_retx``,
    ``n_giveup``, ``n_duprej``)."""
    P, d = app.n_workers, app.dim
    W = cfg.effective_window
    f32, i32 = torch.float32, torch.int32
    dev = app.x0.device
    churned = schedule is not None
    if churned and schedule.live.shape[1] != P:
        raise ValueError(f"schedule has {schedule.live.shape[1]} workers, "
                         f"app has {P}")
    # the comm substrate routes cross-pod shipment through the wire ring
    wired = cfg.comm_active
    G, agg = cfg.n_pods, cfg.agg_clocks
    obs_enabled = obsm.obs_on(obs)
    faulted = faults is not None
    if faulted:
        wire.validate_faults(faults, cfg, P, W)
        faults = faults.to(dev)
    if churned:
        schedule = schedule.to(dev)

    base = app.x0.to(f32).clone()
    uring = torch.zeros((W, P, d), dtype=f32, device=dev)
    uclock = torch.full((W,), RING_EMPTY, dtype=i32, device=dev)
    cview = torch.full((P, P), -1, dtype=i32, device=dev)
    rng = jrng.PRNGKey(seed, dev)
    # two-tier staleness bound: s intra-pod, s + s_xpod across pods (+
    # agg_clocks - 1 under the substrate).  Under a lossy wire the trigger
    # stays unwidened, as in the JAX package: only the declared contract
    # carries + retry_budget.
    s_eff = staleness_bound_matrix(cfg, torch.arange(P, device=dev), P,
                                   device=dev)
    worker_ids = torch.arange(P, dtype=i32, device=dev)
    producers = torch.arange(P, device=dev)[None, :]
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    all_live = torch.ones((P,), dtype=torch.bool, device=dev)
    local = app.local0
    cst = None
    if wired:
        in_pod = same_pod_mask(P, G, dev)                   # [P(r), P(q)]
        reader_pods = pod_of(P, G, dev)
        zeros_d = torch.zeros((d,), dtype=f32, device=dev)
        no_ship = torch.zeros((P,), dtype=f32, device=dev)
        cst = comm.init_state(W, P, d, G, dev)
        if faulted:
            cst.update(wire.init_wire_state(P, d, dev))
    else:
        dense_ship = comm.dense_ship_floats(cfg.model, P, d, dev)
    if obs_enabled:
        # the channel tiers of the forced-refresh split (all intra-pod
        # when G == 1)
        in_pod_obs = in_pod if wired else same_pod_mask(P, G, dev)
        oacc = obsm.device_init(P, obs.n_buckets, dev)

    rec = {k: [] for k in ("loss_ref", "loss_view", "staleness", "forced",
                           "delivered", "u_l2", "intransit_inf",
                           "ship_floats", "live", "views0")}
    for c in range(n_clocks):
        rng, k_upd, k_net = jrng.split(rng, 3).unbind(0)

        rates = None
        live_now = all_live
        if churned:
            live_now, died = churn_live(schedule, c)        # [P], [P]
            rates = churn_rates(cfg, schedule, P, c)
            if schedule.drop_inflight:
                # a worker dying this clock takes its in-flight (and,
                # wired, unshipped) mass with it
                uring.masked_fill_(died[None, :, None], 0.0)
                if wired:
                    cst["acc"].masked_fill_(died[:, None], 0.0)
                    cst["res"] = cst["res"].masked_fill(died[:, None], 0.0)
                    cst["xring"].masked_fill_(died[None, :, None], 0.0)
                    if faulted:
                        cst = wire.drop_pending(cst, ~died)
            cview_pre = cview

        # per-producer suffix-aggregate inf-norms of the newest k clocks:
        # drive VAP enforcement and the in-transit metric
        norms = ops.vap_suffix_norms(uring, uclock, c)      # [W+1, P]

        # --- 1. pre-read consistency enforcement (blocking fetches) -----
        if cfg.model == "bsp":
            forced = cview < (c - 1)
            cview = torch.full_like(cview, c - 1)
        elif cfg.model in ("ssp", "essp"):
            forced = cview < (c - s_eff - 1)
            if wired:
                # a cross-pod refresh fetches only what has shipped, and
                # under faults only what has arrived (wire_tip)
                tgt = _xpod_target(cst, in_pod, c - 1,
                                   comm.shipped_through(c, agg), faulted)
                cview = torch.where(forced, tgt, cview)
            else:
                cview = torch.where(forced, c - 1, cview)
        elif cfg.model == "vap":
            cview, forced = enforce_vap(cfg, c, cview, norms, W)
        else:  # async
            forced = torch.zeros_like(cview, dtype=torch.bool)
        if cfg.read_my_writes:
            cview = torch.where(eye, c - 1, cview)
        if churned:
            # dead readers neither fetch nor advance: their rows freeze,
            # which trips the bound (one forced burst) on rejoin
            forced = forced & live_now[:, None]
            cview = torch.where(live_now[:, None], cview, cview_pre)
        staleness = cview - c

        # channel (r, q) has the newest c-1-cview[r,q] clocks of q in
        # transit: its in-transit norm is one gather from `norms`
        kcur = torch.clamp(c - 1 - cview, 0, W).long()
        intransit_inf = norms[kcur, producers].amax()

        # --- 2. materialize views ---------------------------------------
        if wired:
            # intra-pod producers read the raw ring, cross-pod producers
            # the wire ring, on the folded base of the reader's pod; a
            # masked-out channel sees nothing (cview below every clock)
            cv_intra = torch.where(in_pod, cview, RING_EMPTY)
            cv_xpod = torch.where(in_pod, RING_EMPTY, cview)
            rb = comm.reader_base(base, cst["base_pod"], cst["xbase_pod"],
                                  reader_pods)
            views = ((rb + ops.ring_view(zeros_d, uring, uclock, cv_intra))
                     + ops.ring_view(zeros_d, cst["xring"], uclock, cv_xpod))
        else:
            views = ops.ring_view(base, uring, uclock, cview)

        # --- 3. worker computation --------------------------------------
        upd_keys = jrng.split(k_upd, P)
        u, local_new = app.worker_update(views, local, worker_ids, c,
                                         upd_keys)
        u = u.to(f32)
        if churned:
            # dead workers push nothing and their local state freezes; the
            # update still runs for all P, its dead rows discarded
            u = u.masked_fill(~live_now[:, None], 0.0)
            local = _select_local(live_now, local_new, local)
        else:
            local = local_new

        # --- 4. commit to server: fold oldest slot, write newest ---------
        slot = c % W
        w_old = torch.where(uclock[slot] > RING_INVALID, 1.0, 0.0)
        if wired:
            # recycled slots fold per producer pod: raw into base_pod,
            # wire into xbase_pod (base itself stays x0)
            cst["base_pod"] = (cst["base_pod"]
                               + w_old * comm.fold_pods(uring[slot], G))
            cst["xbase_pod"] = (cst["xbase_pod"] + w_old
                                * comm.fold_pods(cst["xring"][slot], G))
        else:
            base = base + w_old * comm.sum_rows(uring[slot])
        uring[slot] = u
        uclock[slot].fill_(c)       # a fill: `= c` copies from the host
        if wired:
            ship_floats = _ship(cst, u, c, cfg, d, live_now if churned
                                else None, faults, no_ship, slot)
        else:
            ship_floats = (torch.where(live_now, dense_ship, 0.0)
                           if churned else dense_ship)

        # --- 5. end-of-clock delivery (affects reads at c+1) -------------
        if cfg.model == "bsp":
            delivered = torch.ones((P, P), dtype=torch.bool, device=dev)
            if churned:
                # the barrier drains to live readers only
                delivered = delivered & live_now[:, None]
                cview = torch.where(live_now[:, None],
                                    torch.full_like(cview, c), cview)
            else:
                cview = torch.full_like(cview, c)
        elif cfg.model == "ssp":
            delivered = torch.zeros((P, P), dtype=torch.bool, device=dev)
        else:  # essp / async / vap: delay-driven eager delivery
            delivered = delivery_matrix(k_net, cfg, P, rates)
            if churned:
                # pushes to dead readers are lost; the draws themselves
                # are the no-churn draws
                delivered = delivered & live_now[:, None]
            if wired:
                # a cross-pod delivery carries the latest shipment (under
                # faults, the latest arrived one)
                tgt = _xpod_target(cst, in_pod, c,
                                   comm.shipped_end(c, agg), faulted)
                cview = torch.where(delivered, torch.maximum(cview, tgt),
                                    cview)
            else:
                cview = torch.where(delivered, c, cview)

        # --- 6. record ----------------------------------------------------
        x_ref = _x_ref(_folded(base, cst, wired), uring, uclock)
        rec["loss_ref"].append(app.loss(x_ref, local))
        rec["loss_view"].append(app.loss(views[0], local))
        rec["staleness"].append(staleness)
        rec["forced"].append(forced)
        rec["delivered"].append(delivered)
        rec["u_l2"].append(torch.linalg.vector_norm(u, dim=-1))
        rec["intransit_inf"].append(intransit_inf)
        rec["ship_floats"].append(ship_floats)
        rec["live"].append(live_now)
        if record_views:
            rec["views0"].append(views[0])
        if obs_enabled:
            oacc = obsm.device_update(
                oacc, staleness=staleness, forced=forced,
                delivered=delivered, ship_floats=ship_floats, live=live_now,
                live_rows=live_now, in_pod=in_pod_obs)

    def stacked(k, shape, dtype):
        if rec[k]:
            return torch.stack(rec[k])
        return torch.empty((0,) + shape, dtype=dtype, device=dev)

    trace = Trace(
        loss_ref=stacked("loss_ref", (), f32),
        loss_view=stacked("loss_view", (), f32),
        staleness=stacked("staleness", (P, P), i32),
        forced=stacked("forced", (P, P), torch.bool),
        delivered=stacked("delivered", (P, P), torch.bool),
        u_l2=stacked("u_l2", (P,), f32),
        intransit_inf=stacked("intransit_inf", (), f32),
        ship_floats=stacked("ship_floats", (P,), f32),
        live=stacked("live", (P,), torch.bool),
        views0=stacked("views0", (d,), f32) if record_views else None,
        x_final=_x_ref(_folded(base, cst, wired), uring, uclock),
        locals_final=local, obs=oacc if obs_enabled else None)
    return trace, cst


def _xpod_target(cst, in_pod, intra: int, xpod: int, faulted: bool):
    """[P, P] int32 visibility target of a refresh or delivery: ``intra``
    on intra-pod channels, ``xpod`` (the shipment boundary) across pods,
    capped under faults by each producer's ``wire_tip``."""
    if faulted:
        tip = torch.clamp(cst["wire_tip"], max=xpod).expand(in_pod.shape)
    else:                           # filled on the device
        tip = torch.full(in_pod.shape, xpod, dtype=torch.int32,
                         device=in_pod.device)
    return tip.masked_fill(in_pod, intra)


def _ship(cst, u, c: int, cfg, d: int, live, faults, no_ship, slot: int,
          full_rows=None):
    """Section 4b of a clock on the comm substrate, updating ``cst``:
    accumulate ``u``, pack and ship at a boundary, run the lossy wire's
    ARQ under ``faults``.  Returns the clock's ``ship_floats [P]``.

    ``ship_now`` is a test of the host's clock, so the pack runs (one
    ``delta_pack`` launch) on boundary clocks only.  Under churn or faults
    who ships is a ``[P]`` device mask (boundary x liveness x idleness),
    applied to the packed rows with ``torch.where``.  A shard of the
    sharded runtime passes its column block as ``u`` and ``full_rows``,
    which gathers a block's full rows (the threshold, the scale and the
    count are taken on them)."""
    cst["acc"].add_(u)              # acc is the state's own tensor
    boundary = comm.ship_now(c, cfg.agg_clocks)
    masked = live is not None or faults is not None
    wire_u = floats = ship = None
    if boundary:
        delta = cst["acc"] + cst["res"]
        if full_rows is None:
            wire_u, resid, nnz = comm.pack(delta, cfg.topk_frac, cfg.quant)
        else:
            wire_u, resid, nnz = comm.pack_block(
                delta, full_rows(delta), cfg.topk_frac, cfg.quant)
        floats = comm.wire_floats(nnz, d, cfg.quant)
        if not masked:
            cst["acc"].zero_()
            cst["res"] = resid
        else:
            ship = torch.ones_like(resid[:, 0], dtype=torch.bool)
            if live is not None:
                ship = ship & live
            if faults is not None:
                # stop-and-wait: a producer with an unacked shipment skips
                # the boundary; the skipped content rides the next one
                ship = ship & wire.idle(cst)
            cst["acc"].masked_fill_(ship[:, None], 0.0)
            cst["res"] = torch.where(ship[:, None], resid, cst["res"])
            wire_u = wire_u.masked_fill(~ship[:, None], 0.0)
    if faults is not None:
        # the recycled slot clears; a shipment enters the wire ring only
        # when it arrives, through wire_step's sequence-guarded fold
        cst["xring"][slot].zero_()
        new, ship_floats = wire.wire_step(cst, wire_u, floats, ship, c,
                                          faults, live=live)
        cst.update(new)
        return ship_floats
    if not boundary:
        cst["xring"][slot].zero_()
        return no_ship
    cst["xring"][slot] = wire_u
    return floats if ship is None else torch.where(ship, floats, 0.0)
