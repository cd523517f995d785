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
The port packs only on clocks that ship, where the JAX package packs
every clock and discards the result; the state and the trace are the
same.

Fleet churn (``schedule``), telemetry (``obs``) and the lossy wire
(``faults``) are ported in later slices; passing them raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import rng as jrng
from ..comm import substrate as comm
from ..kernels import ops
from ..kernels.ref import RING_EMPTY, RING_INVALID
from .consistency import ConsistencyConfig
from .delays import delivery_matrix, pod_of, same_pod_mask, \
    staleness_bound_matrix


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
    live: torch.Tensor            # [T, P] worker liveness (all True: churn
    #                               is not ported yet)
    views0: torch.Tensor | None   # [T, d] worker-0 views (if record_views)
    x_final: torch.Tensor         # [d] final reference parameters
    locals_final: Any             # final worker-local state


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
    """Reference parameters: base plus every stored (valid) ring slot."""
    valid = (uclock > RING_INVALID).to(uring.dtype)
    # sum the producers first: the temporaries are [W, d], not the ring's
    # [W, P, d]
    return base + (uring.sum(dim=1) * valid[:, None]).sum(dim=0)


def _tier_target(in_pod, intra: int, xpod: int, like):
    """[P, P] int32 visibility target: ``intra`` on intra-pod channels,
    ``xpod`` across pods (filled on the device)."""
    return torch.full_like(like, xpod).masked_fill_(in_pod, intra)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, "
        f"{item}); run it on the JAX package")


def simulate(app: PSApp, cfg: ConsistencyConfig, n_clocks: int, seed=0,
             record_views: bool = False, schedule=None, obs=None,
             faults=None) -> Trace:
    """Run ``n_clocks`` of the app under the given consistency model, on
    the device of ``app.x0``.  Same contract as the JAX package's
    ``core.ps.simulate`` in its dense flat and two-tier modes and under
    the comm substrate."""
    if schedule is not None:
        _not_ported("fleet churn (schedule=ChurnSchedule)", "item 10")
    if obs is not None:
        _not_ported("telemetry (obs=ObsSpec)", "item 12")
    if faults is not None:
        _not_ported("the lossy wire (faults=WireFaults)", "item 11")

    P, d = app.n_workers, app.dim
    W = cfg.effective_window
    f32, i32 = torch.float32, torch.int32
    dev = app.x0.device

    base = app.x0.to(f32).clone()
    uring = torch.zeros((W, P, d), dtype=f32, device=dev)
    uclock = torch.full((W,), RING_EMPTY, dtype=i32, device=dev)
    cview = torch.full((P, P), -1, dtype=i32, device=dev)
    rng = jrng.PRNGKey(seed, dev)
    # two-tier staleness bound: s intra-pod, s + s_xpod across pods
    s_eff = staleness_bound_matrix(cfg, torch.arange(P, device=dev), P,
                                   device=dev)
    worker_ids = torch.arange(P, dtype=i32, device=dev)
    producers = torch.arange(P, device=dev)[None, :]
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    all_live = torch.ones((P,), dtype=torch.bool, device=dev)
    local = app.local0
    # the comm substrate routes cross-pod shipment through the wire ring
    wired = cfg.comm_active
    G, agg = cfg.n_pods, cfg.agg_clocks
    if wired:
        in_pod = same_pod_mask(P, G, dev)                   # [P(r), P(q)]
        reader_pods = pod_of(P, G, dev)
        zeros_d = torch.zeros((d,), dtype=f32, device=dev)
        no_ship = torch.zeros((P,), dtype=f32, device=dev)
        cst = comm.init_state(W, P, d, G, dev)
    else:
        ship_floats = comm.dense_ship_floats(cfg.model, P, d, dev)

    rec = {k: [] for k in ("loss_ref", "loss_view", "staleness", "forced",
                           "delivered", "u_l2", "intransit_inf",
                           "ship_floats", "views0")}
    for c in range(n_clocks):
        rng, k_upd, k_net = jrng.split(rng, 3).unbind(0)

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
                # a cross-pod refresh fetches only what has shipped
                tgt = _tier_target(in_pod, c - 1,
                                   comm.shipped_through(c, agg), cview)
                cview = torch.where(forced, tgt, cview)
            else:
                cview = torch.where(forced, c - 1, cview)
        elif cfg.model == "vap":
            cview, forced = enforce_vap(cfg, c, cview, norms, W)
        else:  # async
            forced = torch.zeros_like(cview, dtype=torch.bool)
        if cfg.read_my_writes:
            cview = torch.where(eye, c - 1, cview)
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
        u, local = app.worker_update(views, local, worker_ids, c, upd_keys)
        u = u.to(f32)

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
            base = base + w_old * uring[slot].sum(0)
        uring[slot] = u
        uclock[slot].fill_(c)       # a fill: `= c` copies from the host
        if wired:
            # --- 4b. comm substrate: accumulate, and ship on boundary ----
            # acc is the state's own tensor: accumulate in place
            cst["acc"].add_(u)
            if comm.ship_now(c, agg):
                delta = cst["acc"] + cst["res"]
                wire_u, cst["res"], nnz = comm.pack(delta, cfg.topk_frac,
                                                    cfg.quant)
                cst["acc"].zero_()
                cst["xring"][slot] = wire_u
                ship_floats = comm.wire_floats(nnz, d, cfg.quant)
            else:
                cst["xring"][slot].zero_()
                ship_floats = no_ship

        # --- 5. end-of-clock delivery (affects reads at c+1) -------------
        if cfg.model == "bsp":
            delivered = torch.ones((P, P), dtype=torch.bool, device=dev)
            cview = torch.full_like(cview, c)
        elif cfg.model == "ssp":
            delivered = torch.zeros((P, P), dtype=torch.bool, device=dev)
        else:  # essp / async / vap: delay-driven eager delivery
            delivered = delivery_matrix(k_net, cfg, P)
            if wired:
                # a cross-pod delivery carries the latest shipment
                tgt = _tier_target(in_pod, c, comm.shipped_end(c, agg),
                                   cview)
                cview = torch.where(delivered, torch.maximum(cview, tgt),
                                    cview)
            else:
                cview = torch.where(delivered, c, cview)

        # --- 6. record ----------------------------------------------------
        x_ref = _x_ref(base + cst["base_pod"].sum(0) if wired else base,
                       uring, uclock)
        rec["loss_ref"].append(app.loss(x_ref, local))
        rec["loss_view"].append(app.loss(views[0], local))
        rec["staleness"].append(staleness)
        rec["forced"].append(forced)
        rec["delivered"].append(delivered)
        rec["u_l2"].append(torch.linalg.vector_norm(u, dim=-1))
        rec["intransit_inf"].append(intransit_inf)
        rec["ship_floats"].append(ship_floats)
        if record_views:
            rec["views0"].append(views[0])

    def stacked(k, shape, dtype):
        if rec[k]:
            return torch.stack(rec[k])
        return torch.empty((0,) + shape, dtype=dtype, device=dev)

    return Trace(
        loss_ref=stacked("loss_ref", (), f32),
        loss_view=stacked("loss_view", (), f32),
        staleness=stacked("staleness", (P, P), i32),
        forced=stacked("forced", (P, P), torch.bool),
        delivered=stacked("delivered", (P, P), torch.bool),
        u_l2=stacked("u_l2", (P,), f32),
        intransit_inf=stacked("intransit_inf", (), f32),
        ship_floats=stacked("ship_floats", (P,), f32),
        live=all_live.expand(n_clocks, P).clone(),
        views0=stacked("views0", (d,), f32) if record_views else None,
        x_final=_x_ref(base + cst["base_pod"].sum(0) if wired else base,
                       uring, uclock),
        locals_final=local)
