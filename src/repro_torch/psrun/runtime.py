"""The executable PS runtime: one process per mesh point, on
``torch.distributed``.

The port of ``repro/psrun/runtime.py``.  Layout (mesh dims ``("data",
"model")`` from `launch.mesh.make_ps_mesh`; the hierarchical runtime in
``repro_torch.pods`` uses worker axes ``("pod", "data")`` on a 3-D mesh
from `launch.mesh.make_pods_mesh`):

- the flat parameter vector (dim ``d``, zero-padded to ``dpad``, which
  divides the model axis) is split over ``"model"``: the rank at model
  index ``mi`` *owns* the column block ``[mi·dl, (mi+1)·dl)`` of the table
  (the server side);
- the ``P`` workers are partitioned over the *worker axes* (``"data"``, or
  ``("pod","data")`` pod-major; ``P`` must divide by their product): the
  rank at worker index ``di`` runs workers ``di·Pl .. di·Pl + Pl - 1``,
  holds their local state and their reader rows of the per-channel clock
  matrix ``cview``, and (with the model axis) its block of every
  producer's in-transit update ring (the client cache);
- the update ring ``uring[W, P, dl]`` is replicated over the worker axes
  and split over ``"model"``: every reader sees every producer's updates
  for the columns its block owns.  Under the pod axis this replication is
  the per-pod replica of the parameter shards.

Per clock, on each rank (collectives named; each is one call on the
worker or model group of the mesh, enqueued on the current stream):

1. consistency enforcement advances the rank's reader rows of ``cview``
   (VAP reads the global suffix-aggregate inf-norms: the block's
   ``vap_suffix_norms``, then an ``all_reduce(MAX)`` over ``"model"`` on
   their int32 bit patterns: the norms are >= +0, so the bits order as the
   floats and a NaN above +inf, as the kernel's own ``atomicMax`` fold);
2. views materialize rank-locally through ``kernels.ops.ring_view`` on the
   rank's reader rows and column block, then an ``all_gather`` over
   ``"model"`` assembles the readers' full views;
3. each worker shard runs ``app.worker_update`` on its own rows;
4. the updates are gathered over the worker axes (``all_gather``), the
   owned block is written into the ring, and the oldest slot folds into
   the block's base; under the comm substrate the shipment's threshold,
   scale and count come from the block's full rows (an ``all_gather``
   over ``"model"`` on shipping clocks) and ``delta_pack`` packs the block;
5. the end-of-clock delivery (the simulator's `core.delays` model, the
   rank's reader rows of the full draw) advances ``cview``;
6. the record: ``x_ref``'s block gathered over ``"model"``, the locals
   over the worker axes, worker 0's view broadcast from its rank.  At the
   end of the run the per-rank ``staleness``, ``forced`` and
   ``delivered`` rows and the in-transit maxima are gathered, so every
   rank returns the whole `Trace`, and the `PSState` is gathered whole.

The key stream is replicated: every rank draws the whole threefry stream
and takes its rows of ``split(k_upd, P)``.  The arithmetic is the
simulator's (``core.ps``: the same key splits, the same operand shapes
where a reduction's order depends on them, the producer and slot sums in
``comm.sum_rows``'s fixed order, ``ring_view``'s adds in one order at any
reader count and column offset), which makes the simulator an executable
oracle: seeded BSP, SSP and ESSP runs equal it bit for bit at any mesh
(`psrun.validate.cross_validate`) as long as every worker shard carries
more than one worker (a batch of one may take another CPU code path:
``default_mesh`` keeps two or more).

``init_state`` / ``run_from`` expose the mid-run `PSState` (the whole
clock-step state, the key too): resuming from a saved state reproduces
the uninterrupted run bit for bit (``checkpoint.io.save_runtime``).

What has no counterpart: the JAX runtime compiles one program per config
family and counts its traces (``trace_count``); here nothing is compiled
per family (the kernels are built once per process), so there is no
count, and ``run_fn`` builds a plain closure each call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import rng as jrng
from ..comm import substrate as comm
from ..comm import wire
from ..core.consistency import ConsistencyConfig
from ..core.delays import ChurnSchedule, churn_live, churn_rates, \
    delivery_matrix, pod_of, staleness_bound_matrix
from ..core.ps import PSApp, Trace, _folded, _select_local, _ship, \
    _x_ref, _xpod_target, enforce_vap
from ..kernels import ops
from ..kernels.ref import RING_EMPTY, RING_INVALID
from ..launch.mesh import ensure_world, make_ps_mesh, process_device
from ..obs import metrics as obsm


@dataclass(frozen=True)
class PSState:
    """Mid-run runtime state (everything the clock step carries), whole:
    every rank holds all of it.

    ``base``/``uring`` are in the runtime's padded column layout (``dpad``
    divides the model axis); ``clock`` is the next clock to run, a host
    int as the port's clock loop is.  ``checkpoint.io.save_runtime`` /
    ``restore_runtime`` round-trip it."""

    clock: int                 # next clock to execute
    base: torch.Tensor         # [dpad] folded (globally visible) updates
    #                            (under the comm substrate: constant x0 —
    #                            folds go to comm["base_pod"] per pod)
    uring: torch.Tensor        # [W, P, dpad] in-transit update ring
    uclock: torch.Tensor       # [W] clock stored in each ring slot
    cview: torch.Tensor        # [P, P] per-channel visibility clocks
    local: Any                 # worker-local state (leaves lead with P)
    rng: torch.Tensor          # key of the simulator's key stream
    comm: Any = None           # comm-substrate state (acc, res, xring,
    #                            base_pod, xbase_pod, and under faults the
    #                            ARQ state) when cfg.comm_active


def default_mesh(n_workers: int, device=None):
    """The widest ``("data","model")`` mesh of the world for ``n_workers``
    that stays in the bit-identity regime: the data axis is the largest
    divisor of the world size that divides the worker count while keeping
    >= 2 workers per shard; an even leftover becomes 2 model columns.  It
    must use every rank (one process per mesh point)."""
    ensure_world(process_device(device))
    n = dist.get_world_size()
    data = 1
    for cand in range(min(n, n_workers // 2), 0, -1):
        if n_workers % cand == 0 and n % cand == 0:
            data = cand
            break
    rest = n // data
    model = 2 if (rest > 1 and rest % 2 == 0) else 1
    return make_ps_mesh(data=data, model=model, device=device)


def _layout(app: PSApp, mesh, worker_axes):
    """Validate the (app, mesh) pairing and derive the shard geometry."""
    names = mesh.mesh_dim_names
    assert set(worker_axes) | {"model"} <= set(names), (names, worker_axes)
    DP = 1
    for ax in worker_axes:
        DP *= mesh.size(names.index(ax))
    M = mesh.size(names.index("model"))
    P, d = app.n_workers, app.dim
    if P % DP:
        raise ValueError(
            f"n_workers={P} must divide by the worker axes "
            f"{tuple(worker_axes)} of total size {DP}; build a smaller "
            f"mesh with launch.mesh.make_ps_mesh/make_pods_mesh")
    dpad = -(-d // M) * M
    return DP, M, P // DP, dpad, dpad // M


class _Shard:
    """This rank's place in the mesh: its worker and model indices, the
    process groups of its worker axes and of ``"model"``, and the
    collectives the clock step runs on them."""

    def __init__(self, mesh, worker_axes):
        names = mesh.mesh_dim_names
        coord = dict(zip(names, mesh.get_coordinate(), strict=True))
        self.mi = coord["model"]
        self.di = 0
        for ax in worker_axes:                   # pod-major worker index
            self.di = self.di * mesh.size(names.index(ax)) + coord[ax]
        self.model = mesh.get_group("model")
        ranks = mesh.mesh.permute(
            *[names.index(a) for a in worker_axes], names.index("model"))
        ranks = ranks.reshape(-1, ranks.shape[-1])   # [DP, M]
        if len(worker_axes) == 1:
            self.workers = mesh.get_group(worker_axes[0])
        else:
            # one group per model column over the flattened worker axes;
            # every rank makes every group, in the same order
            groups = [dist.new_group(ranks[:, m].tolist())
                      for m in range(ranks.shape[1])]
            self.workers = groups[self.mi]
        self.worker0 = int(ranks[0, self.mi])   # global rank of worker row 0

    @staticmethod
    def gather(t, group, dim: int):
        """``all_gather`` of ``t`` over ``group``, concatenated along
        ``dim`` in group-rank order (bools travel as uint8)."""
        src = t.contiguous()
        wire_t = src.to(torch.uint8) if src.dtype == torch.bool else src
        parts = [torch.empty_like(wire_t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, wire_t, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if src.dtype == torch.bool else out

    @staticmethod
    def max_bits(t, group):
        """MAX of a float tensor whose values are >= +0 or NaN over
        ``group``, folded as int32 bit patterns (NaN above +inf)."""
        bits = t.contiguous().clone().view(torch.int32)
        dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=group)
        return bits.view(torch.float32)

    def gather_tree(self, tree, group, dim: int):
        if isinstance(tree, dict):
            return {k: self.gather_tree(v, group, dim)
                    for k, v in tree.items()}
        return self.gather(tree, group, dim)


def _rows(tree, lo: int, hi: int):
    """Rows ``lo:hi`` of every leaf (a dict of tensors, possibly nested)."""
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi].clone()


def make_run_fn(app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
                mesh=None, record_views: bool = False,
                worker_axes: tuple = ("data",),
                schedule: ChurnSchedule | None = None,
                obs: obsm.ObsSpec | None = None,
                faults: wire.WireFaults | None = None):
    """The runtime for one config family on ``mesh``, on this rank.

    Returns a callable ``fn(seed, cfg, schedule=None, faults=None) ->
    Trace``.  ``cfg`` may differ from the one given here in its numeric
    knobs; the ring window and the comm structure are fixed here (a
    mismatch raises, as in the JAX package).  ``schedule`` and ``faults``
    here fix only the churn and fault structure; the ones passed to a call
    are the ones run.  ``fn.init_state(seed) -> PSState`` and
    ``fn.run_from(state, cfg, schedule, faults) -> (Trace, PSState)`` are
    the state-carrying entry points; ``fn(seed, cfg)`` is
    ``fn.run_from(fn.init_state(seed), cfg)[0]``.  Schedules index by
    absolute clock, so a resumed segment reads what the uninterrupted run
    would.  Every rank of the mesh must make the same calls."""
    mesh = make_ps_mesh() if mesh is None else mesh
    worker_axes = tuple(worker_axes)
    _DP, M, Pl, dpad, dl = _layout(app, mesh, worker_axes)
    P, d = app.n_workers, app.dim
    W = cfg.effective_window
    if cfg.n_pods > 1 and P % cfg.n_pods:
        raise ValueError(f"n_workers={P} must divide by n_pods={cfg.n_pods}")
    f32, i32 = torch.float32, torch.int32
    dev = app.x0.device
    if dev.type != mesh.device_type:
        raise ValueError(f"the app lives on {dev}, the mesh on "
                         f"{mesh.device_type}")
    wired = cfg.comm_active
    quant0, G = cfg.quant, cfg.n_pods
    obs_enabled = obsm.obs_on(obs)
    churned = schedule is not None
    if churned and schedule.live.shape[1] != P:
        raise ValueError(f"schedule has {schedule.live.shape[1]} workers, "
                         f"app has {P}")
    faulted = faults is not None
    if faulted:
        wire.validate_faults(faults, cfg, P, W)
    sh = _Shard(mesh, worker_axes)
    rows0, mi = sh.di * Pl, sh.mi
    lo, hi = mi * dl, (mi + 1) * dl            # the owned column block

    def block(t):
        """A contiguous copy of the owned column block of ``t [..., dpad]``
        (the run updates its blocks in place; the caller's state stays)."""
        return t[..., lo:hi].clone(memory_format=torch.contiguous_format)

    def full_cols(t):
        """``t [..., dl]`` gathered over "model": ``[..., d]``."""
        return sh.gather(t, sh.model, t.dim() - 1)[..., :d]

    def run_from_local(state: PSState, cfg, sched, flt):
        c0 = int(state.clock)
        worker_ids = torch.arange(rows0, rows0 + Pl, dtype=i32, device=dev)
        producers = torch.arange(P, device=dev)[None, :]
        eye_l = worker_ids[:, None] == producers
        all_live = torch.ones((P,), dtype=torch.bool, device=dev)
        # two-tier staleness bound on the rank's reader rows; under a
        # lossy wire the trigger stays unwidened (simulator mirror)
        s_eff = staleness_bound_matrix(cfg, worker_ids, P, device=dev)
        pods_all = pod_of(P, G, dev)
        in_pod = pods_all[worker_ids.long()][:, None] == pods_all[None, :]
        if flt is not None:
            flt = flt.to(dev)
        if sched is not None:
            sched = sched.to(dev)
        base = block(state.base)
        uring = block(state.uring)
        uclock = state.uclock.clone()
        cview = state.cview[rows0:rows0 + Pl].clone()
        local = _rows(state.local, rows0, rows0 + Pl)
        rng = state.rng.clone()
        cst = None
        if wired:
            reader_pods = pods_all[worker_ids.long()]
            zeros_dl = torch.zeros((dl,), dtype=f32, device=dev)
            no_ship = torch.zeros((P,), dtype=f32, device=dev)
            cst = {k: (block(v) if k in ("acc", "res", "xring", "base_pod",
                                         "xbase_pod", "pend")
                       else v.clone()) for k, v in state.comm.items()}
        else:
            dense_ship = comm.dense_ship_floats(cfg.model, P, d, dev)
        if obs_enabled:
            oacc = obsm.device_init(P, obs.n_buckets, dev)

        rec = {k: [] for k in ("loss_ref", "loss_view", "staleness", "forced",
                               "delivered", "u_l2", "intransit_inf",
                               "ship_floats", "live", "views0")}
        for c in range(c0, c0 + n_clocks):
            rng, k_upd, k_net = jrng.split(rng, 3).unbind(0)

            rates = None
            live_now, live_l = all_live, None
            if sched is not None:
                live_now, died = churn_live(sched, c)          # [P], [P]
                live_l = live_now[rows0:rows0 + Pl]             # own readers
                rates = churn_rates(cfg, sched, P, c)
                if sched.drop_inflight:
                    # a dying producer's in-flight (and unshipped) mass
                    # zeroes the clock it dies (simulator mirror)
                    uring.masked_fill_(died[None, :, None], 0.0)
                    if wired:
                        cst["acc"].masked_fill_(died[:, None], 0.0)
                        cst["res"] = cst["res"].masked_fill(died[:, None],
                                                            0.0)
                        cst["xring"].masked_fill_(died[None, :, None], 0.0)
                        if flt is not None:
                            cst = wire.drop_pending(cst, ~died)
                cview_pre = cview

            # global per-producer suffix-aggregate inf-norms: the block's
            # norms, max-folded over the owning shards
            norms = sh.max_bits(ops.vap_suffix_norms(uring, uclock, c),
                                sh.model)                      # [W+1, P]

            # --- 1. pre-read consistency enforcement --------------------
            if cfg.model == "bsp":
                forced = cview < (c - 1)
                cview = torch.full_like(cview, c - 1)
            elif cfg.model in ("ssp", "essp"):
                forced = cview < (c - s_eff - 1)
                if wired:
                    tgt = _xpod_target(cst, in_pod, c - 1,
                                       comm.shipped_through(c,
                                                            cfg.agg_clocks),
                                       flt is not None)
                    cview = torch.where(forced, tgt, cview)
                else:
                    cview = torch.where(forced, c - 1, cview)
            elif cfg.model == "vap":
                cview, forced = enforce_vap(cfg, c, cview, norms, W)
            else:  # async
                forced = torch.zeros_like(cview, dtype=torch.bool)
            if cfg.read_my_writes:
                cview = torch.where(eye_l, c - 1, cview)
            if sched is not None:
                # dead readers neither fetch nor advance
                forced = forced & live_l[:, None]
                cview = torch.where(live_l[:, None], cview, cview_pre)
            staleness = cview - c

            # the rank's channels' in-transit maximum; folded over the
            # worker axes once, after the run
            kcur = torch.clamp(c - 1 - cview, 0, W).long()
            intransit_l = norms[kcur, producers].amax()

            # --- 2. views: rank-local, then assembled over "model" ------
            if wired:
                cv_intra = torch.where(in_pod, cview, RING_EMPTY)
                cv_xpod = torch.where(in_pod, RING_EMPTY, cview)
                rb = comm.reader_base(base, cst["base_pod"],
                                      cst["xbase_pod"], reader_pods)
                views_l = ((rb + ops.ring_view(zeros_dl, uring, uclock,
                                               cv_intra))
                           + ops.ring_view(zeros_dl, cst["xring"], uclock,
                                           cv_xpod))          # [Pl, dl]
            else:
                views_l = ops.ring_view(base, uring, uclock, cview)
            views = full_cols(views_l).contiguous()            # [Pl, d]

            # --- 3. the rank's workers -----------------------------------
            upd_keys = jrng.split(k_upd, P)[rows0:rows0 + Pl]
            u_l, local_new = app.worker_update(views, local, worker_ids, c,
                                               upd_keys)
            u_l = u_l.to(f32)
            if sched is not None:
                # dead workers push nothing (masked before the gather, as
                # in the simulator's operand) and their state freezes
                u_l = u_l.masked_fill(~live_l[:, None], 0.0)
                local = _select_local(live_l, local_new, local)
            else:
                local = local_new

            # --- 4. push to the owning shards; fold the oldest slot -----
            u_all = sh.gather(u_l, sh.workers, 0)              # [P, d]
            # the norm on the gathered [P, d]: the simulator's operand
            u_l2 = torch.linalg.vector_norm(u_all, dim=-1)
            u_blk = u_all if M == 1 else block(F.pad(u_all, (0, dpad - d)))
            slot = c % W
            w_old = torch.where(uclock[slot] > RING_INVALID, 1.0, 0.0)
            if wired:
                cst["base_pod"] = (cst["base_pod"]
                                   + w_old * comm.fold_pods(uring[slot], G))
                cst["xbase_pod"] = (cst["xbase_pod"] + w_old
                                    * comm.fold_pods(cst["xring"][slot], G))
            else:
                base = base + w_old * comm.sum_rows(uring[slot])
            uring[slot] = u_blk
            uclock[slot].fill_(c)       # a fill: `= c` copies from the host
            if wired:
                ship_floats = _ship(cst, u_blk, c, cfg, d, live_now
                                    if sched is not None else None, flt,
                                    no_ship, slot, full_rows=full_cols)
            else:
                ship_floats = (torch.where(live_now, dense_ship, 0.0)
                               if sched is not None else dense_ship)

            # --- 5. end-of-clock delivery (reads at c+1) ----------------
            if cfg.model == "bsp":
                delivered = torch.ones((Pl, P), dtype=torch.bool,
                                       device=dev)
                if sched is not None:
                    delivered = delivered & live_l[:, None]
                    cview = torch.where(live_l[:, None],
                                        torch.full_like(cview, c), cview)
                else:
                    cview = torch.full_like(cview, c)
            elif cfg.model == "ssp":
                delivered = torch.zeros((Pl, P), dtype=torch.bool,
                                        device=dev)
            else:  # essp / async / vap: delay-driven eager delivery
                delivered = delivery_matrix(k_net, cfg, P,
                                            rates)[rows0:rows0 + Pl]
                if sched is not None:
                    delivered = delivered & live_l[:, None]
                if wired:
                    tgt = _xpod_target(cst, in_pod, c,
                                       comm.shipped_end(c, cfg.agg_clocks),
                                       flt is not None)
                    cview = torch.where(delivered,
                                        torch.maximum(cview, tgt), cview)
                else:
                    cview = torch.where(delivered, c, cview)

            # --- 6. record (gathered, so the losses are the simulator's)
            x_ref = full_cols(_x_ref(_folded(base, cst, wired), uring,
                                     uclock))                  # [d]
            locals_all = sh.gather_tree(local, sh.workers, 0)
            view0 = (views[0].clone() if sh.di == 0 else
                     torch.empty((d,), dtype=f32, device=dev))
            dist.broadcast(view0, src=sh.worker0, group=sh.workers)
            rec["loss_ref"].append(app.loss(x_ref, locals_all))
            rec["loss_view"].append(app.loss(view0, locals_all))
            rec["staleness"].append(staleness)
            rec["forced"].append(forced)
            rec["delivered"].append(delivered)
            rec["u_l2"].append(u_l2)
            rec["intransit_inf"].append(intransit_l)
            rec["ship_floats"].append(ship_floats)
            rec["live"].append(live_now)
            if record_views:
                rec["views0"].append(view0)
            if obs_enabled:
                # the rank's reader rows only; folded once after the run
                oacc = obsm.device_update(
                    oacc, staleness=staleness, forced=forced,
                    delivered=delivered, ship_floats=ship_floats,
                    live=live_now,
                    live_rows=live_l if live_l is not None
                    else all_live[:Pl], in_pod=in_pod)

        def stacked(k, shape, dtype):
            if rec[k]:
                return torch.stack(rec[k])
            return torch.empty((0,) + shape, dtype=dtype, device=dev)

        def rows_gathered(k, dtype):
            return sh.gather(stacked(k, (Pl, P), dtype), sh.workers, 1)

        x_final = full_cols(_x_ref(_folded(base, cst, wired), uring, uclock))
        trace = Trace(
            loss_ref=stacked("loss_ref", (), f32),
            loss_view=stacked("loss_view", (), f32),
            staleness=rows_gathered("staleness", i32),
            forced=rows_gathered("forced", torch.bool),
            delivered=rows_gathered("delivered", torch.bool),
            u_l2=stacked("u_l2", (P,), f32),
            intransit_inf=(sh.max_bits(stacked("intransit_inf", (), f32),
                                       sh.workers) if n_clocks else
                           stacked("intransit_inf", (), f32)),
            ship_floats=stacked("ship_floats", (P,), f32),
            live=stacked("live", (P,), torch.bool),
            views0=stacked("views0", (d,), f32) if record_views else None,
            x_final=x_final,
            locals_final=sh.gather_tree(local, sh.workers, 0),
            obs=obsm.device_reduce(oacc, sh.workers) if obs_enabled
            else None)

        def whole(t):                          # [..., dl] -> [..., dpad]
            return sh.gather(t, sh.model, t.dim() - 1)

        new_comm = None
        if wired:
            new_comm = {k: (whole(v) if k in ("acc", "res", "xring",
                                              "base_pod", "xbase_pod",
                                              "pend") else v)
                        for k, v in cst.items()}
        new_state = PSState(
            clock=c0 + n_clocks, base=whole(base), uring=whole(uring),
            uclock=uclock, cview=sh.gather(cview, sh.workers, 0),
            local=trace.locals_final, rng=rng, comm=new_comm)
        return trace, new_state

    def init_state(seed) -> PSState:
        """Clock-0 state for ``seed`` (the simulator's initial conditions,
        in the runtime's padded layout)."""
        cst = None
        if wired:
            cst = comm.init_state(W, P, dpad, G, dev)
            if faulted:
                cst.update(wire.init_wire_state(P, dpad, dev))
        return PSState(
            clock=0, base=F.pad(app.x0.to(f32), (0, dpad - d)),
            uring=torch.zeros((W, P, dpad), dtype=f32, device=dev),
            uclock=torch.full((W,), RING_EMPTY, dtype=i32, device=dev),
            cview=torch.full((P, P), -1, dtype=i32, device=dev),
            local=app.local0, rng=jrng.PRNGKey(seed, dev), comm=cst)

    def _norm_cfg(cfg_run: ConsistencyConfig | None) -> ConsistencyConfig:
        c = cfg if cfg_run is None else cfg_run
        if c.effective_window != W:
            raise ValueError(
                f"runtime built for ring window {W}, got "
                f"{c.effective_window}; set cfg.window explicitly or build "
                f"a new run fn")
        if c.comm_active != wired or (wired and c.quant != quant0):
            raise ValueError(
                f"runtime built with comm_active={wired} "
                f"(quant={quant0!r}); got comm_active={c.comm_active} "
                f"(quant={c.quant!r}) — build a new run fn for a "
                f"different comm structure")
        return c

    def _norm_sched(sched):
        s = schedule if sched is None else sched
        if (s is not None) != churned:
            raise ValueError(
                f"runtime built with churn={'on' if churned else 'off'}; "
                f"build a new run fn to change the churn structure")
        if s is not None and s.live.shape[1] != P:
            raise ValueError(f"schedule has {s.live.shape[1]} workers, "
                             f"app has {P}")
        return s

    def _norm_faults(flt):
        f = faults if flt is None else flt
        if (f is not None) != faulted:
            raise ValueError(
                f"runtime built with faults="
                f"{'on' if faulted else 'off'}; build a new run fn to "
                f"change the fault structure")
        if f is not None and wire.faults_key(f) != wire.faults_key(faults):
            raise ValueError(
                f"runtime built with ARQ knobs "
                f"{wire.faults_key(faults)}, got {wire.faults_key(f)}; "
                f"build a new run fn")
        return f

    def run_from(state: PSState, cfg_run: ConsistencyConfig | None = None,
                 schedule: ChurnSchedule | None = None,
                 faults: wire.WireFaults | None = None):
        """Advance ``state`` by ``n_clocks``; returns ``(Trace, PSState)``.
        Bit-identical to running the clocks uninterrupted."""
        return run_from_local(state, _norm_cfg(cfg_run),
                              _norm_sched(schedule), _norm_faults(faults))

    def fn(seed, cfg_run: ConsistencyConfig | None = None,
           schedule: ChurnSchedule | None = None,
           faults: wire.WireFaults | None = None) -> Trace:
        return run_from(init_state(seed), cfg_run, schedule, faults)[0]

    fn.init_state = init_state
    fn.run_from = run_from
    return fn


class PSRuntime:
    """Executable sharded PS: ``PSRuntime(mesh).run(app, cfg, n_clocks)``,
    called by every rank of the mesh.

    Produces the same `core.ps.Trace` schema as ``core.ps.simulate`` (the
    Trace-producer contract: identical fields, leading clock axis, same
    key stream), run over the mesh, every rank returning the whole trace.
    ``PSRuntime()`` with no mesh builds ``make_ps_mesh`` over the world,
    making a world of one rank on ``device`` (default: this rank's card,
    NCCL; ``device="cpu"``: gloo) when no process group exists.

    ``init_state`` / ``run_from`` expose the mid-run `PSState`:
    ``run_from`` resumed from a saved state reproduces the uninterrupted
    trace bit for bit, with or without a churn schedule (schedules index
    by absolute clock; see `pods.elastic` for the pod-rejoin recipe).
    """

    worker_axes: tuple = ("data",)

    def __init__(self, mesh=None, device=None):
        self.mesh = self._default_mesh(device) if mesh is None else mesh

    def _default_mesh(self, device):
        return make_ps_mesh(device=device)

    def run_fn(self, app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
               record_views: bool = False,
               schedule: ChurnSchedule | None = None,
               obs: obsm.ObsSpec | None = None,
               faults: wire.WireFaults | None = None):
        """``fn(seed, cfg) -> Trace`` for this family (see `make_run_fn`)."""
        return make_run_fn(app, cfg, n_clocks, mesh=self.mesh,
                           record_views=record_views,
                           worker_axes=self.worker_axes, schedule=schedule,
                           obs=obs if obsm.obs_on(obs) else None,
                           faults=faults)

    def run(self, app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
            seed=0, record_views: bool = False,
            schedule: ChurnSchedule | None = None,
            obs: obsm.ObsSpec | None = None,
            faults: wire.WireFaults | None = None) -> Trace:
        """Run ``n_clocks`` of the app under ``cfg`` on the mesh."""
        return self.run_fn(app, cfg, n_clocks, record_views, schedule, obs,
                           faults)(seed, cfg, schedule, faults)

    def init_state(self, app: PSApp, cfg: ConsistencyConfig, seed=0,
                   n_clocks: int = 1,
                   faults: wire.WireFaults | None = None) -> PSState:
        """Clock-0 `PSState` (``n_clocks`` is accepted for the JAX
        package's signature)."""
        return self.run_fn(app, cfg, n_clocks,
                           faults=faults).init_state(seed)

    def run_from(self, app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
                 state: PSState, record_views: bool = False,
                 schedule: ChurnSchedule | None = None,
                 obs: obsm.ObsSpec | None = None,
                 faults: wire.WireFaults | None = None):
        """Advance ``state`` by ``n_clocks`` -> ``(Trace, PSState)``."""
        return self.run_fn(app, cfg, n_clocks, record_views, schedule, obs,
                           faults).run_from(state, cfg, schedule, faults)
