"""Lossy-wire fault injection and ack/retransmit ARQ for the comm substrate.

The port of ``repro/comm/wire.py``.  Shipments can be dropped, duplicated
or delayed per a seeded :class:`WireFaults` schedule, and the substrate
answers with a stop-and-wait ARQ: sequence numbers, idempotent
dedup-on-fold, and ack-driven retransmission with exponential backoff.
A neutral schedule (:func:`no_faults`) is bit-equal to no schedule.

Protocol, per producer, each clock (:func:`wire_step`):

- **ship**: at an aggregation boundary an *idle* producer packs its delta
  into a pending shipment ``pend`` tagged with the next sequence number,
  and transmits; a *busy* one (previous shipment unacked) skips the
  boundary and keeps accumulating.
- **transmit**: an attempt at clock ``t`` is dropped iff ``drop[t, p]``;
  otherwise it takes the single in-flight lane, arriving at ``t +
  delay[t, p]`` (0: the same clock, the lossless wire's timing) and
  superseding an older copy; ``dup[t, p]`` makes its arrival echo one
  clock later.
- **fold (ack)**: an arrival folds into the wire ring iff its sequence
  number matches the pending shipment and exceeds ``recv_seq``; folding
  acks the shipment and advances ``wire_tip``, the highest producer clock
  that has arrived.  Echoes fail the guard and tick ``n_duprej``.
- **retransmit**: an unacked shipment retransmits when ``c >= retry_at``
  (backoff ``rto0 * 2^(attempts-1)``), at most ``max_retries`` times;
  every attempt is charged into ``Trace.ship_floats``.
- **give-up (self-healing)**: once the ladder has run out with nothing in
  flight, the pending mass folds back into the error-feedback residual
  ``res`` (exact for f32 shipments, whose ``res`` and ``pend`` have
  disjoint supports), or is discarded with ``heal=False``.

Cross-pod visibility is capped by ``wire_tip``; under conforming faults
the staleness bound widens by ``retry_budget = 2 * flight_budget``.
Faulted runs need ``W >= required_window(cfg, faults)``
(:func:`validate_faults`).

What changed in the port: the masks are torch tensors on the run's
device (built in numpy with the JAX package's ``default_rng`` draws, then
copied once), the clock is a Python int, and every per-producer decision
is a tensor operation (no ``.item()``, no Python branch on device state),
so a faulted clock makes the host wait for nothing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# retry_at sentinel for "no retry scheduled": `c >= retry_at` never fires
_NEVER = 2 ** 30

# The per-clock functions (``repro_torch.analysis``'s clock-step scope: no
# host sync may run in them or in what they call).
CLOCK_STEP = ("wire_step", "drop_pending", "idle")


@dataclass(frozen=True)
class WireFaults:
    """Per-clock, per-producer wire faults, indexed by absolute clock.

    ``drop[t, p]`` drops any transmission producer ``p`` makes at clock
    ``t``; ``dup[t, p]`` duplicates it; ``delay[t, p]`` clocks of delivery
    delay.  Clocks past the horizon clamp to the last row.  The ARQ knobs
    (``rto0``, ``max_retries``, ``max_delay``, ``heal``) shape the
    staleness contract and the give-up condition.
    """

    drop: torch.Tensor              # [T, P] bool: transmission dropped
    dup: torch.Tensor               # [T, P] bool: transmission duplicated
    delay: torch.Tensor             # [T, P] int32 delivery delay in clocks
    rto0: int = 1
    max_retries: int = 0
    max_delay: int = 0
    heal: bool = True

    @property
    def n_clocks(self) -> int:
        return self.drop.shape[0]

    @property
    def n_workers(self) -> int:
        return self.drop.shape[1]

    @property
    def flight_budget(self) -> int:
        """Max clocks a conforming shipment stays unacked: the last retry
        at ``rto0 * (2^max_retries - 1)`` past the ship clock, plus its
        delivery delay."""
        return self.rto0 * (2 ** self.max_retries - 1) + self.max_delay

    @property
    def retry_budget(self) -> int:
        """Clocks the cross-pod staleness bound widens by: two conforming
        flight windows stack under stop-and-wait (0 when neutral)."""
        return 2 * self.flight_budget

    @property
    def max_lifetime(self) -> int:
        """Max clocks from ship to resolution (ack or give-up)."""
        return max(self.rto0 * (2 ** (self.max_retries + 1) - 1),
                   self.flight_budget)

    def to(self, device) -> "WireFaults":
        """The same schedule with its masks on ``device``."""
        return WireFaults(drop=self.drop.to(device), dup=self.dup.to(device),
                          delay=self.delay.to(device), rto0=self.rto0,
                          max_retries=self.max_retries,
                          max_delay=self.max_delay, heal=self.heal)


def no_faults(n_clocks: int, P: int, device=None) -> WireFaults:
    """The neutral schedule: nothing drops, duplicates or delays, and a
    zero retry budget; bit-equal to running with no ``faults``."""
    z = torch.zeros((n_clocks, P), dtype=torch.bool, device=device)
    return WireFaults(drop=z, dup=z.clone(),
                      delay=torch.zeros((n_clocks, P), dtype=torch.int32,
                                        device=device))


def make_faults(n_clocks: int, P: int, *, seed: int = 0,
                drop_rate: float = 0.0, dup_rate: float = 0.0,
                delay_rate: float = 0.0, max_delay: int = 0,
                bursts=(), rto0: int = 1, max_retries: int = 3,
                heal: bool = True, device=None) -> WireFaults:
    """A seeded `WireFaults` from scenario primitives: the JAX package's
    ``numpy.random.default_rng(seed)`` draws in its order, so the masks
    are its masks.

    - ``drop_rate`` / ``dup_rate``: i.i.d. per-(clock, producer) rates;
    - ``delay_rate`` + ``max_delay``: a transmission delayed uniformly in
      ``[1, max_delay]`` clocks with probability ``delay_rate``;
    - ``bursts``: ``(t0, t1, rate)``, the drop rate overridden on
      ``[t0, t1)``;
    - ``rto0`` / ``max_retries``: the backoff ladder;
    - ``heal=False``: given-up mass is discarded, not re-shipped.
    """
    rng = np.random.default_rng(seed)
    p_drop = np.full((n_clocks, P), float(drop_rate))
    for t0, t1, rate in bursts:
        p_drop[t0:t1, :] = float(rate)
    drop = rng.random((n_clocks, P)) < p_drop
    dup = rng.random((n_clocks, P)) < float(dup_rate)
    delay = np.zeros((n_clocks, P), np.int32)
    if max_delay > 0 and delay_rate > 0.0:
        delayed = rng.random((n_clocks, P)) < float(delay_rate)
        delay = np.where(delayed,
                         rng.integers(1, max_delay + 1, (n_clocks, P)),
                         0).astype(np.int32)
    on = lambda a: torch.from_numpy(a).to(device)
    return WireFaults(drop=on(drop), dup=on(dup), delay=on(delay),
                      rto0=int(rto0), max_retries=int(max_retries),
                      max_delay=int(max_delay), heal=bool(heal))


def faults_key(faults: WireFaults | None):
    """The fault structure a run is specialized on: presence plus the ARQ
    knobs (the JAX package compiles per key; the port keeps the key for
    callers that group runs by it)."""
    if faults is None:
        return None
    return (faults.rto0, faults.max_retries, faults.max_delay, faults.heal)


def required_window(cfg, faults: WireFaults) -> int:
    """Minimum ring window for a faulted run: the lossless requirement
    ``s + s_xpod + (agg_clocks - 1) + 2`` plus the retry budget, and at
    least ``max_lifetime + 1`` (arrivals land before their slot
    recycles)."""
    base = (int(cfg.staleness) + int(cfg.s_xpod) + (int(cfg.agg_clocks) - 1)
            + faults.retry_budget + 2)
    return max(base, faults.max_lifetime + 1)


def validate_faults(faults: WireFaults, cfg, P: int, W: int):
    """Raise ``ValueError`` unless ``faults`` is well-formed for this
    (cfg, P, W)."""
    if not cfg.comm_active:
        raise ValueError(
            "WireFaults model the compressed cross-pod wire; they require "
            "cfg.comm_active (ssp/essp/async with n_pods >= 2 — see "
            "consistency.compressed)")
    if faults.drop.shape != faults.dup.shape or \
            faults.drop.shape != faults.delay.shape:
        raise ValueError(
            f"fault masks disagree: drop {tuple(faults.drop.shape)}, dup "
            f"{tuple(faults.dup.shape)}, delay {tuple(faults.delay.shape)}")
    if faults.n_workers != P:
        raise ValueError(f"faults cover {faults.n_workers} producers, "
                         f"app has {P}")
    if faults.rto0 < 1 or faults.max_retries < 0 or faults.max_delay < 0:
        raise ValueError(
            f"need rto0 >= 1, max_retries >= 0, max_delay >= 0; got "
            f"({faults.rto0}, {faults.max_retries}, {faults.max_delay})")
    if faults.max_lifetime > W - 1:
        raise ValueError(
            f"a pending shipment can outlive its ring slot: max_lifetime="
            f"{faults.max_lifetime} > window - 1 = {W - 1}; set "
            f"cfg.window >= wire.required_window(cfg, faults)")
    req = required_window(cfg, faults)
    if W < req:
        raise ValueError(
            f"ring window {W} too small for the faulted staleness "
            f"contract (retry_budget={faults.retry_budget}): need "
            f"W >= {req}; set cfg.window = wire.required_window(cfg, "
            f"faults)")


# ----------------------------------------------------------- wire state


def init_wire_state(P: int, dcols: int, device=None) -> dict:
    """Zero ARQ state, merged into the substrate's comm dict.

    ``pend [P, dcols]`` the pending (unacked) shipment, with
    ``pend_clock``, ``pend_seq``, ``pend_floats`` (its boundary clock,
    sequence number and bits-weighted floats), ``attempts`` and
    ``retry_at``; ``arr_at``/``arr_seq``/``arr_dup`` the in-flight lane
    (arrival clock, -1 when empty); ``echo_at``/``echo_seq`` a pending
    duplicate echo; ``recv_seq`` the dedup guard, ``wire_tip`` the highest
    arrived producer clock, ``seq_next``; counters ``n_retx``,
    ``n_giveup``, ``n_duprej``.
    """
    i32, f32 = torch.int32, torch.float32

    def full(v, dtype=i32):
        return torch.full((P,), v, dtype=dtype, device=device)

    return dict(
        pend=torch.zeros((P, dcols), dtype=f32, device=device),
        pend_clock=full(-1), pend_seq=full(0), pend_floats=full(0.0, f32),
        attempts=full(0), retry_at=full(_NEVER),
        arr_at=full(-1), arr_seq=full(0), arr_dup=full(False, torch.bool),
        echo_at=full(-1), echo_seq=full(0),
        recv_seq=full(0), wire_tip=full(-1), seq_next=full(1),
        n_retx=full(0), n_giveup=full(0), n_duprej=full(0))


WIRE_KEYS = tuple(init_wire_state(1, 1).keys())


def idle(cst: dict) -> torch.Tensor:
    """[P] bool: producers with no unacked shipment (free to ship)."""
    return cst["pend_clock"] < 0


def drop_pending(cst: dict, keep) -> dict:
    """Drop-in-flight churn policy for the wire: a dying producer's pending
    shipment, in-flight copy and echo vanish with it; receiver-side state
    (``recv_seq``, ``wire_tip``, ``seq_next``) survives."""
    kb = keep[:, None]
    return dict(cst,
                pend=torch.where(kb, cst["pend"], 0.0),
                pend_clock=torch.where(keep, cst["pend_clock"], -1),
                pend_seq=torch.where(keep, cst["pend_seq"], 0),
                pend_floats=torch.where(keep, cst["pend_floats"], 0.0),
                attempts=torch.where(keep, cst["attempts"], 0),
                retry_at=torch.where(keep, cst["retry_at"], _NEVER),
                arr_at=torch.where(keep, cst["arr_at"], -1),
                arr_seq=torch.where(keep, cst["arr_seq"], 0),
                arr_dup=cst["arr_dup"] & keep,
                echo_at=torch.where(keep, cst["echo_at"], -1),
                echo_seq=torch.where(keep, cst["echo_seq"], 0))


# ------------------------------------------------------------- wire step


def _arrive(cst: dict, c: int) -> dict:
    """Process due arrivals (in-flight copies with ``arr_at <= c``, and
    duplicate echoes) through the fold guard; ack what folds."""
    pend, pclk = cst["pend"], cst["pend_clock"]
    pseq, recv = cst["pend_seq"], cst["recv_seq"]
    lane = cst["arr_at"]
    due = (lane >= 0) & (lane <= c)
    # fold guard: the copy's seq must match the pending shipment and
    # exceed recv_seq; a stale or duplicate copy is never re-folded
    fresh = due & (cst["arr_seq"] == pseq) & (pseq > recv) & (pclk >= 0)
    xring = cst["xring"]
    W, P = xring.shape[0], pend.shape[0]
    rows = torch.arange(P, device=pend.device)
    slots = torch.where(fresh, torch.remainder(pclk, W), 0).long()
    xring[slots, rows] = torch.where(fresh[:, None], pend,
                                     xring[slots, rows])
    # duplicate copies echo one clock after the original arrival; the
    # echo re-runs the guard (seq <= recv_seq by then: rejected)
    dup_new = fresh & cst["arr_dup"]
    echo_due = (cst["echo_at"] >= 0) & (cst["echo_at"] <= c)
    echo_rej = echo_due & ~((cst["echo_seq"] == pseq)
                            & (cst["echo_seq"] > recv))
    echo_at = torch.where(echo_due, -1, cst["echo_at"])
    echo_at = torch.where(dup_new, c + 1, echo_at)
    echo_seq = torch.where(dup_new, pseq, cst["echo_seq"])
    return dict(
        cst, xring=xring,
        recv_seq=torch.where(fresh, pseq, recv),
        wire_tip=torch.where(fresh, pclk, cst["wire_tip"]),
        pend=torch.where(fresh[:, None], 0.0, pend),
        pend_clock=torch.where(fresh, -1, pclk),
        pend_seq=torch.where(fresh, 0, pseq),
        pend_floats=torch.where(fresh, 0.0, cst["pend_floats"]),
        attempts=torch.where(fresh, 0, cst["attempts"]),
        retry_at=torch.where(fresh, _NEVER, cst["retry_at"]),
        arr_at=torch.where(due, -1, lane),
        echo_at=echo_at, echo_seq=echo_seq,
        n_duprej=cst["n_duprej"] + echo_rej.to(torch.int32))


def wire_step(cst: dict, wire_u, floats, ship, c: int, faults: WireFaults,
              live=None):
    """One clock of the faulted wire (the simulator's section 4b tail).

    ``cst`` holds the comm state with the :func:`init_wire_state` entries
    and this clock's ``acc``/``res``/``xring`` already updated under the
    ``ship`` mask (boundary x liveness x :func:`idle`).  ``wire_u [P, d]``
    and ``floats [P]`` are this clock's packed shipment and its floats,
    or ``None`` on a clock that is no boundary (``ship`` then all False);
    ``live`` (``[P]`` bool or None) gates transmissions under churn: a
    dead producer neither retransmits nor gives up.

    Returns ``(cst', ship_floats[P])``: every transmission made this clock
    (first attempts and retries) charged at its shipment's floats.
    """
    i32 = torch.int32
    T = faults.drop.shape[0]
    t = min(max(c, 0), T - 1)
    drop_r, dup_r, delay_r = faults.drop[t], faults.dup[t], faults.delay[t]

    # (a) arrivals due from earlier clocks (delayed copies, echoes)
    st = _arrive(cst, c)
    tx_ok = torch.ones_like(st["arr_dup"]) if live is None else live

    # (b) give-up: the backoff ladder ran out with nothing in flight, so
    # every attempt was dropped; the mass folds back into the residual
    # (disjoint support: exact in f32), or is discarded with heal=False
    busy = st["pend_clock"] >= 0
    gup = (busy & tx_ok & (st["retry_at"] <= c)
           & (st["attempts"] > faults.max_retries) & (st["arr_at"] < 0))
    res = st["res"]
    if faults.heal:
        res = res + torch.where(gup[:, None], st["pend"], 0.0)
    pend = torch.where(gup[:, None], 0.0, st["pend"])
    pclk = torch.where(gup, -1, st["pend_clock"])
    pseq = torch.where(gup, 0, st["pend_seq"])
    pfl = torch.where(gup, 0.0, st["pend_floats"])
    att = torch.where(gup, 0, st["attempts"])
    rat = torch.where(gup, _NEVER, st["retry_at"])

    # (c) retransmission due (backoff expired, retries left)
    rtx = (pclk >= 0) & tx_ok & (rat <= c) & (att <= faults.max_retries)

    # (d) new shipments (the caller's ship mask, off start-of-clock
    # idleness)
    seq_next = st["seq_next"]
    if wire_u is not None:
        new = ship
        pend = torch.where(new[:, None], wire_u, pend)
        pclk = torch.where(new, c, pclk)
        pseq = torch.where(new, seq_next, pseq)
        seq_next = torch.where(new, seq_next + 1, seq_next)
        pfl = torch.where(new, floats, pfl)
        att = torch.where(new, 0, att)
        tx = new | rtx
    else:
        tx = rtx

    # (e) transmit through this clock's fault row: dropped copies vanish,
    # surviving copies take the in-flight lane (newest wins) arriving at
    # c + delay; dup-tagged copies will echo
    att = att + tx.to(i32)
    backoff = faults.rto0 * torch.bitwise_left_shift(
        torch.ones_like(att), torch.clamp(att - 1, min=0))
    rat = torch.where(tx, c + backoff, rat)
    sent = tx & ~drop_r
    arr_at = torch.where(sent, c + delay_r, st["arr_at"])
    arr_seq = torch.where(sent, pseq, st["arr_seq"])
    arr_dup = torch.where(sent, dup_r, st["arr_dup"])
    ship_floats = torch.where(tx, pfl, 0.0)

    st = dict(st, res=res, pend=pend, pend_clock=pclk, pend_seq=pseq,
              pend_floats=pfl, attempts=att, retry_at=rat,
              seq_next=seq_next, arr_at=arr_at, arr_seq=arr_seq,
              arr_dup=arr_dup,
              n_retx=st["n_retx"] + rtx.to(i32),
              n_giveup=st["n_giveup"] + gup.to(i32))

    # (f) instant (delay-0) arrivals land this clock: the lossless wire's
    # timing, which keeps a neutral schedule bit-equal to no faults
    st = _arrive(st, c)
    return st, ship_floats
