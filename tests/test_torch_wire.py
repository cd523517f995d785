"""The lossy wire in the port against the JAX package, on the CPU.

- ``make_faults`` builds the JAX package's masks (the same
  ``default_rng`` draws), and the budgets and window sizing agree.
- A faulted ``simulate`` (drop, duplicate, delay, a burst, ``heal=False``,
  ``max_retries=0``, with and without churn) on the quad app and the
  small MF app: integer Trace fields exact, floats within
  ``VAP_ULP_BUDGET`` ulp of field scale up to the first shipment whose
  rounding decisions differ (``test_torch_churn.assert_run_parity``).
- In the port itself ``no_faults`` is bit-equal to no faults.
- The f32 mass-conservation law of the JAX package's wire tests, on the
  port alone: ``acc + res + pend + xring`` equals the exact sum of each
  producer's updates under any fault mask, and ``heal=False`` loses
  exactly a positive amount, only when give-ups fired.
- The ARQ state after the last clock (sequence numbers, the in-flight
  lane, echoes, ``wire_tip``, the counters ``n_retx``, ``n_giveup``,
  ``n_duprej``) equals the JAX package's, read through an ordered
  callback on its ``wire.wire_step``.
- The ARQ counters move, retransmissions are charged into
  ``ship_floats``, conforming faults keep the widened staleness bound
  (and break the unwidened one), and ``validate_faults`` raises
  ``ValueError`` where JAX's does.
"""
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_churn import apps, assert_run_parity  # noqa: E402,F401

from repro.comm import wire as jw  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import delays as jd  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import delays as td  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

T = 14
SCENARIOS = {
    "drop": dict(seed=5, drop_rate=0.3),
    "dup": dict(seed=6, dup_rate=0.4),
    "delay": dict(seed=7, delay_rate=0.5, max_delay=2),
    "burst": dict(seed=8, drop_rate=0.15, bursts=((4, 8, 0.9),)),
    "no_heal": dict(seed=9, drop_rate=0.5, heal=False),
    "no_retry": dict(seed=10, drop_rate=0.3, max_retries=0),
    "heavy": dict(seed=5, drop_rate=0.35, dup_rate=0.25, delay_rate=0.3,
                  max_delay=1, max_retries=2, bursts=((6, 9, 0.9),)),
}
OUTAGES = ((2, 4, 9), (5, 7, 12))


def wired(m, quant="int8", topk=0.5, **kw):
    base = m.compressed(m.podded(m.essp(2), 2, s_xpod=1), agg_clocks=2,
                        topk_frac=topk, quant=quant)
    return base.replace(**kw) if kw else base


def sized(make_cfg, faults):
    """``make_cfg`` at the ring window the faults need."""
    W = tw.required_window(make_cfg(tc), faults)
    return lambda m: make_cfg(m).replace(window=W)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_make_faults_and_budgets_match_jax(name):
    kw = SCENARIOS[name]
    jf, tf = jw.make_faults(T, 8, **kw), tw.make_faults(T, 8, **kw)
    for f in ("drop", "dup", "delay"):
        np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                      np.asarray(getattr(jf, f)), f)
    for f in ("flight_budget", "retry_budget", "max_lifetime", "rto0",
              "max_retries", "max_delay", "heal"):
        assert getattr(tf, f) == getattr(jf, f), f
    assert tw.faults_key(tf) == jw.faults_key(jf)
    for make in (wired, lambda m: wired(m, agg_clocks=3, staleness=4)):
        assert tw.required_window(make(tc), tf) == \
            jw.required_window(make(jc), jf)


# the integer leaves of the ARQ state (the payload ``pend`` is a pack's
# output, held through the trace's floats)
ARQ_INT_KEYS = tuple(k for k in tw.WIRE_KEYS
                     if k not in ("pend", "pend_floats"))


@contextlib.contextmanager
def recorded_jax_wire():
    """Record the JAX package's ARQ state after each ``wire_step`` (an
    ordered callback); yields the list of per-clock dicts."""
    rec, step = [], jw.wire_step

    def recording(*args, **kw):
        st, floats = step(*args, **kw)
        leaves = {k: st[k] for k in ARQ_INT_KEYS}
        jax.debug.callback(lambda x: rec.append(
            {k: np.array(v) for k, v in x.items()}), leaves, ordered=True)
        return st, floats

    jw.wire_step = recording
    try:
        yield rec
    finally:
        jw.wire_step = step


@pytest.mark.parametrize("churn", [False, True], ids=["", "churn"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_faulted_simulate_matches_jax(apps, name, churn):
    japp, tapp = apps["quad"]
    kw = SCENARIOS[name]
    jf, tf = jw.make_faults(T, 8, **kw), tw.make_faults(T, 8, **kw)
    jkw, tkw = dict(faults=jf), dict(faults=tf)
    if churn:
        ch = dict(worker_outages=OUTAGES, drop_inflight=name == "heavy")
        jkw["schedule"] = jd.make_churn(T, 8, **ch)
        tkw["schedule"] = td.make_churn(T, 8, **ch)
    make = sized(wired, tf)
    with recorded_jax_wire() as jstates:
        _, got, _ = assert_run_parity(japp, tapp, make, T, seed=2, jkw=jkw,
                                      tkw=tkw)
    if churn:
        dead = ~got.live.numpy()
        assert (got.u_l2.numpy()[dead] == 0.0).all()
    assert len(jstates) == T
    _, cst = tps.simulate_with_state(tapp, make(tc), T, seed=2, **tkw)
    for k in ARQ_INT_KEYS:
        np.testing.assert_array_equal(cst[k].numpy(), jstates[-1][k],
                                      err_msg=k)


@pytest.mark.parametrize("churn", [False, True], ids=["", "churn"])
@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_faulted_mf_matches_jax(apps, quant, churn):
    japp, tapp = apps["mf"]
    P = japp.n_workers
    kw = SCENARIOS["burst"]
    jf, tf = jw.make_faults(T, P, **kw), tw.make_faults(T, P, **kw)
    jkw, tkw = dict(faults=jf), dict(faults=tf)
    if churn:
        ch = dict(worker_outages=((1, 3, 8),), drop_inflight=True)
        jkw["schedule"] = jd.make_churn(T, P, **ch)
        tkw["schedule"] = td.make_churn(T, P, **ch)
    topk = 1.0 if quant == "f32" else 0.5
    assert_run_parity(japp, tapp,
                      sized(lambda m: wired(m, quant, topk), tf), T, seed=2,
                      jkw=jkw, tkw=tkw)


@pytest.mark.parametrize(("quant", "topk"), [("f32", 1.0), ("int8", 0.5)])
def test_no_faults_bit_equal_in_port(apps, quant, topk):
    _, tapp = apps["quad"]
    cfg = wired(tc, quant, topk)
    nf = tw.no_faults(T, 8)
    assert nf.retry_budget == 0 and nf.flight_budget == 0
    want = tps.simulate(tapp, cfg, T, seed=2, record_views=True)
    got = tps.simulate(tapp, cfg, T, seed=2, record_views=True, faults=nf)
    for f in tval.TRACE_FIELDS + ("views0",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# mass conservation: acc + res + pend + xring == the exact update sum
# ---------------------------------------------------------------------------
def _one_hot_app(P, d, T):
    """Worker ``p`` adds exactly ``(p + 1) * T + c + 1`` at coordinate
    ``c`` at clock ``c``: disjoint supports, so any correct accounting is
    float-exact."""
    def worker_update(views, local, wids, clock, keys):
        u = torch.zeros((P, d), dtype=torch.float32)
        u[:, clock] = (wids.to(torch.float32) + 1.0) * T + (clock + 1.0)
        return u, local

    return convert.psapp_from_state(
        f"onehot{P}", np.zeros(d, np.float32), {"_": np.zeros((P, 1))},
        worker_update, lambda x, _l: x.sum(), device="cpu")


def _deficit(app, cfg, T, faults, seed=0):
    """``expected - (acc + res + pend + xring)`` per producer over the
    first ``T`` coordinates (no others are ever touched); and the final
    comm state."""
    _, cst = tps.simulate_with_state(app, cfg, T, seed=seed, faults=faults)
    total = (cst["acc"].double() + cst["res"].double()
             + cst["pend"].double() + cst["xring"].double().sum(0)).numpy()
    assert (total[:, T:] == 0.0).all()
    P = app.n_workers
    expected = np.array([[(p + 1) * T + c + 1 for c in range(T)]
                         for p in range(P)], np.float64)
    return expected - total[:, :T], cst


@pytest.mark.parametrize(("seed", "drop", "dup", "delayed"), [
    (0, 0.2, 0.0, False), (11, 0.5, 0.4, True), (123, 0.9, 0.0, True),
    (9_999, 0.5, 0.0, False), (77_777, 0.9, 0.4, False),
    (500_000, 0.2, 0.4, True)])
def test_mass_conservation_under_arbitrary_masks(seed, drop, dup, delayed):
    T, P = 10, 4
    app = _one_hot_app(P, 16, T)
    flt = tw.make_faults(T, P, seed=seed, drop_rate=drop, dup_rate=dup,
                         delay_rate=0.5 if delayed else 0.0,
                         max_delay=2 if delayed else 0, max_retries=2)
    cfg = wired(tc, "f32", 1.0)
    cfg = cfg.replace(window=tw.required_window(cfg, flt))
    assert T < cfg.window, "premise: nothing may fold out of the ring"
    deficit, _ = _deficit(app, cfg, T, flt, seed=seed % 7)
    assert (deficit == 0.0).all(), deficit


def test_heal_false_loses_exactly_the_given_up_mass():
    T, P = 10, 4
    app = _one_hot_app(P, 16, T)
    lossy = tw.make_faults(T, P, seed=3, drop_rate=0.95, max_retries=1,
                           heal=False)
    cfg = wired(tc, "f32", 1.0)
    cfg = cfg.replace(window=tw.required_window(cfg, lossy))
    deficit, cst = _deficit(app, cfg, T, lossy)
    assert int(cst["n_giveup"].sum()) > 0
    assert (deficit >= 0.0).all() and (deficit > 0.0).any()
    healed, _ = _deficit(app, cfg, T, tw.make_faults(
        T, P, seed=3, drop_rate=0.95, max_retries=1, heal=True))
    assert (healed == 0.0).all()


# ---------------------------------------------------------------------------
# ARQ mechanics, the widened bound, the guards
# ---------------------------------------------------------------------------
def test_arq_counters_and_retransmit_charging(apps):
    _, tapp = apps["quad"]
    flt = tw.make_faults(T, 8, **SCENARIOS["heavy"])
    cfg = wired(tc)
    cfg = cfg.replace(window=tw.required_window(cfg, flt))
    tr, cst = tps.simulate_with_state(tapp, cfg, T, seed=2, faults=flt)
    assert int(cst["n_retx"].sum()) > 0
    assert int(cst["n_duprej"].sum()) > 0
    clean = tps.simulate(tapp, cfg, T, seed=2)
    assert float(tr.ship_floats.sum()) > float(clean.ship_floats.sum())


def test_conforming_faults_respect_widened_bound(apps):
    """Every even-clock transmission drops: each first attempt at an even
    boundary retransmits once, inside the flight budget, so the widened
    bound holds on the trace and the unwidened one does not."""
    _, tapp = apps["quad"]
    T, P = 16, 8
    drop = torch.zeros((T, P), dtype=torch.bool)
    drop[::2, :] = True
    flt = tw.WireFaults(drop=drop, dup=torch.zeros_like(drop),
                        delay=torch.zeros((T, P), dtype=torch.int32),
                        rto0=1, max_retries=2, max_delay=0)
    assert flt.retry_budget == 2 * flt.flight_budget
    cfg = wired(tc, agg_clocks=1, staleness=1, s_xpod=0)
    cfg = cfg.replace(window=tw.required_window(cfg, flt))
    tr = tps.simulate(tapp, cfg, T, seed=4, faults=flt)
    wide = tval.check_staleness_bound(tr, cfg,
                                      retry_budget=flt.retry_budget)
    assert wide["violations"] == 0, wide
    assert tval.check_staleness_bound(tr, cfg)["violations"] > 0


def test_validate_faults_guards_match_jax(apps):
    """The structure guards raise ``ValueError`` in both packages: faults
    off the comm substrate, masks of the wrong shape or worker count, bad
    ARQ knobs, a window below ``required_window``."""
    japp, tapp = apps["quad"]
    kw = SCENARIOS["heavy"]
    jf, tf = jw.make_faults(T, 8, **kw), tw.make_faults(T, 8, **kw)
    need = tw.required_window(wired(tc), tf)
    assert need == jw.required_window(wired(jc), jf)
    bad = [
        (lambda m: m.essp(2), lambda w: w.make_faults(T, 8, **kw)),
        (lambda m: wired(m).replace(window=need - 1),
         lambda w: w.make_faults(T, 8, **kw)),
        (lambda m: wired(m).replace(window=need),
         lambda w: w.no_faults(T, 9)),
        (lambda m: wired(m).replace(window=need),
         lambda w: w.make_faults(T, 8, seed=1, rto0=0)),
        (lambda m: wired(m).replace(window=4),
         lambda w: w.make_faults(T, 8, seed=1, max_retries=3)),
    ]
    for make_cfg, make_faults in bad:
        with pytest.raises(ValueError):
            jps.simulate(japp, make_cfg(jc), 2, faults=make_faults(jw))
        with pytest.raises(ValueError):
            tps.simulate(tapp, make_cfg(tc), 2, faults=make_faults(tw))
    ragged = tw.WireFaults(drop=tf.drop, dup=tf.dup[:, :4], delay=tf.delay)
    with pytest.raises(ValueError, match="disagree"):
        tw.validate_faults(ragged, wired(tc), 8, need)
    jragged = jw.WireFaults(drop=jf.drop, dup=jf.dup[:, :4], delay=jf.delay)
    with pytest.raises(ValueError, match="disagree"):
        jw.validate_faults(jragged, wired(jc), 8, need)


def test_wire_state_layout_matches_jax():
    t, j = tw.init_wire_state(3, 5), jw.init_wire_state(3, 5)
    assert tw.WIRE_KEYS == jw.WIRE_KEYS
    for k in tw.WIRE_KEYS:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), k)
    keep = torch.tensor([True, False, True])
    moved = {k: v + 1 if v.dtype != torch.bool else ~v for k, v in t.items()}
    got = tw.drop_pending(moved, keep)
    want = jw.drop_pending({k: jnp.asarray(v.numpy())
                            for k, v in moved.items()},
                           jnp.asarray(keep.numpy()))
    for k in tw.WIRE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      k)
