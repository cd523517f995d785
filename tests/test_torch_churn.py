"""Fleet churn in the port against the JAX package, on the CPU.

Both simulators start from the same state and seed under the same
`ChurnSchedule` (worker outages, a pod outage, ``drop_inflight`` both
ways, a straggler-regime shift), on the quad app (8 workers) and the small
MF app of ``test_torch_ps.py``, dense and under the comm substrate:

- the integer Trace fields (``staleness``, ``forced``, ``delivered``,
  ``live``) are equal, so are ``ship_floats``;
- the float fields are within ``VAP_ULP_BUDGET`` (128) ulp of each
  field's scale.  ``x_final`` sums ``x0`` with every update and on the
  quad app cancels toward 0, so its drift is stated in ulp of the scale
  of ``x0``, the scale its additions ran at.  An int8 or bf16 wire value
  is a rounding decision: where a shipment's quantized levels or top-k
  selection differ between the two runs (the delta drifted by at most
  the budget: checked), the floats are held up to that shipment's clock
  (:func:`assert_run_parity`), as ``chip_smoke.py`` holds card against
  CPU.  A tighter bound holds in practice: on the churn, wire and obs
  runs the drift stays within 3 ulp (``x_final`` within 5 of ``x0``'s
  scale), integer fields and ``ship_floats`` exact;
- in the port itself ``no_churn`` is bit-equal to no schedule;
- ``outage_windows``, ``score_detections``, ``churn_rates`` and the time
  model's ``bw_scale`` equal JAX's, and a schedule of the wrong worker
  count raises ``ValueError`` as JAX's does.
"""
import contextlib
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_ps import MF_CFG, _quad_jax, _quad_torch  # noqa: E402

from repro.apps import matfact as jmf  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import delays as jd  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro.core import timemodel as jtm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import matfact as tmf  # noqa: E402
from repro_torch.comm import substrate as tsub  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import delays as td  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.core import timemodel as ttm  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

T = 14
OUTAGES = ((2, 4, 9), (5, 7, 12))        # (worker, down from, up at)
MF_OUTAGES = ((1, 3, 8), (2, 6, 11))
BUDGET = tval.VAP_ULP_BUDGET


def wired(m):
    return m.compressed(m.podded(m.essp(2), 2, s_xpod=3, t_net_xpod=6.0),
                        agg_clocks=2, topk_frac=0.5, quant="int8")


CONFIGS = {
    "bsp": lambda m: m.bsp(),
    "ssp2": lambda m: m.ssp(2),
    "essp2": lambda m: m.essp(2),
    "async": lambda m: m.ConsistencyConfig(model="async"),
    "vap": lambda m: m.vap(0.5, staleness=4),
    "essp2_2pod": lambda m: m.podded(m.essp(2), 2, s_xpod=2,
                                     t_net_xpod=4.0),
    "wired_int8": wired,
}


@pytest.fixture(scope="module")
def apps():
    jquad = _quad_jax(P=8)
    jmfapp = jmf.make_mf_app(jmf.MFConfig(**MF_CFG))
    tmfapp = convert.mf_app_from_state(
        tmf.MFConfig(**MF_CFG), np.asarray(jmfapp.x0),
        {k: np.asarray(v) for k, v in jmfapp.local0.items()}, device="cpu")
    return {"quad": (jquad, _quad_torch(jquad)), "mf": (jmfapp, tmfapp)}


# ---------------------------------------------------------------------------
# the parity helper the churn, wire and obs tests share
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def recorded_shipments():
    """Record each pack of both simulators: the JAX package's through an
    ordered callback on ``ops.delta_pack`` (it packs every clock), the
    port's through ``substrate.pack`` (boundary clocks only).  Yields
    ``(jax_packs, port_packs)``, lists of ``(delta, wire)`` numpy pairs."""
    jrec, trec = [], []
    jpack, tpack = jps.ops.delta_pack, tsub.pack

    def jrecording(delta, thresh, scale, quant="f32"):
        out = jpack(delta, thresh, scale, quant)
        jax.debug.callback(lambda d, w: jrec.append((np.array(d),
                                                     np.array(w))),
                           delta, out[0], ordered=True)
        return out

    def trecording(delta, topk_frac, quant):
        out = tpack(delta, topk_frac, quant)
        trec.append((delta.detach().cpu().numpy().copy(),
                     out[0].detach().cpu().numpy().copy()))
        return out

    jps.ops.delta_pack, tsub.pack = jrecording, trecording
    try:
        yield jrec, trec
    finally:
        jps.ops.delta_pack, tsub.pack = jpack, tpack


def _levels(delta, wire, cfg):
    """The rounding decisions of one pack: the top-k selection and, for
    int8 and bf16, the quantized values."""
    d = torch.from_numpy(delta)
    sel = (d.abs() >= tsub.row_threshold(d, cfg.topk_frac)[:, None]).numpy()
    if cfg.quant == "int8":
        scale = tsub.quant_scale(d, "int8").numpy()[:, None]
        return sel, np.rint(wire / scale)
    return sel, (wire if cfg.quant == "bf16" else None)


def first_level_flip(jpacks, tpacks, cfg):
    """The first boundary clock whose shipment's rounding decisions differ
    between the runs, or None.  The pack is bit-equal on equal inputs
    (``test_torch_comm.py``), so a flip needs a drifted delta: the drift
    must be within the budget (ulp of the delta's scale)."""
    agg = cfg.agg_clocks
    boundary = [jpacks[c] for c in range(len(jpacks)) if (c + 1) % agg == 0]
    assert len(boundary) == len(tpacks), (len(boundary), len(tpacks))
    for i, ((dj, wj), (dt, wt)) in enumerate(zip(boundary, tpacks,
                                                 strict=True)):
        lj, lt = _levels(dj, wj, cfg), _levels(dt, wt, cfg)
        if all(a is None or np.array_equal(a, b)
               for a, b in zip(lj, lt, strict=True)):
            continue
        spacing = np.spacing(np.float32(np.abs(dj).max()))
        drift = float(np.abs(dj.astype(np.float64) - dt).max() / spacing)
        assert drift <= BUDGET, f"shipment {i}: a flip from {drift} ulp"
        return (i + 1) * agg - 1
    return None


def _host(x):
    return tval._np(x)


def _x_final_ulp(got, want, x0):
    scale = np.float32(max(np.abs(_host(x0)).max(),
                           np.abs(_host(want.x_final)).max()))
    return float(np.abs(_host(got.x_final).astype(np.float64)
                        - np.asarray(want.x_final)).max()
                 / np.spacing(scale))


def assert_run_parity(japp, tapp, make_cfg, n_clocks, seed=3, jkw=None,
                      tkw=None):
    """Run both simulators and hold the port to the JAX package (see the
    module doc).  Returns ``(jax_trace, port_trace, flip_clock)``."""
    jcfg, tcfg = make_cfg(jc), make_cfg(tc)
    with recorded_shipments() as (jpacks, tpacks):
        want = jps.simulate(japp, jcfg, n_clocks, seed=seed, **(jkw or {}))
        jax.effects_barrier()
        got = tps.simulate(tapp, tcfg, n_clocks, seed=seed, **(tkw or {}))
    for f in tval.INT_FIELDS:
        np.testing.assert_array_equal(_host(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    flip = first_level_flip(jpacks, tpacks, tcfg) if tcfg.comm_active \
        else None
    last = n_clocks - 1 if flip is None else flip
    # a flipped selection moves that shipment's count: exact before it
    upto = n_clocks if flip is None else flip
    np.testing.assert_array_equal(_host(got.ship_floats)[:upto],
                                  np.asarray(want.ship_floats)[:upto])
    ulps = tval.trace_max_ulp(_head(got, last), _head(want, last))
    ulps["x_final"] = 0.0 if flip is not None else _x_final_ulp(
        got, want, tapp.x0)
    bad = {f: u for f, u in ulps.items() if u > BUDGET}
    assert not bad, (ulps, flip)
    return want, got, flip


def _head(trace, last):
    """The per-clock fields cut to clocks 0..``last``; ``x_final`` zeroed
    (it is checked apart, or not at all after a flip)."""
    out = {f: _host(getattr(trace, f))[:last + 1]
           for f in tval.TRACE_FIELDS if f != "x_final"}
    return types.SimpleNamespace(**out, x_final=np.zeros(1))


# ---------------------------------------------------------------------------
# churned simulate against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drop", [False, True], ids=["drain", "drop"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_churned_simulate_matches_jax(apps, cfg_name, drop):
    japp, tapp = apps["quad"]
    kw = dict(worker_outages=OUTAGES, drop_inflight=drop)
    _, got, _ = assert_run_parity(
        japp, tapp, CONFIGS[cfg_name], T,
        jkw=dict(schedule=jd.make_churn(T, 8, **kw)),
        tkw=dict(schedule=td.make_churn(T, 8, **kw)))
    live = got.live.numpy()
    np.testing.assert_array_equal(live, td.make_churn(T, 8, **kw).live)
    assert (got.u_l2.numpy()[~live] == 0.0).all()


@pytest.mark.parametrize("drop", [False, True], ids=["drain", "drop"])
@pytest.mark.parametrize("cfg_name", ["essp2", "vap", "wired_int8"])
def test_churned_mf_matches_jax(apps, cfg_name, drop):
    japp, tapp = apps["mf"]
    P = MF_CFG["n_workers"]
    kw = dict(worker_outages=MF_OUTAGES, drop_inflight=drop)
    assert_run_parity(japp, tapp, CONFIGS[cfg_name], T,
                      jkw=dict(schedule=jd.make_churn(T, P, **kw)),
                      tkw=dict(schedule=td.make_churn(T, P, **kw)))


def test_pod_outage_and_regime_shift_match_jax(apps):
    """A whole pod down on the wired path, and a straggler-regime shift
    (per-clock rates through ``delivery_matrix``) on the dense one."""
    japp, tapp = apps["quad"]
    pod = dict(n_pods=2, pod_outages=((1, 3, 8),))
    assert_run_parity(japp, tapp, wired, T,
                      jkw=dict(schedule=jd.make_churn(T, 8, **pod)),
                      tkw=dict(schedule=td.make_churn(T, 8, **pod)))
    shift = dict(regime_shift=(5, 3, 0.2))
    cfg = lambda m: m.essp(3).replace(push_prob=1.0)  # noqa: E731
    _, got, _ = assert_run_parity(
        japp, tapp, cfg, T, jkw=dict(schedule=jd.make_churn(T, 8, **shift)),
        tkw=dict(schedule=td.make_churn(T, 8, **shift)))
    sched = td.make_churn(T, 8, **shift)
    for c in (2, 9):
        np.testing.assert_array_equal(
            td.churn_rates(tc.essp(3), sched, 8, c).numpy(),
            np.asarray(jd.churn_rates(jc.essp(3),
                                      jd.make_churn(T, 8, **shift), 8,
                                      jnp.asarray(c))))
    d = got.delivered.numpy().astype(float)
    assert d[5:, :, :3].mean() < d[:5, :, :3].mean()


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_no_churn_bit_equal_in_port(apps, cfg_name):
    _, tapp = apps["quad"]
    cfg = CONFIGS[cfg_name](tc)
    want = tps.simulate(tapp, cfg, T, seed=3, record_views=True)
    got = tps.simulate(tapp, cfg, T, seed=3, record_views=True,
                       schedule=td.no_churn(T, 8))
    for f in tval.TRACE_FIELDS + ("views0",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_dead_reader_rows_freeze(apps):
    _, tapp = apps["quad"]
    w, t0, t1 = 2, 4, 9
    tr = tps.simulate(tapp, tc.essp(2), T, seed=0,
                      schedule=td.make_churn(T, 8,
                                             worker_outages=((w, t0, t1),)))
    stw = tr.staleness.numpy()[:, w, :]
    for c in range(t0 + 1, t1):
        np.testing.assert_array_equal(stw[c], stw[t0] - (c - t0))
    chk = tval.check_staleness_bound(tr, tc.essp(2))
    assert chk["violations"] == 0 and chk["max"] == -1, chk


def test_schedule_structure_guard(apps):
    japp, tapp = apps["quad"]
    with pytest.raises(ValueError, match="workers"):
        jps.simulate(japp, jc.essp(2), 4, schedule=jd.no_churn(4, 4))
    with pytest.raises(ValueError, match="workers"):
        tps.simulate(tapp, tc.essp(2), 4, schedule=td.no_churn(4, 4))


# ---------------------------------------------------------------------------
# the host-side readouts and the time model
# ---------------------------------------------------------------------------
def test_make_churn_and_outage_scoring_match_jax():
    kw = dict(n_pods=2, worker_outages=((1, 2, 5), (6, 9, 20)),
              pod_outages=((0, 12, 15),), regime_shift=(4, 2, 0.3),
              bw_drop=(3, 7, 0.25))
    js, ts = jd.make_churn(20, 8, **kw), td.make_churn(20, 8, **kw)
    for f in ("live", "straggler_workers", "straggler_rate", "bw_scale"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    for c in range(22):
        for a, b in zip(td.churn_live(ts, c), jd.churn_live(js, c),
                        strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert td.outage_windows(ts.live) == jd.outage_windows(js.live)
    verdicts = [{"kind": "worker_down", "worker": 1, "t": 4, "missed": 2},
                {"kind": "worker_down", "worker": 3, "t": 6, "missed": 2},
                {"kind": "worker_up", "worker": 1, "t": 5},
                {"kind": "worker_down", "worker": 6, "t": 12, "missed": 3},
                {"kind": "worker_down", "worker": 0, "t": 14, "missed": 2}]
    for budget in (1, 3):
        assert (td.score_detections(ts.live, verdicts, budget)
                == jd.score_detections(js.live, verdicts, budget))


def test_bw_scale_time_model_matches_jax(apps):
    """The per-clock ``bw_scale`` floors the wire and scales cross-pod
    fetches as JAX's model does, and a neutral one changes nothing."""
    japp, tapp = apps["quad"]
    jcfg, tcfg = wired(jc), wired(tc)
    tr = convert.trace_to_numpy(tps.simulate(tapp, tcfg, T, seed=0))
    for kw in (dict(t_comp=1e-6, straggler_sigma=0.0, rtt=0.0),
               dict(seed=7)):
        jm, tm = jtm.TimeModel(**kw), ttm.TimeModel(**kw)
        for drop in ((0, T, 1.0), (4, 10, 0.25)):
            js = jd.make_churn(T, 8, n_pods=2, bw_drop=drop)
            ts = td.make_churn(T, 8, n_pods=2, bw_drop=drop)
            got = tm.per_clock_np(tr, "essp", cfg=tcfg, schedule=ts)
            want = jm.per_clock(tr, "essp", cfg=jcfg, schedule=js)
            for g, w in zip(got, want, strict=True):
                w = np.asarray(w)
                drift = np.abs(g - w) / np.spacing(np.abs(w).max())
                assert drift.max() <= 4.0, (kw, drop, drift.max())
            tl = tm.timeline_np(tr, "essp", cfg=tcfg, schedule=ts)
            wl = jm.timeline_np(tr, "essp", cfg=jcfg, schedule=js)
            for k in ("wire", "sync", "wall"):
                drift = (np.abs(tl[k] - wl[k])
                         / np.spacing(np.float32(np.abs(wl[k]).max())))
                assert drift.max() <= 4.0, (k, drift.max())
        neutral = td.make_churn(T, 8, n_pods=2, bw_drop=(0, T, 1.0))
        np.testing.assert_array_equal(
            tm.wall_time_np(tr, "essp", cfg=tcfg, schedule=neutral),
            tm.wall_time_np(tr, "essp", cfg=tcfg))
