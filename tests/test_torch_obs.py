"""Telemetry, the monitor and the recovery controller in the port against
the JAX package, on the CPU.

- ``Trace.obs``: the accumulators the port folds on the device equal the
  JAX package's (integer leaves exact, ``ship_floats`` within
  ``VAP_ULP_BUDGET`` ulp of its scale) on dense, two-pod, churned and
  faulted wired runs; they equal the same sums taken over the port's own
  Trace fields; ``obs=None`` leaves every other field bit-equal to
  ``obs=ObsSpec()``, through ``simulate`` and through ``sweep``.
- ``collect_events`` on the port's trace against JAX's on JAX's trace:
  the same events in the same order, integer and string fields exact,
  floats (modeled seconds, losses) within ``VAP_ULP_BUDGET`` ulp of each
  field's largest value in the stream, plus the stream's 1 ns rounding.
  The schema checks (version, rejections, forward compatibility, JSONL
  round trip) hold on the port's streams.
- ``monitor_stream``, ``plan_recovery`` and ``apply_actions`` on the
  port's stream equal JAX's on JAX's stream (verdicts, violations,
  actions, the degraded config), and a neutral run gives no action.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from test_torch_churn import apps, assert_run_parity  # noqa: E402,F401

from repro.comm import wire as jw  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import delays as jd  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro.core import timemodel as jtm  # noqa: E402
from repro.ctrl import recover as jrec  # noqa: E402
from repro.obs import ObsSpec as JObs  # noqa: E402
from repro.obs import events as jev  # noqa: E402
from repro.obs import metrics as jmet  # noqa: E402
from repro.obs import monitor as jmon  # noqa: E402
from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import delays as td  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core import timemodel as ttm  # noqa: E402
from repro_torch.ctrl import recover as trec  # noqa: E402
from repro_torch.obs import ObsSpec as TObs  # noqa: E402
from repro_torch.obs import events as tev  # noqa: E402
from repro_torch.obs import metrics as tmet  # noqa: E402
from repro_torch.obs import monitor as tmon  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

T = 16
BUDGET = tval.VAP_ULP_BUDGET
FAULTS = dict(seed=8, drop_rate=0.15, bursts=((6, 10, 0.9),), max_retries=2)


def wired(m):
    return m.compressed(m.podded(m.essp(2), 2, s_xpod=1), agg_clocks=2,
                        topk_frac=0.5, quant="int8")


def _window(faults):
    return tw.required_window(wired(tc), faults)


# (cfg, churn kwargs or None, faults or not)
SCENARIOS = {
    "flat": (lambda m: m.essp(2), None, False),
    "two_pod_churn": (lambda m: m.podded(m.ssp(1), 2, s_xpod=2),
                      dict(worker_outages=((1, 3, 8), (7, 5, 10))), False),
    "wired_faults_churn": (wired, dict(n_pods=2, pod_outages=((1, 4, 9),),
                                       drop_inflight=True), True),
}


def _kwargs(scenario, P=8):
    make, churn, faulted = SCENARIOS[scenario]
    jkw, tkw = dict(obs=JObs()), dict(obs=TObs())
    if churn is not None:
        jkw["schedule"] = jd.make_churn(T, P, **churn)
        tkw["schedule"] = td.make_churn(T, P, **churn)
    if faulted:
        jkw["faults"] = jw.make_faults(T, P, **FAULTS)
        tkw["faults"] = tw.make_faults(T, P, **FAULTS)
        W = _window(tkw["faults"])
        return (lambda m: make(m).replace(window=W)), jkw, tkw
    return make, jkw, tkw


@pytest.fixture(scope="module")
def runs(apps):
    """Each scenario through both packages on the quad app."""
    japp, tapp = apps["quad"]
    out = {}
    for name in SCENARIOS:
        make, jkw, tkw = _kwargs(name)
        want, got, flip = assert_run_parity(japp, tapp, make, T, seed=0,
                                            jkw=jkw, tkw=tkw)
        out[name] = (make, jkw, tkw, want, got, flip)
    return out


# ---------------------------------------------------------------------------
# the device half
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_obs_accumulators_match_jax(runs, scenario):
    *_, want, got, flip = runs[scenario]
    assert set(got.obs) == set(want.obs)
    for k, v in got.obs.items():
        w = np.asarray(want.obs[k])
        if k != "ship_floats":
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        elif flip is None:      # a flipped selection moves the floats
            drift = np.abs(v.numpy() - w).max() / np.spacing(
                np.float32(max(np.abs(w).max(), 1e-30)))
            assert drift <= BUDGET, (k, drift)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_obs_equals_trace_sums_and_leaves_trace_bit_equal(apps, runs,
                                                          scenario):
    _, tapp = apps["quad"]
    make, _, tkw, _, got, _ = runs[scenario]
    off = tps.simulate(tapp, make(tc), T, seed=0,
                       **{k: v for k, v in tkw.items() if k != "obs"})
    for f in tval.TRACE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(off, f)), f
    assert off.obs is None
    o, live = got.obs, got.live
    lag = (-1 - got.staleness).long()
    rows = live[:, :, None].expand_as(lag)
    nb = o["lag_hist"].numel()
    hist = torch.bincount(lag.clamp(0, nb - 1)[rows], minlength=nb)
    assert torch.equal(o["lag_hist"].long(), hist)
    assert int(o["lag_max"]) == int(lag[rows].max())
    cfg = make(tc)
    in_pod = td.same_pod_mask(8, cfg.n_pods)
    f = got.forced & live[:, :, None]
    assert int(o["forced_intra"]) == int((f & in_pod).sum())
    assert int(o["forced_xpod"]) == int((f & ~in_pod).sum())
    assert int(o["delivered"]) == int((got.delivered
                                       & live[:, :, None]).sum())
    assert int(o["dead_worker_clocks"]) == int((~live).sum())
    assert int(o["clocks"]) == T
    assert torch.equal(o["ship_floats"], got.ship_floats.sum(0))


def test_sweep_threads_obs(apps):
    _, tapp = apps["quad"]
    cfgs = [tc.essp(1), tc.essp(3)]
    on = tsweep.sweep(tapp, cfgs, 8, seeds=2, obs=TObs())
    off = tsweep.sweep(tapp, cfgs, 8, seeds=2)
    for i in range(2):
        for j in range(2):
            a, b = on.trace(i, j), off.trace(i, j)
            for f in tval.TRACE_FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
            want = tps.simulate(tapp, on.harmonized[i], 8, seed=j,
                                obs=TObs()).obs
            for k in want:
                assert torch.equal(a.obs[k], want[k]), k
        assert on.traces[i].obs["clocks"].shape == (2,)


def test_registry_and_drain_match_jax(runs):
    *_, want, got, _ = runs["two_pod_churn"]
    treg, jreg = tmet.MetricsRegistry(), jmet.MetricsRegistry()
    with pytest.raises(ValueError):
        tmet.drain_device(treg, None)
    tmet.drain_device(treg, got.obs)
    jmet.drain_device(jreg, want.obs)
    assert treg.to_dict() == jreg.to_dict()
    assert treg.flat() == jreg.flat()
    treg.counter_add("a/n", np.int64(2))
    treg.gauge_set("a/g", torch.tensor(1.5))
    treg.hist_add("a/h", [1, 0, 2])
    treg.hist_add("a/h", [0, 1, 0])
    assert treg.to_dict()["hists"]["a/h"]["buckets"] == ["0", "1", "2+"]
    with pytest.raises(ValueError):
        treg.hist_add("a/h", [1, 2])
    tm = ttm.TimeModel()
    tmet.record_timing(treg, got, "ssp", tm, fold=(0, 0))
    flat = treg.flat()
    assert flat["ps/modeled_wall_s"] > 0
    assert "ps/worker07/modeled_comp_s" in flat
    with pytest.raises(ValueError, match="n_buckets"):
        tmet.ObsSpec(n_buckets=1)
    assert not tmet.obs_on(None) and not tmet.obs_on(
        tmet.ObsSpec(enabled=False)) and tmet.obs_on(tmet.ObsSpec())


# ---------------------------------------------------------------------------
# the event stream
# ---------------------------------------------------------------------------
def _scales(events):
    out = {}
    for e in events:
        for k, v in e.items():
            if isinstance(v, float):
                out[k] = max(out.get(k, 0.0), abs(v))
    return out


def assert_events_close(got, want):
    """Same events in the same order: non-float fields equal, floats
    within the budget of their key's largest value, plus 1 ns."""
    assert [e["type"] for e in got] == [e["type"] for e in want]
    scales = _scales(want)
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w), (g, w)
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, float):
                tol = BUDGET * float(np.spacing(np.float32(scales[k])))
                assert abs(gv - wv) <= tol + 1e-9, (k, gv, wv)
            elif isinstance(wv, dict):
                assert gv.keys() == wv.keys(), k
            else:
                assert gv == wv, (k, gv, wv)


def _streams(runs, scenario, tm_kw=None):
    make, jkw, tkw, want, got, _ = runs[scenario]
    jcfg, tcfg = make(jc), make(tc)
    jtmod, ttmod = jtm.TimeModel(**(tm_kw or {})), ttm.TimeModel(
        **(tm_kw or {}))
    jev_ = jev.collect_events(want, jcfg, jtmod, fold=(0, 0),
                              schedule=jkw.get("schedule"), run=scenario,
                              faults=jkw.get("faults"))
    tev_ = tev.collect_events(got, tcfg, ttmod, fold=(0, 0),
                              schedule=tkw.get("schedule"), run=scenario,
                              faults=tkw.get("faults"))
    return tev_, jev_


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_collect_events_matches_jax(runs, scenario):
    got, want = _streams(runs, scenario)
    tev.validate_events(got)
    assert_events_close(got, want)
    if scenario == "wired_faults_churn":
        flt = runs[scenario][2]["faults"]
        assert got[0]["retry_budget"] == flt.retry_budget > 0
        assert got[0]["bound"] == tev.declared_bound(
            runs[scenario][0](tc), flt.retry_budget)
    assert {"run_start", "clock", "worker_span", "run_end"} <= {
        e["type"] for e in got}


def test_schema_checks_on_port_streams(runs, tmp_path):
    ev, _ = _streams(runs, "two_pod_churn")
    reg = tmet.MetricsRegistry()
    tmet.drain_device(reg, runs["two_pod_churn"][4].obs)
    make, _, tkw, _, got, _ = runs["two_pod_churn"]
    ev = tev.collect_events(got, make(tc), ttm.TimeModel(),
                            schedule=tkw["schedule"], registry=reg)
    path = tmp_path / "events.jsonl"
    tev.write_jsonl(ev, path)
    assert tev.read_jsonl(path) == ev
    assert {"churn", "stale_read", "metrics"} <= {
        e["type"] for e in ev}
    Err = tev.SchemaError
    for broken in ([], ev[1:], ev[:-1], [dict(ev[0], v=99)] + ev[1:],
                   ev[:-1] + [{"type": "mystery"}, ev[-1]]):
        with pytest.raises(Err):
            tev.validate_events(broken)
    ci = next(i for i, e in enumerate(ev) if e["type"] == "clock")
    missing = dict(ev[ci])
    del missing["loss_ref"]
    with pytest.raises(Err):
        tev.validate_events(ev[:ci] + [missing] + ev[ci + 1:])
    with pytest.raises(Err, match="lag_p99"):
        tev.validate_events(ev[:ci] + [dict(ev[ci], lag_p99="high")]
                            + ev[ci + 1:])
    tev.validate_events(ev[:ci] + [dict(ev[ci], from_the_future=1.5)]
                        + ev[ci + 1:])
    alien = {"type": "adaptive_hint", "t": 0, "ts": 0.0}
    tev.validate_events([dict(ev[0], vm=tev.SCHEMA_MINOR + 1), alien,
                         *ev[1:]])
    with pytest.raises(Err, match="unknown type"):
        tev.validate_events([ev[0], alien, *ev[1:]])
    assert tev.check_version(ev) == (1, 2) == (jev.SCHEMA_VERSION,
                                               jev.SCHEMA_MINOR)
    assert tev.SCHEMA == jev.SCHEMA
    assert tev.SCHEMA_OPTIONAL == jev.SCHEMA_OPTIONAL
    # the JAX package's validator accepts the port's stream
    jev.validate_events(ev)
    for cfg in (tc.essp(2), wired(tc), tc.ConsistencyConfig(model="async"),
                tc.podded(tc.ssp(1), 2, s_xpod=2)):
        jcfg = jc.ConsistencyConfig(**dataclasses.asdict(cfg))
        for rb in (0, 6):
            assert tev.declared_bound(cfg, rb) == jev.declared_bound(jcfg,
                                                                     rb)


# ---------------------------------------------------------------------------
# the monitor and the controller
# ---------------------------------------------------------------------------
def _close_dicts(got, want, tol_keys=("ts", "phi", "value", "limit")):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w), (g, w)
        for k in w:
            if k in tol_keys and isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), \
                    (k, g, w)
            else:
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_monitor_and_controller_match_jax(apps, runs, scenario):
    got_ev, want_ev = _streams(runs, scenario)
    _, tapp = apps["quad"]
    make = runs[scenario][0]
    # the wire SLO of the faults bench: 3 % above the fault-free twin
    if make(tc).comm_active:
        clean = tps.simulate(tapp, make(tc), T, seed=0)
        floats = 1.03 * float(clean.ship_floats.sum()) / T
    else:
        floats = None
    jslo = jmon.SLOParams(window=4, max_floats_per_clock=floats)
    tslo = tmon.SLOParams(window=4, max_floats_per_clock=floats)
    det = dict(timeout_clocks=2)
    tres = tmon.monitor_stream(got_ev, tmon.DetectorParams(**det), tslo)
    jres = jmon.monitor_stream(want_ev, jmon.DetectorParams(**det), jslo)
    _close_dicts(tres.verdicts, jres.verdicts)
    _close_dicts(tres.violations, jres.violations)
    assert tres.health.keys() == jres.health.keys()
    for k in ("n_worker_down", "n_worker_up", "n_pod_down",
              "n_slo_violations", "violations_by_slo", "suspected_at_end"):
        assert tres.health[k] == jres.health[k], k
    tev.validate_events(tres.events)
    tact, _ = trec.plan_recovery(got_ev, tmon.DetectorParams(**det), tslo)
    jact, _ = jrec.plan_recovery(want_ev, jmon.DetectorParams(**det), jslo)
    _close_dicts(tact, jact)
    assert trec.plan_from_result(tres) == tact
    if scenario == "flat":
        assert not tact
    else:
        assert tact
    new_t, new_j = trec.apply_actions(make(tc), tact), jrec.apply_actions(
        make(jc), jact)
    assert dataclasses.asdict(new_t) == dataclasses.asdict(new_j)
    attached = trec.attach_actions(got_ev, tact)
    tev.validate_events(attached)
    _close_dicts([e for e in attached if e["type"] == "recovery_action"],
                 tact)
    assert trec.unrecovered_violations(tres.violations, tact) == \
        jrec.unrecovered_violations(tres.violations, tact)
    live = tmon.live_from_events(got_ev)
    np.testing.assert_array_equal(np.asarray(live),
                                  runs[scenario][4].live.numpy())
    score = td.score_detections(live, tres.verdicts, 4)
    assert score == jd.score_detections(np.asarray(
        jmon.live_from_events(want_ev)), jres.verdicts, 4)
    assert tmon.stream_summary(got_ev).keys() == jmon.stream_summary(
        want_ev).keys()


def test_neutral_stream_gives_no_action(apps):
    """The faults bench's controller contract on the port: with the wire
    SLO just above the fault-free floats, the neutral twin (``no_faults``)
    gives no action and the faulted run gives at least one."""
    _, tapp = apps["quad"]
    flt = tw.make_faults(T, 8, **FAULTS)
    cfg = wired(tc).replace(window=_window(flt))
    neutral = tps.simulate(tapp, cfg, T, seed=0, obs=TObs(),
                           faults=tw.no_faults(T, 8))
    faulted = tps.simulate(tapp, cfg, T, seed=0, obs=TObs(), faults=flt)
    slo = tmon.SLOParams(window=4, max_floats_per_clock=1.03 * float(
        neutral.ship_floats.sum()) / T)
    tm = ttm.TimeModel()
    ev0 = tev.collect_events(neutral, cfg, tm, run="neutral")
    ev1 = tev.collect_events(faulted, cfg, tm, run="faulted", faults=flt)
    assert trec.plan_recovery(ev0, slo=slo)[0] == []
    assert len(trec.plan_recovery(ev1, slo=slo)[0]) > 0
    with pytest.raises(ValueError):
        trec.RecoveryPolicy(sustained_windows=0)
    with pytest.raises(tev.SchemaError):
        trec.plan_recovery([dict(ev0[0], v=2)] + ev0[1:])
