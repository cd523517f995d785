"""The port's Trace consumers against the JAX package's, on the CPU.

Every consumer reads the very same trace (a JAX simulation's, as numpy,
or the port's own tensors for the device-side paths), so the integer
readouts must be equal.  The time model's straggler draws go through
``normal`` (within 3 ulp of ``jax.random.normal``, bit-equal at most
points) and ``exp`` (torch's, an ulp from XLA's), so its per-clock
seconds are held within ``CLOCK_ULP`` ulp of each value, and its sums
over the clocks (``wall_time``, ``breakdown``) within ``CLOCK_ULP`` ulp
per clock summed (``CLOCK_ULP · T`` ulp of the total).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.apps import matfact as jmf  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core import timemodel as jtm  # noqa: E402
from repro.core import valuebound as jvb  # noqa: E402
from repro.pods import reconcile as jrec  # noqa: E402
from repro_torch import convert, rng  # noqa: E402
from repro_torch.apps import matfact as tmf  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402
from repro_torch.core import timemodel as ttm  # noqa: E402
from repro_torch.core import valuebound as tvb  # noqa: E402
from repro_torch.pods import reconcile as trec  # noqa: E402

CLOCK_ULP = 4.0
T = 20
CONFIGS = {
    "bsp": lambda m: m.bsp(),
    "ssp3": lambda m: m.ssp(3),
    "essp3": lambda m: m.essp(3),
    "vap": lambda m: m.vap(0.3),
    "async": lambda m: m.ConsistencyConfig(model="async"),
    "essp2_2pod": lambda m: m.podded(m.essp(2), 2, s_xpod=2,
                                     t_net_xpod=4.0),
    "ssp2_2pod_wired": lambda m: m.compressed(
        m.podded(m.ssp(2), 2, s_xpod=1), agg_clocks=2, topk_frac=0.5,
        quant="bf16"),
}
MF = dict(n_rows=32, n_cols=24, rank=6, true_rank=3, n_workers=4, batch=16,
          density=0.3)


def _numpy_trace(jtrace):
    """A JAX trace's fields as numpy, in the port's `Trace`."""
    return tps.Trace(**{f.name: jax.tree.map(np.asarray,
                                             getattr(jtrace, f.name))
                        for f in dataclasses.fields(tps.Trace)})


@pytest.fixture(scope="module")
def traces():
    """One JAX MF trace per config, as numpy."""
    app = jmf.make_mf_app(jmf.MFConfig(**MF))
    return {name: _numpy_trace(jps.simulate(app, make(jc), T, seed=2))
            for name, make in CONFIGS.items()}


def _close(got, want, ulps, context):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, context
    drift = np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))
    assert drift.max() <= ulps, (context, drift.max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_time_model_matches_jax(traces, name):
    tr = traces[name]
    cfg_t, cfg_j = CONFIGS[name](tc), CONFIGS[name](jc)
    model = cfg_t.model
    for kw in ({}, {"t_comp": 0.2, "bytes_per_channel": 2e6, "seed": 5}):
        tm, jm = ttm.TimeModel(**kw), jtm.TimeModel(**kw)
        for fold in ((), (1, 3)):
            for tcfg, jcfg in ((None, None), (cfg_t, cfg_j)):
                got = tm.per_clock_np(tr, model, fold, cfg=tcfg)
                want = jm.per_clock_np(tr, model, fold, cfg=jcfg)
                for g, w, part in zip(got, want, ("wall", "comp", "comm"),
                                      strict=True):
                    _close(g, w, CLOCK_ULP, (name, kw, fold, part))
                _close(tm.wall_time_np(tr, model, fold, cfg=tcfg),
                       jm.wall_time_np(tr, model, fold, cfg=jcfg),
                       CLOCK_ULP * T, (name, "wall_time"))
                gb = tm.breakdown(tr, model, fold, cfg=tcfg)
                wb = jm.breakdown(tr, model, fold, cfg=jcfg)
                assert set(gb) == set(wb)
                for k in gb:
                    _close(gb[k], wb[k], CLOCK_ULP * T, (name, k))
        tl = tm.timeline_np(tr, model, cfg=cfg_t)
        wl = jm.timeline_np(tr, model, cfg=cfg_j)
        assert set(tl) == set(wl)
        for k in ("wall", "comp", "sync", "comp_clock", "comm_clock",
                  "wire"):
            _close(tl[k], wl[k], CLOCK_ULP, (name, "timeline", k))


def test_time_model_on_port_tensors_and_tiers(traces):
    """The model runs on a trace of tensors (a port run) as on numpy; the
    two-pod accounting charges the thin tier; a churn schedule's
    ``bw_scale`` scales it as JAX's model does."""
    tr = traces["essp2_2pod"]
    as_tensors = type(tr)(**{k: (torch.from_numpy(np.asarray(v))
                                 if isinstance(v, np.ndarray) else v)
                             for k, v in vars(tr).items()})
    tm = ttm.TimeModel()
    cfg = CONFIGS["essp2_2pod"](tc)
    np.testing.assert_array_equal(tm.wall_time(as_tensors, "essp",
                                               cfg=cfg).numpy(),
                                  tm.wall_time_np(tr, "essp", cfg=cfg))
    flat = tm.per_clock_np(tr, "essp")[0]
    tiered = tm.per_clock_np(tr, "essp", cfg=cfg)[0]
    assert (tiered >= flat).all() and (tiered > flat).any()
    from repro.core import delays as jdelays
    from repro_torch.core import delays as tdelays
    P = tr.forced.shape[1]
    drop = dict(n_pods=2, bw_drop=(3, 9, 0.25))
    crunch = tm.per_clock_np(tr, "essp", cfg=cfg,
                             schedule=tdelays.make_churn(T, P, **drop))
    want = jtm.TimeModel().per_clock(
        tr, "essp", cfg=CONFIGS["essp2_2pod"](jc),
        schedule=jdelays.make_churn(T, P, **drop))
    for got, w in zip(crunch, want, strict=True):
        _close(got, w, CLOCK_ULP, "bw_scale")
    assert (crunch[0] >= tiered).all() and (crunch[0][3:9] > tiered[3:9]).any()


def test_straggler_draws_mean_corrected():
    """``comp_draws`` are JAX's draws (same key folding, same stream) and
    average to ``t_comp``."""
    tm, jm = ttm.TimeModel(seed=7), jtm.TimeModel(seed=7)
    np.testing.assert_array_equal(
        tm.key((3, 11), "cpu").numpy(),
        np.asarray(jm.key((3, 11))).astype(np.int64))
    got = tm.comp_draws((400, 50), (2,), "cpu").numpy()
    want = np.asarray(jm.comp_draws((400, 50), (2,)))
    _close(got, want, CLOCK_ULP, "comp_draws")
    assert abs(got.mean() / tm.t_comp - 1.0) < 0.01
    assert tmf.mf_time_model().t_comp == 0.05
    assert tmf.mf_time_model(t_comp=1.0).t_comp == 1.0


@pytest.mark.parametrize("name", ["vap", "async", "essp3"])
def test_valuebound_and_replica_value_divergence(traces, name):
    tr = traces[name]
    for kind in ("inv_sqrt", "constant", "inv_t"):
        assert tvb.check_condition(tr, 0.3, kind) == \
            jvb.check_condition(tr, 0.3, kind)
        assert tvb.v_schedule(0.3, kind)(4) == jvb.v_schedule(0.3, kind)(4)
    assert tvb.sync_cost(tr) == jvb.sync_cost(tr)
    with pytest.raises(ValueError):
        tvb.v_schedule(1.0, "nope")
    got = trec.replica_value_divergence(tr, CONFIGS[name](tc))
    want = jrec.replica_value_divergence(tr, CONFIGS[name](jc))
    np.testing.assert_array_equal(got.pop("per_clock"),
                                  want.pop("per_clock"))
    assert got == want
    if name == "vap":
        assert got["ok"] is True and got["violations"] == 0


def test_theory_matches_jax(traces, quad_app):
    lv = traces["essp3"].loss_view
    np.testing.assert_array_equal(ttheory.regret_curve(lv, 0.01),
                                  jtheory.regret_curve(lv, 0.01))
    np.testing.assert_array_equal(
        ttheory.regret_curve(torch.from_numpy(lv), 0.01),
        jtheory.regret_curve(lv, 0.01))
    curve = jtheory.regret_curve(lv, 0.0)
    assert ttheory.sqrt_decay_fit(curve, skip=2) == \
        jtheory.sqrt_decay_fit(curve, skip=2)
    kw = dict(T=1000, s=3, P=8, eta=0.1, L=1.0, F=1.0, mu_gamma=2.0,
              sigma_gamma=1.0, tau=0.05)
    assert ttheory.theorem5_bound(**kw) == jtheory.theorem5_bound(**kw)
    # the variance across seeds, through each package's sweep
    P, d = quad_app.n_workers, quad_app.dim
    eta = torch.tensor(0.3, dtype=torch.float32)

    def worker_update(views, local, _wids, clock, keys):
        g = views + 0.05 * rng.normal(keys, (d,))
        step = eta / torch.sqrt(torch.tensor(1.0 + clock,
                                             dtype=torch.float32))
        return -step * g / P, local

    tquad = convert.psapp_from_state(
        "quad", np.asarray(quad_app.x0),
        {"_": np.asarray(quad_app.local0["_"])}, worker_update,
        lambda x, _l: torch.sum(torch.square(x)), device="cpu")
    got = ttheory.variance_trace(tquad, tc.essp(3), 30, n_seeds=4)
    want = jtheory.variance_trace(quad_app, jc.essp(3), 30, n_seeds=4)
    assert got.shape == want.shape == (30,)
    # a variance of float32 views from four seeds: 1e-5 of its scale
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert got[20:].mean() < got[2:8].mean()
