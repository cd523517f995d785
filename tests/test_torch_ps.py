"""The port's simulator against the JAX simulator, on the CPU.

Both start from the same state and the same seed and draw the same key
stream, so the integer Trace fields (staleness, forced, delivered, live)
must be equal and the float fields must agree to within
``VAP_ULP_BUDGET`` ulp of each field's scale (reduction orders differ
between the frameworks, and the quad app's ``normal`` noise differs by up
to 3 ulp).  VAP's decisions rest on float norms; the configurations here
keep every norm further from ``v_t`` than that budget, so its decisions
must be equal too.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.apps import matfact as jmf  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import delays as jdelays  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro.core import staleness as jstaleness  # noqa: E402
from repro_torch import convert, rng  # noqa: E402
from repro_torch.apps import matfact as tmf  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import delays as tdelays  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.core import staleness as tstaleness  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

CONFIGS = {
    "bsp": lambda m: m.bsp(),
    "ssp2": lambda m: m.ssp(2),
    "essp2": lambda m: m.essp(2),
    "async": lambda m: m.ConsistencyConfig(model="async"),
    "vap": lambda m: m.vap(0.3),
    "essp2_2pod": lambda m: m.podded(m.essp(2), 2, s_xpod=2,
                                     t_net_xpod=4.0),
}
N_CLOCKS = 12


def _quad_jax(P=4, d=16):
    """The quad app of tests/conftest.py (ring-view-sized)."""
    eta = 0.3

    def worker_update(view, local, _wid, clock, key):
        g = view + 0.05 * jax.random.normal(key, view.shape)
        return -(eta / jnp.sqrt(1.0 + clock)) * g / P, local

    return jps.PSApp(name="quad", dim=d, n_workers=P,
                     x0=jnp.ones((d,)) * 2.0,
                     local0={"_": jnp.zeros((P, 1))},
                     worker_update=worker_update,
                     loss=lambda x, _l: jnp.sum(jnp.square(x)))


def _quad_torch(japp):
    """The same app in the port, its noise from the port's rng.normal."""
    P, d = japp.n_workers, japp.dim
    eta = torch.tensor(0.3, dtype=torch.float32)

    def worker_update(views, local, _wids, clock, keys):
        g = views + 0.05 * rng.normal(keys, (d,))
        step = eta / torch.sqrt(torch.tensor(1.0 + clock,
                                             dtype=torch.float32))
        return -step * g / P, local

    return convert.psapp_from_state(
        "quad", np.asarray(japp.x0), {"_": np.asarray(japp.local0["_"])},
        worker_update, lambda x, _l: torch.sum(torch.square(x)),
        device="cpu")


MF_CFG = dict(n_rows=32, n_cols=24, rank=6, true_rank=3, n_workers=4,
              batch=16, density=0.3)


@pytest.fixture(scope="module")
def apps():
    jquad = _quad_jax()
    jmfapp = jmf.make_mf_app(jmf.MFConfig(**MF_CFG))
    tmfapp = convert.mf_app_from_state(
        tmf.MFConfig(**MF_CFG), np.asarray(jmfapp.x0),
        {k: np.asarray(v) for k, v in jmfapp.local0.items()}, device="cpu")
    return {"quad": (jquad, _quad_torch(jquad)), "mf": (jmfapp, tmfapp)}


def _assert_parity(want, got):
    for f in tval.INT_FIELDS:
        np.testing.assert_array_equal(tval._np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    ulps = tval.trace_max_ulp(got, want)
    bad = {f: u for f, u in ulps.items() if u > tval.VAP_ULP_BUDGET}
    assert not bad, ulps


@pytest.mark.parametrize("app_name", ["quad", "mf"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_simulate_matches_jax(apps, app_name, cfg_name):
    japp, tapp = apps[app_name]
    want = jps.simulate(japp, CONFIGS[cfg_name](jc), N_CLOCKS, seed=3)
    got = tps.simulate(tapp, CONFIGS[cfg_name](tc), N_CLOCKS, seed=3)
    _assert_parity(want, got)
    if cfg_name in ("ssp2", "essp2", "essp2_2pod"):
        assert tval.check_staleness_bound(
            got, CONFIGS[cfg_name](tc))["violations"] == 0


def test_vap_forces_and_staleness_readout(apps):
    """The VAP case enforces (forced fetches happen), and the port's
    staleness readout equals the JAX package's on the same trace."""
    japp, tapp = apps["mf"]
    got = convert.trace_to_numpy(tps.simulate(tapp, tc.vap(0.3), N_CLOCKS))
    assert got.forced.sum() > 0
    for skip in (False, True):
        b1, p1 = tstaleness.histogram(got, skip_warmup=skip)
        b2, p2 = jstaleness.histogram(got, skip_warmup=skip)
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(p1, p2)
    assert tstaleness.summary(got) == jstaleness.summary(got)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_delivery_model_matches_jax(cfg_name):
    P = 8
    jcfg, tcfg = CONFIGS[cfg_name](jc), CONFIGS[cfg_name](tc)
    jkey, tkey = jax.random.PRNGKey(11), rng.PRNGKey(11)
    np.testing.assert_array_equal(
        tdelays.delivery_matrix(tkey, tcfg, P).numpy(),
        np.asarray(jdelays.delivery_matrix(jkey, jcfg, P)))
    np.testing.assert_array_equal(
        tdelays.channel_push_prob(tcfg, P).numpy(),
        np.asarray(jdelays.channel_push_prob(jcfg, P)))
    np.testing.assert_array_equal(
        tdelays.expected_delay(tcfg, P).numpy(),
        np.asarray(jdelays.expected_delay(jcfg, P)))
    np.testing.assert_array_equal(
        tdelays.staleness_bound_matrix(tcfg, np.arange(P), P).numpy(),
        np.asarray(jdelays.staleness_bound_matrix(jcfg, jnp.arange(P), P)))


def test_configs_match_jax():
    for name, make in CONFIGS.items():
        j, t = make(jc), make(tc)
        assert t.effective_window == j.effective_window, name
        assert t.family == j.family, name
        assert t.comm_active == j.comm_active, name
    assert tc.KNOB_BOUNDS == jc.KNOB_BOUNDS
    assert tc.MODELS == jc.MODELS
    c = tc.compressed(tc.podded(tc.essp(1), 2), agg_clocks=3)
    assert c.comm_active and c.effective_window == 1 + 2 + 2
    with pytest.raises(ValueError, match="unknown consistency model"):
        tc.ConsistencyConfig(model="nope")


def test_unported_paths_raise(apps):
    """Churn, telemetry and the lossy wire are ported: what still raises
    are the structure guards, ``ValueError`` as in the JAX package — a
    schedule of the wrong worker count, faults off the comm substrate, a
    ring window below ``wire.required_window`` — on the dense path and on
    the comm substrate's."""
    from repro.comm import wire as jw
    from repro_torch.comm import wire as tw
    from repro_torch.obs import ObsSpec
    japp, tapp = apps["quad"]
    P = tapp.n_workers
    for m, w, app, d in ((jc, jw, japp, jdelays), (tc, tw, tapp, tdelays)):
        wired = m.compressed(m.podded(m.essp(1), 2), agg_clocks=2)
        faults = w.make_faults(4, P, seed=1, drop_rate=0.5, max_retries=1)
        short = wired.replace(window=w.required_window(wired, faults) - 1)
        for cfg, kw in ((m.essp(1), dict(schedule=d.no_churn(4, P + 1))),
                        (wired, dict(schedule=d.no_churn(4, P + 1))),
                        (m.essp(1), dict(faults=faults)),
                        (short, dict(faults=faults)),
                        (wired, dict(faults=w.no_faults(4, P + 1)))):
            with pytest.raises(ValueError):
                (jps if m is jc else tps).simulate(app, cfg, 2, **kw)
    tr = tps.simulate(tapp, tc.essp(1), 2, obs=ObsSpec())
    assert int(tr.obs["clocks"]) == 2


def test_enforce_vap_matches_jax():
    """Row-block cview (the runtimes' shape) and a full matrix."""
    r = np.random.default_rng(0)
    W, P, c = 6, 5, 9
    norms = np.sort(r.uniform(0, 1, (W + 1, P)).astype(np.float32), axis=0)
    norms[0] = 0
    for rows in (P, 2):
        cview = r.integers(c - W - 2, c, (rows, P)).astype(np.int32)
        jcv, jf = jps.enforce_vap(jc.vap(0.9), jnp.int32(c),
                                  jnp.asarray(cview), jnp.asarray(norms), W)
        tcv, tf = tps.enforce_vap(tc.vap(0.9), c, torch.from_numpy(cview),
                                  torch.from_numpy(norms), W)
        np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
