"""The port's auto-tuner against the JAX package's, on the CPU.

- ``grid_configs`` and ``pareto_indices`` equal JAX's.
- ``frontier`` (and one ``refine`` round) on the small MF app of
  ``test_torch_ps.py``: the same configs scored, each point's
  ``final_loss`` and ``wall_to_threshold`` within ``VAP_ULP_BUDGET`` ulp
  of their scale (the threshold is a float, so a point whose crossing
  clock differs must have its loss there within the budget of it), and
  the same frontier.
- ``loss_at_budget`` within the budget of JAX's value.
- ``grad_knobs``: JAX's gradients of the config knobs (``push_prob``,
  ``v0``) are exactly 0, because the simulator reads them only through
  comparisons, and the port's are 0.0 too; the gradients of the time
  model's constants (``t_comp``, ``bandwidth``, ``rtt``) flow through the
  time model and the softmin only, and are within the budget of JAX's
  (in ulp of the largest gradient's scale).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_ps import MF_CFG, _quad_jax, _quad_torch  # noqa: E402

from repro.apps import matfact as jmf  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import timemodel as jtm  # noqa: E402
from repro.core import tune as jtune  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import matfact as tmf  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import timemodel as ttm  # noqa: E402
from repro_torch.core import tune as ttune  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

BUDGET = tval.VAP_ULP_BUDGET
N_CLOCKS = 30


def _ulp(a, b, scale=None):
    scale = np.float32(scale if scale is not None
                       else max(abs(a), abs(b), 1e-30))
    return abs(float(a) - float(b)) / float(np.spacing(scale))


@pytest.fixture(scope="module")
def mf():
    japp = jmf.make_mf_app(jmf.MFConfig(**MF_CFG))
    tapp = convert.mf_app_from_state(
        tmf.MFConfig(**MF_CFG), np.asarray(japp.x0),
        {k: np.asarray(v) for k, v in japp.local0.items()}, device="cpu")
    return japp, tapp


@pytest.fixture(scope="module")
def quad():
    japp = _quad_jax(P=4)
    return japp, _quad_torch(japp)


def _key(cfg):
    return (cfg.model, int(cfg.staleness), float(cfg.push_prob),
            float(cfg.v0))


def test_grid_and_pareto_match_jax():
    grids = {"staleness": [1, 3], "push_prob": [0.5, 0.9]}
    got = ttune.grid_configs([tc.ssp(1), tc.essp(1)], grids)
    want = jtune.grid_configs([jc.ssp(1), jc.essp(1)], grids)
    assert [_key(c) for c in got] == [_key(c) for c in want]
    assert ttune.grid_configs(tc.essp(2), None) == [tc.essp(2)]
    r = np.random.default_rng(0)
    for _ in range(20):
        xs, ys = r.uniform(size=9), r.uniform(size=9)
        ys[r.integers(9)] = np.inf
        xs[r.integers(9)] = np.nan
        assert ttune.pareto_indices(xs, ys) == jtune.pareto_indices(xs, ys)
    assert ttune.pareto_indices(np.array([1.0, 2.0, 3.0, 0.5, 2.5]),
                                np.array([3.0, 1.0, 2.0, 4.0, np.inf])) \
        == [3, 0, 1]


def _assert_points_close(got, want):
    assert [_key(p["config"]) for p in got.points] == \
        [_key(p["config"]) for p in want.points]
    assert _ulp(got.threshold, want.threshold) <= BUDGET
    for gp, wp in zip(got.points, want.points, strict=True):
        assert _ulp(gp["final_loss"], wp["final_loss"]) <= BUDGET
        g, w = gp["wall_to_threshold"], wp["wall_to_threshold"]
        if np.isinf(w) or np.isinf(g):
            assert g == w
        else:
            assert _ulp(g, w, wp["wall_total"]) <= BUDGET, (g, w)
    assert got.frontier_idx == want.frontier_idx


def test_frontier_matches_jax(mf):
    japp, tapp = mf
    grids = {"push_prob": [0.5, 0.9]}
    got = ttune.frontier(tapp, [tc.ssp(3), tc.essp(3)], grids,
                         time_model=ttm.TimeModel(), n_clocks=N_CLOCKS,
                         seeds=2)
    want = jtune.frontier(japp, [jc.ssp(3), jc.essp(3)], grids,
                          time_model=jtm.TimeModel(), n_clocks=N_CLOCKS,
                          seeds=2)
    _assert_points_close(got, want)
    assert got.history[0]["n_runs"] == 8
    assert _key(got.best()["config"]) == _key(want.best()["config"])
    assert got.summary()["n_points"] == 4


def test_refine_matches_jax(quad):
    japp, tapp = quad
    kw = dict(n_clocks=20, seeds=1, threshold=0.05, refine_rounds=1)
    grids = {"push_prob": [0.3, 0.7]}
    got = ttune.frontier(tapp, tc.essp(3), grids,
                         time_model=ttm.TimeModel(), **kw)
    want = jtune.frontier(japp, jc.essp(3), grids,
                          time_model=jtm.TimeModel(), **kw)
    _assert_points_close(got, want)
    assert len(got.points) > 2
    assert all(0.05 <= p["config"].push_prob <= 1.0 for p in got.points)


@pytest.mark.parametrize("budget", [0.4, 1.2])
def test_loss_at_budget_matches_jax(quad, budget):
    japp, tapp = quad
    got = ttune.loss_at_budget(tapp, tc.essp(3), 30, ttm.TimeModel(),
                               budget, temp=0.5)
    want = jtune.loss_at_budget(japp, jc.essp(3), 30, jtm.TimeModel(),
                                budget, temp=0.5)
    assert _ulp(float(got), float(want)) <= BUDGET


@pytest.mark.parametrize(("app_name", "cfg_name", "knobs", "tm_knobs"), [
    ("quad", "essp3", ("push_prob",), ("t_comp",)),
    ("quad", "vap", ("v0",), ()),
    ("mf", "essp3", ("push_prob",), ("t_comp", "bandwidth", "rtt")),
    ("mf", "vap", ("v0", "push_prob"), ("t_comp",)),
])
def test_grad_knobs_match_jax(quad, mf, app_name, cfg_name, knobs,
                              tm_knobs):
    japp, tapp = {"quad": quad, "mf": mf}[app_name]
    make = {"essp3": lambda m: m.essp(3),
            "vap": lambda m: m.vap(0.5, staleness=4)}[cfg_name]
    got = ttune.grad_knobs(tapp, make(tc), 25, ttm.TimeModel(), budget=0.8,
                           knobs=knobs, tm_knobs=tm_knobs)
    want = jtune.grad_knobs(japp, make(jc), 25, jtm.TimeModel(), budget=0.8,
                            knobs=knobs, tm_knobs=tm_knobs)
    assert _ulp(got["value"], want["value"]) <= BUDGET
    assert got["grads"].keys() == want["grads"].keys()
    for k in knobs:
        # the shortcut's premise: no config knob reaches the loss
        assert want["grads"][k] == 0.0, (k, want["grads"][k])
        assert got["grads"][k] == 0.0
    scale = max([abs(want["grads"][k]) for k in tm_knobs] + [1e-30])
    for k in tm_knobs:
        assert np.isfinite(got["grads"][k])
        assert _ulp(got["grads"][k], want["grads"][k], scale) <= BUDGET, \
            (k, got["grads"][k], want["grads"][k])
    if "t_comp" in tm_knobs:
        assert got["grads"]["t_comp"] != 0.0
