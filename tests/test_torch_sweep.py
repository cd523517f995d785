"""The port's sweep engine against its own ``simulate`` and against the JAX
package's ``sweep``, on the CPU.

The port runs each (config, seed) in turn, so its contract is the JAX
engine's without the compile: ``trace(i, j)`` is bit-equal to
``simulate(app, harmonized[i], T, seeds[j])`` (as
``tests/test_sweep.py::test_sweep_bit_identical_to_simulate`` asks of the
JAX engine), configs group by family with the family's largest window,
and ``post`` / ``keep_traces=False`` return the consumer's outputs.
Against JAX's ``sweep`` on the quad app (and on a small LDA app): integer
Trace fields exact, float fields within ``VAP_ULP_BUDGET`` ulp of each
field's scale; ``post`` outputs (the time model's breakdown) within
``POST_ULP`` ulp of each value (the straggler draws go through ``normal``
and ``exp``, an ulp or two from XLA's, summed over the clocks).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.apps import lda as jlda  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core.sweep import sweep as jax_sweep  # noqa: E402
from repro_torch import convert, rng  # noqa: E402
from repro_torch.apps import lda as tlda  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core.timemodel import TimeModel  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

POST_ULP = 16.0
FAMILY_CASES = {
    "bsp": lambda m: [m.bsp(), m.bsp(push_prob=0.5)],
    "ssp": lambda m: [m.ssp(2), m.ssp(5)],
    "essp": lambda m: [m.essp(2, push_prob=0.6), m.essp(5)],
    "async": lambda m: [m.ConsistencyConfig(model="async", push_prob=0.4),
                        m.ConsistencyConfig(model="async", push_prob=0.9)],
    "vap": lambda m: [m.vap(0.3, staleness=5), m.vap(1.0, staleness=5)],
}
MIXED = lambda m: [m.bsp(), m.ssp(3), m.essp(3), m.ssp(6),  # noqa: E731
                   m.bsp(push_prob=0.5)]


@pytest.fixture(scope="module")
def tquad(quad_app):
    """conftest's quad app in the port, its noise from ``rng.normal``."""
    P, d = quad_app.n_workers, quad_app.dim
    eta = torch.tensor(0.3, dtype=torch.float32)

    def worker_update(views, local, _wids, clock, keys):
        g = views + 0.05 * rng.normal(keys, (d,))
        step = eta / torch.sqrt(torch.tensor(1.0 + clock,
                                             dtype=torch.float32))
        return -step * g / P, local

    return convert.psapp_from_state(
        "quad", np.asarray(quad_app.x0),
        {"_": np.asarray(quad_app.local0["_"])}, worker_update,
        lambda x, _l: torch.sum(torch.square(x)), device="cpu")


def _assert_equal(got, want, context=""):
    for f in tval.TRACE_FIELDS:
        np.testing.assert_array_equal(tval._np(getattr(got, f)),
                                      tval._np(getattr(want, f)),
                                      err_msg=f"{context}:{f}")


def _assert_parity(got, want, context=""):
    for f in tval.INT_FIELDS:
        np.testing.assert_array_equal(tval._np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{context}:{f}")
    ulps = tval.trace_max_ulp(got, want)
    assert max(ulps.values()) <= tval.VAP_ULP_BUDGET, (context, ulps)


@pytest.mark.parametrize("family", list(FAMILY_CASES))
def test_sweep_bit_equal_to_simulate_and_near_jax(quad_app, tquad, family):
    seeds = [0, 3]
    configs = FAMILY_CASES[family](tc)
    res = tsweep.sweep(tquad, configs, 25, seeds=seeds)
    want = jax_sweep(quad_app, FAMILY_CASES[family](jc), 25, seeds=seeds)
    assert res.n_runs == len(configs) * len(seeds)
    assert not hasattr(res, "n_compiles")
    for i in range(len(configs)):
        assert res.harmonized[i].window == want.harmonized[i].window
        assert res.harmonized[i].effective_window == \
            tsweep.family_window(configs)
        for j, sd in enumerate(seeds):
            got = res.trace(i, j)
            _assert_equal(got, tps.simulate(tquad, res.harmonized[i], 25,
                                            seed=sd), f"{family}[{i}]")
            _assert_parity(got, want.trace(i, j), f"{family}[{i}] jax")


def test_sweep_groups_mixed_families(quad_app, tquad):
    res = tsweep.sweep(tquad, MIXED(tc), 15, seeds=2)
    want = jax_sweep(quad_app, MIXED(jc), 15, seeds=2)
    assert len(res.families) == want.n_compiles == 3     # bsp, ssp, essp
    assert res.families == want.families
    assert res.harmonized[1].window == res.harmonized[3].window == 8
    assert res.harmonized[0].window == 2
    assert res.traces[3].staleness.shape == (2, 15, 4, 4)
    np.testing.assert_array_equal(res.seeds, want.seeds)
    _assert_equal(res.trace(3, 1),
                  tps.simulate(tquad, res.harmonized[3], 15, seed=1))
    for i in range(5):
        _assert_parity(res.trace(i, 1), want.trace(i, 1), f"mixed[{i}]")


def _breakdown(tm):
    def post(trace, cfg, seed, cfg_idx):
        return tm.breakdown_traced(trace, cfg.model, fold=(cfg_idx, seed))
    return post


def _assert_posts(got, want, context):
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = tval._np(got[k])
        assert g.shape == w.shape, (context, k)
        ulp = np.abs(g.astype(np.float64) - w) / np.spacing(np.abs(w))
        assert ulp.max() <= POST_ULP, (context, k, ulp.max())


def test_post_and_keep_traces(quad_app, tquad):
    """``post`` runs on each trace with the harmonized config, the seed
    and the config index; ``keep_traces=False`` returns the posts only."""
    configs = [tc.ssp(2), tc.essp(2), tc.bsp()]
    seen = []

    def post(trace, cfg, seed, cfg_idx):
        seen.append((cfg, seed, cfg_idx))
        return {"last": trace.loss_ref[-1], "forced": trace.forced.sum()}

    res = tsweep.sweep(tquad, configs, 10, seeds=[4, 5], post=post,
                       timeit=True)
    assert res.n_runs == 12 and res.t_exec_s is not None
    assert seen[:2] == [(res.harmonized[0], 4, 0), (res.harmonized[0], 5, 0)]
    for i in range(3):
        p = res.post(i)
        assert p["last"].shape == (2,)
        for j in range(2):
            assert float(res.post(i, j)["last"]) == \
                float(res.trace(i, j).loss_ref[-1])
            assert int(res.post(i, j)["forced"]) == \
                int(res.trace(i, j).forced.sum())
    tm = TimeModel(seed=3)
    lean = tsweep.sweep(tquad, configs, 10, seeds=[4, 5], post=_breakdown(tm),
                        keep_traces=False)
    want = jax_sweep(quad_app, [jc.ssp(2), jc.essp(2), jc.bsp()], 10,
                        seeds=[4, 5], keep_traces=False,
                        post=_jax_breakdown(3))
    assert lean.traces == [None] * 3
    with pytest.raises(ValueError, match="keep_traces=False"):
        lean.trace(0)
    for i in range(3):
        _assert_posts(lean.post(i), want.post(i), f"post[{i}]")
    with pytest.raises(ValueError, match="without a post"):
        tsweep.sweep(tquad, configs[:1], 2).post(0)


def _jax_breakdown(seed):
    from repro.core.timemodel import TimeModel as JTimeModel
    tm = JTimeModel(seed=seed)

    def post(trace, cfg, seed, cfg_idx):
        return tm.breakdown_traced(trace, cfg.model, fold=(cfg_idx, seed))
    return post


def test_lda_figure_sweep_matches_jax():
    """The C2-LDA figure's configs on a small LDA app from JAX's state,
    with the LDA time model as the post."""
    kw = dict(n_docs=16, doc_len=24, vocab=48, n_topics=4, true_topics=4,
              n_workers=4)
    japp = jlda.make_lda_app(jlda.LDAConfig(**kw))
    tapp = convert.lda_app_from_state(
        tlda.LDAConfig(**kw), np.asarray(japp.x0),
        {k: np.asarray(v) for k, v in japp.local0.items()}, device="cpu")
    tm = tlda.lda_time_model()
    res = tsweep.sweep(tapp, [tc.bsp(), tc.ssp(5), tc.essp(5)], 8,
                       post=_breakdown(tm))
    jtm = jlda.lda_time_model()

    def jpost(trace, cfg, seed, cfg_idx):
        return jtm.breakdown_traced(trace, cfg.model, fold=(cfg_idx, seed))

    want = jax_sweep(japp, [jc.bsp(), jc.ssp(5), jc.essp(5)], 8,
                        post=jpost)
    for i in range(3):
        _assert_parity(res.trace(i, 0), want.trace(i, 0), f"lda[{i}]")
        np.testing.assert_array_equal(
            res.trace(i, 0).locals_final["z"].numpy(),
            np.asarray(want.trace(i, 0).locals_final["z"]))
        _assert_posts(res.post(i), want.post(i), f"lda post[{i}]")


def test_sharding_options_checked(tquad):
    """The sharding options check their arguments (an unknown
    ``mesh_axis``, a mesh of several dimensions without one, ``mesh_axis``
    without a mesh, ``devices`` that do not list one device per rank);
    telemetry comes back batched per config
    (``test_torch_obs.py::test_sweep_threads_obs`` holds its values).
    ``test_torch_sweep_sharded.py`` runs the sharded sweep itself."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_batch_mesh, make_pods_mesh
    from repro_torch.obs import ObsSpec
    made = not dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="the world has 1 ranks"):
            tsweep.sweep(tquad, [tc.ssp(1)], 2, devices=["cpu", "cpu"])
        with pytest.raises(ValueError, match="not a dimension"):
            tsweep.sweep(tquad, [tc.ssp(1)], 2,
                         mesh=make_batch_mesh(["cpu"]), mesh_axis="pod")
        with pytest.raises(ValueError, match="name the one"):
            tsweep.sweep(tquad, [tc.ssp(1)], 2,
                         mesh=make_pods_mesh(1, 1, 1, device="cpu"))
        with pytest.raises(ValueError, match="pass mesh="):
            tsweep.sweep(tquad, [tc.ssp(1)], 2, mesh_axis="batch")
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    res = tsweep.sweep(tquad, [tc.ssp(1)], 2, seeds=2, obs=ObsSpec())
    assert res.traces[0].obs["clocks"].tolist() == [2, 2]
    with pytest.raises(ValueError, match="requires a post"):
        tsweep.sweep(tquad, [tc.ssp(1)], 2, keep_traces=False)
