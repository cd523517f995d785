"""The port's sharded runtime (``repro_torch.psrun``) on the CPU.

Each world runs every scenario once per module: a world of one rank in
the test process (``PSRuntime`` makes it, gloo over an in-process store)
and a gloo world of four ranks (a 2 x 2 ``("data", "model")`` mesh)
started by ``repro_torch.launch.worlds.run_world``; the rank-side code is
``tests/torch_psrun_worlds.py``.  Held, on the quad app (P = 8, d = 16)
and the small MF app (P = 4):

- bsp, ssp and essp traces bit-identical to the port's ``simulate``
  (``cross_validate``), with the staleness bound kept, on the dense and
  the wired path, under fleet churn (drain and drop) and on a lossy
  wired path with a pod outage; vap's decisions exact and its floats
  within ``VAP_ULP_BUDGET`` ulp; async finite;
- every rank of the four returns the whole trace, the same on each;
- ``obs`` accumulators and ``record_views`` bit-equal to ``simulate``'s;
- a checkpoint round trip (``save_runtime`` / ``restore_runtime``) and
  ``run_from`` resume the run bit for bit, also with a shipment in flight
  on a faulted wire; the JAX package's checkpoint files restore in the
  port with equal leaves and the other way round (``psstate_from_jax``);
- the guards: a ring-window mismatch and a worker count the worker axis
  does not divide raise;
- the runtime's traces held to the JAX package's ``simulate`` by
  ``assert_run_parity``'s rules (ints exact; floats within the budget up
  to the first flipped wire level or top-k selection).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch_psrun_worlds as worlds  # noqa: E402
from test_torch_churn import (MF_CFG, _x_final_ulp, apps,  # noqa: E402,F401
                              assert_run_parity)

from repro.checkpoint import io as jckpt  # noqa: E402
from repro.comm import wire as jw  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import delays as jd  # noqa: E402
from repro.psrun import PSRuntime as JRuntime  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as tckpt  # noqa: E402
from repro_torch.comm import wire as tw  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import delays as td  # noqa: E402
from repro_torch.launch.worlds import run_world  # noqa: E402
from repro_torch.psrun import PSRuntime, default_mesh  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402
from repro_torch.utils.tree import named_leaves  # noqa: E402

T = worlds.T
BUDGET = tval.VAP_ULP_BUDGET
EXACT = ["quad_bsp", "quad_ssp", "quad_essp", "mf_bsp", "mf_essp",
         "quad_wired", "quad_churn_drain", "quad_churn_drop",
         "quad_wired_faults_churn", "mf_wired"]
WORLDS = ["world1", "world4"]


@pytest.fixture(scope="module")
def mf_np(apps):
    japp, _ = apps["mf"]
    return MF_CFG, {"x0": np.asarray(japp.x0),
                    "local0": {k: np.asarray(v)
                               for k, v in japp.local0.items()}}


@pytest.fixture(scope="module")
def one_rank():
    """A world of one rank in this process, made by the runtime itself;
    taken down after the module."""
    made = not dist.is_initialized()
    rt = PSRuntime(device="cpu")
    yield rt
    if made:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world1(one_rank, mf_np):
    return [worlds.psrun_scenarios(*mf_np)]


@pytest.fixture(scope="module")
def world4(mf_np, tmp_path_factory):
    return run_world("torch_psrun_worlds:psrun_scenarios", 4,
                     tmp_path_factory.mktemp("psrun_world4"),
                     args=(*mf_np, (2, 2)))


def _rank0(request, world):
    return request.getfixturevalue(world)[0]


def test_world_shapes(world1, world4):
    assert world1[0]["world"] == 1 and world1[0]["mesh"] == [1, 1]
    assert [r["world"] for r in world4] == [4] * 4
    assert world4[0]["mesh"] == [2, 2]


def test_every_rank_returns_the_whole_trace(world4):
    first = world4[0]["traces"]
    for other in world4[1:]:
        assert set(other["traces"]) == set(first)
        for name, tr in first.items():
            for f in tval.TRACE_FIELDS:
                np.testing.assert_array_equal(getattr(other["traces"][name],
                                                      f), getattr(tr, f),
                                              err_msg=f"{name}.{f}")
    assert first["quad_essp"].staleness.shape == (T, 8, 8)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", EXACT)
def test_bit_identical_to_simulate(request, world, scenario):
    res = _rank0(request, world)["cross"][scenario]
    assert res["ok"], res
    assert all(v == 0.0 for v in res["max_diff"].values()), res["max_diff"]
    if "violations" in res:            # ssp/essp without faults
        assert res["violations"] == 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", ["quad_vap", "mf_vap"])
def test_vap_decisions_exact_floats_in_budget(request, world, scenario):
    res = _rank0(request, world)["cross"][scenario]
    assert res["ok"] and res["decisions_exact"], res
    assert res["violations"] == 0
    assert max(res["max_ulp"].values()) <= BUDGET


@pytest.mark.parametrize("world", WORLDS)
def test_async_runs_finite(request, world):
    out = _rank0(request, world)
    assert out["cross"]["quad_async"]["ok"]
    assert np.isfinite(out["traces"]["quad_async"].loss_ref).all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", ["essp", "wired_faults"])
def test_obs_and_views_bit_equal_to_simulate(request, world, scenario):
    eq = _rank0(request, world)[f"obs_views_{scenario}"]
    assert all(eq.values()), eq
    assert set(eq) >= {"obs", "views0"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", ["resume_essp",
                                      "resume_mid_retransmit"])
def test_checkpoint_resume_bit_exact(request, world, scenario):
    res = _rank0(request, world)[scenario]
    assert all(res["state_round_trip"].values()), res["state_round_trip"]
    assert all(res["stitched"].values()), res["stitched"]
    if scenario == "resume_mid_retransmit":
        assert res["in_flight_at_cut"], "no shipment in flight at the cut"


@pytest.mark.parametrize("world", WORLDS)
def test_guards(request, world):
    g = _rank0(request, world)["guards"]
    assert "ring window" in g["window"]
    if world == "world4":
        assert "must divide by the worker axes" in g["workers"]


def test_default_mesh_and_comm_structure_guard(one_rank, apps):
    _, tapp = apps["quad"]
    assert tuple(one_rank.mesh.shape) == (1, 1)
    assert tuple(default_mesh(8, device="cpu").shape) == (1, 1)
    W = tc.essp(2).effective_window
    with pytest.raises(ValueError, match="comm_active"):
        one_rank.run_fn(tapp, tc.essp(2), 3)(
            0, worlds.wired(tc).replace(window=W))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _faults_kw(scenario):
    if scenario != "quad_wired_faults_churn":
        return None, {}, {}
    flt = dict(worlds.FAULTS)
    churn = dict(n_pods=2, pod_outages=((1, 4, 9),), drop_inflight=True)
    W = jw.required_window(worlds.wired(jc), jw.make_faults(T, 8, **flt))
    jkw = dict(faults=jw.make_faults(T, 8, **flt),
               schedule=jd.make_churn(T, 8, **churn))
    tkw = dict(faults=tw.make_faults(T, 8, **flt),
               schedule=td.make_churn(T, 8, **churn))
    return W, jkw, tkw


@pytest.mark.parametrize("scenario", ["quad_bsp", "quad_essp", "quad_vap",
                                      "mf_essp", "mf_wired",
                                      "quad_wired_faults_churn"])
def test_runtime_holds_to_jax(apps, world4, scenario):
    app_name, model = scenario.split("_", 1)
    japp, tapp = apps["quad" if app_name == "quad" else "mf"]
    if app_name == "quad":
        tapp = worlds.quad_app()
    W, jkw, tkw = _faults_kw(scenario)
    make = (worlds.wired if "wired" in model
            else worlds.MODELS[model])
    if W is not None:
        make = (lambda m, _mk=make: _mk(m).replace(window=W))  # noqa: E731
    seed = 3 if app_name == "quad" else 1
    want, _sim, flip = assert_run_parity(japp, tapp, make, T, seed=seed,
                                         jkw=jkw, tkw=tkw)
    got = world4[0]["traces"][scenario]
    for f in tval.INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    upto = T if flip is None else flip
    np.testing.assert_array_equal(got.ship_floats[:upto],
                                  np.asarray(want.ship_floats)[:upto])
    last = upto if flip is not None else T
    for f in tval.FLOAT_FIELDS:
        if f == "x_final":
            if flip is None:
                assert _x_final_ulp(got, want, tapp.x0) <= BUDGET
            continue
        a = getattr(got, f)[:last].astype(np.float64)
        b = np.asarray(getattr(want, f))[:last].astype(np.float64)
        scale = np.float32(max(np.abs(a).max(), np.abs(b).max(), 1e-30))
        assert np.abs(a - b).max() / np.spacing(scale) <= BUDGET, f


def _jax_state(japp, jcfg, k, seed, **kw):
    rt = JRuntime()
    st = rt.init_state(japp, jcfg, seed=seed, **kw)
    return rt.run_from(japp, jcfg, k, st, **kw)[1]


@pytest.mark.parametrize("wired", [False, True], ids=["dense", "wired"])
def test_checkpoints_cross_packages(apps, one_rank, tmp_path, wired):
    """A JAX-written file restores in the port with equal leaves, and a
    port-written file in the JAX package."""
    japp, _ = apps["quad"]
    tapp = worlds.quad_app()
    if wired:
        flt = dict(worlds.FAULTS)
        jf = jw.make_faults(T, 8, **flt)
        W = jw.required_window(worlds.wired(jc), jf)
        jcfg = worlds.wired(jc).replace(window=W)
        tcfg = worlds.wired(tc).replace(window=W)
        jkw = dict(faults=jf)
        tkw = dict(faults=tw.make_faults(T, 8, **flt))
    else:
        jcfg, tcfg, jkw, tkw = jc.essp(2), tc.essp(2), {}, {}
    jstate = _jax_state(japp, jcfg, 5, 3, **jkw)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_runtime(jpath, jstate)
    like = one_rank.init_state(tapp, tcfg, seed=0, **tkw)
    got = tckpt.restore_runtime(jpath, like)
    want = convert.psstate_from_jax(jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    names = [n for n, _ in named_leaves(got)]
    assert names == [n for n, _ in named_leaves(want)]
    assert got.clock == 5 == want.clock
    for (n, a), (_, b) in zip(named_leaves(got), named_leaves(want),
                              strict=True):
        if isinstance(a, int):
            assert a == b, n
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), n
    # the port runs on from the JAX state, and its own file goes back
    tr, tstate = one_rank.run_from(tapp, tcfg, 3, got, **tkw)
    assert np.isfinite(tr.loss_ref.numpy()).all() and tstate.clock == 8
    tpath = str(tmp_path / "port.npz")
    tckpt.save_runtime(tpath, tstate)
    back = jckpt.restore_runtime(tpath, jstate)
    for (n, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            named_leaves(tstate), strict=True):
        a = np.asarray(a)       # the key: uint32 there, int64 words here
        b = np.asarray(b) if isinstance(b, int) else b.numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype),
                                      err_msg=jax.tree_util.keystr(n))
