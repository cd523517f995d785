"""The port's comm substrate against the JAX package's, on the CPU.

- The plain ``delta_pack`` is bit-equal to the JAX reference as XLA
  compiles it (``jax.jit``, which is how the simulator's scan runs it:
  the int8 residual is one fused multiply-add) and to the Pallas body in
  interpret mode, for f32, bf16 and int8, at ragged ``d``, ties at the
  threshold and exact .5 int8 quotients.
- ``row_threshold`` (with ``k`` a float32 ceil), ``quant_scale``,
  ``selected_count``, ``wire_floats`` and the shipment schedule equal
  JAX's exactly.
- f32 mass conservation is exact, and a ship/accumulate stream
  telescopes.
- The wired ``simulate`` on the quad app and the small MF app: integer
  Trace fields and ``ship_floats`` equal, float fields within
  ``VAP_ULP_BUDGET``; the neutral substrate reproduces the dense
  decisions; the reconciliation readouts equal JAX's on the same trace.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_kernels import PACK_CASES, bits, pack_case  # noqa: E402
from test_torch_ps import MF_CFG, _quad_jax, _quad_torch  # noqa: E402

from repro.apps import matfact as jmf  # noqa: E402
from repro.comm import substrate as jsub  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro.kernels import delta_pack as jdp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.pods import reconcile as jrec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import matfact as tmf  # noqa: E402
from repro_torch.comm import substrate as tsub  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.pods import reconcile as trec  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

QUANTS = ["f32", "bf16", "int8"]
POD = dict(s_xpod=3, t_net_xpod=6.0)
# the configs of the JAX package's compressed-path tests
WIRED = {
    "neutral": lambda m: m.compressed(m.podded(m.essp(2), 2, **POD)),
    "essp-agg2-int8": lambda m: m.compressed(m.podded(m.essp(2), 2, **POD),
                                             2, 0.25, "int8"),
    "ssp-agg3-bf16": lambda m: m.compressed(m.podded(m.ssp(2), 2, **POD),
                                            3, 0.5, "bf16"),
    "async-agg2": lambda m: m.compressed(
        m.podded(m.ConsistencyConfig(model="async", staleness=2), 2, **POD),
        2, 0.5),
}
N_CLOCKS = 12
_jit_pack = jax.jit(jref.delta_pack, static_argnums=3)


def _assert_bit_equal(got, want, msg=""):
    np.testing.assert_array_equal(bits(got), bits(np.asarray(want)),
                                  err_msg=msg)


# ---------------------------------------------------------------- pack


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("case", list(PACK_CASES))
def test_plain_delta_pack_bit_equal_to_jitted_jax(case, quant):
    delta, thresh, scale = pack_case(*PACK_CASES[case])
    want = _jit_pack(delta, thresh, scale, quant)
    got = ref.delta_pack(*(torch.from_numpy(a) for a in (delta, thresh,
                                                           scale)), quant)
    for g, w, name in zip(got, want, ("wire", "residual"), strict=True):
        _assert_bit_equal(g, w, f"{case}/{quant}/{name}")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("shape", [(4, 128), (8, 256), (1, 128)])
def test_plain_delta_pack_bit_equal_to_pallas_interpret(shape, quant):
    """The Pallas body (``d % 128 == 0`` only) under ``interpret=True``."""
    delta, thresh, scale = pack_case(*shape, 0.3, "normal", seed=7)
    want = jdp.delta_pack(jnp.asarray(delta), jnp.asarray(thresh),
                          jnp.asarray(scale), quant, interpret=True)
    got = ref.delta_pack(*(torch.from_numpy(a) for a in (delta, thresh,
                                                           scale)), quant)
    for g, w in zip(got, want, strict=True):
        _assert_bit_equal(g, w, f"{shape}/{quant}")


def test_int8_residual_is_one_rounding():
    """The jitted JAX residual is ``delta - r*s`` rounded once (an FMA);
    two roundings (``delta - float32(r*s)``) differ somewhere here."""
    delta, thresh, scale = pack_case(8, 4096, 0.3, "normal")
    _, res = ref.delta_pack(*(torch.from_numpy(a) for a in (delta, thresh,
                                                            scale)), "int8")
    s = scale[:, None]
    r = np.clip(np.round(delta / s), -127, 127).astype(np.float32)
    two = np.where(np.abs(delta) >= thresh[:, None], delta - r * s, delta)
    assert (bits(res) != bits(two)).any()
    _assert_bit_equal(res, _jit_pack(delta, thresh, scale, "int8")[1])


# ------------------------------------------------- threshold, scale, count


@pytest.mark.parametrize("topk_frac", [0.0625, 0.07, 0.3, 1.0])
@pytest.mark.parametrize("case", ["main", "ragged", "ties", "zeros"])
def test_threshold_scale_count_match_jax(case, topk_frac):
    P, d, _, kind = PACK_CASES[case]
    delta = pack_case(P, d, topk_frac, kind)[0]
    t = torch.from_numpy(delta)
    jd = jnp.asarray(delta)
    thresh = tsub.row_threshold(t, topk_frac)
    jthresh = jsub.row_threshold(jd, topk_frac)
    _assert_bit_equal(thresh, jthresh)
    for quant in QUANTS:
        _assert_bit_equal(tsub.quant_scale(t, quant),
                          jsub.quant_scale(jd, quant), quant)
    nnz = tsub.selected_count(t, thresh)
    _assert_bit_equal(nnz, jsub.selected_count(jd, jthresh))
    k = tsub.topk_count(topk_frac, d)
    assert (nnz.numpy() >= k).all()
    if case == "ties" and topk_frac < 1.0:
        assert (nnz.numpy() > k).any()          # ties admit more than k
    for quant in QUANTS:
        _assert_bit_equal(tsub.wire_floats(nnz, d, quant),
                          jsub.wire_floats(jnp.asarray(nnz.numpy()), d,
                                           quant), quant)


@pytest.mark.parametrize(("topk_frac", "d"), [
    (0.07, 5_053_800), (0.0625, 5_053_800), (0.25, 16), (0.5, 1003),
    (0.01, 99), (1.0, 7), (0.3, 2000), (0.1, 100_003)])
def test_topk_count_is_jax_float32_ceil(topk_frac, d):
    """``k`` as ``row_threshold`` computes it in JAX (``substrate.py:94``),
    without a ``d``-float row."""
    want = int(jnp.clip(jnp.ceil(topk_frac * d).astype(jnp.int32), 1, d))
    assert tsub.topk_count(topk_frac, d) == want
    if (topk_frac, d) == (0.07, 5_053_800):
        assert want == 353_766                  # float64 ceil: 353,767


def test_ship_schedule_matches_jax():
    for agg in (1, 2, 3, 5):
        for c in range(13):
            jcl, ja = jnp.int32(c), jnp.int32(agg)
            assert tsub.ship_now(c, agg) == bool(jsub.ship_now(jcl, ja))
            assert tsub.shipped_end(c, agg) == int(jsub.shipped_end(jcl, ja))
            assert (tsub.shipped_through(c, agg)
                    == int(jsub.shipped_through(jcl, ja)))


@pytest.mark.parametrize("G", [2, 4])
def test_reader_base_and_fold_pods_match_jax(G):
    r = np.random.default_rng(G)
    P, d = 8, 40
    x0 = r.standard_normal(d).astype(np.float32)
    bp, xbp = (r.standard_normal((G, d)).astype(np.float32)
               for _ in range(2))
    slot = r.standard_normal((P, d)).astype(np.float32)
    pods = (np.arange(P) // (P // G)).astype(np.int32)
    got = tsub.reader_base(*(torch.from_numpy(a) for a in (x0, bp, xbp,
                                                           pods)))
    want = jsub.reader_base(x0, bp, xbp, jnp.asarray(pods))
    _assert_bit_equal(got, want)
    _assert_bit_equal(tsub.fold_pods(torch.from_numpy(slot), G),
                      jsub.fold_pods(jnp.asarray(slot), G))
    st = tsub.init_state(5, P, d, G)
    jst = jsub.init_state(5, P, d, G)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in jst.items()}
    for model in ("essp", "ssp"):
        _assert_bit_equal(tsub.dense_ship_floats(model, P, d),
                          jsub.dense_ship_floats(model, P, d))


# ------------------------------------------------------ mass conservation


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("P", [1, 4, 8])
def test_pack_f32_conserves_mass_exactly(P, seed):
    r = np.random.default_rng(seed)
    topk = float(r.uniform(0.05, 1.0))
    delta = torch.from_numpy((3 * r.standard_normal((P, 96))
                              ).astype(np.float32))
    wire, res, nnz = tsub.pack(delta, topk, "f32")
    assert ((wire == 0) | (res == 0)).all()             # disjoint supports
    torch.testing.assert_close(wire + res, delta, rtol=0, atol=0)
    assert (nnz >= tsub.topk_count(topk, 96)).all()


def test_stream_telescopes():
    """Shipped plus held back equals produced: dropped coordinates are
    delayed, never lost."""
    r = np.random.default_rng(0)
    P, d, agg, topk = 4, 32, 3, 0.25
    acc = torch.zeros((P, d))
    res = torch.zeros((P, d))
    shipped = torch.zeros((P, d), dtype=torch.float64)
    total = torch.zeros((P, d), dtype=torch.float64)
    for t in range(30):
        u = torch.from_numpy(r.standard_normal((P, d)).astype(np.float32))
        total += u.double()
        acc += u
        if tsub.ship_now(t, agg):
            delta = acc + res
            wire, res, _ = tsub.pack(delta, topk, "f32")
            torch.testing.assert_close(wire + res, delta, rtol=0, atol=0)
            shipped += wire.double()
            acc = torch.zeros_like(acc)
    torch.testing.assert_close(shipped + acc.double() + res.double(), total,
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------- the simulator


@pytest.fixture(scope="module")
def apps():
    jquad = _quad_jax(P=8)
    jmfapp = jmf.make_mf_app(jmf.MFConfig(**MF_CFG))
    tmfapp = convert.mf_app_from_state(
        tmf.MFConfig(**MF_CFG), np.asarray(jmfapp.x0),
        {k: np.asarray(v) for k, v in jmfapp.local0.items()}, device="cpu")
    return {"quad": (jquad, _quad_torch(jquad)), "mf": (jmfapp, tmfapp)}


@pytest.fixture(scope="module")
def runs(apps):
    """(JAX trace, port trace) per (app, config), run once per module."""
    cache = {}

    def get(app_name, cfg_name):
        key = (app_name, cfg_name)
        if key not in cache:
            japp, tapp = apps[app_name]
            cache[key] = (
                jps.simulate(japp, WIRED[cfg_name](jc), N_CLOCKS, seed=1),
                convert.trace_to_numpy(tps.simulate(
                    tapp, WIRED[cfg_name](tc), N_CLOCKS, seed=1)))
        return cache[key]
    return get


@pytest.mark.parametrize("app_name", ["quad", "mf"])
@pytest.mark.parametrize("cfg_name", list(WIRED))
def test_wired_simulate_matches_jax(runs, app_name, cfg_name):
    want, got = runs(app_name, cfg_name)
    for f in tval.INT_FIELDS + ("ship_floats",):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    ulps = tval.trace_max_ulp(got, want)
    assert all(u <= tval.VAP_ULP_BUDGET for u in ulps.values()), ulps
    cfg = WIRED[cfg_name](tc)
    if cfg.model in ("ssp", "essp"):    # the widened bound
        assert tval.check_staleness_bound(got, cfg)["violations"] == 0
    if cfg.agg_clocks > 1:          # shipments only on boundaries
        clocks = np.arange(N_CLOCKS)
        boundary = (clocks + 1) % cfg.agg_clocks == 0
        assert not got.ship_floats[~boundary].any()
        assert (got.ship_floats[boundary] > 0).all()


def test_neutral_substrate_matches_dense_decisions(apps):
    """agg 1, topk 1.0, f32 through the substrate ships the exact dense
    delta: every integer decision and ship_floats equal the port's dense
    path; the floats agree to association (split-ring summation)."""
    _, tapp = apps["quad"]
    dense = tc.podded(tc.essp(2), 2, **POD)
    tr_d = tps.simulate(tapp, dense, 25, seed=3)
    tr_n = tps.simulate(tapp, tc.compressed(dense), 25, seed=3)
    for f in ("staleness", "forced", "delivered", "ship_floats"):
        torch.testing.assert_close(getattr(tr_n, f), getattr(tr_d, f),
                                   rtol=0, atol=0, msg=f)
    torch.testing.assert_close(tr_n.x_final, tr_d.x_final, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("cfg_name", ["essp-agg2-int8", "ssp-agg3-bf16",
                                      "async-agg2", "dense-essp",
                                      "dense-ssp"])
def test_reconcile_readouts_match_jax(apps, runs, cfg_name):
    """``reconcile_stats`` and ``replica_divergence`` of the port equal
    JAX's on the same port trace; the compressed run cuts the wire."""
    if cfg_name.startswith("dense"):
        mk = tc.essp if cfg_name == "dense-essp" else tc.ssp
        cfg = tc.podded(mk(2), 2, **POD)
        jcfg = jc.podded((jc.essp if cfg_name == "dense-essp"
                          else jc.ssp)(2), 2, **POD)
        tr = convert.trace_to_numpy(tps.simulate(apps["quad"][1], cfg,
                                                 N_CLOCKS, seed=1))
    else:
        cfg, jcfg = WIRED[cfg_name](tc), WIRED[cfg_name](jc)
        tr = runs("quad", cfg_name)[1]
    d = apps["quad"][1].dim
    got, want = trec.reconcile_stats(tr, cfg, dim=d), \
        jrec.reconcile_stats(tr, jcfg, dim=d)
    assert got == want
    gdiv, wdiv = trec.replica_divergence(tr, cfg), \
        jrec.replica_divergence(tr, jcfg)
    np.testing.assert_array_equal(gdiv.pop("per_clock"),
                                  wdiv.pop("per_clock"))
    assert gdiv == wdiv
    np.testing.assert_array_equal(trec.replica_clock(tr, cfg),
                                  jrec.replica_clock(tr, jcfg))
    np.testing.assert_array_equal(trec.xpod_channel_mask(cfg, 8),
                                  jrec.xpod_channel_mask(jcfg, 8))
    if cfg.model in ("ssp", "essp"):
        assert gdiv["ok"]
    if cfg_name == "essp-agg2-int8":
        assert got["wire_compression"] > 2.0
