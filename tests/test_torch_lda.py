"""The port's samplers and LDA app against the JAX package, on the CPU.

Tolerances, each stated where it is used:

- ``rng.log`` and ``rng.log1p`` replay XLA's float32 CPU formulas (the
  Cephes polynomials, contracted to multiply-adds), so they, ``gumbel``
  (float32 and bfloat16) and ``exponential`` are bit-equal to
  ``jax.random`` (0 ulp);
- ``loggamma`` is bit-equal at ``a < 1`` (the boost) and at most
  ``a >= 1``; at some ``a`` (3.0) a share of its draws differ by up to 3
  ulp of their scale, which neither ``normal`` (on the ``log1p``
  replay), ``log(d)`` nor ``c`` explains: within ``LOGGAMMA_ULP`` ulp of
  the draws' scale; ``gamma`` also takes its ``a < 1`` boost through
  torch's ``pow``: within ``GAMMA_ULP`` ulp of each value (20 observed,
  near the bottom of the range);
- ``dirichlet`` is the softmax of such log-gamma draws, through torch's
  ``exp`` and sum order: each value within its relative share of the
  log-gamma drift (twice ``LOGGAMMA_ULP`` ulp of the row's log-gamma
  scale) plus ``DIRICHLET_ULP`` ulp of itself, with the same exact zeros
  (XLA flushes results below float32's smallest normal);
- ``categorical`` is equal except where JAX's own top-2 margin of
  ``logits + gumbel`` is within ``TIE_ULP`` ulp of its scale; the draws
  here are counted, and there is none at the test seeds;
- the corpus (``words``, ``docid``, ``z``, ``ndk``, ``x0``) is exactly
  equal at ``LDAConfig()`` and at the small configs of
  ``tests/test_psrun.py`` and ``tests/test_ps_convergence.py``;
- one ``worker_update`` on the same inputs gives equal ``z``, ``ndk``
  and deltas; ``simulate`` from JAX's state keeps the integer Trace
  fields and ``z`` exact and the float fields within ``VAP_ULP_BUDGET``
  ulp of each field's scale (the loss's sums add in another order).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.apps import lda as jlda  # noqa: E402
from repro.core import consistency as jc  # noqa: E402
from repro.core import ps as jps  # noqa: E402
from repro_torch import convert, rng  # noqa: E402
from repro_torch.apps import lda as tlda  # noqa: E402
from repro_torch.core import consistency as tc  # noqa: E402
from repro_torch.core import ps as tps  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1]
LOGGAMMA_ULP = 4.0
GAMMA_ULP = 32.0
DIRICHLET_ULP = 8.0
TIE_ULP = 4.0

CORPUS_CFGS = {
    "default": {},
    "psrun": dict(n_docs=16, doc_len=24, vocab=48, n_topics=4,
                  true_topics=4, n_workers=4),
    "convergence": dict(n_docs=32, doc_len=64, vocab=100, n_topics=8,
                        true_topics=8, n_workers=4),
}
SIM_CFG = CORPUS_CFGS["psrun"]
CONFIGS = {
    "bsp": lambda m: m.bsp(),
    "ssp2": lambda m: m.ssp(2),
    "essp2": lambda m: m.essp(2),
    "async": lambda m: m.ConsistencyConfig(model="async"),
}


def _bits(x):
    """float32 bit patterns, every NaN as one pattern."""
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), x).view(np.int32)


def _ulp(got, want):
    """Per-element drift in ulp of each wanted value (of float32's
    smallest normal for zeros)."""
    want = np.asarray(want, np.float32)
    spacing = np.spacing(np.maximum(np.abs(want), np.finfo(np.float32).tiny))
    return np.abs(np.asarray(got, np.float64) - want) / spacing


def _keys(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


def test_log_and_log1p_are_xla_bit_for_bit():
    r = np.random.default_rng(0)
    x = np.concatenate([r.uniform(0, 1, 20000),
                        np.exp(r.uniform(-80, 80, 20000)),
                        [0.0, 1e-40, -1.0, np.inf, np.nan, 1.0]])
    x = x.astype(np.float32)
    for jfn, tfn, arg in ((jnp.log, rng.log, x),
                          (jnp.log1p, rng.log1p,
                           (x[:40000] * 3 - 0.999).astype(np.float32))):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(arg)))
        got = tfn(torch.from_numpy(arg)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_exponential_bit_equal(seed):
    jk, tk = _keys(seed)
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax.random.gumbel(jk, (4001,), dtype)
                          .astype(jnp.float32))
        got = rng.gumbel(tk, (4001,), tdtype).float().numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(rng.exponential(tk, (3, 999)).numpy()),
        _bits(jax.random.exponential(jk, (3, 999))))


def _scale_ulp(got, want):
    """Max drift in ulp of the largest wanted magnitude."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.spacing(np.abs(want).max()))


@pytest.mark.parametrize("seed", SEEDS)
def test_gamma_family_within_ulp(seed):
    """Both rejection loops at a < 1 (the boost) and a >= 1, per-element
    ``a``, and the Dirichlet draws the LDA corpus makes."""
    jk, tk = _keys(seed)
    for a in (0.05, 0.3, 0.9, 1.0, 2.5, 10.0):
        assert _scale_ulp(rng.loggamma(tk, a, (500,)).numpy(),
                          jax.random.loggamma(jk, a, (500,))) \
            <= LOGGAMMA_ULP, a
        assert _ulp(rng.gamma(tk, a, (500,)).numpy(),
                    jax.random.gamma(jk, a, (500,))).max() <= GAMMA_ULP, a
    a = np.array([[0.1, 0.7], [1.5, 4.0]], np.float32)
    assert _scale_ulp(
        rng.loggamma(tk, torch.from_numpy(a), (3, 2, 2)).numpy(),
        jax.random.loggamma(jk, jnp.asarray(a), (3, 2, 2))) <= LOGGAMMA_ULP
    for alpha, shape in ((np.full(200, 0.05), (10,)),
                         (np.full(30, 0.3), (64,)),
                         (np.array([1.0, 2.0, 5.0]), (7, 2))):
        alpha = alpha.astype(np.float32)
        want = np.asarray(jax.random.dirichlet(jk, jnp.asarray(alpha),
                                               shape))
        got = rng.dirichlet(tk, torch.from_numpy(alpha), shape).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got == 0, want == 0)
        lg = np.asarray(jax.random.loggamma(jk, jnp.asarray(alpha),
                                            shape + alpha.shape))
        lg_ulp = np.spacing(np.abs(lg).max(axis=-1, keepdims=True))
        allowed = (want * 2 * LOGGAMMA_ULP * lg_ulp + DIRICHLET_ULP
                   * np.spacing(np.maximum(want, np.finfo(np.float32).tiny)))
        assert (np.abs(got.astype(np.float64) - want) <= allowed).all()


def _tie_free(noisy, axis=-1):
    """JAX's top-2 margin of ``logits + gumbel`` exceeds ``TIE_ULP`` ulp
    of its scale everywhere."""
    top = np.sort(np.moveaxis(np.asarray(noisy, np.float32), axis, -1),
                  axis=-1)
    scale = np.spacing(np.abs(top).max().astype(np.float32))
    return bool(((top[..., -1] - top[..., -2]) > TIE_ULP * scale).all())


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed, monkeypatch):
    """Every form the LDA app and the decoder use; hashing in blocks of
    rows (a small ``_CHUNK``) must give the same draws."""
    jk, tk = _keys(seed)
    r = np.random.default_rng(seed)
    lg = (2.0 * r.standard_normal((64, 30))).astype(np.float32)
    jl, tl = jnp.asarray(lg), torch.from_numpy(lg)
    cases = [
        ({}, jax.random.gumbel(jk, (64, 30)) + jl),
        (dict(axis=0), jax.random.gumbel(jk, (64, 30)) + jl),
        (dict(shape=(5, 64)), jax.random.gumbel(jk, (5, 64, 30)) + jl),
    ]
    for kw, noisy in cases:
        assert _tie_free(noisy, kw.get("axis", -1)), kw
        want = np.asarray(jax.random.categorical(jk, jl, **kw))
        got = rng.categorical(tk, tl, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
    # the LDA corpus's broadcast form: [D, 1, K] logits, shape (D, L)
    want = np.asarray(jax.random.categorical(jk, jl[:, None, :], axis=-1,
                                             shape=(64, 7)))
    assert _tie_free(jax.random.gumbel(jk, (64, 7, 30)) + jl[:, None, :])
    monkeypatch.setattr(rng, "_CHUNK", 64)
    np.testing.assert_array_equal(
        rng.categorical(tk, tl[:, None, :], shape=(64, 7)).numpy(), want)
    np.testing.assert_array_equal(
        rng.categorical_rows(tk, tl[:6], torch.arange(64) % 6).numpy(),
        np.asarray(jax.random.categorical(jk, jl[:6][np.arange(64) % 6])))
    # without replacement (the Gumbel top-k)
    np.testing.assert_array_equal(
        rng.categorical(tk, tl, shape=(4, 64), replace=False).numpy(),
        np.asarray(jax.random.categorical(jk, jl, shape=(4, 64),
                                          replace=False)))
    # a batch of keys maps over the logits' leading axis, like vmap
    jks, tks = jax.random.split(jk, 4), rng.split(tk, 4)
    lg4 = lg.reshape(4, 16, 30)
    np.testing.assert_array_equal(
        rng.categorical(tks, torch.from_numpy(lg4)).numpy(),
        np.asarray(jax.vmap(jax.random.categorical)(jks,
                                                    jnp.asarray(lg4))))
    # bfloat16 logits draw bfloat16 noise, as the decoder's do
    lb = jl.astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        rng.categorical(tk, tl.to(torch.bfloat16)).numpy(),
        np.asarray(jax.random.categorical(jk, lb)))
    with pytest.raises(ValueError, match="broadcast"):
        rng.categorical(tk, tl, shape=(3, 5))


@pytest.fixture(scope="module", params=list(CORPUS_CFGS))
def corpus_pair(request):
    kw = CORPUS_CFGS[request.param]
    return (kw, jlda.make_lda_app(jlda.LDAConfig(**kw)),
            tlda.make_lda_app(tlda.LDAConfig(**kw), device="cpu"))


def test_corpus_matches_jax(corpus_pair):
    _, japp, tapp = corpus_pair
    for k in ("words", "docid", "z", "ndk"):
        got, want = tapp.local0[k].numpy(), np.asarray(japp.local0[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tapp.x0.numpy(), np.asarray(japp.x0))
    assert (tapp.dim, tapp.n_workers) == (japp.dim, japp.n_workers)


def _state(japp):
    return np.asarray(japp.x0), {k: np.asarray(v)
                                 for k, v in japp.local0.items()}


def test_worker_update_and_loss_match_jax(corpus_pair):
    """One clock on a stale view that holds negative counts (the clamp's
    case), for every worker and the same keys."""
    kw, japp, _ = corpus_pair
    cfg = tlda.LDAConfig(**kw)
    x0, local0 = _state(japp)
    tapp = convert.lda_app_from_state(cfg, x0, local0, device="cpu")
    P, d = japp.n_workers, japp.dim
    r = np.random.default_rng(1)
    views = (x0[None, :] + r.integers(-2, 3, (P, d))).astype(np.float32)
    jkeys = jax.random.split(jax.random.PRNGKey(4), P)
    for clock in (0, 3):
        want, wloc = jax.vmap(japp.worker_update,
                              in_axes=(0, 0, 0, None, 0))(
            jnp.asarray(views), japp.local0, jnp.arange(P),
            jnp.int32(clock), jkeys)
        got, gloc = tapp.worker_update(
            torch.from_numpy(views), tapp.local0, torch.arange(P), clock,
            rng.split(rng.PRNGKey(4), P))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for k in ("z", "ndk", "words", "docid"):
            np.testing.assert_array_equal(gloc[k].numpy(),
                                          np.asarray(wloc[k]), err_msg=k)
    # the update writes nothing into the state it was given
    np.testing.assert_array_equal(tapp.local0["z"].numpy(), local0["z"])
    for x in (views[0], x0):
        jl = float(japp.loss(jnp.asarray(x), japp.local0))
        tl = float(tapp.loss(torch.from_numpy(np.array(x, copy=True)),
                             tapp.local0))
        assert abs(tl - jl) <= 8 * np.spacing(np.float32(jl))


@pytest.fixture(scope="module")
def sim_pair():
    japp = jlda.make_lda_app(jlda.LDAConfig(**SIM_CFG))
    tapp = convert.lda_app_from_state(tlda.LDAConfig(**SIM_CFG),
                                      *_state(japp), device="cpu")
    return japp, tapp


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_simulate_from_jax_state_matches(sim_pair, cfg_name):
    japp, tapp = sim_pair
    want = jps.simulate(japp, CONFIGS[cfg_name](jc), 10, seed=1)
    got = tps.simulate(tapp, CONFIGS[cfg_name](tc), 10, seed=1)
    for f in tval.INT_FIELDS:
        np.testing.assert_array_equal(tval._np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.locals_final["z"].numpy(),
                                  np.asarray(want.locals_final["z"]))
    ulps = tval.trace_max_ulp(got, want)
    assert max(ulps.values()) <= tval.VAP_ULP_BUDGET, ulps
    if cfg_name in ("ssp2", "essp2"):
        assert tval.check_staleness_bound(
            got, CONFIGS[cfg_name](tc))["violations"] == 0


def test_nll_band_over_seeds():
    """Three corpus seeds under ssp(3), 15 clocks: the predictive NLL
    falls by at least 0.05 nats per token in each, and ends inside the
    band the JAX app's three runs span (widened by the float budget)."""
    kw = dict(CORPUS_CFGS["convergence"])
    ends, got_ends = [], []
    for seed in (0, 1, 2):
        jt = jps.simulate(jlda.make_lda_app(jlda.LDAConfig(seed=seed, **kw)),
                          jc.ssp(3), 15)
        tt = tps.simulate(tlda.make_lda_app(tlda.LDAConfig(seed=seed, **kw),
                                            device="cpu"), tc.ssp(3), 15)
        tl = tt.loss_ref.numpy()
        assert np.isfinite(tl).all() and tl[-1] < tl[0] - 0.05, (seed, tl)
        ends.append(float(jt.loss_ref[-1]))
        got_ends.append(float(tl[-1]))
    slack = tval.VAP_ULP_BUDGET * np.spacing(np.float32(max(ends)))
    assert min(ends) - slack <= min(got_ends)
    assert max(got_ends) <= max(ends) + slack


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlda.make_lda_app(tlda.LDAConfig())
    with pytest.raises(ValueError, match="divide"):
        tlda.make_lda_app(tlda.LDAConfig(n_docs=63), device="cpu")
    tm = tlda.lda_time_model()
    assert (tm.t_comp, tm.bytes_per_channel) == (0.2, 2e6)
