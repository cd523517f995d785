"""The port's optimizers, schedules, losses and gradient sync
(``repro_torch.optim``, ``train.losses``, ``psdist.grad_sync``) against
the JAX package's, on the CPU.

The same trees of parameters and gradients, made with numpy from a seed,
go through both packages for several steps.  The optimizers take JAX's
operations in JAX's order with its float32 casts, so float32 results
agree to a few ulp (``F32_TOL``, relative to each leaf's largest
magnitude: ``b ** step`` and ``sqrt`` may round an ulp apart); bfloat16
states and parameters are held to one bf16 step of their scale
(``BF16_TOL``), since an ulp of float32 drift can flip one rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consistency as jcc
from repro.optim import optimizers as jopt
from repro.psdist import grad_sync as jgs
from repro.train import losses as jlosses
from repro_torch.core import consistency as tcc
from repro_torch.optim import optimizers as topt
from repro_torch.psdist import grad_sync as tgs
from repro_torch.train import losses as tlosses

F32_TOL = 1e-6
BF16_TOL = 2 ** -7
SHAPES = {"a": (7, 5), "b": {"w": (3, 4, 2), "c": (11,)}}


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (scale * r.standard_normal(s)).astype(np.float32)
    return make(SHAPES)


def _to_jax(t, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


def _to_torch(t, dtype=torch.float32):
    if isinstance(t, dict):
        return {k: _to_torch(v, dtype) for k, v in t.items()}
    return torch.from_numpy(np.array(t, copy=True)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    """Every leaf within ``tol`` of its largest magnitude."""
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], tol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(
        1.0, float(np.abs(w).max())))


OPTS = {
    "sgd": (lambda: jopt.sgd(0.05), lambda: topt.sgd(0.05)),
    "sgd_cosine": (lambda: jopt.sgd(jopt.cosine_schedule(0.1, 2, 8)),
                   lambda: topt.sgd(topt.cosine_schedule(0.1, 2, 8))),
    "momentum": (lambda: jopt.momentum(0.05, 0.8),
                 lambda: topt.momentum(0.05, 0.8)),
    "momentum_inv_sqrt": (
        lambda: jopt.momentum(jopt.inv_sqrt_schedule(0.2, 2.0)),
        lambda: topt.momentum(topt.inv_sqrt_schedule(0.2, 2.0))),
    "adamw": (lambda: jopt.adamw(1e-2), lambda: topt.adamw(1e-2)),
    "adamw_decay_cosine": (
        lambda: jopt.adamw(jopt.cosine_schedule(3e-3, 3, 10),
                           weight_decay=0.1),
        lambda: topt.adamw(topt.cosine_schedule(3e-3, 3, 10),
                           weight_decay=0.1)),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_jax_over_steps(name):
    """Five steps of each optimizer on the same gradients: the updates,
    the optimizer state and the parameters after `apply_updates`."""
    jo, to = OPTS[name][0](), OPTS[name][1]()
    p0 = _tree(0)
    jp, tp = _to_jax(p0), _to_torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _tree(10 + step, scale=0.5)
        ju, js = jo.update(_to_jax(g), js, jp)
        tu, ts = to.update(_to_torch(g), ts, tp)
        _close(tu, ju, F32_TOL)
        jp = jopt.apply_updates(jp, ju)
        topt.apply_updates(tp, tu)
        _close(tp, jp, F32_TOL)
        assert int(ts["step"]) == int(js["step"])
        for key in ("mu", "m", "v"):
            if key in js:
                _close(ts[key], js[key], F32_TOL)


def test_adamw_bf16_states_match_jax():
    """``state_dtype`` bfloat16: m and v rounded each step."""
    jo = jopt.adamw(1e-2, state_dtype=jnp.bfloat16)
    to = topt.adamw(1e-2, state_dtype=torch.bfloat16)
    p0 = _tree(1)
    jp, tp = _to_jax(p0), _to_torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["m"]["a"].dtype == torch.bfloat16
    for step in range(4):
        g = _tree(20 + step)
        ju, js = jo.update(_to_jax(g), js, jp)
        tu, ts = to.update(_to_torch(g), ts, tp)
        _close(ts["m"], js["m"], BF16_TOL)
        _close(ts["v"], js["v"], BF16_TOL)
        _close(tu, ju, BF16_TOL)


def test_apply_updates_keeps_a_bf16_param():
    """``(p.f32 + u.f32).to(p.dtype)``, in place on the port's tensor."""
    p0, u = _tree(2), _tree(3, scale=0.01)
    jp = jopt.apply_updates(_to_jax(p0, jnp.bfloat16), _to_jax(u))
    tp = _to_torch(p0, torch.bfloat16)
    leaf = tp["a"]
    out = topt.apply_updates(tp, _to_torch(u))
    assert out["a"] is leaf and leaf.dtype == torch.bfloat16
    for k, want in (("a", jp["a"]), ("c", jp["b"]["c"])):
        got = tp[k] if k == "a" else tp["b"][k]
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize(("base", "warmup", "total"),
                         [(3e-3, 10, 100), (0.1, 0, 5), (1.0, 3, 3)])
def test_schedules_match_jax(base, warmup, total):
    steps = np.arange(0, total + 4, dtype=np.int32)
    jc = jopt.cosine_schedule(base, warmup, total)
    tc = topt.cosine_schedule(base, warmup, total)
    ji = jopt.inv_sqrt_schedule(base, 2.0)
    ti = topt.inv_sqrt_schedule(base, 2.0)
    for s in steps:
        js, ts = jnp.int32(s), torch.tensor(s, dtype=torch.int32)
        np.testing.assert_allclose(_np(tc(ts)), _np(jc(js)), rtol=1e-6)
        np.testing.assert_allclose(_np(ti(ts)), _np(ji(js)), rtol=1e-6)


@pytest.mark.parametrize(("z_loss", "dtype"), [(1e-4, "float32"),
                                               (0.0, "float32"),
                                               (1e-4, "bfloat16")])
def test_softmax_xent_matches_jax(z_loss, dtype):
    """The loss and its gradient on the same logits (bf16 logits are cast
    to float32 first on both sides)."""
    r = np.random.default_rng(4)
    logits = (3 * r.standard_normal((2, 9, 33))).astype(np.float32)
    labels = r.integers(0, 33, (2, 9)).astype(np.int32)
    jl = jnp.asarray(logits, dtype)
    jloss, jg = jax.value_and_grad(
        lambda x: jlosses.softmax_xent(x, jnp.asarray(labels), z_loss))(jl)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tloss = tlosses.softmax_xent(tl, torch.from_numpy(labels), z_loss)
    (tg,) = torch.autograd.grad(tloss, tl)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(tg, jg, tol)


def test_shift_labels_matches_jax():
    toks = np.random.default_rng(5).integers(0, 50, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tlosses.shift_labels(torch.from_numpy(toks)).numpy(),
        np.asarray(jlosses.shift_labels(jnp.asarray(toks))))


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 8])
def test_bucket_assignment_matches_jax(n_buckets):
    g = _tree(6)
    assert tgs.bucket_assignment(_to_torch(g), n_buckets) == \
        jgs.bucket_assignment(_to_jax(g), n_buckets)


@pytest.mark.parametrize("staleness", [1, 2, 3])
def test_fifo_warm_up_and_order_match_jax(staleness):
    """`push_pop` through `sync_gradients`: nothing applied for the first
    ``staleness`` steps, then the gradient of step ``t - staleness``."""
    js = jgs.GradSync("ssp", staleness)
    ts = tgs.GradSync("ssp", staleness)
    p = _tree(7)
    jf, tf = jgs.init_fifo(js, _to_jax(p)), tgs.init_fifo(ts, _to_torch(p))
    for step in range(staleness + 3):
        g = _tree(30 + step)
        jg, jf, jscale = jgs.sync_gradients(js, _to_jax(g), jf, ())
        tg, tf, tscale = tgs.sync_gradients(ts, _to_torch(g), tf, ())
        assert float(tscale) == float(jscale) == float(step >= staleness)
        _close(tg, jg, 0.0)
        if step >= staleness:
            _close(tg, _tree(30 + step - staleness), 0.0)
        assert int(tf["filled"]) == int(jf["filled"])


def test_bsp_sync_is_the_identity_and_collectives_wait():
    g = _to_torch(_tree(8))
    out, fifo, scale = tgs.sync_gradients(tgs.GradSync(), g, None)
    assert out is g and fifo is None and float(scale) == 1.0
    assert tgs.init_fifo(tgs.GradSync(), g) is None
    with pytest.raises(NotImplementedError, match="16.4b"):
        tgs.sync_gradients(tgs.GradSync(), g, None, ("data",))


@pytest.mark.parametrize("model", ["bsp", "ssp", "essp", "vap"])
def test_from_consistency_matches_jax(model):
    mk = {"bsp": lambda m: m.bsp(), "ssp": lambda m: m.ssp(3),
          "essp": lambda m: m.essp(2), "vap": lambda m: m.vap(0.5)}[model]
    if model == "vap":
        with pytest.raises(ValueError, match="simulator-only"):
            jgs.GradSync.from_consistency(mk(jcc))
        with pytest.raises(ValueError, match="simulator-only"):
            tgs.GradSync.from_consistency(mk(tcc))
        return
    j = jgs.GradSync.from_consistency(mk(jcc), n_buckets=4)
    t = tgs.GradSync.from_consistency(mk(tcc), n_buckets=4)
    assert (t.model, t.staleness, t.n_buckets) == (j.model, j.staleness,
                                                   j.n_buckets)
