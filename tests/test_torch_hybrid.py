"""The port's hybrid family (jamba-1.5-large-398b: groups of seven mamba
sublayers and one attention sublayer, each followed by the dense MLP or,
on every other sublayer, a 16-expert top-2 MoE) against the JAX
package, on the CPU, at its smoke config (8 layers in one group, d 256,
4 query heads over 2 KV heads of 64, 4 experts top-2), and its forward
also at an odd period (``attn_every`` 5, 10 layers in two groups), where
the JAX forward runs its sublayers in another order than its prefill
and decode (``transformer._hybrid_forward_order``).

The holding rules are ``tests/torch_memory_models.py``'s (the same
weights, the attention projections scaled to ``1/sqrt(d)``, the same
prompts, each step held on the same inputs, one JAX compile a function
and dtype) and ``tests/test_torch_serve.py``'s for the MoE layers
(``tests/torch_routing.py``): each MoE layer's routing is recorded in
both packages and logits and caches are held in the sequences whose
routing agreed, every flip a near tie.  float32: every step within
``LOGIT_TOL``.  bfloat16: the smoke model's seven bf16 mamba sublayers
put JAX's own bfloat16 run ~2 % of scale from its float32 run of the
same step (``d``), so a step's logits and each cache tensor are held
within ``LOGIT_TOL`` plus ``2 d`` (``d`` counted where JAX's float32
routing is its bfloat16 one), as ``test_torch_serve.py`` holds its archs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch import rng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import moe, transformer
from repro_torch.models.registry import build_model, model_specs
from repro_torch.models.params import param_count
from repro_torch.serve.decode import generate, generate_scan
from torch_memory_models import (B, CPU_DRAW_CHUNK, NEW, conditioned, hold,
                                 jax_init)
from torch_memory_models import pair as make_pair
from torch_routing import RoutingTap, jax_routing_tap  # noqa: F401

ARCH = "jamba-1.5-large-398b"
# the published config's parameters, counted from the JAX spec tree
N_PARAMS = 401_810_177_280
# the reduced cell chip_smoke.py serves on one card: 2 groups and each
# expert's hidden size cut to 4096 (51.4 GB in bf16)
REDUCED = dict(n_layers=16, d_ff_expert=4096)
N_PARAMS_REDUCED = 25_701_779_968
N_STEPS = 4


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return make_pair(ARCH, request.param)


def _n_moe_calls(cfg):
    return cfg.n_layers // cfg.attn_every * (cfg.attn_every // 2)


def test_configs_match_jax():
    """The published and smoke configs read field for field as JAX's."""
    for t, j in ((get_config(ARCH), jax_get_config(ARCH)),
                 (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "d_ff",
                  "vocab_size", "act", "attn_every", "param_dtype",
                  "compute_dtype", "tie_embeddings", "norm_eps", "source"):
            assert getattr(t, f) == getattr(j, f), f
        for sub in ("attn", "mamba", "moe"):
            assert vars(getattr(t, sub)) == vars(getattr(j, sub)), sub
        assert t.head_dim == j.head_dim


def _spec_table(specs, dtype_name):
    return {"/".join(k.key for k in path): (tuple(ps.shape), tuple(ps.axes),
                                            ps.init, ps.scale,
                                            dtype_name(ps.dtype))
            for path, ps in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: hasattr(x, "shape"))[0]}


@pytest.mark.parametrize("which", ["published", "smoke", "odd_period"])
def test_spec_tree_matches_jax(which):
    """Paths, shapes, axes, inits and dtypes of the spec tree equal JAX's
    (specs only: nothing is allocated), and the parameter counts: the
    published 401,810,177,280, and the reduced card cell's."""
    if which == "published":
        t, j = get_config(ARCH), jax_get_config(ARCH)
    else:
        t, j = get_smoke_config(ARCH), jax_smoke_config(ARCH)
        if which == "odd_period":
            t, j = (c.replace(attn_every=5, n_layers=10) for c in (t, j))
    got = _spec_table(model_specs(t), lambda d: str(d).split(".")[-1])
    want = _spec_table(jax_build_model(j).param_specs,
                       lambda d: str(np.dtype(d)))
    assert got == want
    if which == "published":
        assert param_count(model_specs(t)) == N_PARAMS
        cut = t.replace(n_layers=REDUCED["n_layers"], moe=t.moe.__class__(
            **dict(vars(t.moe), d_ff_expert=REDUCED["d_ff_expert"])))
        assert param_count(model_specs(cut)) == N_PARAMS_REDUCED
        assert got["blocks/mamba/mixer/in_proj"][0] == (9, 7, 8192, 41216)
        assert got["blocks/moe/ffn/router"][4] == "float32"


def test_init_draws_match_jax(monkeypatch):
    """The port's own init draws JAX's weights to a few ulp."""
    monkeypatch.setattr(rng, "_CHUNK", CPU_DRAW_CHUNK)
    jp = jax_init(ARCH, 7)
    tm = build_model(get_smoke_config(ARCH), seed=7, device="cpu")
    state = tm.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        want = np.asarray(leaf)
        got = state[".".join(k.key for k in path)].numpy()
        assert np.abs(got - want).max() <= 4 * np.spacing(
            np.float32(np.abs(want).max()))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_model_params_from_jax_covers_every_path(param_dtype):
    """Every path of the hybrid tree carries across bit for bit; at the
    published bfloat16 params every leaf but the router (and the mamba
    mixers' float32 ``a_log``, ``dt_bias``, ``d_skip``) is bfloat16."""
    cfg = get_smoke_config(ARCH).replace(param_dtype=param_dtype)
    if param_dtype == "float32":
        jp = jax_init(ARCH, 0)
    else:
        jcfg = jax_smoke_config(ARCH).replace(param_dtype=param_dtype)
        jp = jax.tree.map(np.asarray, jax.jit(jax_build_model(jcfg).init)(
            jax.random.PRNGKey(0)))
    tm = model_params_from_jax(cfg, jp, device="cpu")
    names = {".".join(k.key for k in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    state = tm.state_dict()
    assert set(state) == set(names)
    for group in ("mamba", "attn", "mlp", "moe"):
        assert any(n.startswith(f"blocks.{group}.") for n in names), group
    assert state["blocks.mamba.mixer.in_proj"].shape[:2] == (1, 7)
    assert state["blocks.moe.ffn.wi_gate"].shape[:3] == (1, 4, 4)
    f32 = ("router", "a_log", "dt_bias", "d_skip")
    for name, leaf in names.items():
        want_dt = (torch.float32 if name.endswith(f32)
                   else getattr(torch, param_dtype))
        assert state[name].dtype == want_dt, name
        np.testing.assert_array_equal(state[name].float().numpy(),
                                      leaf.astype(np.float32))
    assert tm.n_params == sum(v.size for v in names.values())


def test_hybrid_sublayer_orders():
    """Prefill and decode run the published order; the forward runs the
    JAX forward's, which is the same at an even period and at an odd one
    skips mamba sublayer ``attn_every - 2`` and the last MLP."""
    cfg = get_smoke_config(ARCH)
    plan = transformer._hybrid_sublayers(cfg)
    assert plan == [(("mamba", 0), ("mlp", 0)), (("mamba", 1), ("moe", 0)),
                    (("mamba", 2), ("mlp", 1)), (("mamba", 3), ("moe", 1)),
                    (("mamba", 4), ("mlp", 2)), (("mamba", 5), ("moe", 2)),
                    (("mamba", 6), ("mlp", 3)), (("attn", 0), ("moe", 3))]
    assert transformer._hybrid_forward_order(cfg) == plan
    odd = cfg.replace(attn_every=5)
    assert transformer._hybrid_forward_order(odd) == [
        (("mamba", 0), ("mlp", 0)), (("mamba", 1), ("moe", 0)),
        (("mamba", 2), ("mlp", 1)), (("attn", 0), ("moe", 1))]
    assert transformer._hybrid_sublayers(odd)[3:] == [
        (("mamba", 3), ("moe", 1)), (("attn", 0), ("mlp", 2))]


def _first_flips(got, want, tol, n_pos):
    """``[B]``: each sequence's first position whose routing differs
    between the runs ``got`` and ``want`` in any MoE layer (``n_pos``
    where none); every flip must be a near tie.  A causal model's earlier
    positions do not see it."""
    first = np.full(B, n_pos)
    if not want:
        return first
    _, flips = moe.routing_agreement(got, want, tol)
    assert all(margin <= budget for *_, margin, budget in flips), flips
    for _, b, s, _, _ in flips:
        first[b] = min(first[b], s)
    return first


@functools.lru_cache(maxsize=None)
def _odd_params():
    """JAX's conditioned init of the smoke config at ``attn_every`` 5 (10
    layers in two groups), as numpy."""
    jcfg = jax_smoke_config(ARCH).replace(attn_every=5, n_layers=10)
    return conditioned(jax.tree.map(np.asarray, jax.jit(
        jax_build_model(jcfg).init)(jax.random.PRNGKey(1))))


@functools.lru_cache(maxsize=None)
def _odd_forward(compute):
    """JAX's jitted forward at ``attn_every`` 5 in ``compute``."""
    return jax.jit(jax_build_model(jax_smoke_config(ARCH).replace(
        compute_dtype=compute, attn_every=5, n_layers=10)).forward)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("period", [8, 5])
def test_forward_matches_jax(compute, period):
    """``forward``'s logits and summed MoE aux loss against JAX's.  The
    logits are held at the positions before each sequence's first routing
    flip (float32: no flip at all); bfloat16 within the tolerance plus
    ``2 d`` (JAX's float32 forward on the same weights) before the first
    position where JAX's float32 routing differs from its bfloat16 one."""
    p32 = make_pair(ARCH, "float32")
    if period == 8:
        p = make_pair(ARCH, compute)
        jcfg, tm, jp = p.jcfg, p.tm, p.jp
        forward, forward32 = p.jit(p.jm, "forward"), p32.jit(p32.jm,
                                                              "forward")
    else:
        jcfg = jax_smoke_config(ARCH).replace(
            compute_dtype=compute, attn_every=5, n_layers=10)
        jp = _odd_params()
        tm = model_params_from_jax(get_smoke_config(ARCH).replace(
            compute_dtype=compute, attn_every=5, n_layers=10), jp,
            device="cpu")
        forward, forward32 = _odd_forward(compute), _odd_forward("float32")
    tol = 1e-4 if compute == "float32" else 2e-2
    toks = p32.toks
    S = toks.shape[1]
    batch = {"tokens": jnp.asarray(toks)}
    with RoutingTap() as tap:
        want, want_aux = forward(jp, batch)
        got, aux = tm(torch.from_numpy(toks))
    assert len(tap.jax) == _n_moe_calls(jcfg)
    first = _first_flips(tap.port, tap.jax, tol, S)
    assert got.dtype == getattr(torch, compute) and got.shape == want.shape
    assert aux.dtype == torch.float32 and aux.dim() == 0
    want = np.asarray(want, np.float32)
    bound = np.full((B, S), tol)
    if compute == "float32":
        assert (first == S).all(), first
        assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    else:
        with RoutingTap() as tap32:
            exact = np.asarray(forward32(jp, batch)[0])
        first32 = _first_flips(tap32.jax, tap.jax, tol, S)
        d = np.abs(want - exact).max(axis=2) / np.abs(want).max()
        bound += np.where(np.arange(S) < first32[:, None], 2 * d, 0.0)
        assert abs(float(aux) - float(want_aux)) <= tol * float(want_aux)
    held = np.arange(S) < first[:, None]
    assert held.any(), first
    err = (np.abs(got.float().numpy() - want).max(axis=2)
           / np.abs(want[held]).max())
    assert (err <= bound)[held].all(), (err.max(), bound.min(), first)


def _rows(tree, held):
    """Every leaf of a (nested) numpy cache by path, its leading layers
    axes flattened (a dict's ``pos`` is ``[*layers, batch]``), the
    sequences ``held`` kept."""
    lead = tree["pos"].ndim - 1 if "pos" in tree else 1
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _rows(v, held).items()})
        else:
            out[k] = v.reshape((-1,) + v.shape[lead:])[:, held]
    return out


def _step(pair, model, tokens, cache, dtype=None):
    """`Pair.jax_step` or `Pair.port_step` under a `RoutingTap`."""
    with RoutingTap() as tap:
        fn = pair.jax_step if model is pair.jm else pair.port_step
        out = fn(model, tokens, cache, dtype)
    return out, tap


def test_prefill_and_decode_match_jax(pair):
    """The prefill and ``N_STEPS`` greedy decode steps, each held on the
    same inputs (each JAX step runs from the port's cache, fed the token
    of JAX's free-running run): in the sequences whose routing agreed,
    the logits within ``bound`` and every cache leaf (the mamba
    sublayers' ``conv``, ``ssm``, ``pos``, the attention's ``k``, ``v``,
    ``pos``) within the tolerance (bfloat16: plus twice its own ``d``),
    the integer leaves exactly; the free-running logits within ``bound``
    plus the distance between JAX's two runs.  At most one sequence of
    the ``(N_STEPS + 1) * B`` may be let go for a flip."""
    bf16 = pair.compute == "bfloat16"
    jdt, tdt = jnp.dtype(pair.compute), getattr(torch, pair.compute)
    p32 = make_pair(ARCH, "float32")
    steps, toks = pair.jax_run()
    cache, let_go = None, 0
    for t in range(N_STEPS + 1):
        tok = pair.toks if t == 0 else toks[:, t - 1:t]
        with RoutingTap() as tap:
            want = pair.jax_step(pair.jm, tok, cache, jdt)
            got = pair.port_step(pair.tm, tok, cache, tdt)
        held = tap.agreement(pair.tol)
        assert len(tap.jax) == _n_moe_calls(pair.jcfg), t
        let_go += int((~held).sum())
        g_rows, w_rows = _rows(got[1], held), _rows(want[1], held)
        bound = np.full(B, pair.tol)
        cache_bound = dict.fromkeys(w_rows, pair.tol)
        if bf16:
            with RoutingTap() as tap32:
                exact = p32.jax_step(p32.jm, tok, cache, jnp.float32)
            routed = moe.routing_agreement(tap32.jax, tap.jax,
                                           pair.tol)[0].numpy()
            scale = np.abs(want[0][held]).max()
            d = np.abs(want[0] - exact[0]).max(axis=(1, 2)) / scale
            bound += np.where(routed, 2 * d, 0.0)
            e_rows = _rows(exact[1], held & routed)
            for k, w in _rows(want[1], held & routed).items():
                if np.issubdtype(w.dtype, np.floating) and w.size:
                    cache_bound[k] += 2 * np.abs(w - e_rows[k]).max() / max(
                        np.abs(w).max(), 1e-30)
        assert set(g_rows) == set(w_rows) == {
            "mamba/conv", "mamba/ssm", "mamba/pos", "attn/k", "attn/v",
            "attn/pos"}
        for k, w in w_rows.items():
            assert g_rows[k].shape == w.shape, (t, k)
            if np.issubdtype(w.dtype, np.floating):
                hold(g_rows[k], w, cache_bound[k], (t, k))
            else:
                np.testing.assert_array_equal(g_rows[k], w, str((t, k)))
        scale = np.abs(want[0][held]).max()
        err = np.abs(got[0] - want[0]).max(axis=(1, 2)) / scale
        assert (err <= bound)[held].all(), (t, err, bound, held)
        free = np.abs(got[0] - steps[t][0]).max(axis=(1, 2)) / scale
        moved = np.abs(want[0] - steps[t][0]).max(axis=(1, 2)) / scale
        assert (free <= bound + moved)[held].all(), (t, free, moved)
        cache = got[1]
    assert let_go <= 1, let_go


def test_generate_scan_matches_jax(pair):
    """Greedy tokens of ``generate_scan`` (and ``generate``) against JAX's
    greedy run: float32 equal; bfloat16 each row equal up to its first
    differing token, and there the row's routing flipped on the way
    (the same tokens in, so the same inputs) or JAX's top-2 margin lies
    within the step's bound (the tolerance plus ``2 d``, ``d`` JAX's
    float32 distance at that step)."""
    steps, want = pair.jax_run()
    toks = torch.from_numpy(pair.toks)
    with RoutingTap() as tap:
        got = generate_scan(pair.tm, toks, NEW)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(generate(pair.tm, toks, NEW), got)
    if pair.compute == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    # JAX's greedy run again, with its routing, and each of its steps
    # once more in float32 on the same inputs
    p32 = make_pair(ARCH, "float32")
    n = _n_moe_calls(pair.jcfg)
    cache = None
    jroutes, d = [], []
    for t in range(NEW):
        tok = pair.toks if t == 0 else want[:, t - 1:t]
        (lg32, _), _ = _step(p32, p32.jm, tok, cache, jnp.float32)
        (lg, cache), tp = _step(pair, pair.jm, tok, cache, jnp.bfloat16)
        jroutes += tp.jax
        d.append(np.abs(lg - lg32).max() / np.abs(lg).max())
    tap.jax = jroutes
    differ = got.numpy() != want
    for row in np.flatnonzero(differ.any(axis=1)):
        t = int(np.argmax(differ[row]))
        if not tap.agreement(pair.tol, slice(0, (t + 1) * n))[row]:
            continue
        logits = steps[t][0][:, -1]
        top = np.sort(logits[row])
        assert top[-1] - top[-2] <= (pair.tol + 2 * d[t]) * np.abs(
            logits).max(), (row, t)


def test_cache_layout():
    """The caches are ``{"mamba": {conv, ssm, pos}, "attn": {k, v,
    pos}}`` with the groups leading and, under ``mamba``, the mamba
    sublayers; a prefill fills every mamba sublayer's and the attention's,
    a decode step moves every ``pos`` on by one.  Two groups: the smoke
    model's weights, its one group twice."""
    p = make_pair(ARCH, "float32")
    jp = dict(p.jp, blocks=jax.tree.map(
        lambda v: np.concatenate([v, v]), p.jp["blocks"]))
    m = model_params_from_jax(p.tcfg.replace(n_layers=16), jp, device="cpu")
    cache = m.init_cache(2, 12)
    assert cache["mamba"]["conv"].shape == (2, 7, 2, 3, 640)
    assert cache["mamba"]["ssm"].shape == (2, 7, 2, 16, 32, 32)
    assert cache["mamba"]["pos"].shape == (2, 7, 2)
    assert cache["attn"]["k"].shape == (2, 2, 12, 2, 64)
    assert cache["attn"]["pos"].shape == (2, 2)
    toks = torch.arange(10).reshape(2, 5)
    _, cache = m.prefill(toks, cache)
    assert bool((cache["mamba"]["pos"] == 5).all())
    assert bool((cache["attn"]["pos"] == 5).all())
    assert bool(cache["mamba"]["ssm"].abs().amax(dim=(2, 3, 4, 5)).gt(0)
                .all())
    assert bool(cache["attn"]["k"][:, :, :5].abs().amax(dim=(1, 2, 3, 4))
                .gt(0).all())
    logits, cache = m.decode_step(toks[:, :1], cache)
    assert logits.shape == (2, 1, 512) and bool(torch.isfinite(logits).all())
    assert bool((cache["mamba"]["pos"] == 6).all())
    assert bool((cache["attn"]["pos"] == 6).all())
