"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py``, on the CPU.

The same parameters (JAX's ``init_params`` of ``moe_spec``) and inputs
(numpy, from a seed) go through both ``moe_forward``s.  The cases mirror
``tests/test_moe.py``: slack capacity, shared experts, drops at tight
capacity, the capacity formula, a balanced against a skewed router; then
the routing's tie-break and the full-width expert counts (64 top-6 with
2 shared, 128 top-8) at a narrow width.  Tolerances:

- routing (``eidx``) equal, but where JAX's own logit margin at the first
  differing rank is within ``2^-20`` of the token's ``|x| @ |W_router|``
  (the float32 router's sums taken in another order; none seen);
- the drops (``keep``) equal to a per-sequence oracle that walks the
  assignments in position order, fed JAX's routing;
- float32: ``y`` within ``1e-5`` of its largest magnitude (products and
  the top-k sum in another order), ``aux`` within ``1e-6`` relative;
- bfloat16: ``y`` within ``2^-6`` of its largest magnitude: both round
  each expert product, ``silu(g)·u``, the gate weighting and the sum over
  the top k to bfloat16 at the same points, from float32 values that may
  differ by an ulp, so a value may land one bfloat16 step (2^-8 relative)
  away in each of the three products; ``aux`` (float32 throughout) within
  ``1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.models.params import init_params as jinit
from repro_torch.configs import MoEConfig
from repro_torch.models import moe

ROUTE_BUDGET = 2.0 ** -20
Y_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _params(cfg, d, seed):
    jcfg = JMoEConfig(**vars(cfg))
    return jax.tree.map(np.asarray, jinit(jmoe.moe_spec(jcfg, d),
                                          jax.random.PRNGKey(seed)))


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _jax_routing(p, cfg, x):
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ p["router"], -1)
    logits = np.asarray(jnp.asarray(x, jnp.float32) @ p["router"])
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    bound = (np.abs(np.asarray(x, np.float32)) @ np.abs(p["router"])).max(-1)
    return {"eidx": torch.from_numpy(np.asarray(eidx)).long(),
            "logits": torch.from_numpy(logits),
            "bound": torch.from_numpy(bound)}


def _keep_oracle(eidx, E, C):
    """Per sequence, each (position, rank) assignment in order takes its
    expert's next slot while it has one."""
    B, S, K = eidx.shape
    keep = np.zeros((B, S * K), bool)
    for b in range(B):
        used = np.zeros(E, int)
        for n, e in enumerate(eidx[b].reshape(-1)):
            keep[b, n] = used[e] < C
            used[e] += 1
    return keep


def run_both(cfg, d, dtype, B=2, S=32, seed=0, p=None):
    """``moe_forward`` of both packages on the same parameters and input:
    ``(y_jax, aux_jax, y_port, aux_port, routing_jax, routing_port,
    keep_port)``."""
    p = _params(cfg, d, seed) if p is None else p
    x = _x(B, S, d, seed + 1)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    yj, auxj = jmoe.moe_forward({k: jnp.asarray(v) for k, v in p.items()},
                                JMoEConfig(**vars(cfg)), jnp.asarray(x, jdt))
    tx = torch.from_numpy(x).to(tdt)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    with moe.recording() as routes:
        yt, auxt = moe.moe_forward(tp, cfg, tx)
    _, keep = moe.dispatch_slots(routes[0]["eidx"], cfg.n_experts,
                                 moe._capacity(S, cfg))
    jx = x.astype(jdt).astype(np.float32)       # the router sees x in dtype
    return (np.asarray(yj, np.float32), float(auxj), yt.float().numpy(),
            float(auxt), _jax_routing(p, cfg, jx), routes[0], keep.numpy())


def _hold(res, cfg, dtype, S=32):
    yj, auxj, yt, auxt, rj, rt, keep = res
    same, flips = moe.routing_agreement([rt], [rj], ROUTE_BUDGET)
    assert all(m <= bud for *_, m, bud in flips), flips
    assert same.all(), flips           # no near tie flipped at these seeds
    np.testing.assert_array_equal(
        keep, _keep_oracle(rj["eidx"].numpy(), cfg.n_experts,
                           moe._capacity(S, cfg)))
    scale = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= Y_TOL[dtype] * scale
    assert abs(auxt - auxj) <= 1e-6 * max(1.0, abs(auxj))
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_jax_with_slack_capacity(dtype):
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=0,
                    capacity_factor=8.0)   # no drops
    keep = _hold(run_both(cfg, 64, dtype), cfg, dtype)
    assert keep.all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_shared_experts_match_jax(dtype):
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1,
                    capacity_factor=8.0)
    _hold(run_both(cfg, 64, dtype, seed=3), cfg, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_drops_at_tight_capacity_match_jax(dtype):
    """capacity_factor 0.25: assignments past an expert's C slots drop, in
    position order, in both packages alike."""
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=0,
                    capacity_factor=0.25)
    keep = _hold(run_both(cfg, 64, dtype, seed=5), cfg, dtype)
    assert not keep.all()


@pytest.mark.parametrize(("E", "K", "cf"), [(128, 8, 1.25), (64, 6, 1.25),
                                            (4, 2, 1.25), (4, 2, 0.25),
                                            (8, 1, 4.0), (16, 4, 1.0)])
def test_moe_capacity_formula_matches_jax(E, K, cf):
    cfg = MoEConfig(n_experts=E, top_k=K, capacity_factor=cf)
    jcfg = JMoEConfig(n_experts=E, top_k=K, capacity_factor=cf)
    for S in (1, 2, 3, 7, 32, 100, 2048, 4096):
        assert moe._capacity(S, cfg) == jmoe._capacity(S, jcfg)
    assert moe._capacity(1, cfg) == 1


def test_router_aux_loss_balanced_vs_skewed_matches_jax():
    cfg = MoEConfig(n_experts=8, top_k=1, d_ff_expert=16, n_shared=0,
                    router_aux_weight=1.0, capacity_factor=4.0)
    p = _params(cfg, 32, 0)
    bal = run_both(cfg, 32, "float32", B=4, S=64, p=p)
    _hold(bal, cfg, "float32", S=64)
    skew_router = np.zeros_like(p["router"])
    skew_router[:, 0] = 5.0
    skew = run_both(cfg, 32, "float32", B=4, S=64,
                    p=dict(p, router=skew_router))
    _hold(skew, cfg, "float32", S=64)
    assert skew[3] > bal[3] * 1.5
    assert 0.5 < bal[3] < 2.0


@pytest.mark.parametrize("k", [1, 3, 4])
def test_top_k_breaks_ties_as_lax_top_k(k):
    """Equal probabilities pick the lower expert first, as ``lax.top_k``
    does: a router of zeros (all equal), and rows of repeated values."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                      [0.1, 0.3, 0.1, 0.3, 0.1, 0.1],
                      [0.0, 0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.5, 0.1, 0.1, 0.1, 0.1, 0.1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    cfg = MoEConfig(n_experts=8, top_k=k, d_ff_expert=16, n_shared=0,
                    capacity_factor=4.0)
    p = dict(_params(cfg, 16, 2), router=np.zeros((16, 8), np.float32))
    res = run_both(cfg, 16, "float32", p=p)
    np.testing.assert_array_equal(res[5]["eidx"].numpy(),
                                  res[4]["eidx"].numpy())
    np.testing.assert_array_equal(res[5]["eidx"][0, 0].numpy(), np.arange(k))
    _hold(res, cfg, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(("E", "K", "shared"), [(64, 6, 2), (128, 8, 0)])
def test_moe_full_width_expert_counts_match_jax(dtype, E, K, shared):
    """deepseek-v2-lite's 64 routed experts top-6 with 2 shared, and
    qwen3-moe's 128 top-8, at d = 64 and 16-wide experts."""
    cfg = MoEConfig(n_experts=E, top_k=K, d_ff_expert=16, n_shared=shared,
                    capacity_factor=1.25)
    _hold(run_both(cfg, 64, dtype, B=2, S=48, seed=7), cfg, dtype, S=48)


def test_moe_decode_shape_runs_every_expert():
    """At S = 1 (decode) C is 1: no assignment drops, and the output
    equals JAX's."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1)
    assert moe._capacity(1, cfg) == 1
    keep = _hold(run_both(cfg, 32, "float32", B=3, S=1, seed=9), cfg,
                 "float32", S=1)
    assert keep.all()


def test_forcing_takes_the_given_routing():
    """``moe.forcing`` on a run's own routing gives its output bit for
    bit; on that routing with each token's two experts swapped, the same
    function up to the order of the two-term sum (the gates follow the
    experts); on another input's routing the recording still shows the
    layer's own choice.  A forced routing left untaken raises."""
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=16)
    p = {k: torch.from_numpy(np.array(v))
         for k, v in _params(cfg, 32, 3).items()}
    x = torch.from_numpy(_x(2, 24, 32, 4))
    with moe.recording() as own:
        y, aux = moe.moe_forward(p, cfg, x)
    with moe.forcing(own):
        y_same, aux_same = moe.moe_forward(p, cfg, x)
    assert torch.equal(y_same, y) and torch.equal(aux_same, aux)
    swapped = [dict(own[0], eidx=own[0]["eidx"].flip(-1))]
    with moe.recording() as rec, moe.forcing(swapped):
        y_swap, _ = moe.moe_forward(p, cfg, x)
    torch.testing.assert_close(y_swap, y, rtol=1e-6, atol=1e-6)
    assert torch.equal(rec[0]["eidx"], own[0]["eidx"])
    with moe.recording() as other:
        moe.moe_forward(p, cfg, torch.from_numpy(_x(2, 24, 32, 5)))
    with moe.recording() as rec, moe.forcing(other):
        y_other, _ = moe.moe_forward(p, cfg, x)
    assert torch.equal(rec[0]["eidx"], own[0]["eidx"])
    assert not torch.equal(other[0]["eidx"], own[0]["eidx"])
    assert not torch.allclose(y_other, y)
    with pytest.raises(ValueError, match="not taken"):
        with moe.forcing(own + own):
            moe.moe_forward(p, cfg, x)
