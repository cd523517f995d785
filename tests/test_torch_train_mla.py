"""Training through MLA in the port against the JAX package, on the CPU.

- The gradient of attention with V as K's first Dv columns (MLA's latent
  values, ``ref.v_is_k_prefix``): ``ops.attention`` under autograd on the
  CPU (the `_Attention` Function, whose backward is ``ref.attention_bwd``
  with dV folded into dK's first columns) against ``jax.vjp`` of JAX's
  ``ref.attention`` taken through the key and its prefix, at MLA's
  published (576, 512) (16 heads over one KV head, 8 over two) and its
  smoke config's (80, 64), float32 and bf16, causal, a window, masked
  keys and rows that see no key, within ``GRAD_TOL``.
- The folded contract against the plain version's separate dK and dV:
  one bf16 rounding apart; the planted ``unfolded_dv`` fault fails the
  card's limit.
- deepseek-v2-lite-16b's smoke config (MLA at (80, 64), V as K's prefix,
  and MoE) on JAX's weights: the loss and every gradient leaf against
  ``jax.value_and_grad``, and 3 SGD steps in every parameter, in float32
  and bf16, on JAX's routing (``RoutingTap``, ``moe.forcing``), one JAX
  compile an arch and dtype.  Tolerances as `test_torch_train.py`'s.

The card's kernels at these head sizes are held in
``test_torch_kernels.py`` (``cuda``-marked; that module imports no JAX).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (BF16_TOL, F32_TOL, GRAD_TOL, JDT, MOVE_TOL,
                              TDT, _arch_batch, _arch_params, _arch_port,
                              _close, _flat, _hold, _metric_tol)
from torch_routing import RoutingTap, jax_routing_tap  # noqa: F401

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.models.registry import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro.train import state as jstate
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.optim import optimizers as topt
from repro_torch.psdist import grad_sync as tgs
from repro_torch.train import state as tstate

ARCH = "deepseek-v2-lite-16b"
B = 2

# B, Sq, Sk, H, Hkv, Dk, Dv, causal, window, positions: V is always K's
# first Dv columns
MLA_CASES = {
    "d576_h16_causal": (1, 40, 40, 16, 1, 576, 512, True, None, "arange"),
    "d576_h8_hkv2_window": (1, 48, 48, 8, 2, 576, 512, True, 13, "arange"),
    "d576_h16_holes": (2, 30, 30, 16, 1, 576, 512, True, None, "holes"),
    "d576_h8_hkv2_late_keys": (1, 36, 36, 8, 2, 576, 512, True, None,
                               "late_keys"),
    "d80_h4_causal": (2, 40, 40, 4, 1, 80, 64, True, None, "arange"),
    "d80_h4_window_holes": (1, 50, 50, 4, 1, 80, 64, True, 9, "holes"),
}


def mla_case(B_, Sq, Sk, H, Hkv, Dk, Dv, positions, seed=0):
    """``(q, k, dout, q_pos, kv_pos)`` as numpy arrays; V is ``k[...,
    :Dv]``."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B_, Sq, H, Dk)).astype(np.float32)
    k = r.standard_normal((B_, Sk, Hkv, Dk)).astype(np.float32)
    do = r.standard_normal((B_, Sq, H, Dv)).astype(np.float32)
    qp = np.ascontiguousarray(np.broadcast_to(np.arange(Sk - Sq, Sk),
                                              (B_, Sq)), dtype=np.int32)
    kp = np.broadcast_to(np.arange(Sk), (B_, Sk)).astype(np.int32).copy()
    if positions == "holes":
        kp[:, r.choice(Sk, Sk // 4, replace=False)] = -1
    elif positions == "late_keys":      # the first 5 queries see no key
        kp += 5 + Sk - Sq
    return q, k, do, qp, kp


def _mla_tensors(case, dt):
    B_, Sq, Sk, H, Hkv, Dk, Dv, causal, window, kind = MLA_CASES[case]
    q, k, do, qp, kp = mla_case(B_, Sq, Sk, H, Hkv, Dk, Dv, kind)
    kw = dict(scale=1.0 / np.sqrt(Dk), q_pos=torch.from_numpy(qp),
              kv_pos=torch.from_numpy(kp), causal=causal, window=window)
    q, k, do = (torch.from_numpy(a).to(TDT[dt]) for a in (q, k, do))
    return q, k, do, Dv, kw


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_attention_grad_matches_jax_vjp_through_the_key(case, dt):
    """``ops.attention(q, k, k[..., :Dv])`` under autograd: dq and the
    key's whole gradient (dK with dV folded in) against ``jax.vjp`` of
    JAX's ``ref.attention`` through ``(q, k)``, V taken as ``k[...,
    :Dv]`` inside the function."""
    B_, Sq, Sk, H, Hkv, Dk, Dv, causal, window, kind = MLA_CASES[case]
    q, k, do, qp, kp = mla_case(B_, Sq, Sk, H, Hkv, Dk, Dv, kind)
    scale = 1.0 / np.sqrt(Dk)
    _, vjp = jax.vjp(lambda q, k: jref.attention(
        q, k, k[..., :Dv], q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp),
        scale=scale, causal=causal, window=window, kv_chunk=32),
        *(jnp.asarray(a, JDT[dt]) for a in (q, k)))
    want = vjp(jnp.asarray(do, JDT[dt]))
    tq, tk, tdo, _, kw = _mla_tensors(case, dt)
    tq.requires_grad_()
    tk.requires_grad_()
    out = ops.attention(tq, tk, tk[..., :Dv], **kw)
    assert "_Attention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk), tdo)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == TDT[dt]
        _close(g, w, GRAD_TOL[dt])
    if kind == "late_keys":     # a row that sees no key: no gradient
        assert not got[0][:, :5].any()


@pytest.mark.parametrize("case", ["d576_h16_causal", "d576_h8_hkv2_window",
                                  "d80_h4_window_holes"])
def test_folded_contract_is_one_rounding_from_separate_dk_dv(case):
    """In bf16, ``ref.attention_bwd`` with V as K's prefix returns ``(dq,
    dk, None)``, dk within one bf16 rounding of the plain version's
    separate dK plus dV (V a copy) in dK's first Dv columns, and dq as
    close: each entry within 2^-7 of its magnitude (the outputs' own
    roundings, which may go either way) plus 2^-8 of the output's scale
    (dS rounded after the scale instead of before); the ``unfolded_dv``
    fault (dV left out) fails the card's limit,
    ``ref.attention_bwd_tolerance``."""
    q, k, do, Dv, kw = _mla_tensors(case, "bf16")
    v = k[..., :Dv]
    assert ref.v_is_k_prefix(k, v) and not ref.v_is_k_prefix(k, v.clone())
    out, lse = ref.attention_lse(q, k, v, **kw)
    dq, dk, dv = ref.attention_bwd(q, k, v, out, lse, do, **kw)
    assert dv is None and dk.shape == k.shape
    sq, sk, sv = ref.attention_bwd(q, k, v.clone(), out, lse, do, **kw)
    both = sk.float()
    both[..., :Dv] += sv.float()
    for got, want in ((dq, sq.float()), (dk, both)):
        bound = 2 ** -7 * want.abs() + 2 ** -8 * want.abs().max()
        assert bool(((got.float() - want).abs() <= bound).all())
    bad = ref.attention_bwd_fault(q, k, v, out, lse, do, fault="unfolded_dv",
                                  **kw)
    assert bad[2] is None and torch.equal(bad[0], dq)
    atol, rtol = ref.attention_bwd_tolerance(torch.bfloat16)
    w = dk.float()
    assert bool(((bad[1].float() - w).abs()
                 > atol * w.abs().max() + rtol * w.abs()).any())
    with pytest.raises(ValueError):
        ref.attention_bwd_fault(q, k, v.clone(), out, lse, do,
                                fault="unfolded_dv", **kw)


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b's smoke config: JAX's train step against the port's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_sgd_run(compute, steps=3, lr=0.05):
    """JAX's gradient at each of ``steps`` SGD steps of the smoke config
    from `_arch_params`, with ``make_train_step``'s update and metrics
    taken eagerly around one jitted ``value_and_grad``: per step the loss,
    ``grad_norm``, the gradient (step 1) and the params after it (numpy),
    and the routing its MoE layers took."""
    model = jax_build_model(jax_smoke_config(ARCH).replace(
        compute_dtype=compute))
    fn = jax.jit(jax.value_and_grad(jstate.make_loss_fn(model)))
    opt = jopt.sgd(lr)
    params = jax.tree.map(jnp.asarray, _arch_params(ARCH))
    ostate = opt.init(params)
    out = []
    for i in range(steps):
        with RoutingTap(B) as tap:
            loss, grads = fn(params, {"tokens": jnp.asarray(
                _arch_batch(ARCH, i).numpy())})
            loss = float(loss)
        gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(
            jnp.float32))) for g in jax.tree.leaves(grads))))
        updates, ostate = opt.update(grads, ostate, params)
        params = jopt.apply_updates(params, updates)
        out.append({"loss": loss, "grad_norm": gnorm, "route": tap.jax,
                    "grads": _flat(jax.tree.map(np.asarray, grads))
                    if i == 0 else None,
                    "params": _flat(jax.tree.map(np.asarray, params))})
    return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_deepseek_loss_and_every_gradient_leaf_match_jax(compute):
    """The loss and every gradient leaf of deepseek-v2-lite-16b's smoke
    config (MLA through `ops._Attention` with V as K's prefix, MoE on
    JAX's routing) against JAX's ``value_and_grad``."""
    want, want32 = _jax_sgd_run(compute)[0], _jax_sgd_run("float32")[0]
    assert want["route"]
    model = _arch_port(ARCH, compute)
    with moe.forcing(want["route"]):
        tl, tg = tstate.value_and_grad(tstate.make_loss_fn(model),
                                       model.params,
                                       {"tokens": _arch_batch(ARCH)})
    ltol = _metric_tol(compute, want["loss"], want32["loss"])
    assert abs(float(tl) - want["loss"]) <= ltol * abs(want["loss"])
    _hold(_flat(tg), want["grads"], compute, want32=want32["grads"])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_deepseek_sgd_steps_match_jax_in_every_parameter(compute):
    """3 SGD steps of deepseek-v2-lite-16b's smoke config on JAX's
    routing: the loss, ``grad_norm`` and how far each parameter moved, as
    `test_torch_train.py` holds qwen3's."""
    want, want32 = _jax_sgd_run(compute), _jax_sgd_run("float32")
    model = _arch_port(ARCH, compute)
    opt = topt.sgd(0.05)
    step_fn = tstate.make_train_step(model, opt, tgs.GradSync())
    state = tstate.init_state(model, opt, tgs.GradSync())
    init = _flat(_arch_params(ARCH))
    for i, (w, w32) in enumerate(zip(want, want32, strict=True)):
        with moe.forcing(w["route"]):
            state, m = step_fn(state, {"tokens": _arch_batch(ARCH, i)})
        for name in ("loss", "grad_norm"):
            tol = _metric_tol(compute, w[name], w32[name])
            assert abs(float(m[name]) - w[name]) <= tol * abs(w[name]), name
        floor = {k: (i + 1) * np.finfo(np.float32).eps
                 * float(np.abs(v).max()) for k, v in init.items()}
        _hold({k: v - init[k] for k, v in _flat(state.params).items()},
              {k: v - init[k] for k, v in w["params"].items()}, compute,
              {k: v - init[k] for k, v in w32["params"].items()}, floor,
              MOVE_TOL)
