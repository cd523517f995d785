"""Training in the port (``repro_torch.train``, ``launch.train`` and the
gradient of attention) against the JAX package, on the CPU.

- The gradient of attention: the port's ``ref.attention_bwd`` (the plain
  version of the CUDA ``flash_attention_bwd``, the flash recompute from
  the forward's ``lse``) against ``jax.vjp`` of JAX's ``ref.attention``
  (what JAX's train step differentiates), on the same inputs made with
  numpy from a seed; and the autograd ``Function`` of ``ops.attention``
  on the CPU against it and against torch's autograd through the port's
  ``ref.attention``; ``gradcheck`` in float64.  Tolerances, of each
  gradient's largest magnitude: float32 1e-5 (both sum the same float32
  terms in other orders; seen: 1e-6); bfloat16 2e-2 (JAX's autodiff
  rounds P to bf16 inside its blocked scan and takes dP and dS through
  the casts, the port rounds P and dS once each: seen up to 8e-3).
- qwen3-0.6b's smoke config with JAX's weights carried across
  (``convert.model_params_from_jax``), float32 and bfloat16 compute: the
  loss and every gradient leaf against ``jax.value_and_grad`` of JAX's
  ``make_loss_fn``; 3 steps of ``make_train_step`` with ``sgd`` (every
  parameter), with ``adamw`` (loss and ``grad_norm``), SSP with a FIFO
  of 2 (``apply_scale`` and the parameters of each step),
  ``make_accum_train_step`` with 2 microbatches, and a resume from
  ``convert.train_state_from_jax`` after 2 JAX steps.  Tolerances, of
  each tensor's largest magnitude: float32 ``F32_TOL``; bfloat16
  ``BF16_TOL`` plus twice ``d``, JAX's own distance between its bf16 and
  its float32 run of the same quantity, as the serving tests hold bf16
  logits: XLA keeps float32 inside fused bf16 chains where torch rounds
  each op.  The parameters after a step are held by how far the steps
  moved them (``MOVE_TOL``, plus a float32 rounding of the parameter a
  step), since they are ~100x larger than the moves.
- remat on and off give the same bits in the port; ``launch.train.main``
  against JAX's ``repro.launch.train.main`` with the same flags (the loss
  of each logged step), and ``--checkpoint-dir`` writes a ``final.npz``
  that restores.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_memory_models import CPU_DRAW_CHUNK, jax_init, jax_params
from torch_routing import RoutingTap, jax_routing_tap  # noqa: F401

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.launch import train as jlaunch
from repro.models.registry import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro.psdist import grad_sync as jgs
from repro.train import state as jstate
from repro_torch import rng
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_jax, train_state_from_jax
from repro_torch.data.synthetic import TokenGenConfig, token_batch
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe
from repro_torch.optim import optimizers as topt
from repro_torch.psdist import grad_sync as tgs
from repro_torch.train import state as tstate

ARCH = "qwen3-0.6b"
B, S = 2, 40
F32_TOL = 2e-5
BF16_TOL = 2e-2
# float32 moves of the parameters over 3 steps: each step's gradient is
# taken at parameters an ulp apart, and the smoke model at JAX's init
# (logits of std ~16) carries that on (seen: 3e-5 after 2 steps)
MOVE_TOL = 1e-4
GRAD_TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


# ---------------------------------------------------------------------------
# the gradient of attention
# ---------------------------------------------------------------------------
# B, Sq, Sk, H, Hkv, D, causal, window, positions: causal and not, a
# window, masked keys (kv_pos < 0), rows that see no key ("late_keys"),
# rep 1, 2 and 4, head sizes 64 and 128 (the wgmma kernels'), ragged Sq !=
# Sk; then the mma.sync sizes, D as (Dk, Dv) with a separate V:
# stablelm-3b's (80, 80) and the test sizes (32, 16), (32, 32)
ATTN_CASES = {
    "causal_rep2_d64": (2, 80, 80, 4, 2, 64, True, None, "arange"),
    "noncausal_rep1_d64": (1, 50, 90, 4, 4, 64, False, None, "arange"),
    "window_rep4_d128": (1, 100, 100, 8, 2, 128, True, 17, "arange"),
    "holes_rep2_d64": (2, 70, 70, 4, 2, 64, True, None, "holes"),
    "late_keys_d128": (1, 60, 60, 4, 2, 128, True, None, "late_keys"),
    "ragged_rep4_d128": (1, 33, 75, 4, 1, 128, True, None, "arange"),
    "causal_rep1_d80_80": (2, 45, 45, 4, 4, (80, 80), True, None, "arange"),
    "window_holes_rep2_d32_16": (1, 60, 70, 4, 2, (32, 16), True, 11,
                                 "holes"),
    "noncausal_late_keys_rep4_d32_32": (1, 40, 52, 8, 2, (32, 32), True,
                                        None, "late_keys"),
}


def head_dims(D):
    """``(Dk, Dv)`` of an `ATTN_CASES` head size."""
    return D if isinstance(D, tuple) else (D, D)


def attn_case(B_, Sq, Sk, H, Hkv, D, positions, seed=0):
    """``(q, k, v, dout, q_pos, kv_pos)`` as numpy arrays."""
    Dk, Dv = head_dims(D)
    r = np.random.default_rng(seed)
    q = r.standard_normal((B_, Sq, H, Dk)).astype(np.float32)
    k = r.standard_normal((B_, Sk, Hkv, Dk)).astype(np.float32)
    v = r.standard_normal((B_, Sk, Hkv, Dv)).astype(np.float32)
    do = r.standard_normal((B_, Sq, H, Dv)).astype(np.float32)
    qp = np.ascontiguousarray(np.broadcast_to(np.arange(Sk - Sq, Sk),
                                              (B_, Sq)), dtype=np.int32)
    kp = np.broadcast_to(np.arange(Sk), (B_, Sk)).astype(np.int32).copy()
    if positions == "holes":
        kp[:, r.choice(Sk, Sk // 4, replace=False)] = -1
    elif positions == "late_keys":      # the first 5 queries see no key
        kp += 5 + Sk - Sq
    return q, k, v, do, qp, kp


def _close(got, want, tol):
    """Within ``tol`` of ``want``'s largest magnitude."""
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                   jnp.asarray(got, jnp.float32), np.float32)
    w = np.asarray(want.float() if isinstance(want, torch.Tensor) else
                   jnp.asarray(want, jnp.float32), np.float32)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, (err / scale, tol)


def _port_grads(q, k, v, do, qp, kp, dt, **kw):
    t = [torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v, do)]
    qp_t, kp_t = torch.from_numpy(qp), torch.from_numpy(kp)
    out, lse = ref.attention_lse(*t[:3], q_pos=qp_t, kv_pos=kp_t, **kw)
    return out, lse, ref.attention_bwd(*t[:3], out, lse, t[3], q_pos=qp_t,
                                       kv_pos=kp_t, **kw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_bwd_matches_jax_vjp(case, dt):
    B_, Sq, Sk, H, Hkv, D, causal, window, kind = ATTN_CASES[case]
    q, k, v, do, qp, kp = attn_case(B_, Sq, Sk, H, Hkv, D, kind)
    kw = dict(scale=1.0 / np.sqrt(head_dims(D)[0]), causal=causal,
              window=window)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention(
        q, k, v, q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp), kv_chunk=32,
        **kw), *(jnp.asarray(a, JDT[dt]) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, JDT[dt]))
    _, lse, got = _port_grads(q, k, v, do, qp, kp, dt, **kw)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == TDT[dt]
        _close(g, w, GRAD_TOL[dt])
    if kind == "late_keys":     # a row that sees no key: lse +inf, no grad
        assert torch.isinf(lse[:, :, :5]).all()
        assert not got[0][:, :5].any()


@pytest.mark.parametrize("case", ["causal_rep2_d64", "window_rep4_d128",
                                  "late_keys_d128"])
def test_attention_function_matches_autograd_of_plain_version(case):
    """``ops.attention`` under autograd on the CPU (the `_Attention`
    Function: ``ref.attention_lse`` forward, ``ref.attention_bwd``
    backward) against torch's autograd through ``ref.attention``, in
    float64 (exact but for rounding), and its output bit-equal to the
    call without a gradient."""
    B_, Sq, Sk, H, Hkv, D, causal, window, kind = ATTN_CASES[case]
    q, k, v, do, qp, kp = attn_case(B_, Sq, Sk, H, Hkv, D, kind)
    kw = dict(scale=1.0 / np.sqrt(head_dims(D)[0]), q_pos=torch.from_numpy(qp),
              kv_pos=torch.from_numpy(kp), causal=causal, window=window)
    ins = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    out = ops.attention(*ins, **kw)
    assert out.grad_fn is not None and "_Attention" in type(
        out.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(out, ops.attention(*ins, **kw))
    dout = torch.from_numpy(do).double()
    got = torch.autograd.grad(out, ins, dout)
    want = torch.autograd.grad(ref.attention(*ins, **kw), ins, dout)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_attention_function_gradcheck():
    """``torch.autograd.gradcheck`` of ``ops.attention`` in float64
    (causal, a window, a masked key, GQA rep 2)."""
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal(s)).requires_grad_()
               for s in ((1, 6, 4, 8), (1, 7, 2, 8), (1, 7, 2, 8)))
    qp = torch.arange(1, 7, dtype=torch.int32)[None]
    kp = torch.arange(7, dtype=torch.int32)[None].clone()
    kp[0, 2] = -1
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.attention(q, k, v, scale=0.4, q_pos=qp,
                                      kv_pos=kp, causal=True, window=4),
        (q, k, v))


def test_planted_backward_faults_move_the_gradient():
    """`ref.attention_bwd_fault`'s faults, which the card's check must
    catch, are outside ``ref.attention_bwd_tolerance`` on a CPU case."""
    q, k, v, do, qp, kp = attn_case(1, 192, 192, 4, 2, 64, "arange")
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    kw = dict(scale=0.125, q_pos=torch.from_numpy(qp),
              kv_pos=torch.from_numpy(kp), causal=True, window=None)
    out, lse = ref.attention_lse(*t[:3], **kw)
    want = ref.attention_bwd(*t[:3], out, lse, t[3], **kw)
    atol, rtol = ref.attention_bwd_tolerance(torch.bfloat16)
    for fault in ("d_zero", "dropped_tile"):
        bad = ref.attention_bwd_fault(*t[:3], out, lse, t[3], fault=fault,
                                      **kw)
        assert any(bool(((b.float() - w.float()).abs()
                         > atol * w.float().abs().max()
                         + rtol * w.float().abs()).any())
                   for b, w in zip(bad, want, strict=True)), fault


def test_ssd_under_grad_on_the_cpu_differentiates_the_plain_version():
    """On the CPU ``ops.ssd`` under autograd goes through ``ops._SSD``,
    whose backward is the plain ``ref.ssd_bwd`` (the card's is the CUDA
    ``ssd_bwd``: ``test_torch_kernels.py``); its gradient is autograd's
    of the port's ``ref.ssd_chunked``.  B and C are one tensor here, so
    its gradient is the sum of both."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((1, 16, 2, 4)).astype(
        np.float32)).requires_grad_()
    dt = torch.full((1, 16, 2), 0.1)
    A = -torch.ones(2)
    Bm = torch.from_numpy(r.standard_normal((1, 16, 1, 8)).astype(
        np.float32)).requires_grad_()
    y, _ = ops.ssd(x, dt, A, Bm, Bm, chunk=8)
    assert y.grad_fn.name() == "_SSDBackward"
    g = torch.autograd.grad(y.sum(), (x, Bm))
    w = torch.autograd.grad(ref.ssd_chunked(x, dt, A, Bm, Bm, 8)[0].sum(),
                            (x, Bm))
    for a, b in zip(g, w, strict=True):
        assert torch.isfinite(a).all() and a.abs().sum() > 0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# qwen3-0.6b's smoke config: JAX's train step against the port's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax_init(ARCH, 1)


@functools.lru_cache(maxsize=None)
def _jax_model(compute):
    return jax_build_model(jax_smoke_config(ARCH).replace(
        compute_dtype=compute))


def _port_model(compute, remat=False):
    cfg = get_smoke_config(ARCH).replace(compute_dtype=compute, remat=remat)
    return model_params_from_jax(cfg, _jax_params(), device="cpu")


@functools.lru_cache(maxsize=None)
def _tokens(step=0, batch=B):
    return token_batch(TokenGenConfig(
        vocab_size=get_smoke_config(ARCH).vocab_size, seq_len=S,
        batch=batch, seed=3), step, device="cpu")


def _jbatch(step=0, batch=B):
    return {"tokens": jnp.asarray(_tokens(step, batch).numpy())}


def _tbatch(step=0, batch=B):
    return {"tokens": _tokens(step, batch).clone()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(compute):
    fn = jax.jit(jax.value_and_grad(jstate.make_loss_fn(_jax_model(
        compute))))
    loss, grads = fn(jax.tree.map(jnp.asarray, _jax_params()), _jbatch())
    return float(loss), jax.tree.map(np.asarray, grads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy().copy()}
    return {prefix: np.asarray(jnp.asarray(tree, jnp.float32))}


def _dist(a, b) -> float:
    """``max|a - b|`` over ``max|b|``."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _hold(got, want, compute, want32=None, floor=None, tol32=F32_TOL):
    """Every leaf of ``got`` within the tolerance of ``want`` (flat
    dicts): ``tol32`` of its largest magnitude in float32; for bf16
    ``BF16_TOL + 2 d``, ``d`` JAX's bf16 run's distance from its float32
    run (``want32``) per leaf.  ``floor`` (per leaf, absolute) is added:
    a parameter's own rounding, when the moves of parameters are held."""
    assert set(got) == set(want)
    for path in want:
        tol = tol32
        if compute == "bfloat16":
            tol = BF16_TOL + 2 * _dist(want[path], want32[path])
        scale = max(float(np.abs(want[path]).max()), 1e-30)
        err = float(np.abs(got[path] - want[path]).max())
        extra = 0.0 if floor is None else floor[path]
        assert err <= tol * scale + extra, (path, err / scale, tol)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_and_every_gradient_leaf_match_jax(compute):
    jl, jg = _jax_value_and_grad(compute)
    jl32, jg32 = _jax_value_and_grad("float32")
    model = _port_model(compute)
    tl, tg = tstate.value_and_grad(tstate.make_loss_fn(model), model.params,
                                   _tbatch())
    assert tl.dtype == torch.float32
    ltol = F32_TOL if compute == "float32" else BF16_TOL + 2 * abs(
        jl - jl32) / abs(jl32)
    assert abs(float(tl) - jl) <= ltol * abs(jl)
    _hold(_flat(tg), _flat(jg), compute, want32=_flat(jg32))
    # the module's own parameters take no gradient and are unchanged
    assert all(not p.requires_grad and p.grad is None
               for p in model.parameters())


def _jax_state(opt, sync):
    params = jax.tree.map(jnp.asarray, _jax_params())
    return jstate.TrainState(params=params, opt_state=opt.init(params),
                             fifo=jgs.init_fifo(sync, params),
                             step=jnp.zeros((), jnp.int32))


@functools.lru_cache(maxsize=None)
def _jax_run(compute, opt_name, staleness=0, steps=3, accum=1):
    """JAX's train step from `_jax_params` over ``steps`` batches: per
    step the metrics and the params (numpy), and the states (JAX)."""
    opt = _OPTS[opt_name][0]()
    sync = jgs.GradSync("ssp" if staleness else "bsp", staleness)
    model = _jax_model(compute)
    fn = jax.jit(jstate.make_accum_train_step(model, opt, sync, accum=accum))
    state = _jax_state(opt, sync)
    out = []
    for i in range(steps):
        batch = _jbatch(i, B * accum)
        if accum > 1:
            batch = {k: v.reshape(accum, B, *v.shape[1:])
                     for k, v in batch.items()}
        state, m = fn(state, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    _flat(jax.tree.map(np.asarray, state.params)), state))
    return out


_OPTS = {"sgd": (lambda: jopt.sgd(0.05), lambda: topt.sgd(0.05)),
         "adamw": (lambda: jopt.adamw(jopt.cosine_schedule(3e-3, 1, 3)),
                   lambda: topt.adamw(topt.cosine_schedule(3e-3, 1, 3)))}


def _port_run(compute, opt_name, staleness=0, steps=3, accum=1,
              state=None, model=None, first=0):
    opt = _OPTS[opt_name][1]()
    sync = tgs.GradSync("ssp" if staleness else "bsp", staleness)
    if model is None:
        model = _port_model(compute)
    step_fn = tstate.make_accum_train_step(model, opt, sync, accum=accum)
    if state is None:
        state = tstate.init_state(model, opt, sync)
    out = []
    for i in range(first, steps):
        batch = _tbatch(i, B * accum)
        if accum > 1:
            batch = {k: v.reshape(accum, B, *v.shape[1:])
                     for k, v in batch.items()}
        state, m = step_fn(state, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    _flat(state.params)))
    return out


def _moves(params):
    """How far training moved each parameter from JAX's initial one (what
    the steps changed; the parameters themselves are ~100x larger)."""
    init = _flat(_jax_params())
    return {k: v - init[k] for k, v in params.items()}


def _hold_moves(got, want, compute, steps, want32=None):
    """The moves of every parameter (`_moves`) within ``MOVE_TOL`` (float32)
    or the bf16 bound of their largest magnitude, plus ``steps`` float32
    roundings of the parameter's largest magnitude (each step rounds
    ``p + u``, and the move is read back from the rounded sum)."""
    init = _flat(_jax_params())
    floor = {k: steps * np.finfo(np.float32).eps * float(np.abs(v).max())
             for k, v in init.items()}
    _hold(_moves(got), _moves(want), compute,
          None if want32 is None else _moves(want32), floor, MOVE_TOL)


def _metric_tol(compute, want, want32):
    if compute == "float32":
        return F32_TOL
    return BF16_TOL + 2 * abs(want - want32) / max(abs(want32), 1e-30)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_sgd_steps_match_jax_in_every_parameter(compute):
    want = _jax_run(compute, "sgd")
    want32 = _jax_run("float32", "sgd")
    got = _port_run(compute, "sgd")
    for i, ((gm, gp), (wm, wp, _), (wm32, wp32, _)) in enumerate(zip(
            got, want, want32, strict=True)):
        for name in ("loss", "grad_norm"):
            tol = _metric_tol(compute, wm[name], wm32[name])
            assert abs(gm[name] - wm[name]) <= tol * abs(wm[name]), name
        assert gm["apply_scale"] == wm["apply_scale"] == 1.0
        _hold_moves(gp, wp, compute, i + 1, want32=wp32)


def test_adamw_steps_match_jax():
    """AdamW with the launcher's cosine schedule (float32): the loss and
    ``grad_norm`` of each step."""
    want = _jax_run("float32", "adamw")
    got = _port_run("float32", "adamw")
    for (gm, _), (wm, _, _) in zip(got, want, strict=True):
        for name in ("loss", "grad_norm"):
            assert abs(gm[name] - wm[name]) <= 1e-4 * abs(wm[name]), name


def test_ssp_fifo_steps_match_jax():
    """``GradSync("ssp", 2)``: nothing applied for 2 steps (the params
    stay the initial ones), then the gradient of 2 steps before."""
    want = _jax_run("float32", "sgd", staleness=2, steps=4)
    got = _port_run("float32", "sgd", staleness=2, steps=4)
    init = _flat(_jax_params())
    for i, ((gm, gp), (wm, wp, _)) in enumerate(zip(got, want, strict=True)):
        assert gm["apply_scale"] == wm["apply_scale"] == float(i >= 2)
        assert abs(gm["loss"] - wm["loss"]) <= F32_TOL * abs(wm["loss"])
        if i < 2:
            assert all(np.array_equal(gp[k], init[k]) for k in init)
        else:
            _hold_moves(gp, wp, "float32", i - 1)


def test_accum_steps_match_jax():
    """``make_accum_train_step`` with 2 microbatches (float32)."""
    want = _jax_run("float32", "sgd", steps=2, accum=2)
    got = _port_run("float32", "sgd", steps=2, accum=2)
    for i, ((gm, gp), (wm, wp, _)) in enumerate(zip(got, want,
                                                    strict=True)):
        assert abs(gm["loss"] - wm["loss"]) <= F32_TOL * abs(wm["loss"])
        _hold_moves(gp, wp, "float32", i + 1)


def test_resume_from_jax_train_state():
    """JAX's AdamW run, stopped after 2 steps and carried across with
    ``convert.train_state_from_jax`` (params, m, v, step), continues in
    the port as it does in JAX."""
    want = _jax_run("float32", "adamw", steps=3)
    mid = jax.tree.map(np.asarray, want[1][2])
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32",
                                         remat=False)
    model, state = train_state_from_jax(cfg, mid, device="cpu")
    assert int(state.step) == 2 and int(state.opt_state["step"]) == 2
    got = _port_run("float32", "adamw", steps=3, state=state, model=model,
                    first=2)
    (gm, gp), (wm, wp, _) = got[0], want[2]
    assert abs(gm["loss"] - wm["loss"]) <= F32_TOL * abs(wm["loss"])
    _hold_moves(gp, wp, "float32", 3)


def test_remat_is_bit_equal_in_the_port():
    """``cfg.remat`` (each block under ``torch.utils.checkpoint``) gives
    the same loss and gradients, bit for bit, as without it."""
    out = []
    for remat in (False, True):
        model = _port_model("bfloat16", remat=remat)
        out.append(tstate.value_and_grad(tstate.make_loss_fn(model),
                                         model.params, _tbatch()))
    assert torch.equal(out[0][0], out[1][0])
    a, b = _flat(out[0][1]), _flat(out[1][1])
    assert all(np.array_equal(a[k], b[k]) for k in a)


ARGV = ["--arch", ARCH, "--steps", "4", "--batch", "2", "--seq", "32",
        "--log-every", "2", "--lr", "1e-3"]


def test_launcher_matches_jax(tmp_path, monkeypatch):
    """``launch.train.main`` on the CPU against JAX's ``main`` with the
    same flags (bf16 compute, the smoke config's): the loss of each logged
    step, within ``BF16_TOL``; ``--checkpoint-dir`` writes ``final.npz``,
    which restores into the model's parameter tree."""
    monkeypatch.setattr(rng, "_CHUNK", CPU_DRAW_CHUNK)
    want = jlaunch.main(list(ARGV))
    got = tlaunch.main(ARGV + ["--device", "cpu", "--checkpoint-dir",
                               str(tmp_path)])
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 4]
    for g, w in zip(got, want, strict=True):
        assert abs(g["loss"] - w["loss"]) <= BF16_TOL * abs(w["loss"])
    model = tlaunch.build_model(get_smoke_config(ARCH), seed=0,
                                device="cpu")
    back = ckpt.restore(str(tmp_path / "final.npz"), model.params)
    assert set(_flat(back)) == set(_flat(model.params))
    assert (tmp_path / "history.json").is_file()


# ---------------------------------------------------------------------------
# mamba2-130m's and Jamba's smoke configs: the gradient through the SSD
# scan (`ops._SSD`, ``ref.ssd_bwd`` on the CPU) against JAX's autodiff
# ---------------------------------------------------------------------------
SSM_ARCH, HYBRID_ARCH = "mamba2-130m", "jamba-1.5-large-398b"


@functools.lru_cache(maxsize=None)
def _arch_params(arch):
    """JAX's init of ``arch``'s smoke config: mamba2's as drawn, Jamba's
    with its q/k/v projections at ``1/sqrt(d)`` (`jax_params`), whose
    attention at JAX's init is near one-hot."""
    return jax_init(arch, 1) if arch == SSM_ARCH else jax_params(arch, 1)


def _arch_batch(arch, step=0):
    return token_batch(TokenGenConfig(
        vocab_size=get_smoke_config(arch).vocab_size, seq_len=S, batch=B,
        seed=3), step, device="cpu")


@functools.lru_cache(maxsize=None)
def _arch_value_and_grad(arch, compute):
    """JAX's loss and gradient (numpy) of ``arch``'s smoke config in
    ``compute``, and the routing its MoE layers took (``RoutingTap``)."""
    model = jax_build_model(jax_smoke_config(arch).replace(
        compute_dtype=compute))
    fn = jax.jit(jax.value_and_grad(jstate.make_loss_fn(model)))
    with RoutingTap(B) as tap:
        loss, grads = fn(jax.tree.map(jnp.asarray, _arch_params(arch)),
                         {"tokens": jnp.asarray(_arch_batch(arch).numpy())})
        loss = float(loss)
    return loss, _flat(jax.tree.map(np.asarray, grads)), tap.jax


def _arch_port(arch, compute):
    cfg = get_smoke_config(arch).replace(compute_dtype=compute)
    return model_params_from_jax(cfg, _arch_params(arch), device="cpu")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [SSM_ARCH, HYBRID_ARCH])
def test_ssd_archs_loss_and_every_gradient_leaf_match_jax(arch, compute):
    """The loss and every gradient leaf of mamba2-130m's and Jamba's smoke
    configs (the mamba sublayers' through `ops._SSD`) against JAX's; the
    port's MoE layers take JAX's routing (``moe.forcing``), a router near
    tie being a rounding decision."""
    jl, jg, route = _arch_value_and_grad(arch, compute)
    jl32, jg32, _ = _arch_value_and_grad(arch, "float32")
    model = _arch_port(arch, compute)
    with moe.forcing(route or None):
        tl, tg = tstate.value_and_grad(tstate.make_loss_fn(model),
                                       model.params,
                                       {"tokens": _arch_batch(arch)})
    assert bool(route) == (arch == HYBRID_ARCH)
    ltol = F32_TOL if compute == "float32" else BF16_TOL + 2 * abs(
        jl - jl32) / abs(jl32)
    assert abs(float(tl) - jl) <= ltol * abs(jl)
    _hold(_flat(tg), jg, compute, want32=jg32)


@functools.lru_cache(maxsize=None)
def _ssm_jax_sgd(compute, steps=3):
    """JAX's SGD steps of mamba2-130m's smoke config: per step the
    metrics and the params (numpy)."""
    model = jax_build_model(jax_smoke_config(SSM_ARCH).replace(
        compute_dtype=compute))
    opt, sync = jopt.sgd(0.05), jgs.GradSync("bsp", 0)
    fn = jax.jit(jstate.make_train_step(model, opt, sync))
    params = jax.tree.map(jnp.asarray, _arch_params(SSM_ARCH))
    state = jstate.TrainState(params=params, opt_state=opt.init(params),
                              fifo=jgs.init_fifo(sync, params),
                              step=jnp.zeros((), jnp.int32))
    out = []
    for i in range(steps):
        state, m = fn(state, {"tokens": jnp.asarray(
            _arch_batch(SSM_ARCH, i).numpy())})
        out.append(({k: float(v) for k, v in m.items()},
                    _flat(jax.tree.map(np.asarray, state.params))))
    return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_ssm_sgd_steps_match_jax_in_every_parameter(compute):
    """3 SGD steps of mamba2-130m's smoke config: the loss, ``grad_norm``
    and how far each parameter moved, as `test_sgd_steps_match_jax_in_
    every_parameter` holds qwen3's."""
    want, want32 = _ssm_jax_sgd(compute), _ssm_jax_sgd("float32")
    model = _arch_port(SSM_ARCH, compute)
    opt = topt.sgd(0.05)
    step_fn = tstate.make_train_step(model, opt, tgs.GradSync())
    state = tstate.init_state(model, opt, tgs.GradSync())
    init = _flat(_arch_params(SSM_ARCH))
    for i, ((wm, wp), (wm32, wp32)) in enumerate(zip(want, want32,
                                                     strict=True)):
        state, m = step_fn(state, {"tokens": _arch_batch(SSM_ARCH, i)})
        for name in ("loss", "grad_norm"):
            tol = _metric_tol(compute, wm[name], wm32[name])
            assert abs(float(m[name]) - wm[name]) <= tol * abs(wm[name])
        floor = {k: (i + 1) * np.finfo(np.float32).eps
                 * float(np.abs(v).max()) for k, v in init.items()}
        _hold({k: v - init[k] for k, v in _flat(state.params).items()},
              {k: v - init[k] for k, v in wp.items()}, compute,
              {k: v - init[k] for k, v in wp32.items()}, floor, MOVE_TOL)

