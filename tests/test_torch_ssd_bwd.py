"""The gradient of the port's SSD scan (``repro_torch.kernels.ref.ssd_bwd``,
the plain version of the CUDA ``ssd_bwd``, and the autograd ``Function``
of ``ops.ssd``) against the JAX package, on the CPU.

JAX's train step differentiates ``ops.ssd``, which on the CPU is its
``ref.ssd_chunked`` (the Pallas kernel has no ``custom_vjp``), so the
reference is ``jax.vjp`` of JAX's ``ref.ssd_chunked`` on the same inputs,
made with numpy from a seed.

- A tie ``cum_i == cum_j`` inside the causal mask (dt = 0 on a span of
  rows) takes half the pair's gradient in JAX's ``minimum``; the port's
  autograd of its ``ref.ssd_chunked`` once passed all of it
  (``torch.clamp``) and put ``ddt`` off by a third of its scale.
- Tolerances (``ref.ssd_bwd_tolerance``: ``atol`` of each gradient's
  largest magnitude, ``rtol`` of each entry): float32 1e-4 and 1e-4 (both
  sum the same float32 terms in other orders; seen: under 2e-6 of
  scale).  On bf16 inputs the port computes in float32 from the rounded
  values, so it is held to JAX's float32 ``vjp`` on those values within
  one bf16 rounding of dx, dB and dC (1e-4 of scale, 1e-2 of each entry)
  and the float32 limit for ddt and dA; and to JAX's own bf16 ``vjp``
  within ``BF16_TOL`` plus twice JAX's distance between its bf16 and
  float32 runs, as the training tests hold bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ssd import RAGGED_CASES, SSD_CASES

from repro.kernels import ref as jref
from repro_torch.kernels import launch, ops, ref

BF16_TOL = 2e-2
NAMES = ("dx", "ddt", "dA", "dB", "dC")
# b, s, h, p, g, n, chunk: the tie case of the fault (ddt off by a third
# of its scale before torch.minimum), and a tie case over three chunks
TIE = (1, 32, 2, 8, 1, 8, 16)
TIE_CASES = [(1, 32, 2, 8, 1, 8, 16, "f32"), (2, 100, 4, 16, 2, 16, 32, "f32"),
             (2, 100, 4, 16, 2, 16, 32, "bf16")]


def _inputs(b, s, h, p, g, n, chunk, seed=0, ties=False):
    """float32 ``(x, dt, A, B, C, dy, dstate)``; dt softplus'd, and with
    ``ties`` 0 on rows 3-6 and on the last chunk's first rows, so
    ``cum_i == cum_j`` there."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    if ties:
        last = (s - 1) // chunk * chunk
        dt[:, 3:7] = 0
        dt[:, last:last + 5] = 0
    A = (-np.exp(0.3 * r.standard_normal(h))).astype(np.float32)
    B = r.standard_normal((b, s, g, n)).astype(np.float32)
    C = r.standard_normal((b, s, g, n)).astype(np.float32)
    dy = r.standard_normal((b, s, h, p)).astype(np.float32)
    ds = r.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, dy, ds


def _bf16(a):
    """``a`` rounded to bf16, as float32 numpy."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _jax_grads(x, dt, A, B, C, dy, ds, chunk, dtype=jnp.float32):
    """``jax.vjp`` of JAX's ``ref.ssd_chunked``: (dx, ddt, dA, dB, dC) as
    float32 numpy; x, B, C and dy in ``dtype``, the state's cotangent
    ``ds`` (zero where None)."""
    args = (jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, dtype), jnp.asarray(C, dtype))
    (_, st), vjp = jax.vjp(lambda *a: jref.ssd_chunked(*a, chunk), *args)
    dst = jnp.zeros_like(st) if ds is None else jnp.asarray(ds)
    return [np.asarray(g, np.float32)
            for g in vjp((jnp.asarray(dy, dtype), dst))]


def _port(x, dt, A, B, C, dy, ds, chunk, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, dy)]
    for i in (0, 3, 4, 5):
        t[i] = t[i].to(dtype)
    return ref.ssd_bwd(*t, None if ds is None else torch.from_numpy(ds),
                       chunk)


def _hold(got, want, dtypes, extra=None):
    """Each gradient within ``ref.ssd_bwd_tolerance`` of its dtype
    (``extra``: a further share of scale per gradient)."""
    for i, (name, g, w, dt) in enumerate(zip(NAMES, got, want, dtypes,
                                             strict=True)):
        atol, rtol = ref.ssd_bwd_tolerance(dt)
        if extra is not None:
            atol += extra[i]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        scale = float(np.abs(w).max())
        err = np.abs(g - w) - (atol * scale + rtol * np.abs(w))
        assert err.max() <= 0, (name, float(np.abs(g - w).max()) / scale)


def _dist(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_tie_gradient_matches_jax():
    """The port's autograd of its ``ref.ssd_chunked`` at a tie (dt = 0 on
    rows 3-6): ``ddt`` as JAX's, where ``torch.clamp``'s gradient put it
    off by a third of its scale; and ``ref.ssd_bwd`` the same."""
    x, dt, A, B, C, dy, _ = _inputs(*TIE, ties=True)
    want = _jax_grads(x, dt, A, B, C, dy, None, TIE[-1])
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y, _ = ref.ssd_chunked(*ins, TIE[-1])
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    f32 = [torch.float32] * 5
    _hold(got, want, f32)
    _hold(_port(x, dt, A, B, C, dy, None, TIE[-1]), want, f32)


@pytest.mark.parametrize("dstate", [False, True])
@pytest.mark.parametrize("case", SSD_CASES + RAGGED_CASES + TIE_CASES)
def test_ssd_bwd_matches_jax_vjp(case, dstate):
    b, s, h, p, g, n, chunk, d = case
    x, dt, A, B, C, dy, ds = _inputs(b, s, h, p, g, n, chunk, seed=s,
                                     ties=case in TIE_CASES)
    ds = ds if dstate else None
    if d == "f32":
        got = _port(x, dt, A, B, C, dy, ds, chunk)
        _hold(got, _jax_grads(x, dt, A, B, C, dy, ds, chunk),
              [torch.float32] * 5)
        return
    x, B, C, dy = (_bf16(a) for a in (x, B, C, dy))
    got = _port(x, dt, A, B, C, dy, ds, chunk, torch.bfloat16)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    want32 = _jax_grads(x, dt, A, B, C, dy, ds, chunk)
    dtypes = [torch.bfloat16, torch.float32, torch.float32,
              torch.bfloat16, torch.bfloat16]
    _hold(got, want32, dtypes)
    want16 = _jax_grads(x, dt, A, B, C, dy, ds, chunk, jnp.bfloat16)
    for name, gt, w16, w32 in zip(NAMES, got, want16, want32, strict=True):
        err = _dist(gt.float().numpy(), w16)
        assert err <= BF16_TOL + 2 * _dist(w16, w32), name


@pytest.mark.parametrize("case", [(2, 100, 4, 16, 2, 16, 32, "f32", False),
                                  (2, 100, 4, 16, 2, 16, 32, "f32", True),
                                  (1, 64, 4, 32, 2, 32, 32, "bf16", False)])
def test_ops_ssd_under_autograd_is_the_function(case):
    """``ops.ssd`` under autograd on the CPU is `_SSD` (``ref.ssd_bwd``),
    held to torch's autograd through the port's ``ref.ssd_chunked``: the
    gradient of y alone and of y and the final state; nothing launches."""
    b, s, h, p, g, n, chunk, d, ties = case
    arrays = _inputs(b, s, h, p, g, n, chunk, seed=7, ties=ties)
    dtype = torch.float32 if d == "f32" else torch.bfloat16
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4, 5):
        t[i] = t[i].to(dtype)
    dy, ds = t[5], t[6]
    before = dict(launch.launches)
    for with_ds in (False, True):
        got_in = [a.clone().requires_grad_() for a in t[:5]]
        want_in = [a.clone().requires_grad_() for a in t[:5]]
        y, st = ops.ssd(*got_in, chunk=chunk)
        yw, stw = ref.ssd_chunked(*want_in, chunk)
        outs, cots = ((y, st), (dy, ds)) if with_ds else ((y,), (dy,))
        got = torch.autograd.grad(outs, got_in, cots)
        want = torch.autograd.grad((yw, stw)[:len(outs)], want_in, cots)
        direct = ref.ssd_bwd(*t[:5], dy, ds if with_ds else None, chunk)
        for gt, dr in zip(got, direct, strict=True):
            assert torch.equal(gt, dr)
        # bf16: autograd rounds the scores and their gradient to bf16
        # where the plain backward keeps float32
        extra = None if d == "f32" else [BF16_TOL] * 5
        _hold(got, [w.float().numpy() for w in want],
              [a.dtype for a in t[:5]], extra)
    assert launch.launches == before


def test_ssd_function_gradcheck():
    """``gradcheck`` of ``ops.ssd`` (`_SSD`) in float64 at a tiny shape:
    a ragged s over three chunks, ties, y and the final state."""
    x, dt, A, B, C, _, _ = _inputs(1, 10, 2, 4, 1, 4, 4, seed=3, ties=True)
    ins = [torch.from_numpy(a).double().requires_grad_()
           for a in (x, dt, A, B, C)]
    assert torch.autograd.gradcheck(lambda *a: ops.ssd(*a, chunk=4), ins)


@pytest.mark.parametrize("ties", [False, True])
def test_planted_faults_fail_the_tolerance(ties):
    """Each ``ref.ssd_bwd_fault`` fails ``ref.ssd_bwd_within`` (the tie
    rule's only where there are ties, and it passes without them)."""
    arrays = _inputs(2, 100, 4, 16, 2, 16, 32, seed=9, ties=ties)
    t = [torch.from_numpy(a) for a in arrays]
    want = ref.ssd_bwd(*t, 32)
    for fault in ref.SSD_BWD_FAULTS:
        bad = ref.ssd_bwd_fault(*t, 32, fault)
        assert [b.shape for b in bad] == [w.shape for w in want]
        caught = not ref.ssd_bwd_within(bad, want)
        assert caught == (fault != "no_tie_rule" or ties), fault
    with pytest.raises(ValueError, match="unknown SSD backward fault"):
        ref.ssd_bwd_fault(*t, 32, "no_such_fault")
