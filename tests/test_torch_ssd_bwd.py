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

Then what the card's bf16 kernels rest on: ``ref.bf16_split3``, the
exact three-way bf16 split of a float32 operand that they mirror; their
chunk kernel's pair blocks, parsed from its source; and the bounds of
``chip_smoke.py`` (``ssd_bwd_bound``, ``ssd_bound``), which charge each
split product at three bf16 tensor-core passes.
"""
import importlib.util
import re
from fractions import Fraction
from pathlib import Path

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


# ---- the bf16 kernel's exact split, work order and bound ---------------------
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _split_sum(v):
    return sum(q.double() for q in ref.bf16_split3(v))


def test_bf16_split3_is_exact():
    """hi + mid + lo == v in float64, each a bf16 value, for float32 values
    of every exponent from 2^-110 up and for values at and beside bf16's
    rounding ties (a bf16 value plus half its ulp, and one float32 ulp
    either side)."""
    r = np.random.default_rng(5)
    v = (r.standard_normal(200_000) * np.exp2(
        r.integers(-109, 120, 200_000))).astype(np.float32)
    v = v[np.abs(v) >= 2.0 ** -110]
    base = r.standard_normal(20_000).astype(np.float32)
    base = torch.from_numpy(base).bfloat16().float()
    half = torch.from_numpy(np.exp2(np.floor(np.log2(
        np.abs(base.numpy()))) - 8).astype(np.float32))
    tie = base + half
    ulp = torch.from_numpy(np.spacing(np.abs(tie.numpy())).astype(np.float32))
    for t in (torch.from_numpy(v), tie, tie + ulp, tie - ulp,
              torch.tensor([2.0 ** -110, -(2.0 ** -110), 3.3e38, 0.0])):
        parts = ref.bf16_split3(t)
        assert all(q.dtype == torch.bfloat16 for q in parts)
        assert torch.equal(_split_sum(t), t.double())
    # the pieces step down by 8 bits: |mid| <= ulp_bf16(v) / 2, and so on
    hi, mid, lo = ref.bf16_split3(torch.from_numpy(v))
    assert bool((mid.double().abs() <= hi.double().abs() * 2.0 ** -8).all())
    assert bool((lo.double().abs() <= mid.double().abs() * 2.0 ** -8).all())


def test_bf16_split3_below_its_range():
    """Below 2^-110, down to e^-80 (the decays' range over a chunk), the
    split is off by at most 2^-133, bf16's least step."""
    r = np.random.default_rng(6)
    v = torch.from_numpy(np.exp(r.uniform(-80, -110 * np.log(2), 100_000))
                         .astype(np.float32))
    assert bool((v.double() < 2.0 ** -110).all())
    err = (_split_sum(v) - v.double()).abs().max().item()
    assert err <= 2.0 ** -133


def test_bf16_split3_products_are_exact():
    """A bf16 matrix times a float32 one is three bf16 products whose
    entries are exact in float32 and whose sum is the exact product (held
    in rationals)."""
    r = np.random.default_rng(7)
    a = torch.from_numpy(r.standard_normal((6, 16)).astype(np.float32))
    a = a.bfloat16()
    v = torch.from_numpy((r.standard_normal((16, 5))
                          * np.exp2(r.integers(-40, 40, (16, 5))))
                         .astype(np.float32))
    parts = ref.bf16_split3(v)
    for q in parts:    # each partial product exact in float32
        prod = a.float()[:, :, None] * q.float()[None]
        assert torch.equal(prod.double(),
                           a.double()[:, :, None] * q.double()[None])
    fa = [[Fraction(float(e)) for e in row] for row in a.float().tolist()]
    fv = [[Fraction(float(e)) for e in row] for row in v.tolist()]
    fq = [[[Fraction(float(e)) for e in row] for row in q.float().tolist()]
          for q in parts]
    for i in range(6):
        for j in range(5):
            want = sum(fa[i][k] * fv[k][j] for k in range(16))
            got = sum(fa[i][k] * q[k][j] for q in fq for k in range(16))
            assert got == want


def _passes(src):
    """The chunk kernel's three pair loops as ``(pass, lo, hi)`` bounds in
    row blocks, parsed from the source."""
    body = src.split("__global__ void __launch_bounds__(THREADS, 1) "
                     "ssd_bwd_chunk_tc(", 1)[1].split("\ncudaError_t", 1)[0]
    assert "const int rb = warp, r0 = 16 * rb;" in body
    loops = re.findall(r"for \(int (jb|ib) = (0|rb); (?:jb <= rb|16 \* ib < L)"
                       r"; \+\+(?:jb|ib)\)", body)
    return loops


@pytest.mark.parametrize("L", [16, 32, 48, 80, 128])
def test_chunk_kernel_takes_every_pair_block_once(L):
    """A CPU mirror of ``ssd_bwd_chunk_tc``'s work, parsed from its
    source: warp w owns row block w; the dC pass takes key blocks 0..w,
    the dx̄ and dB passes query blocks w..; so each block of the causal
    lower triangle is taken exactly once by each pass, in a fixed order,
    and every row block has its warp (chunk <= 128: 8 blocks, 8 warps)."""
    src = (CSRC / "ssd_scan_bwd.cu").read_text()
    loops = _passes(src)
    assert loops == [("jb", "0"), ("ib", "rb"), ("ib", "rb")]
    warps = int(re.search(r"constexpr int THREADS = (\d+);", src)
                .group(1)) // 32
    nb = L // 16
    assert nb <= warps
    want = sorted((i, j) for i in range(nb) for j in range(i + 1))
    for kind, start in loops:
        got = []
        for rb in range(min(warps, nb)):
            if kind == "jb":
                got += [(rb, jb) for jb in range(0, rb + 1)]
            else:
                got += [(ib, rb) for ib in range(rb, nb)]
        assert sorted(got) == want


def _f32_bound(score_ops, f32_ops, nbytes, rates):
    bw, f32, _ = rates
    t_o, t_b = (score_ops + f32_ops) / f32 * 1e3, nbytes / bw * 1e3
    return max(t_o, t_b)


def test_ssd_bounds_charge_split_products_at_three_passes():
    """``ssd_bwd_bound`` and ``ssd_bound`` on the H100's data-sheet rates:
    bf16 inputs take the scores at one bf16 pass and every product with a
    float32 operand at three (the exact split), so the backward at
    mamba2-130m's training shape is (9.739 + 3 x 48.44) GFLOP / 989
    TFLOP/s = 0.1568 ms and at jamba's 1.672 ms, the forward at
    mamba2-130m's 0.0555 ms; float32 inputs are charged as before (every
    product on the CUDA cores)."""
    rates = chip_smoke.card_rates(chip_smoke.CARD[0])
    bwd = chip_smoke.SSD_BWD_SHAPES
    main, jamba = bwd["main"][0], bwd["jamba"][0]
    assert chip_smoke.ssd_bwd_bound(main, rates) == (
        pytest.approx(0.1568, abs=5e-5), "operations")
    assert chip_smoke.ssd_bwd_bound(jamba, rates)[0] == pytest.approx(
        1.672, abs=5e-4)
    fwd = chip_smoke.SSD_SHAPES["main"]
    assert chip_smoke.ssd_bound(fwd, rates) == (
        pytest.approx(0.0555, abs=5e-5), "operations")
    for shape in (bwd["smoke_f32"][0], bwd["ties_f32"][0],
                  chip_smoke.SSD_SHAPES["f32_ragged"]):
        b, s, h, p, g, n, chunk = shape[:7]
        tri = sum(L * (L + 1) // 2
                  for L in (min(chunk, s - c) for c in range(0, s, chunk)))
        want = _f32_bound(
            (2 * n + 2 * p) * tri * b * h,
            (2 * p * tri + 4 * n * tri + 10 * p * n * s) * b * h,
            (3 * b * s * h * p + 4 * b * s * g * n) * 4
            + 4 * (2 * b * s * h + 2 * h), rates)
        assert chip_smoke.ssd_bwd_bound(shape, rates)[0] == pytest.approx(
            want, rel=1e-12)
        want = _f32_bound(
            2 * n * tri * b * h, (2 * p * tri + 4 * p * n * s) * b * h,
            (2 * b * s * h * p + 2 * b * s * g * n) * 4
            + 4 * (b * s * h + h + b * h * p * n), rates)
        assert chip_smoke.ssd_bound(shape, rates)[0] == pytest.approx(
            want, rel=1e-12)
