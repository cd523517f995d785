"""The port's SSD scan (``repro_torch.kernels.ref.ssd_chunked``, the plain
version of the CUDA ``ssd``) and decode step (``ssd_recurrent``) against
the JAX package.

The same inputs, made with numpy from a seed, go through JAX's Pallas
``ssd`` in interpret mode (which takes only ``s % chunk == 0``), its
``ref.ssd_chunked`` (any ``s``: it pads with ``dt = 0, x = 0``) and its
``ref.ssd_recurrent``.  Tolerance (``ref.ssd_tolerance``), relative to
the largest ``|y|``: 1e-4 in float32, the JAX kernel test's bound (the
in-chunk cumsum is parallel in JAX, accumulates in float64 in torch's CPU
``cumsum`` and in order in the CUDA kernel); 1e-2 in bfloat16, which also
covers the bfloat16 rounding of the scores (JAX's reference and the
port's plain version round ``C·Bᵀ`` to bfloat16, the Pallas and CUDA
kernels accumulate it in float32).  The final state is float32 on every
path and has its own limit (``ref.ssd_state_tolerance``): 2e-5 of the
largest ``|state|``.  The decode step has no reduction that differs but
its einsum: 1e-5 of scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd as jssd
from repro_torch.kernels import launch, ops, ref

# b, s, h, p, g, n, chunk, dtype: tests/test_kernels.py's SSD_CASES, then
# ragged s and the models' widths (mamba2-130m: h 24, p 64, g 3, n 128)
SSD_CASES = [
    (2, 128, 4, 32, 2, 32, 32, "f32"),
    (1, 256, 8, 64, 1, 64, 64, "f32"),
    (2, 128, 4, 32, 4, 32, 32, "bf16"),
    (1, 256, 24, 64, 3, 128, 128, "bf16"),
]
RAGGED_CASES = [
    (2, 100, 4, 32, 2, 32, 32, "f32"),
    (2, 100, 4, 32, 2, 32, 32, "bf16"),
    (1, 200, 24, 64, 3, 128, 128, "bf16"),
]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(b, s, h, p, g, n, seed=0, mamba_dt=False):
    """float32 inputs; dt is softplus(N(0, 1)), or with ``mamba_dt``
    log-uniform in [1e-3, 1e-1] (mamba2's dt init range), where the state
    carries across chunks instead of decaying by ~e^-L within one."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    if mamba_dt:
        dt = np.exp(r.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    else:
        dt = np.log1p(np.exp(r.standard_normal((b, s, h))))
    dt = dt.astype(np.float32)
    A = (-np.exp(0.3 * r.standard_normal(h))).astype(np.float32)
    B = r.standard_normal((b, s, g, n)).astype(np.float32)
    C = r.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _both(x, dt, A, B, C, d):
    jx = (jnp.asarray(x, JDT[d]), jnp.asarray(dt), jnp.asarray(A),
          jnp.asarray(B, JDT[d]), jnp.asarray(C, JDT[d]))
    tx = (torch.from_numpy(x).to(TDT[d]), torch.from_numpy(dt),
          torch.from_numpy(A), torch.from_numpy(B).to(TDT[d]),
          torch.from_numpy(C).to(TDT[d]))
    return jx, tx


def _check(got, want):
    y, st = got
    yw, stw = (np.asarray(a, np.float32) for a in want)
    tol = ref.ssd_tolerance(torch.from_numpy(yw), y.dtype)
    assert np.abs(y.float().numpy() - yw).max() <= tol
    tol_st = ref.ssd_state_tolerance(torch.from_numpy(stw))
    assert np.abs(st.numpy() - stw).max() <= tol_st


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_jax_kernel_interpret(case):
    b, s, h, p, g, n, chunk, d = case
    jx, tx = _both(*_inputs(b, s, h, p, g, n), d)
    got = ref.ssd_chunked(*tx, chunk)
    assert got[0].dtype == TDT[d] and got[1].dtype == torch.float32
    _check(got, jssd(*jx, chunk=chunk, interpret=True))
    _check(got, jref.ssd_chunked(*jx, chunk))


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ssd_chunked_ragged_matches_jax_ref(case):
    b, s, h, p, g, n, chunk, d = case
    jx, tx = _both(*_inputs(b, s, h, p, g, n, seed=1), d)
    got = ref.ssd_chunked(*tx, chunk)
    assert got[0].shape == (b, s, h, p)
    _check(got, jref.ssd_chunked(*jx, chunk))


@pytest.mark.parametrize("d", ["f32", "bf16"])
def test_ssd_chunked_carries_state_like_jax(d):
    b, s, h, p, g, n, chunk = 2, 256, 4, 32, 2, 32, 32
    jx, tx = _both(*_inputs(b, s, h, p, g, n, seed=3, mamba_dt=True), d)
    got = ref.ssd_chunked(*tx, chunk)
    _check(got, jssd(*jx, chunk=chunk, interpret=True))
    _check(got, jref.ssd_chunked(*jx, chunk))
    # the carry is held: the last chunk alone ends in another state
    last = ref.ssd_chunked(*(t[:, -chunk:] if t.dim() > 1 else t
                             for t in tx), chunk)[1]
    assert (last - got[1]).abs().max() > 100 * ref.ssd_state_tolerance(got[1])


@pytest.mark.parametrize(("d", "mamba_dt"), [("bf16", False),
                                              ("bf16", True), ("f32", True)])
def test_ssd_y_tolerance_fails_planted_faults(d, mamba_dt):
    """``ref.ssd_tolerance`` fails both planted faults of the inter-chunk
    term (`ref.ssd_chunked_y_fault`), at dt softplus'd and in mamba2's
    range: each chunk scanned alone, and the state one chunk late."""
    b, s, h, p, g, n, chunk = 2, 200, 4, 32, 2, 32, 32
    _, tx = _both(*_inputs(b, s, h, p, g, n, seed=5, mamba_dt=mamba_dt), d)
    y = ref.ssd_chunked(*tx, chunk)[0]
    tol = ref.ssd_tolerance(y, y.dtype)
    for fault in ("chunks_alone", "state_late"):
        yf = ref.ssd_chunked_y_fault(*tx, chunk, fault)
        assert yf.shape == y.shape and yf.dtype == y.dtype
        assert (yf.float() - y.float()).abs().max() > 10 * tol
    with pytest.raises(ValueError, match="unknown SSD fault"):
        ref.ssd_chunked_y_fault(*tx, chunk, "no_such_fault")


def test_ssd_y_faults_are_what_they_name():
    """``chunks_alone`` is the scan of each chunk on its own (the chunks
    as a batch); ``state_late`` over two chunks is the same, since both
    chunks then see the state before chunk 0, which is zero."""
    b, s, h, p, g, n, chunk = 2, 128, 4, 16, 2, 16, 32
    _, tx = _both(*_inputs(b, s, h, p, g, n, seed=6, mamba_dt=True), "f32")
    x, dt, A, B, C = tx
    nc = s // chunk
    alone = ref.ssd_chunked(x.reshape(b * nc, chunk, h, p),
                            dt.reshape(b * nc, chunk, h), A,
                            B.reshape(b * nc, chunk, g, n),
                            C.reshape(b * nc, chunk, g, n), chunk)[0]
    torch.testing.assert_close(
        ref.ssd_chunked_y_fault(x, dt, A, B, C, chunk, "chunks_alone"),
        alone.reshape(b, s, h, p), rtol=1e-6, atol=1e-6)
    x2, dt2, B2, C2 = (t[:, :2 * chunk] for t in (x, dt, B, C))
    torch.testing.assert_close(
        ref.ssd_chunked_y_fault(x2, dt2, A, B2, C2, chunk, "state_late"),
        ref.ssd_chunked_y_fault(x2, dt2, A, B2, C2, chunk, "chunks_alone"),
        rtol=0, atol=0)


@pytest.mark.parametrize("d", ["f32", "bf16"])
def test_ssd_recurrent_matches_jax(d):
    b, h, p, g, n = 3, 8, 16, 2, 32
    r = np.random.default_rng(2)
    x, dt, A, B, C = _inputs(b, 1, h, p, g, n, seed=2)
    state = r.standard_normal((b, h, p, n)).astype(np.float32)
    jx, tx = _both(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], d)
    js, ts = jnp.asarray(state, JDT[d]), torch.from_numpy(state).to(TDT[d])
    yw, sw = (np.asarray(a, np.float32) for a in jref.ssd_recurrent(*jx, js))
    y, st = ref.ssd_recurrent(*tx, ts)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), yw, atol=1e-5 * np.abs(yw).max(),
                               rtol=0)
    np.testing.assert_allclose(st.numpy(), sw, atol=1e-5 * np.abs(sw).max(),
                               rtol=0)


def test_ssd_chunked_matches_token_recurrence():
    """The chunked dual form equals the token-by-token recurrence (the
    prefill's final state is what decode continues from)."""
    b, s, h, p, g, n, chunk = 1, 64, 2, 16, 1, 16, 16
    _, (x, dt, A, B, C) = _both(*_inputs(b, s, h, p, g, n, seed=7), "f32")
    y_chunk, st_chunk = ref.ssd_chunked(x, dt, A, B, C, chunk)
    state = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        yt, state = ref.ssd_recurrent(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                      state)
        ys.append(yt)
    torch.testing.assert_close(torch.stack(ys, 1), y_chunk, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(state, st_chunk, atol=1e-4, rtol=1e-4)


def test_ops_ssd_cpu_goes_to_plain_versions():
    _, (x, dt, A, B, C) = _both(*_inputs(1, 50, 4, 32, 2, 32), "bf16")
    before = dict(launch.launches)
    got, want = ops.ssd(x, dt, A, B, C, chunk=32), ref.ssd_chunked(
        x, dt, A, B, C, 32)
    for g_, w_ in zip(got, want, strict=True):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    state = torch.zeros((1, 4, 32, 32), dtype=torch.bfloat16)
    got = ops.ssd_decode(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], state)
    want = ref.ssd_recurrent(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], state)
    for g_, w_ in zip(got, want, strict=True):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    assert launch.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd(*(t.to("meta") for t in (x, dt, A, B, C)), chunk=32)


def test_ssd_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import ssd_scan
    _, (x, dt, A, B, C) = _both(*_inputs(1, 32, 4, 32, 2, 32), "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.ssd(x, dt, A, B, C, chunk=32)


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
