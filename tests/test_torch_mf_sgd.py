"""The MF-SGD dense-block update: the port against the JAX package, on
the CPU.

``ops.mf_sgd_block`` on CPU tensors runs the plain version
(``repro_torch.kernels.ref.mf_sgd_block``); it is held on numpy-seeded
inputs against the JAX reference (``repro.kernels.ref.mf_sgd_block``) and
against the Pallas kernel run in interpret mode (which takes only
``N % 8 == 0`` and ``M % 128 == 0``), within ``ref.mf_sgd_tolerance``: the
same float32 sums taken in other orders.  The whole slice: the dense
block of the MF app's own data at ``MFConfig()``, built from the JAX app
and from the port's ``mf_data``, through both.  The CUDA kernel itself is
held against the plain version in ``test_torch_kernels.py`` (``cuda``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.apps import matfact as jmf_app  # noqa: E402
from repro.kernels import mf_sgd as jmf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.apps import matfact as tmf_app  # noqa: E402
from repro_torch.kernels import launch, mf_sgd, ops, ref  # noqa: E402

# (N, M, K): the JAX kernel test's shapes (tests/test_kernels.py), then a
# ragged one the Pallas kernel does not take.
ALIGNED = [(256, 256, 16), (128, 384, 32), (128, 128, 8)]
RAGGED = [(100, 300, 12)]
GAMMA, LAM = 0.1, 1e-3


def block(N, M, K, density=0.3, seed=0, nan=True):
    """``(L, R, D, mask)`` as numpy arrays, made from a seed; D is NaN
    wherever the mask is not set (``nan``)."""
    r = np.random.default_rng(seed)
    L = r.standard_normal((N, K)).astype(np.float32)
    R = r.standard_normal((K, M)).astype(np.float32)
    D = r.standard_normal((N, M)).astype(np.float32)
    mask = r.random((N, M)) < density
    if nan:
        D[~mask] = np.nan
    return L, R, D, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_within(got, want, tol):
    """``got`` and ``want`` (dL, dR, loss) within ``tol`` entry by entry
    of each output's largest difference."""
    for name, g, w, t in zip(("dL", "dR", "loss"), got, want, tol,
                             strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max())
        assert err <= t, (name, err, t)


@pytest.mark.parametrize(("N", "M", "K"), ALIGNED + RAGGED)
def test_plain_version_matches_jax_ref(N, M, K):
    L, R, D, mask = block(N, M, K, seed=N + M + K)
    want = jref.mf_sgd_block(L, R, D, mask, GAMMA, LAM)
    t = _t(L, R, D, mask)
    before = dict(launch.launches)
    got = ops.mf_sgd_block(*t, GAMMA, LAM)
    assert launch.launches == before          # the CPU never launches
    assert_within([x.numpy() for x in got], want,
                  ref.mf_sgd_tolerance(*t, GAMMA, LAM))


@pytest.mark.parametrize(("N", "M", "K"), ALIGNED)
def test_plain_version_matches_pallas_interpret(N, M, K):
    L, R, D, mask = block(N, M, K, seed=N * M + K)
    want = jmf.mf_sgd_block(*(jnp.asarray(x) for x in (L, R, D, mask)),
                            GAMMA, LAM, interpret=True)
    t = _t(L, R, D, mask)
    got = ref.mf_sgd_block(*t, GAMMA, LAM)
    assert_within([x.numpy() for x in got], want,
                  ref.mf_sgd_tolerance(*t, GAMMA, LAM))


@pytest.mark.parametrize("density", [0.0, 1.0])
def test_empty_and_full_blocks_match_jax_ref(density):
    """Density 0: E, dL, dR and the loss are 0 (the count clamps to 1);
    density 1: every entry observed."""
    L, R, D, mask = block(100, 300, 12, density=density, seed=5)
    want = jref.mf_sgd_block(L, R, D, mask, GAMMA, LAM)
    t = _t(L, R, D, mask)
    got = ops.mf_sgd_block(*t, GAMMA, LAM)
    assert_within([x.numpy() for x in got], want,
                  ref.mf_sgd_tolerance(*t, GAMMA, LAM))
    if density == 0.0:
        assert float(got[2]) == 0.0
        assert not got[0].any() and not got[1].any()


def test_unobserved_ratings_never_reach_the_outputs():
    """NaN and Inf in D outside the mask give the same bits as zeros
    there: the mask selects and never multiplies."""
    L, R, D, mask = block(100, 300, 12, seed=6)
    D[~mask] = np.where(np.arange((~mask).sum()) % 2, np.nan, np.inf)
    got = ref.mf_sgd_block(*_t(L, R, D, mask), GAMMA, LAM)
    want = ref.mf_sgd_block(*_t(L, R, np.where(mask, D, 0.0), mask),
                            GAMMA, LAM)
    for g, w in zip(got, want, strict=True):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_tolerance_fails_planted_faults():
    """The limit is tight enough to see a wrong kernel on MF-like data
    (ratings near the factors' product): the mask ignored, one 128-column
    tile of E left out of both products, the λ term dropped."""
    r = np.random.default_rng(7)
    N, M, K = 256, 384, 16
    L = 0.1 * r.standard_normal((N, K)).astype(np.float32)
    R = 0.1 * r.standard_normal((K, M)).astype(np.float32)
    mask = r.random((N, M)) < 0.1
    D = np.where(mask, r.standard_normal((N, M)) * 0.3, np.nan).astype(
        np.float32)
    t = _t(L, R, D, mask)
    gamma, lam = 0.7, 1e-4
    sound = ref.mf_sgd_block(*t, gamma, lam)
    tol = ref.mf_sgd_tolerance(*t, gamma, lam)
    E = ref.mf_residual(*t)
    E[:, :128] = 0.0
    faults = {
        "mask_ignored": ref.mf_sgd_block(
            t[0], t[1], torch.nan_to_num(t[2], nan=0.0),
            torch.ones_like(t[3]), gamma, lam),
        "tile_dropped": ref.mf_update(t[0], t[1], E, t[3], gamma, lam),
        "no_lambda": ref.mf_sgd_block(*t, gamma, 0.0)}
    for name, f in faults.items():
        over = [float((a - b).abs().max()) / tl
                for a, b, tl in zip(f[:2], sound[:2], tol[:2], strict=True)]
        assert max(over) > 1.0, (name, over)


def dense_block(L, R, ii, jj, vv, n, m):
    """The MF app's ratings as a dense block: ``mask[ii, jj]`` set,
    ``D[ii, jj] = vv`` and NaN at every unobserved entry."""
    D = torch.full((n, m), float("nan"))
    mask = torch.zeros((n, m), dtype=torch.bool)
    i, j = ii.reshape(-1).long(), jj.reshape(-1).long()
    mask[i, j] = True
    D[i, j] = vv.reshape(-1)
    return L, R, D, mask


def test_whole_slice_on_the_mf_apps_data():
    """``MFConfig()``: the dense block built from the JAX app's data equals
    the one built from the port's ``mf_data`` (mask and NaNs exactly, the
    ratings and factors to the 1e-6 of ``test_torch_matfact.py``), and on
    it the port's ``ops.mf_sgd_block`` agrees with the JAX package's."""
    cfg = jmf_app.MFConfig()
    n, m, k = cfg.n_rows, cfg.n_cols, cfg.rank
    japp = jmf_app.make_mf_app(cfg)
    jx0 = torch.from_numpy(np.array(japp.x0))
    jb = dense_block(jx0[:n * k].reshape(n, k), jx0[n * k:].reshape(k, m),
                     *(torch.from_numpy(np.array(japp.local0[f]))
                       for f in ("ii", "jj", "vv")), n, m)
    x0, ii, jj, vv = tmf_app.mf_data(tmf_app.MFConfig(), device="cpu")
    tb = dense_block(x0[:n * k].reshape(n, k), x0[n * k:].reshape(k, m),
                     ii, jj, vv, n, m)
    assert torch.equal(tb[3], jb[3]) and int(tb[3].sum()) > 0
    assert torch.equal(torch.isnan(tb[2]), torch.isnan(jb[2]))
    for a, b in zip(tb[:3], jb[:3], strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, equal_nan=True)
    lr, lam = cfg.lr, cfg.lam
    want = jref.mf_sgd_block(*(x.numpy() for x in jb), lr, lam)
    got = ops.mf_sgd_block(*jb, lr, lam)
    assert_within([x.numpy() for x in got], want,
                  ref.mf_sgd_tolerance(*jb, lr, lam))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never runs the plain version: CPU tensors are refused,
    whatever their dtype, and the dispatch refuses other devices."""
    L, R, D, mask = _t(*block(16, 24, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf_sgd.mf_sgd_block(L, R, D, mask, GAMMA, LAM)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf_sgd.mf_sgd_block(L.double(), R.double(), D.double(), mask.int(),
                            GAMMA, LAM)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.mf_sgd_block(*(x.to("meta") for x in (L, R, D, mask)),
                         GAMMA, LAM)
