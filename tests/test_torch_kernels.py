"""The port's kernels: plain versions on the CPU, CUDA kernels on the card.

- The plain versions (``repro_torch.kernels.ref``) are held against the
  JAX package's ``kernels/ref.py`` and against its Pallas bodies run in
  interpret mode (those take only ``d % 128 == 0``).  ``vap_suffix_norms``
  adds one ring row per step in the same order as the Pallas and CUDA
  kernels, so it must equal them exactly (the JAX reference's parallel
  ``cumsum`` differs by rounding); ``ring_view`` sums the same terms in
  another order, within ``ref.ring_view_tolerance``.
- The CUDA kernels are marked ``cuda`` and skip without a card; on the
  card they are held against the plain versions at the same tolerances.
- The port's boundaries: no module imports ``jax`` or ``repro``, the
  default device is the card, and a CUDA tensor never reaches a plain
  version.

JAX is imported inside the tests that need it, so the ``cuda`` tests also
run on a machine that has no JAX
(``python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py``
with ``PYTHONPATH=src``).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops, ps_view, ref

RING_EMPTY = ref.RING_EMPTY
# (W, P, d, empty slots): the simulator's shapes (essp W=5, vap W=11),
# P=1 and P=16, the quad app's d=16, LDA's d=2000, ragged and aligned d.
SHAPES = [(5, 8, 1000, 0), (11, 8, 2000, 2), (5, 1, 300, 1), (5, 16, 128, 0),
          (3, 4, 16, 1), (11, 4, 128, 4), (2, 8, 130, 2)]


def _ring(W, P, d, n_empty, c=40, seed=0):
    r = np.random.default_rng(seed)
    base = r.standard_normal(d).astype(np.float32)
    uring = r.standard_normal((W, P, d)).astype(np.float32)
    uclock = (c - 1 - r.permutation(W)).astype(np.int32)
    uclock[r.choice(W, n_empty, replace=False)] = RING_EMPTY
    cview = r.integers(c - W - 2, c, (P, P)).astype(np.int32)
    return base, uring, uclock, cview, c


def _suffix_tolerance(uring):
    """The JAX reference takes its prefix sums with a parallel scan (its
    ``cumsum``), the kernels and the port's plain version run them in
    order: two sums of at most W terms."""
    W = uring.shape[0]
    return 2 * W * np.finfo(np.float32).eps * np.abs(uring).sum(0).max()


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize(("W", "P", "d", "n_empty"), SHAPES)
def test_plain_versions_match_jax_ref(W, P, d, n_empty):
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    base, uring, uclock, cview, c = _ring(W, P, d, n_empty)
    b, u, uc, cv = _t(base, uring, uclock, cview)
    want = np.asarray(jref.ring_view(base, uring, uclock, cview))
    got = ref.ring_view(b, u, uc, cv).numpy()
    assert np.abs(got - want).max() <= ref.ring_view_tolerance(b, u)
    want = np.asarray(jref.vap_suffix_norms(uring, uclock,
                                            jax.numpy.int32(c)))
    got = ref.vap_suffix_norms(u, uc, c).numpy()
    assert np.abs(got - want).max() <= _suffix_tolerance(uring)


@pytest.mark.parametrize(("W", "P", "d", "n_empty"),
                         [s for s in SHAPES if s[2] % 128 == 0])
def test_plain_versions_match_pallas_interpret(W, P, d, n_empty):
    jax = pytest.importorskip("jax")
    from repro.kernels import ps_view as jpv
    base, uring, uclock, cview, c = _ring(W, P, d, n_empty, seed=1)
    b, u, uc, cv = _t(base, uring, uclock, cview)
    want = np.asarray(jpv.ring_view(base, uring, uclock, cview,
                                    interpret=True))
    got = ref.ring_view(b, u, uc, cv).numpy()
    assert np.abs(got - want).max() <= ref.ring_view_tolerance(b, u)
    want = np.asarray(jpv.vap_suffix_norms(uring, uclock, jax.numpy.int32(c),
                                           interpret=True))
    np.testing.assert_array_equal(ref.vap_suffix_norms(u, uc, c).numpy(),
                                  want)


def test_ops_dispatch_cpu_goes_to_plain_version():
    base, uring, uclock, cview, c = _ring(4, 3, 50, 1)
    b, u, uc, cv = _t(base, uring, uclock, cview)
    before = dict(ps_view.launches)
    torch.testing.assert_close(ops.ring_view(b, u, uc, cv),
                               ref.ring_view(b, u, uc, cv), rtol=0, atol=0)
    torch.testing.assert_close(ops.vap_suffix_norms(u, uc, c),
                               ref.vap_suffix_norms(u, uc, c), rtol=0, atol=0)
    assert ps_view.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ring_view(*(x.to("meta") for x in (b, u, uc, cv)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers never run a plain version: a CPU tensor is refused."""
    base, uring, uclock, cview, c = _ring(4, 3, 50, 1)
    b, u, uc, cv = _t(base, uring, uclock, cview)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ps_view.ring_view(b, u, uc, cv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ps_view.vap_suffix_norms(u, uc, c)


def test_no_jax_or_repro_imports():
    """The port stands alone: no module under src/repro_torch imports jax
    or the JAX package."""
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    files = sorted(root.rglob("*.py"))
    assert len(files) >= 14
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_resolve_device_defaults_to_the_card():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        from repro_torch.apps import matfact
        with pytest.raises(RuntimeError, match="no CUDA device"):
            matfact.make_mf_app(matfact.MFConfig())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(("W", "P", "d", "n_empty"),
                         SHAPES + [(64, 64, 333, 5), (1, 1, 1, 0)])
def test_cuda_kernels_match_plain_versions(cuda, W, P, d, n_empty):
    base, uring, uclock, cview, c = _ring(W, P, d, n_empty, seed=2)
    b, u, uc, cv = _t(base, uring, uclock, cview, device=cuda)
    ps_view.reset_launches()
    got = ps_view.ring_view(b, u, uc, cv)
    norms = ps_view.vap_suffix_norms(u, uc, c)
    torch.cuda.synchronize()
    assert ps_view.launches == {"ring_view": 1, "vap_suffix_norms": 1}
    want = ref.ring_view(b, u, uc, cv)
    assert (got - want).abs().max().item() <= ref.ring_view_tolerance(b, u)
    torch.testing.assert_close(norms, ref.vap_suffix_norms(u, uc, c),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_kernels_check_their_inputs(cuda):
    base, uring, uclock, cview, c = _ring(4, 3, 50, 1)
    b, u, uc, cv = _t(base, uring, uclock, cview, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ps_view.ring_view(b, u, uc.long(), cv)
    with pytest.raises(ValueError, match="contiguous"):
        ps_view.ring_view(b, u.transpose(0, 1).contiguous().transpose(0, 1),
                          uc, cv)
    with pytest.raises(ValueError, match="limits"):
        ps_view.vap_suffix_norms(torch.zeros((65, 2, 4), device=cuda),
                                 torch.zeros(65, dtype=torch.int32,
                                             device=cuda), c)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["essp", "vap"])
def test_cuda_clock_loop_does_not_sync(cuda, model):
    """simulate on the card never makes the host wait for the device: a
    copy from the host or an ``.item()`` in the clock loop raises here."""
    from repro_torch.apps import matfact
    from repro_torch.core import consistency as cc
    from repro_torch.core import ps
    cfg = cc.essp(3) if model == "essp" else cc.vap(0.3)
    app = matfact.make_mf_app(matfact.MFConfig(), device=cuda)
    ps.simulate(app, cfg, 2)                    # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trace = ps.simulate(app, cfg, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trace.loss_ref.shape == (6,)
