"""The port's kernels: plain versions on the CPU, CUDA kernels on the card.

- The plain versions (``repro_torch.kernels.ref``) are held against the
  JAX package's ``kernels/ref.py`` and against its Pallas bodies run in
  interpret mode (those take only ``d % 128 == 0``).  ``vap_suffix_norms``
  adds one ring row per step in the same order as the Pallas and CUDA
  kernels, so it must equal them exactly (the JAX reference's parallel
  ``cumsum`` differs by rounding); ``ring_view`` sums the same terms in
  another order, within ``ref.ring_view_tolerance``.
- The CUDA kernels are marked ``cuda`` and skip without a card; on the
  card they are held against the plain versions at the same tolerances
  (``delta_pack`` bit for bit, at the edge cases of :func:`pack_case`).
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
from repro_torch.comm import substrate
from repro_torch.kernels import delta_pack as dp
from repro_torch.kernels import launch, ops, ps_view, ref

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


# delta_pack's cases: (P, d, topk_frac, what the rows hold).  The main
# path's P = 8 and topk 0.0625, P = 1, d = 16, LDA's d = 2000, ragged d,
# topk 1.0, ties at the threshold, a threshold above every value, a row of
# zeros (the int8 scale's 1e-12 clamp) and exact .5 int8 quotients.
PACK_CASES = {
    "main": (8, 1000, 0.0625, "normal"),
    "p1": (1, 300, 0.3, "normal"),
    "d16": (4, 16, 0.25, "normal"),
    "d2000": (8, 2000, 0.1, "normal"),
    "ragged": (4, 1003, 0.3, "normal"),
    "topk1": (4, 64, 1.0, "normal"),
    "ties": (4, 512, 0.3, "ties"),
    "above": (4, 128, 0.3, "above"),
    "zeros": (4, 256, 0.5, "zeros"),
    "halves": (4, 256, 0.5, "halves"),
}


def pack_case(P, d, topk_frac, kind, seed=0):
    """``(delta, thresh, scale)`` as float32 numpy arrays for one
    ``delta_pack`` case; thresh and scale come from the port's substrate
    (int8 scale; the f32/bf16 kernels do not read it)."""
    r = np.random.default_rng(seed)
    delta = (2.0 * r.standard_normal((P, d))).astype(np.float32)
    if kind == "ties":              # many |delta| equal to the threshold
        delta = (np.round(delta * 2) / 2).astype(np.float32)
    elif kind == "zeros":
        delta[0] = 0.0
    elif kind == "halves":          # scale 1/8 exactly, delta/s = n + 1/2
        n = r.integers(-127, 127, (P, d))
        delta = ((n + 0.5) * 0.125).astype(np.float32)
        delta[:, 0] = 127 * 0.125
    t = torch.from_numpy(delta)
    thresh = substrate.row_threshold(t, topk_frac)
    if kind == "above":
        thresh = t.abs().amax(dim=-1) * 2 + 1
    scale = substrate.quant_scale(t, "int8")
    return delta, thresh.numpy(), scale.numpy()


def bits(t) -> np.ndarray:
    """The float32 bit patterns (so -0.0 and 0.0 differ)."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


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


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
def test_ops_delta_pack_cpu_goes_to_plain_version(quant):
    delta, thresh, scale = _t(*pack_case(*PACK_CASES["ragged"]))
    before = dict(launch.launches)
    got = ops.delta_pack(delta, thresh, scale, quant)
    want = ref.delta_pack(delta, thresh, scale, quant)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(bits(g), bits(w))
    assert launch.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers never run a plain version: a CPU tensor is refused."""
    base, uring, uclock, cview, c = _ring(4, 3, 50, 1)
    b, u, uc, cv = _t(base, uring, uclock, cview)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ps_view.ring_view(b, u, uc, cv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ps_view.vap_suffix_norms(u, uc, c)
    delta, thresh, scale = _t(*pack_case(*PACK_CASES["d16"]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp.delta_pack(delta, thresh, scale, "int8")


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
    assert ps_view.launches == {"ring_view": 1, "vap_suffix_norms": 1,
                                "delta_pack": 0}
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
@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(PACK_CASES) + ["unaligned"])
def test_cuda_delta_pack_matches_plain_version(cuda, case, quant):
    """Bit for bit (tolerance 0), on the float4 path (d % 4 == 0) and the
    scalar path (ragged d, or a row start that is not 16-byte aligned)."""
    P, d, topk, kind = PACK_CASES["main" if case == "unaligned" else case]
    delta, thresh, scale = _t(*pack_case(P, d, topk, kind, seed=3),
                              device=cuda)
    if case == "unaligned":         # a view one float into a buffer
        buf = torch.empty(P * d + 1, device=cuda)
        buf[1:] = delta.reshape(-1)
        delta = buf[1:].view(P, d)
    launch.reset_launches()
    got = dp.delta_pack(delta, thresh, scale, quant)
    torch.cuda.synchronize()
    assert launch.launches["delta_pack"] == 1
    want = ref.delta_pack(delta, thresh, scale, quant)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(bits(g), bits(w))
    if quant == "f32":              # exact mass conservation
        torch.testing.assert_close(got[0] + got[1], delta, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_delta_pack_checks_its_inputs(cuda):
    delta, thresh, scale = _t(*pack_case(*PACK_CASES["d16"]), device=cuda)
    with pytest.raises(ValueError, match="unknown quant"):
        dp.delta_pack(delta, thresh, scale, "fp4")
    with pytest.raises(TypeError, match="dtype"):
        dp.delta_pack(delta.double(), thresh, scale, "f32")
    with pytest.raises(ValueError, match="shape"):
        dp.delta_pack(delta, thresh[:-1], scale, "f32")
    with pytest.raises(ValueError, match="contiguous"):
        dp.delta_pack(delta.t().contiguous().t(), thresh, scale, "f32")
    with pytest.raises(ValueError, match="is on"):
        dp.delta_pack(delta, thresh.cpu(), scale, "f32")
    with pytest.raises(ValueError, match=r"\[P, d\]"):
        dp.delta_pack(delta[0], thresh, scale, "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["essp", "vap", "wired"])
def test_cuda_clock_loop_does_not_sync(cuda, model):
    """simulate on the card never makes the host wait for the device: a
    copy from the host or an ``.item()`` in the clock loop raises here.
    ``wired`` runs the comm substrate (int8 shipments every 2 clocks)."""
    from repro_torch.apps import matfact
    from repro_torch.core import consistency as cc
    from repro_torch.core import ps
    cfg = {"essp": cc.essp(3), "vap": cc.vap(0.3),
           "wired": cc.compressed(cc.podded(cc.essp(2), 2, s_xpod=3), 2,
                                  0.25, "int8")}[model]
    app = matfact.make_mf_app(matfact.MFConfig(), device=cuda)
    ps.simulate(app, cfg, 2)                    # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    launch.reset_launches()
    try:
        trace = ps.simulate(app, cfg, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trace.loss_ref.shape == (6,)
    if model == "wired":
        assert launch.launches == {"ring_view": 12, "vap_suffix_norms": 6,
                                   "delta_pack": 3}
