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
  (``delta_pack`` bit for bit, at the edge cases of :func:`pack_case`;
  ``flash_attention`` within ``ref.attention_tolerance``; ``ssd``'s
  output within ``ref.ssd_tolerance`` and its state within
  ``ref.ssd_state_tolerance``; its backward ``ssd_bwd`` within
  ``ref.ssd_bwd_tolerance`` of ``ref.ssd_bwd`` and bit-equal across two
  calls; ``mf_sgd_block`` within ``ref.mf_sgd_tolerance`` and bit-equal
  across two calls).  The plain versions of the last four are held
  against the JAX package in ``test_torch_attention.py``,
  ``test_torch_ssd.py``, ``test_torch_ssd_bwd.py`` and
  ``test_torch_mf_sgd.py``.
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch, mf_sgd, ops, ps_view, ref, ssd_scan

RING_EMPTY = ref.RING_EMPTY
TILE = ps_view.VAP_TILE
# (W, P, d, empty slots): the simulator's shapes (essp W=5, vap W=11),
# P=1 and P=16, the quad app's d=16, LDA's d=2000, ragged and aligned d.
# Then vap_suffix_norms's: the fault path's W = 22 over one tile and 4
# columns, the edges of its register instances (W = 8, 9, 16, 17, 32, 33,
# 64), d % 4 = 1, 2, 3 (the register instances), d one column below, at
# and one past a tile, W = 64 across two seams, and every slot empty.
SHAPES = [(5, 8, 1000, 0), (11, 8, 2000, 2), (5, 1, 300, 1), (5, 16, 128, 0),
          (3, 4, 16, 1), (11, 4, 128, 4), (2, 8, 130, 2),
          (22, 8, TILE + 4, 3), (8, 4, TILE, 1), (9, 4, TILE - 4, 2),
          (16, 2, TILE + 1, 0), (17, 3, 1002, 5), (32, 2, 1003, 3),
          (33, 2, 260, 0), (64, 2, 2 * TILE + 4, 7), (6, 4, 512, 6)]
# spiked rings (W, P, d): the fault path's W over two seams, ragged d on
# the register instances, W = 64 across two seams and a tail of 4
SPIKED = [(22, 8, 2 * TILE + 904), (5, 16, 2 * TILE + 7),
          (64, 4, 2 * TILE + 4)]


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


def _spiked(W, P, d, device="cpu"):
    return ref.vap_spiked_ring(W, P, d, TILE, seed=W + P, device=device)


@pytest.mark.parametrize("fault", ref.VAP_FAULTS)
@pytest.mark.parametrize(("W", "P", "d"), SPIKED)
def test_spiked_ring_catches_each_fault(W, P, d, fault):
    """A kernel with the planted fault gives other norms on the spiked
    ring: the exact check of the kernel would see it."""
    uring, uclock, c, _ = _spiked(W, P, d)
    want = ref.vap_suffix_norms(uring, uclock, c)
    bad = ref.vap_suffix_norms_fault(uring, uclock, c, fault, TILE)
    assert (bad - want).abs().max().item() > 0.5


def _named_columns(fault, d):
    """The columns a fault leaves out, found without the fault's code."""
    j = np.arange(d)
    if fault == "tail_dropped":
        return j == d - 1
    if fault == "head_dropped":
        return j == 0
    return (j > 0) & ((j % TILE == 0) | (((j + 1) % TILE == 0) & (j + 1 < d)))


@pytest.mark.parametrize("fault", ref.VAP_FAULTS)
def test_vap_faults_are_what_they_name(fault):
    """Each fault is the contract on a ring with its named columns zeroed,
    or (``oldest_slot_skipped``) with the rows of clock c-W left out:
    norms[W] then repeats norms[W-1]."""
    W, P, d = 7, 3, 2 * TILE + 5
    _, uring, uclock, _, c = _ring(W, P, d, 0, seed=5)
    u, uc = _t(uring, uclock)
    got = ref.vap_suffix_norms_fault(u, uc, c, fault, TILE)
    want = ref.vap_suffix_norms(u, uc, c)
    if fault == "oldest_slot_skipped":
        np.testing.assert_array_equal(bits(got[:W]), bits(want[:W]))
        np.testing.assert_array_equal(bits(got[W]), bits(want[W - 1]))
        assert (got[W] != want[W]).any()
        return
    cols = _named_columns(fault, d)
    assert cols.sum() == {"tail_dropped": 1, "head_dropped": 1,
                          "seam_dropped": 4}[fault]
    zeroed = uring.copy()
    zeroed[:, :, cols] = 0.0
    np.testing.assert_array_equal(
        bits(got), bits(ref.vap_suffix_norms(_t(zeroed)[0], uc, c)))


@pytest.mark.parametrize(("W", "P", "d"), SPIKED)
def test_spiked_ring_matches_jax_ref(W, P, d):
    """The spiked ring's norms match the JAX reference, and each
    producer's largest |suffix| sits in its spike column at every k."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    uring, uclock, c, spikes = _spiked(W, P, d)
    u, uc = uring.numpy(), uclock.numpy()
    got = ref.vap_suffix_norms(uring, uclock, c).numpy()
    want = np.asarray(jref.vap_suffix_norms(u, uc, jax.numpy.int32(c)))
    assert np.abs(got - want).max() <= _suffix_tolerance(u)
    order = np.argsort(c - uc)                       # k = 1..W in turn
    suffix = np.cumsum(u[order].astype(np.float64), axis=0)
    assert (np.abs(suffix).argmax(axis=-1) == np.array(spikes)).all()
    assert {0, d - 1, TILE - 1, TILE} <= set(spikes)


def test_vap_tile_matches_the_kernel_source():
    """``ps_view.VAP_TILE`` (the seams the spiked ring plants at) is the
    bulk-copy kernel's tile."""
    src = (Path(ps_view.__file__).parent / "csrc" / "ps_view.cu").read_text()
    assert f"constexpr int VAP_TILE = {TILE};" in src


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
                                "delta_pack": 0, "flash_attention": 0,
                                "flash_attention_bwd": 0, "ssd": 0,
                                "ssd_bwd": 0, "mf_sgd_block": 0}
    want = ref.ring_view(b, u, uc, cv)
    assert (got - want).abs().max().item() <= ref.ring_view_tolerance(b, u)
    torch.testing.assert_close(norms, ref.vap_suffix_norms(u, uc, c),
                               rtol=0, atol=0)


# ring_view on a block of reader rows and columns, as a shard of the
# sharded runtime launches it: (W, P, d, first reader, readers, first
# column, columns).  R = 4 of P = 8 at the essp and fault-path windows, R =
# 2 at a ragged column offset, R = 8 of 16 on an aligned half.
READER_BLOCKS = [(5, 8, 1000, 4, 4, 0, 1000),
                 (22, 8, TILE + 4, 4, 4, 0, TILE + 4),
                 (11, 8, 2003, 2, 2, 1001, 1002),
                 (5, 16, 128, 8, 8, 64, 64)]


def _reader_block(arrays, r0, R, j0, n):
    b, u, uc, cv = arrays
    return (b[j0:j0 + n].contiguous(), u[:, :, j0:j0 + n].contiguous(), uc,
            cv[r0:r0 + R].contiguous())


@pytest.mark.parametrize(("W", "P", "d", "r0", "R", "j0", "n"),
                         READER_BLOCKS)
def test_plain_ring_view_reader_block(W, P, d, r0, R, j0, n):
    """The plain version takes any R <= P readers and any column block;
    its rows equal the same rows of the whole matrix bit for bit (the
    sharded runtime's CPU path)."""
    arrays = _t(*_ring(W, P, d, 1, seed=3)[:4])
    full = ref.ring_view(*arrays)
    got = ref.ring_view(*_reader_block(arrays, r0, R, j0, n))
    assert torch.equal(got, full[r0:r0 + R, j0:j0 + n])


@pytest.mark.cuda
@pytest.mark.parametrize(("W", "P", "d", "r0", "R", "j0", "n"),
                         READER_BLOCKS)
def test_cuda_ring_view_reader_block(cuda, W, P, d, r0, R, j0, n):
    """``ring_view`` at R <= P readers on a column block equals the same
    rows and columns of the R = P launch bit for bit; the rows shifted by
    one reader (a planted fault) do not."""
    arrays = _t(*_ring(W, P, d, 1, seed=3)[:4], device=cuda)
    full = ps_view.ring_view(*arrays)
    got = ps_view.ring_view(*_reader_block(arrays, r0, R, j0, n))
    shifted = ps_view.ring_view(*_reader_block(arrays, r0 - 1, R, j0, n))
    torch.cuda.synchronize()
    want = full[r0:r0 + R, j0:j0 + n]
    assert torch.equal(got, want)
    assert not torch.equal(shifted, want)
    with pytest.raises(ValueError, match="R <="):
        ps_view.ring_view(arrays[0], arrays[1], arrays[2],
                          torch.zeros((P + 1, P), dtype=torch.int32,
                                      device=cuda))


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
@pytest.mark.parametrize(("W", "P", "d"), SPIKED)
def test_cuda_vap_suffix_norms_on_spiked_rings(cuda, W, P, d):
    """Exact on the spiked rings, where each planted fault differs."""
    uring, uclock, c, _ = _spiked(W, P, d, device=cuda)
    got = ps_view.vap_suffix_norms(uring, uclock, c)
    want = ref.vap_suffix_norms(uring, uclock, c)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for fault in ref.VAP_FAULTS:
        bad = ref.vap_suffix_norms_fault(uring, uclock, c, fault, TILE)
        assert (bad - want).abs().max().item() > 0.5, fault


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["outside_window", "nan", "unaligned",
                                  "repeat"])
def test_cuda_vap_suffix_norms_edge_cases(cuda, case):
    """Slots holding clocks outside c-W..c-1 are not read; a NaN in a
    selected row propagates into every later norm of its producer, as
    through the plain version's max; a ring that starts off a 16-byte
    boundary takes the register instance; two calls are bit-equal."""
    W, P, d = 22, 8, TILE + 4
    _, uring, uclock, _, c = _ring(W, P, d, 2, seed=4)
    if case == "outside_window":
        uclock[:5] = [c, c + 3, c - W - 1, c - W - 7, RING_EMPTY + 1]
    k_nan = c - np.sort(uclock[uclock >= c - W])[-2]  # second newest clock
    if case == "nan":               # the row of clock c - k_nan
        uring[np.flatnonzero(uclock == c - k_nan)[0], 5, TILE + 1] = np.nan
    u, uc = _t(uring, uclock, device=cuda)
    if case == "unaligned":                 # a view one float into a buffer
        buf = torch.empty(W * P * d + 1, device=cuda)
        buf[1:] = u.reshape(-1)
        u = buf[1:].view(W, P, d)
    got = ps_view.vap_suffix_norms(u, uc, c)
    want = ref.vap_suffix_norms(u, uc, c)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    if case == "nan":
        assert torch.isnan(got[k_nan:, 5]).all()
        assert not torch.isnan(got[:k_nan]).any()
        assert not torch.isnan(got[:, :5]).any()
    if case == "repeat":
        np.testing.assert_array_equal(
            bits(got), bits(ps_view.vap_suffix_norms(u, uc, c)))


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
                                   "delta_pack": 3, "flash_attention": 0,
                                   "flash_attention_bwd": 0, "ssd": 0,
                                   "ssd_bwd": 0, "mf_sgd_block": 0}


# flash_attention's cases on the card: (B, Sq, Sk, H, Hkv, Dk, Dv, causal,
# window, dtype, positions).  The JAX kernel test's cases, the models'
# head size 128 in both dtypes, ragged Sq and Sk, a window, rows that see
# no key ("late_keys": every key sits 5 positions after the queries
# start), masked keys in the middle ("holes": kv_pos = -1) and keys at a
# random permutation of their slots ("shuffled"); the bf16 cases at head
# sizes 64 and 128 run the wgmma kernel, which classes each KV tile as
# skipped, full or partial (holes, shuffled keys, a window of 100 that
# cuts through its 128-key tiles, a short query block over long keys, and
# ragged Sq = Sk = 333 test that rule).
FA_CASES = {
    "f32": (2, 128, 128, 4, 2, 32, 32, True, None, "f32", "arange"),
    "f32_d64_ragged": (1, 200, 200, 8, 8, 64, 64, True, None, "f32",
                       "arange"),
    "mqa_dv16": (2, 64, 256, 4, 1, 32, 16, True, None, "f32", "arange"),
    "window": (2, 128, 128, 4, 2, 32, 32, True, 48, "f32", "arange"),
    "noncausal": (2, 128, 128, 4, 2, 32, 32, False, None, "f32", "arange"),
    "f32_d128_window": (1, 70, 90, 4, 2, 128, 128, True, 16, "f32",
                        "arange"),
    "bf16": (2, 128, 128, 8, 4, 64, 64, True, None, "bf16", "arange"),
    "bf16_d128_ragged": (2, 100, 157, 16, 8, 128, 128, True, None, "bf16",
                         "arange"),
    "bf16_window_dv16": (2, 96, 200, 4, 2, 32, 16, True, 40, "bf16",
                         "arange"),
    "no_visible_key": (2, 64, 64, 4, 2, 32, 32, True, None, "bf16",
                       "late_keys"),
    "holes": (2, 96, 96, 4, 2, 64, 64, True, None, "f32", "holes"),
    "bf16_d128_holes": (2, 256, 256, 4, 2, 128, 128, True, None, "bf16",
                        "holes"),
    "bf16_d128_noncausal": (2, 200, 300, 4, 2, 128, 128, False, None,
                            "bf16", "arange"),
    "bf16_d128_window100": (2, 384, 384, 4, 2, 128, 128, True, 100, "bf16",
                            "arange"),
    "bf16_d128_shuffled": (2, 256, 384, 4, 2, 128, 128, True, None, "bf16",
                           "shuffled"),
    "bf16_d64_late_keys": (2, 200, 200, 4, 2, 64, 64, True, None, "bf16",
                           "late_keys"),
    "bf16_d128_sq64_sk2048": (1, 64, 2048, 4, 2, 128, 128, True, None,
                              "bf16", "arange"),
    "bf16_d128_ragged333": (1, 333, 333, 4, 2, 128, 128, True, None, "bf16",
                            "arange"),
    # whisper's encoder and cross-attention heads: (64, 64), one head a KV
    # head, non-causal, a ragged query block over 1500 frames
    "bf16_d64_rep1_noncausal": (2, 333, 1500, 4, 4, 64, 64, False, None,
                                "bf16", "arange"),
    # MLA's latent heads (576, 512) at one KV head, V the first 512
    # columns of K as MLA passes it (the MLA kernel's rows are (query,
    # head) pairs: 16 heads, 4 heads a KV head at Hkv = 2, and 3 at H 6,
    # Hkv 2, whose 64-row items are no box of q, so Q and O go by cp.async
    # and plain stores; Sk = 100 ends inside a 64-key tile, a window of 80
    # cuts through them), and the head size 80 of the MLA smoke config
    # (80, 64) and stablelm-3b
    "bf16_mla": (2, 200, 200, 16, 1, 576, 512, True, None, "bf16", "arange"),
    "bf16_mla_ragged333": (1, 333, 333, 16, 1, 576, 512, True, None, "bf16",
                           "arange"),
    "bf16_mla_window50": (1, 300, 300, 16, 1, 576, 512, True, 50, "bf16",
                          "arange"),
    "bf16_mla_holes": (2, 150, 150, 16, 1, 576, 512, True, None, "bf16",
                       "holes"),
    "bf16_mla_late_keys": (1, 100, 100, 16, 1, 576, 512, True, None,
                           "bf16", "late_keys"),
    "bf16_mla_noncausal": (1, 70, 230, 16, 1, 576, 512, False, None, "bf16",
                           "arange"),
    "bf16_mla_rep4": (1, 130, 130, 8, 2, 576, 512, True, None, "bf16",
                      "shuffled"),
    "bf16_mla_rep3": (2, 150, 150, 6, 2, 576, 512, True, None, "bf16",
                      "holes"),
    "bf16_mla_sk100": (2, 70, 100, 16, 1, 576, 512, True, None, "bf16",
                       "arange"),
    "bf16_mla_window80": (1, 256, 256, 16, 1, 576, 512, True, 80, "bf16",
                          "arange"),
    "f32_mla": (1, 100, 130, 4, 1, 576, 512, True, None, "f32", "arange"),
    "bf16_d80_64": (2, 100, 100, 4, 4, 80, 64, True, None, "bf16", "arange"),
    "f32_d80_64": (2, 100, 100, 4, 4, 80, 64, True, None, "f32", "arange"),
    "bf16_d80_80": (2, 150, 150, 8, 8, 80, 80, True, 64, "bf16", "holes"),
    "f32_d80_80": (1, 90, 120, 4, 2, 80, 80, False, None, "f32", "arange"),
    # jamba-1.5-large's attention: 64 query heads over 8 KV heads of 128
    # (8 heads a KV head)
    "bf16_jamba_rep8": (1, 512, 512, 64, 8, 128, 128, True, None, "bf16",
                        "arange"),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def attn_case(B, Sq, Sk, H, Hkv, Dk, Dv, dtype, positions, seed=0):
    """``(q, k, v, q_pos, kv_pos)`` as numpy arrays (float32 and int32)."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Sq, H, Dk)).astype(np.float32)
    k = r.standard_normal((B, Sk, Hkv, Dk)).astype(np.float32)
    v = r.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Sk - Sq, Sk), (B, Sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Sk), (B, Sk)).astype(np.int32).copy()
    if positions == "late_keys":
        kp += 5 + Sk - Sq
    elif positions == "holes":
        kp[:, r.choice(Sk, Sk // 4, replace=False)] = -1
    elif positions == "shuffled":
        kp = np.stack([r.permutation(Sk) for _ in range(B)]).astype(np.int32)
    return q, k, v, np.ascontiguousarray(qp), kp


def ssd_case(b, s, h, p, g, n, seed=0, mamba_dt=False):
    """``(x, dt, A, B, C)`` as float32 numpy arrays, dt softplus'd (or with
    ``mamba_dt`` log-uniform in [1e-3, 1e-1], mamba2's dt init range,
    where the state carries across chunks) and A negative as the models
    give them."""
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


# ssd's cases on the card: (b, s, h, p, g, n, chunk, dtype).  The JAX
# kernel test's cases, ragged s, the models' width (h 24, p 64, g 3,
# n 128, chunk 128) in bf16, and in float32 where the score block is cut
# to fit shared memory; "_carry" cases take mamba2's dt range.  Then the
# bf16 kernel's partition (a CTA per (b, h) and 32-wide slice of p): p of
# one slice, p ending inside a slice (48, and 36, not a multiple of 8),
# h/g of 1 and 8, s shorter than a chunk and ragged inside the last,
# grids of 60 and 240 CTAs (not multiples of 132 SMs), chunk and n of 16
# and 48, n 112 at chunk 80; and bf16 past its limits (n 256, chunk 256),
# which the per-head kernel takes; last jamba-1.5-large's 256 heads in 32
# groups.
SSD_CASES = {
    "f32": (2, 128, 4, 32, 2, 32, 32, "f32"),
    "f32_p64": (1, 256, 8, 64, 1, 64, 64, "f32"),
    "bf16": (2, 128, 4, 32, 4, 32, 32, "bf16"),
    "bf16_ragged": (2, 100, 4, 32, 2, 32, 32, "bf16"),
    "bf16_full_width": (1, 300, 24, 64, 3, 128, 128, "bf16"),
    "f32_full_width_ragged": (1, 300, 6, 64, 3, 128, 128, "f32"),
    "bf16_full_width_carry": (1, 1000, 24, 64, 3, 128, 128, "bf16"),
    "bf16_one_slice": (2, 256, 4, 32, 2, 64, 64, "bf16"),
    "bf16_p48_carry": (1, 300, 4, 48, 2, 64, 128, "bf16"),
    "bf16_p36": (1, 200, 2, 36, 1, 32, 32, "bf16"),
    "bf16_one_head_per_group": (1, 256, 4, 64, 4, 128, 128, "bf16"),
    "bf16_eight_heads_per_group": (1, 256, 8, 64, 1, 128, 128, "bf16"),
    "bf16_s_below_chunk": (2, 50, 4, 64, 2, 128, 128, "bf16"),
    "bf16_ragged_333_carry": (1, 333, 4, 64, 2, 128, 128, "bf16"),
    "bf16_grid60": (3, 300, 10, 64, 2, 128, 128, "bf16"),
    "bf16_grid240_carry": (5, 256, 24, 64, 3, 128, 128, "bf16"),
    "bf16_chunk16_n16": (1, 100, 4, 32, 2, 16, 16, "bf16"),
    "bf16_chunk48_n48_carry": (1, 200, 4, 64, 2, 48, 48, "bf16"),
    "bf16_chunk80_n112": (1, 300, 2, 64, 1, 112, 80, "bf16"),
    "bf16_n256_per_head": (1, 200, 2, 64, 1, 256, 64, "bf16"),
    "bf16_chunk256_per_head": (1, 300, 2, 64, 1, 64, 256, "bf16"),
    # jamba-1.5-large's mamba sublayers: d_inner 16384 in 256 heads of 64,
    # 32 groups of n 128
    "bf16_jamba_h256": (1, 512, 256, 64, 32, 128, 128, "bf16"),
    "bf16_jamba_h256_carry": (1, 512, 256, 64, 32, 128, 128, "bf16"),
}


def ssd_variant(n, chunk, dt_):
    """The kernel the wrapper's rule names for an SSD case."""
    return ("p_split" if dt_ == "bf16" and n <= 128 and chunk <= 128
            else "per_head")


def _attn_tensors(case, device):
    """``(q, k, v, q_pos, kv_pos)`` of an `FA_CASES` case on ``device``;
    at MLA's (576, 512) ``v`` is ``k[..., :512]``, as MLA passes it."""
    B, Sq, Sk, H, Hkv, Dk, Dv, _, _, dt, kind = FA_CASES[case]
    q, k, v, qp, kp = _t(*attn_case(B, Sq, Sk, H, Hkv, Dk, Dv, dt, kind),
                         device=device)
    q, k, v = (t.to(DTYPES[dt]) for t in (q, k, v))
    if (Dk, Dv) == (576, 512):
        v = k[..., :Dv]
    return q, k, v, qp, kp


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FA_CASES))
def test_cuda_flash_attention_matches_plain_version(cuda, case):
    B, Sq, Sk, H, Hkv, Dk, Dv, causal, window, dt, kind = FA_CASES[case]
    q, k, v, qp, kp = _attn_tensors(case, cuda)
    scale = 1.0 / np.sqrt(Dk)
    launch.reset_launches()
    got = fa.flash_attention(q, k, v, scale=scale, q_pos=qp, kv_pos=kp,
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch.launches["flash_attention"] == 1
    want = ref.attention(q, k, v, scale=scale, q_pos=qp, kv_pos=kp,
                         causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == want.shape
    atol, rtol = ref.attention_tolerance(q.dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if kind == "late_keys":             # rows that see no key return 0
        assert not got[:, :5].any()
    want_variant = ("f32_cuda_cores" if dt == "f32" else "wgmma_tma"
                    if (Dk, Dv) in ((64, 64), (128, 128)) else "mla_wgmma"
                    if (Dk, Dv) == (576, 512) else "mma_sync")
    assert fa.last_variant == want_variant


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_d128_window100", "bf16_d128_holes",
                                  "f32", "bf16_window_dv16",
                                  "bf16_mla_window50", "bf16_mla_rep3",
                                  "bf16_d80_80", "bf16_jamba_rep8"])
def test_cuda_flash_attention_is_deterministic(cuda, case):
    """Two calls on the same inputs give bit-equal outputs (no atomics,
    a fixed order of sums)."""
    B, Sq, Sk, H, Hkv, Dk, Dv, causal, window, dt, kind = FA_CASES[case]
    q, k, v, qp, kp = _attn_tensors(case, cuda)
    kw = dict(scale=1.0 / np.sqrt(Dk), q_pos=qp, kv_pos=kp, causal=causal,
              window=window)
    a = fa.flash_attention(q, k, v, **kw)
    b = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
def test_cuda_flash_attention_checks_its_inputs(cuda):
    q, k, v, qp, kp = _t(*attn_case(1, 16, 16, 2, 1, 32, 32, "f32",
                                    "arange"), device=cuda)
    kw = dict(scale=0.2, q_pos=qp, kv_pos=kp)
    with pytest.raises(ValueError, match="head sizes"):
        fa.flash_attention(q[..., :24], k[..., :24], v, **kw)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.double(), k.double(), v.double(), **kw)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k, v, scale=0.2, q_pos=qp.long(), kv_pos=kp)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, **kw)
    with pytest.raises(ValueError, match="limits"):
        fa.flash_attention(q[:, :, :1].expand(1, 16, 3, 32).contiguous(),
                           k.expand(1, 16, 2, 32).contiguous(),
                           v.expand(1, 16, 2, 32).contiguous(), **kw)
    # at MLA's bf16 (576, 512), v must be k's first 512 columns
    qm = torch.zeros((1, 16, 2, 576), dtype=torch.bfloat16, device=cuda)
    km = torch.zeros((1, 16, 1, 576), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="k\\[..., :512\\]"):
        fa.flash_attention(qm, km, km[..., :512].contiguous(), **kw)
    # only the prefix view of k is taken without being contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(qm.float(), km.float(), km.float()[..., 64:],
                           **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_cuda_ssd_matches_plain_version(cuda, case):
    b, s, h, p, g, n, chunk, dt_ = SSD_CASES[case]
    x, dt, A, B, C = _t(*ssd_case(b, s, h, p, g, n,
                                  mamba_dt=case.endswith("_carry")),
                        device=cuda)
    x, B, C = (t.to(DTYPES[dt_]) for t in (x, B, C))
    launch.reset_launches()
    y, state = ssd_scan.ssd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert launch.launches["ssd"] == 1
    y_want, st_want = ref.ssd_chunked(x, dt, A, B, C, chunk)
    assert y.dtype == x.dtype and state.dtype == torch.float32
    tol = ref.ssd_tolerance(y_want, x.dtype)
    assert (y.float() - y_want.float()).abs().max().item() <= tol
    tol_st = ref.ssd_state_tolerance(st_want)
    assert (state - st_want).abs().max().item() <= tol_st
    assert ssd_scan.last_variant == ssd_variant(n, chunk, dt_)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_full_width_carry", "bf16_p36",
                                  "bf16_ragged", "f32"])
def test_cuda_ssd_is_deterministic(cuda, case):
    """Two calls on the same inputs give bit-equal outputs (no atomics,
    a fixed order of sums)."""
    b, s, h, p, g, n, chunk, dt_ = SSD_CASES[case]
    x, dt, A, B, C = _t(*ssd_case(b, s, h, p, g, n,
                                  mamba_dt=case.endswith("_carry")),
                        device=cuda)
    x, B, C = (t.to(DTYPES[dt_]) for t in (x, B, C))
    y1, st1 = ssd_scan.ssd(x, dt, A, B, C, chunk=chunk)
    y2, st2 = ssd_scan.ssd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    bits = torch.int16 if y1.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(y1.view(bits), y2.view(bits))
    assert torch.equal(st1.view(torch.int32), st2.view(torch.int32))


@pytest.mark.cuda
def test_cuda_ssd_checks_its_inputs(cuda):
    x, dt, A, B, C = _t(*ssd_case(1, 64, 4, 32, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="limits"):
        ssd_scan.ssd(x, dt, A, B, C, chunk=24)
    with pytest.raises(ValueError, match="limits"):
        ssd_scan.ssd(x[..., :30].contiguous(), dt, A, B, C, chunk=32)
    with pytest.raises(TypeError, match="dtype"):
        ssd_scan.ssd(x.bfloat16(), dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ssd_scan.ssd(x, dt[:, :-1], A, B, C, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd(x, dt, A, B.transpose(1, 2).contiguous().transpose(1, 2),
                     C, chunk=32)
    shifted = torch.empty(B.numel() + 1, dtype=B.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan.ssd(x, dt, A, shifted.view(B.shape).copy_(B), C, chunk=32)


# ssd_bwd's cases on the card: SSD_CASES's names, each with the final
# state's cotangent or without it.  The bf16 chunk kernel's instances
# (p 32, 64 and 96: 1, 2 and 4 dx̄ tiles a thread), ragged s and s below
# a chunk, p 36, chunk 16 and 80, g | h at 1 and 8 heads a group, the
# models' widths and jamba's 256 heads; then ties (dt = 0 on spans of
# rows, where cum_i == cum_j).
SSD_BWD_CASES = ["f32", "f32_p64", "bf16", "bf16_ragged", "bf16_full_width",
                 "bf16_full_width_carry", "bf16_p36", "bf16_p48_carry",
                 "bf16_one_head_per_group", "bf16_eight_heads_per_group",
                 "bf16_s_below_chunk", "bf16_chunk16_n16",
                 "bf16_chunk80_n112", "bf16_jamba_h256"]
SSD_BWD_EXTRA = {"bf16_p96_n32": (1, 300, 4, 96, 2, 32, 128, "bf16"),
                 "bf16_p128": (1, 300, 4, 128, 2, 128, 128, "bf16"),
                 "f32_n64_chunk128": (1, 200, 4, 64, 2, 64, 128, "f32")}
SSD_TIE_CASES = {"bf16_ties": (2, 300, 4, 64, 2, 128, 128, "bf16"),
                 "f32_ties": (1, 100, 4, 32, 2, 32, 32, "f32")}


def ssd_bwd_tensors(case, device, seed=0):
    """``(x, dt, A, B, C, dy, dstate, chunk)`` of an ssd_bwd case on
    ``device``; a tie case zeroes dt on rows 3-6, 40-47 and the last
    chunk's first 20 rows."""
    spec = {**SSD_CASES, **SSD_BWD_EXTRA, **SSD_TIE_CASES}[case]
    b, s, h, p, g, n, chunk, dt_ = spec
    x, dt, A, B, C = ssd_case(b, s, h, p, g, n, seed=seed,
                              mamba_dt=case.endswith("_carry"))
    if case in SSD_TIE_CASES:
        last = (s - 1) // chunk * chunk
        for lo, hi in ((3, 7), (40, 48), (last, last + 20)):
            dt[:, lo:min(hi, s)] = 0
    r = np.random.default_rng(seed + 1)
    dy = r.standard_normal((b, s, h, p)).astype(np.float32)
    ds = r.standard_normal((b, h, p, n)).astype(np.float32)
    x, dt, A, B, C, dy, ds = _t(x, dt, A, B, C, dy, ds, device=device)
    x, B, C, dy = (t.to(DTYPES[dt_]) for t in (x, B, C, dy))
    return x, dt, A, B, C, dy, ds, chunk


@pytest.mark.cuda
@pytest.mark.parametrize("dstate", [False, True])
@pytest.mark.parametrize("case", SSD_BWD_CASES + ["bf16_p96_n32",
                                                  "f32_n64_chunk128"]
                         + list(SSD_TIE_CASES))
def test_cuda_ssd_bwd_matches_plain_version(cuda, case, dstate):
    x, dt, A, B, C, dy, ds, chunk = ssd_bwd_tensors(case, cuda)
    ds = ds if dstate else None
    launch.reset_launches()
    got = ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)
    torch.cuda.synchronize()
    assert launch.launches["ssd_bwd"] == 1
    assert ssd_scan.last_variant in ssd_scan.BWD_VARIANTS.values()
    want = ref.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)
    for g, w, t in zip(got, want, (x, dt, A, B, C), strict=True):
        assert g.dtype == w.dtype == t.dtype and g.shape == t.shape
        assert torch.isfinite(g).all()
    assert ref.ssd_bwd_within(got, want), [
        ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
        for g, w in zip(got, want, strict=True)]
    if case in SSD_TIE_CASES:
        bad = ref.ssd_bwd_fault(x, dt, A, B, C, dy, ds, chunk, "no_tie_rule")
        assert not ref.ssd_bwd_within(bad, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_full_width_carry", "bf16_p36",
                                  "f32", "bf16_ties"])
def test_cuda_ssd_bwd_is_deterministic(cuda, case):
    """Two backward calls on the same inputs give the same bits (no
    atomics, a fixed order of sums)."""
    x, dt, A, B, C, dy, ds, chunk = ssd_bwd_tensors(case, cuda)
    a = ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)
    b = ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)
    torch.cuda.synchronize()
    for u, v in zip(a, b, strict=True):
        bits = torch.int16 if u.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(u.view(bits), v.view(bits))


@pytest.mark.cuda
def test_cuda_ssd_bwd_checks_its_inputs(cuda):
    x, dt, A, B, C, dy, ds, _ = ssd_bwd_tensors("f32", cuda)
    with pytest.raises(ValueError, match="limits"):
        ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, 24)
    with pytest.raises(TypeError, match="dtype"):
        ssd_scan.ssd_bwd(x, dt, A, B, C, dy.bfloat16(), ds, 32)
    with pytest.raises(ValueError, match="shape"):
        ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds[..., :16], 32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_bwd(x, dt, A, B, C,
                         dy.transpose(1, 2).contiguous().transpose(1, 2),
                         ds, 32)
    with pytest.raises(ValueError, match="up to 128"):
        ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, 256)
    shifted = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan.ssd_bwd(x, dt, A, B, C, shifted.view(dy.shape).copy_(dy),
                         ds, 32)
    # float32 at n = chunk = 128, and p = 128 there, do not fit a CTA's
    # shared memory
    for case in ("f32_full_width_ragged", "bf16_p128"):
        x, dt, A, B, C, dy, ds, chunk = ssd_bwd_tensors(case, cuda)
        with pytest.raises(ValueError, match="shared memory"):
            ssd_scan.ssd_bwd(x, dt, A, B, C, dy, ds, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_full_width", "f32_ties"])
def test_cuda_ssd_under_grad_goes_through_the_kernels(cuda, case):
    """``ops.ssd`` under autograd launches the forward kernel and the
    backward; the gradient (of y alone, and of y and the final state)
    equals the wrappers'."""
    x, dt, A, B, C, dy, ds, chunk = ssd_bwd_tensors(case, cuda)
    for dstate in (None, ds):
        ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
        launch.reset_launches()
        y, st = ops.ssd(*ins, chunk=chunk)
        outs, cots = ((y,), (dy,)) if dstate is None else ((y, st),
                                                          (dy, dstate))
        got = torch.autograd.grad(outs, ins, cots)
        torch.cuda.synchronize()
        assert launch.launches["ssd"] == 1
        assert launch.launches["ssd_bwd"] == 1
        want = ssd_scan.ssd_bwd(x, dt, A, B, C, dy, dstate, chunk)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)


# mf_sgd_block's cases on the card: (N, M, K, density[, pattern]).  The
# JAX kernel test's shapes, kernels_bench's, ragged N and M, the smallest
# block, K past 128 and K = 256, an empty and a full block; then the
# mask's compaction: the Netflix density at K = 100 over a few
# 2048-column batches, M odd (rows start at every byte offset), one
# 64 x 64 block fully observed among empty ones, one row fully observed
# among sparse ones, one entry at the last row and column of a ragged
# block (`mf_case`).
MF_CASES = {
    "jax_256_256_16": (256, 256, 16, 0.3),
    "jax_128_384_32": (128, 384, 32, 0.3),
    "jax_128_128_8": (128, 128, 8, 0.3),
    "kernels_bench": (512, 512, 32, 0.2),
    "ragged": (100, 300, 12, 0.3),
    "one": (1, 1, 1, 1.0),
    "k130": (70, 150, 130, 0.3),
    "k256": (200, 300, 256, 0.3),
    "empty": (100, 300, 12, 0.0),
    "full": (130, 270, 20, 1.0),
    "netflix_density": (1024, 2048, 100, 0.0118),
    "odd_m": (300, 1001, 100, 0.05),
    "one_block": (256, 600, 32, 0.0, "block"),
    "one_row": (200, 3000, 64, 0.01, "row"),
    "last_entry": (130, 333, 16, 0.0, "last"),
}


def mf_case(N, M, K, density, pattern="random", seed=0):
    """``(L, R, D, mask)``, numpy, from a seed; NaN in D where unobserved.
    Observed uniformly at ``density``, and for ``block`` the 64 x 64 block
    at rows 64-127 and columns 128-191, for ``row`` all of row 5, for
    ``last`` the entry at the last row and column."""
    r = np.random.default_rng(seed)
    L = r.standard_normal((N, K)).astype(np.float32)
    R = r.standard_normal((K, M)).astype(np.float32)
    mask = r.random((N, M)) < density
    if pattern == "block":
        mask[64:128, 128:192] = True
    elif pattern == "row":
        mask[5] = True
    elif pattern == "last":
        mask[-1, -1] = True
    D = np.where(mask, r.standard_normal((N, M)), np.nan).astype(np.float32)
    return L, R, D, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MF_CASES))
def test_cuda_mf_sgd_matches_plain_version(cuda, case):
    """Within ``ref.mf_sgd_tolerance`` of the plain version, NaN-free with
    NaN at every unobserved rating, and bit-equal across two calls."""
    L, R, D, mask = _t(*mf_case(*MF_CASES[case], seed=4), device=cuda)
    launch.reset_launches()
    got = mf_sgd.mf_sgd_block(L, R, D, mask, 0.1, 1e-3)
    again = mf_sgd.mf_sgd_block(L, R, D, mask, 0.1, 1e-3)
    torch.cuda.synchronize()
    assert launch.launches["mf_sgd_block"] == 2
    want = ref.mf_sgd_block(L, R, D, mask, 0.1, 1e-3)
    tol = ref.mf_sgd_tolerance(L, R, D, mask, 0.1, 1e-3)
    for g, a, w, t in zip(got, again, want, tol, strict=True):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= t
        np.testing.assert_array_equal(bits(g), bits(a))
    if not mask.any():
        assert got[2].item() == 0.0 and not got[0].any()


@pytest.mark.cuda
def test_cuda_mf_sgd_checks_its_inputs(cuda):
    L, R, D, mask = _t(*mf_case(16, 24, 4, 0.5), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        mf_sgd.mf_sgd_block(L.double(), R, D, mask, 0.1, 1e-3)
    with pytest.raises(TypeError, match="dtype"):
        mf_sgd.mf_sgd_block(L, R, D, mask.to(torch.uint8), 0.1, 1e-3)
    with pytest.raises(ValueError, match="shape"):
        mf_sgd.mf_sgd_block(L, R, D[:, :-1], mask, 0.1, 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        mf_sgd.mf_sgd_block(L, R, D.t().contiguous().t(), mask, 0.1, 1e-3)
    with pytest.raises(ValueError, match="is on"):
        mf_sgd.mf_sgd_block(L, R, D.cpu(), mask, 0.1, 1e-3)
    with pytest.raises(ValueError, match="limits"):
        mf_sgd.mf_sgd_block(torch.zeros((4, 257), device=cuda),
                            torch.zeros((257, 6), device=cuda),
                            torch.zeros((4, 6), device=cuda),
                            torch.ones((4, 6), dtype=torch.bool, device=cuda),
                            0.1, 1e-3)


# flash_attention_bwd's cases on the card: (B, Sq, Sk, H, Hkv, D, causal,
# window, dtype, positions): bf16 at (64, 64) and (128, 128), float32,
# rep 1, 4, 8 and 16, a window (one narrower than a 64-query tile), masked
# keys (kv_pos < 0), ragged Sq and Sk (not multiples of the kernels'
# tiles: the wgmma kernels' 128-key and 128-query items and 64-row tiles,
# Sk one past an item and one short of two), rows that see no key
BWD_CASES = {
    "bf16_d128_sk129": (1, 129, 129, 4, 2, 128, True, None, "bf16",
                        "arange"),
    "bf16_d64_sq100_sk255": (2, 100, 255, 8, 4, 64, True, None, "bf16",
                             "arange"),
    "bf16_d128_sq190_sk255_noncausal_holes": (1, 190, 255, 4, 4, 128, False,
                                              None, "bf16", "holes"),
    "bf16_d128_rep16": (1, 256, 256, 16, 1, 128, True, None, "bf16",
                        "arange"),
    "bf16_d64_rep16_sq77": (2, 77, 200, 16, 1, 64, True, None, "bf16",
                            "arange"),
    "bf16_d128_window24": (2, 320, 320, 8, 2, 128, True, 24, "bf16",
                           "arange"),
    "bf16_d128_rep2": (2, 256, 256, 16, 8, 128, True, None, "bf16",
                       "arange"),
    "bf16_d64_rep4": (2, 200, 200, 8, 2, 64, True, None, "bf16", "arange"),
    "bf16_d128_rep8_window": (1, 300, 300, 16, 2, 128, True, 70, "bf16",
                              "arange"),
    "bf16_d128_rep1_noncausal": (2, 100, 230, 4, 4, 128, False, None,
                                 "bf16", "arange"),
    "bf16_d64_holes": (2, 150, 150, 4, 2, 64, True, None, "bf16", "holes"),
    "bf16_d128_late_keys": (1, 130, 130, 4, 2, 128, True, None, "bf16",
                            "late_keys"),
    "bf16_d128_ragged": (1, 77, 333, 4, 2, 128, True, None, "bf16",
                         "arange"),
    "f32_d64_rep2": (2, 100, 100, 4, 2, 64, True, None, "f32", "arange"),
    "f32_d128_window_holes": (1, 150, 170, 8, 2, 128, True, 50, "f32",
                              "holes"),
    "f32_d64_late_keys": (1, 70, 70, 4, 4, 64, True, None, "f32",
                          "late_keys"),
}


def _bwd_tensors(case, device):
    B, Sq, Sk, H, Hkv, D, causal, window, dt, kind = BWD_CASES[case]
    q, k, v, qp, kp = _t(*attn_case(B, Sq, Sk, H, Hkv, D, D, dt, kind),
                         device=device)
    q, k, v = (t.to(DTYPES[dt]) for t in (q, k, v))
    gd = torch.Generator(device=device).manual_seed(Sq + Sk)
    dout = torch.randn(q.shape, generator=gd, device=device).to(q.dtype)
    kw = dict(scale=1.0 / np.sqrt(D), q_pos=qp, kv_pos=kp, causal=causal,
              window=window)
    return q, k, v, dout, kw


def _within(got, want, dtype):
    atol, rtol = ref.attention_bwd_tolerance(dtype)
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol * w.abs().max() + rtol * w.abs()
                 ).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_cuda_flash_attention_bwd_matches_plain_version(cuda, case):
    """The forward with ``lse`` (its output bit-equal to the forward's,
    ``lse`` within float32 rounding of the plain version's) and the
    backward against ``ref.attention_bwd`` on the same inputs, within
    ``ref.attention_bwd_tolerance``, where both planted faults fail."""
    q, k, v, dout, kw = _bwd_tensors(case, cuda)
    launch.reset_launches()
    out, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    plain = fa.flash_attention(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert launch.launches["flash_attention"] == 2
    assert launch.launches["flash_attention_bwd"] == 1
    bits_t = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits_t), plain.view(bits_t))
    _, want_lse = ref.attention_lse(q, k, v, **kw)
    seen = torch.isfinite(want_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=1e-5,
                               atol=1e-5)
    want = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _within(g, w, q.dtype)
    for fault in ("d_zero", "dropped_tile"):
        bad = ref.attention_bwd_fault(q, k, v, out, lse, dout, fault=fault,
                                      **kw)
        assert not all(_within(b, w, q.dtype)
                       for b, w in zip(bad, want, strict=True)), fault
    if BWD_CASES[case][-1] == "late_keys":   # rows that see no key
        assert not got[0][:, :5].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_d128_rep8_window", "bf16_d64_holes",
                                  "f32_d128_window_holes",
                                  "bf16_d64_sq100_sk255",
                                  "bf16_d128_window24"])
def test_cuda_flash_attention_bwd_is_deterministic(cuda, case):
    """Two backward calls on the same inputs give the same bits (no
    atomics, a fixed order of sums)."""
    q, k, v, dout, kw = _bwd_tensors(case, cuda)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    a = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    b = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b, strict=True):
        bits_t = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(x.view(bits_t), y.view(bits_t))


@pytest.mark.cuda
def test_cuda_attention_under_grad_goes_through_the_kernels(cuda):
    """``ops.attention`` under autograd launches the forward with ``lse``
    and the backward kernel; the gradient equals the wrappers'."""
    q, k, v, dout, kw = _bwd_tensors("bf16_d64_rep4", cuda)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    launch.reset_launches()
    out = ops.attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, dout)
    torch.cuda.synchronize()
    assert launch.launches["flash_attention"] == 1
    assert launch.launches["flash_attention_bwd"] == 1
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    want = fa.flash_attention_bwd(q, k, v, o, lse, dout, **kw)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


# The backward at the mma.sync head sizes, at (80, 80) (the wgmma kernels)
# and at MLA's (576, 512) (the MLA kernels): B, Sq, Sk, H, Hkv, Dk, Dv,
# causal, window, dtype, positions, V as K's prefix (dK then holds dV)
BWD_MMA_CASES = {
    "bf16_d576_fold": (2, 150, 150, 16, 1, 576, 512, True, None, "bf16",
                       "holes", True),
    "bf16_d576_rep3_window": (1, 130, 130, 6, 2, 576, 512, True, 40, "bf16",
                              "shuffled", True),
    "bf16_d80_64_fold": (2, 70, 70, 4, 1, 80, 64, True, None, "bf16",
                         "arange", True),
    "bf16_d80_64": (1, 90, 120, 8, 2, 80, 64, False, None, "bf16", "holes",
                    False),
    "bf16_d80_80": (1, 100, 100, 4, 4, 80, 80, True, 30, "bf16", "late_keys",
                    False),
    "bf16_d32_16_fold": (2, 65, 65, 4, 1, 32, 16, True, None, "bf16",
                         "arange", True),
    "bf16_d32_32": (1, 77, 77, 8, 2, 32, 32, True, None, "bf16", "holes",
                    False),
    "f32_d80_64_fold": (2, 70, 70, 4, 1, 80, 64, True, None, "f32", "arange",
                        True),
    "f32_d80_80": (1, 100, 100, 4, 2, 80, 80, True, 30, "f32", "holes",
                   False),
    "f32_d32_16": (1, 65, 80, 4, 2, 32, 16, True, None, "f32", "late_keys",
                   False),
    "f32_d32_32": (1, 77, 77, 8, 4, 32, 32, True, None, "f32", "arange",
                   False),
}


def _bwd_mma_tensors(case, device):
    B, Sq, Sk, H, Hkv, Dk, Dv, causal, window, dt, kind, prefix = \
        BWD_MMA_CASES[case]
    q, k, v, qp, kp = _t(*attn_case(B, Sq, Sk, H, Hkv, Dk, Dv, dt, kind,
                                    seed=1), device=device)
    q, k, v = (t.to(DTYPES[dt]) for t in (q, k, v))
    if prefix:
        v = k[..., :Dv]
    gd = torch.Generator(device=device).manual_seed(Sq + Sk + Dk)
    dout = torch.randn((B, Sq, H, Dv), generator=gd, device=device).to(
        q.dtype)
    kw = dict(scale=1.0 / np.sqrt(Dk), q_pos=qp, kv_pos=kp, causal=causal,
              window=window)
    return q, k, v, dout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_MMA_CASES))
def test_cuda_mma_backward_matches_plain_version(cuda, case):
    """``flash_attention_bwd`` at the narrow sizes and MLA's against
    ``ref.attention_bwd`` (the folded contract where V is K's prefix:
    ``(dq, dk, None)``), its planted faults outside the limit, two calls
    bit-equal, the forward with ``lse`` bit-equal to the serving forward
    and its ``lse`` against ``ref.attention_lse``, the kernels named by
    ``bwd_variant``."""
    q, k, v, dout, kw = _bwd_mma_tensors(case, cuda)
    launch.reset_launches()
    out, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    served = fa.flash_attention(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert launch.launches["flash_attention_bwd"] == 2
    assert fa.last_bwd_variant == fa.bwd_variant(q.dtype, q.shape[-1],
                                                 v.shape[-1])
    bits = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), served.view(bits))
    _, want_lse = ref.attention_lse(q, k, v, **kw)
    seen = torch.isfinite(want_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=1e-5,
                               atol=1e-4)
    want = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    fold = BWD_MMA_CASES[case][-1]
    assert (got[2] is None) == fold == (want[2] is None)
    n = 2 if fold else 3
    for g, a, w in zip(got[:n], again[:n], want[:n], strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(bits), a.view(bits))
        assert _within(g, w, q.dtype)
    for fault in ("d_zero", "dropped_tile") + (("unfolded_dv",) if fold
                                               else ()):
        bad = ref.attention_bwd_fault(q, k, v, out, lse, dout, fault=fault,
                                      **kw)
        assert not all(_within(b, w, q.dtype)
                       for b, w in zip(bad[:n], want[:n], strict=True)), \
            fault


@pytest.mark.cuda
def test_cuda_mla_grad_under_autograd_goes_through_the_kernels(cuda):
    """``ops.attention(q, k, k[..., :512])`` in bf16 under autograd
    launches the forward with ``lse`` and the MLA backward once each; the
    key's gradient is the wrappers' folded dK."""
    q, k, v, dout, kw = _bwd_mma_tensors("bf16_d576_fold", cuda)
    qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
    launch.reset_launches()
    out = ops.attention(qg, kg, kg[..., :512], **kw)
    got = torch.autograd.grad(out, (qg, kg), dout)
    torch.cuda.synchronize()
    assert launch.launches["flash_attention"] == 1
    assert launch.launches["flash_attention_bwd"] == 1
    assert fa.last_bwd_variant == "mla_wgmma"
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    want = fa.flash_attention_bwd(q, k, v, o, lse, dout, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_kernels_without_backward_raise_under_grad(cuda):
    """On the card a gradient through attention at a head size with no
    backward kernel (float32 at MLA's (576, 512)) raises
    ``NotImplementedError`` naming its ROADMAP item; without a gradient
    the same call runs.  The head sizes that raised before (bf16 (576,
    512) with V as K's prefix, ROADMAP 16.4d; bf16 (80, 80), 16.4e) now
    run and match the plain version, as does a gradient through ``ssd``
    (ROADMAP 16.4c)."""
    x, dt, A, Bm, C = _t(*ssd_case(1, 64, 2, 32, 1, 32), device=cuda)
    x = x.requires_grad_()
    y, _ = ops.ssd(x, dt, A, Bm, C, chunk=32)
    (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
    want = ref.ssd_bwd(x.detach(), dt, A, Bm, C, torch.ones_like(y), None,
                       32)[0]
    assert ref.ssd_bwd_within([g], [want])
    with torch.no_grad():
        ops.ssd(x, dt, A, Bm, C, chunk=32)
    for (Dk, Dv), dtype in (((576, 512), torch.float32),
                            ((576, 512), torch.bfloat16),
                            ((80, 80), torch.bfloat16)):
        q, k, v, qp, kp = _t(*attn_case(1, 64, 64, 4, 1, Dk, Dv, "bf16",
                                        "arange"), device=cuda)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        if Dk == 576:
            v = k[..., :512]
        q.requires_grad_()
        kw = dict(scale=0.1, q_pos=qp, kv_pos=kp)
        if dtype == torch.float32:
            with pytest.raises(NotImplementedError, match="16.4f"):
                ops.attention(q, k, v, **kw)
            with torch.no_grad():
                ops.attention(q, k, v, **kw)
            continue
        out = ops.attention(q, k, v, **kw)
        dout = torch.ones_like(out)
        (gq,) = torch.autograd.grad(out, q, dout)
        o, lse = ref.attention_lse(q.detach(), k, v, **kw)
        assert _within(gq, ref.attention_bwd(q.detach(), k, v, o, lse, dout,
                                             **kw)[0], dtype)
