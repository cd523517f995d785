"""Launch wrapper of the hand-written CUDA kernels in ``csrc/ssd_scan.cu``.

They replace the Pallas kernel of ``repro/kernels/ssd_scan.py``: the
Mamba-2 SSD chunked scan (the intra-chunk dual form, the inter-chunk
state carried across chunks), returning ``y`` and the final state.
``ssd_forward`` picks one of two kernels by a fixed rule; the name of the
one that ran is :data:`last_variant` after each call, and :func:`variant`
gives it beforehand:

- ``"p_split"``: bf16 at ``n <= 128`` and ``chunk <= 128`` (the models'
  path): one CTA of 8 warps per (b, h) and 32-wide slice of the head
  dimension, chunk c+1's inputs loaded by ``cp.async`` while chunk c
  computes, the scores on ``mma.sync`` kept in registers, the three
  float32 products as 8 x 8 register tiles on the CUDA cores;
- ``"per_head"``: float32, and bf16 past those limits: one CTA per
  (b, h), the scores in shared memory a block of rows at a time.

The wrapper checks device, dtype, shape, alignment and contiguity, picks
(for ``"per_head"``) how many rows of the chunk's score matrix the kernel
keeps in shared memory at once, allocates both outputs, launches on the
current stream, raises on a non-zero ``cudaError_t`` and counts the
launch in ``launch.launches``.  The plain version is
``ref.ssd_chunked``; ``ops.ssd`` picks between the two by the tensor's
device.

:func:`ssd_bwd` is the gradient, the three kernels of
``csrc/ssd_scan_bwd.cu`` (one count a call in ``launch.launches["ssd_bwd"]``).
In bf16 (``"bwd_tc"``) every product runs on the tensor cores, each float32
operand split exactly into three bf16 pieces (`ref.bf16_split3`):
``ssd_bwd_states_tc`` and ``ssd_bwd_dstates_tc`` walk the chunks of each
(b, h) and 32-wide slice of p, forward and in reverse, writing the state
entering each chunk and its gradient as three bf16 planes (``[b, h, nc, 3,
p, n]`` each); ``ssd_bwd_chunk_tc`` computes the in-chunk gradients per
(b, group, chunk), the group's heads in order, adding each head's dB and
dC into the group's float32 sums ``[b, s, g, n]``, which the wrapper casts
to bf16.  In float32 (``"bwd_xt*"``) the same three steps run on the CUDA
cores, the states float32 ``[b, h, nc, p, n]``, dB and dC per head
``[b, s, h, n]``, summed over each group's heads by the wrapper.  Its
plain version is ``ref.ssd_bwd``.  Its limits add ``chunk``, ``n`` and
``p`` at most 128 and the chunk kernel's shared memory
(:func:`bwd_smem_bytes`: 217,624 bytes at bf16, ``p = 64``,
``n = chunk = 128``; float32 at ``n = chunk = 128``, and bf16 at ``p = n =
chunk = 128``, do not fit and raise).

Limits: ``p % 4 == 0``, ``n % 16 == 0``, ``chunk % 16 == 0``, ``g | h``,
16-byte aligned ``x``, B and C, and for ``"per_head"`` a chunk whose
tiles fit in a CTA's shared memory (at ``p = 64``, ``n = 128``, ``chunk =
128``: 221 KB in float32 of the H100's 227 KB); ``"p_split"`` takes
226.5 KB at ``n = chunk = 128``.  Any ``s >= 1``: both kernels read rows
past ``s`` as ``dt = 0, x = 0`` (the reference's padding) and do not store
them.  The JAX package falls back to its reference where ``s % chunk !=
0``; this wrapper does not.
"""
from __future__ import annotations

import ctypes

import torch

from .launch import check, launches, load_lib, raise_on, require_cuda, stream

DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("p_split", "per_head")
# The backward's chunk kernel instances, by `ssd_bwd_instance`: the bf16
# kernel on the tensor cores (0), or the float32 one by the dx̄ tiles a
# thread keeps in registers (4 x 4 each).
BWD_VARIANTS = {0: "bwd_tc", 1: "bwd_xt1", 2: "bwd_xt2", 4: "bwd_xt4"}
BWD_MAX = 128       # the backward's largest chunk, n and p

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ssd_forward": [_vp, _vp, _vp, _vp, _vp, _vp, _vp] + [_i] * 9 + [_vp],
    "ssd_smem_bytes": [_i, _i, _i, _i, _i],
    "ssd_max_smem": [_i],
    "ssd_variant": [_i, _i, _i],
}
_BWD_ARGTYPES = {
    "ssd_backward": [_vp] * 14 + [_i] * 8 + [_vp],
    "ssd_bwd_smem_bytes": [_i, _i, _i, _i],
    "ssd_bwd_instance": [_i, _i, _i],
}

# The kernel the last call launched (one of VARIANTS, or of BWD_VARIANTS's
# values after `ssd_bwd`).
last_variant = None


def _lib():
    lib = load_lib("ssd_scan", _ARGTYPES, "ssd_error_string")
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_lib():
    lib = load_lib("ssd_scan_bwd", _BWD_ARGTYPES, "ssd_bwd_error_string")
    lib.ssd_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def variant(dtype, n: int, chunk: int) -> str:
    """The kernel ``ssd_forward`` runs for this dtype, ``n`` and chunk,
    as the library's own rule gives it."""
    return VARIANTS[_lib().ssd_variant(int(dtype == torch.bfloat16), n,
                                       chunk)]


def score_rows(lib, device, p: int, n: int, chunk: int, bf16: bool) -> int:
    """The most rows of a chunk's score matrix whose tiles, with the
    state, ``x̄``, B and C, fit in a CTA's shared memory (the chunk, or
    the chunk halved while it stays a multiple of 16)."""
    limit = lib.ssd_max_smem(device.index if device.index is not None
                             else torch.cuda.current_device())
    rb = chunk
    while lib.ssd_smem_bytes(p, n, chunk, rb, int(bf16)) > limit:
        if rb % 32:
            raise ValueError(f"an SSD chunk of {chunk} at p={p}, n={n} "
                             f"does not fit in {limit} bytes of shared "
                             f"memory")
        rb //= 2
    return rb


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """``(y [b,s,h,p], state [b,h,p,n])`` of the SSD scan on the card;
    contract of ``ref.ssd_chunked``."""
    require_cuda(x)
    b, s, h, p, g, n = _check_dims(x, B, chunk)
    dev = x.device
    check("x", x, x.dtype, (b, s, h, p), dev)
    check("dt", dt, torch.float32, (b, s, h), dev)
    check("A", A, torch.float32, (h,), dev)
    check("B", B, x.dtype, (b, s, g, n), dev)
    check("C", C, x.dtype, (b, s, g, n), dev)
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    global last_variant
    bf16 = x.dtype == torch.bfloat16
    lib = _lib()
    kind = variant(x.dtype, n, chunk)
    rb = score_rows(lib, dev, p, n, chunk, bf16) if kind == "per_head" else 0
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ssd_forward(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              B.data_ptr(), C.data_ptr(), y.data_ptr(),
                              state.data_ptr(), b, s, h, p, g, n, chunk, rb,
                              int(bf16), stream(dev))
    raise_on(lib, err, "ssd")
    last_variant = kind
    launches["ssd"] += 1
    return y, state


def bwd_smem_bytes(p: int, n: int, chunk: int, bf16: bool) -> int:
    """Shared memory of one CTA of the backward's chunk kernel, as the
    library computes it."""
    return int(_bwd_lib().ssd_bwd_smem_bytes(p, n, chunk, int(bf16)))


def _check_dims(x, B, chunk):
    """The kernels' limits on the shapes and the dtype; returns ``(b, s,
    h, p, g, n)``."""
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError("x must be [b, s, h, p] and B, C [b, s, g, n]")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if not (s >= 1 and g >= 1 and h % g == 0 and p % 4 == 0 and p >= 4
            and n % 16 == 0 and n >= 16 and chunk % 16 == 0 and chunk >= 16):
        raise ValueError(f"x {tuple(x.shape)}, B {tuple(B.shape)}, chunk "
                         f"{chunk} is outside the kernel's limits (g | h, "
                         f"p % 4 == 0, n % 16 == 0, chunk % 16 == 0)")
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {DTYPES}")
    return b, s, h, p, g, n


def ssd_bwd(x, dt, A, B, C, dy, dstate, chunk: int = 128):
    """``(dx, ddt, dA, dB, dC)``, the gradient of `ssd` for the cotangents
    ``dy [b,s,h,p]`` (x's dtype) and ``dstate [b,h,p,n]`` (float32, or
    None: the final state takes no gradient), on the card; contract of
    ``ref.ssd_bwd``.  Each gradient in its input's dtype."""
    require_cuda(x)
    b, s, h, p, g, n = _check_dims(x, B, chunk)
    if max(chunk, n, p) > BWD_MAX:
        raise ValueError(f"chunk {chunk}, n {n}, p {p}: the backward takes "
                         f"each up to {BWD_MAX}")
    dev = x.device
    check("x", x, x.dtype, (b, s, h, p), dev)
    check("dt", dt, torch.float32, (b, s, h), dev)
    check("A", A, torch.float32, (h,), dev)
    check("B", B, x.dtype, (b, s, g, n), dev)
    check("C", C, x.dtype, (b, s, g, n), dev)
    check("dy", dy, x.dtype, (b, s, h, p), dev)
    if dstate is not None:
        check("dstate", dstate, torch.float32, (b, h, p, n), dev)
    for name, t in (("x", x), ("B", B), ("C", C), ("dy", dy)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    global last_variant
    bf16 = x.dtype == torch.bfloat16
    lib = _bwd_lib()
    limit = _lib().ssd_max_smem(dev.index if dev.index is not None
                                else torch.cuda.current_device())
    need = lib.ssd_bwd_smem_bytes(p, n, chunk, int(bf16))
    if need > limit:
        raise ValueError(f"the SSD backward at p={p}, n={n}, chunk={chunk} "
                         f"in {x.dtype} needs {need} bytes of shared memory "
                         f"a CTA, more than the {limit} there are")
    nc = -(-s // chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    planes = (b, h, nc, 3, p, n) if bf16 else (b, h, nc, p, n)
    states = torch.empty(planes, dtype=x.dtype, device=dev)
    gstates = torch.empty(planes, dtype=x.dtype, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, h), **f32)
    # bf16: the group sums the kernel adds each head into; float32: per head
    sums = (b, s, g, n) if bf16 else (b, s, h, n)
    dBp = torch.empty(sums, **f32)
    dCp = torch.empty(sums, **f32)
    dAp = torch.empty((b, nc, h), **f32)
    with torch.cuda.device(dev):
        err = lib.ssd_backward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(),
            states.data_ptr(), gstates.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(),
            b, s, h, p, g, n, chunk, int(bf16), stream(dev))
    raise_on(lib, err, "ssd_bwd")
    last_variant = BWD_VARIANTS[lib.ssd_bwd_instance(chunk, p, int(bf16))]
    launches["ssd_bwd"] += 1
    del states, gstates     # scratch (1.61 GB each at jamba's shape)
    if not bf16:
        dBp = dBp.view(b, s, g, h // g, n).sum(3)
        dCp = dCp.view(b, s, g, h // g, n).sum(3)
    return dx, ddt, dAp.sum((0, 1)), dBp.to(x.dtype), dCp.to(x.dtype)
