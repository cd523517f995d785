"""Launch wrapper of the hand-written CUDA kernels in
``csrc/flash_attention.cu``.

They replace the Pallas kernel of ``repro/kernels/flash_attention.py``:
GQA attention with an online softmax, positional masks (causal, sliding
window, ``kv_pos < 0``), KV tiles with no visible key skipped, and
``Dk != Dv``.  ``fa_forward`` picks one of four kernels by a fixed rule
from the dtype and the head sizes ``(Dk, Dv)``; the name of the one that
ran is :data:`last_variant` after each call, and :func:`variant` gives it
beforehand:

- ``"wgmma_tma"``: bf16 at ``(64, 64)`` and ``(128, 128)`` (the models'
  head sizes): TMA loads into a two-stage ring driven by a producer
  warpgroup, ``wgmma`` products for two consumer warpgroups, float32
  accumulate; tensor maps built per call through
  ``cudaGetDriverEntryPoint``;
- ``"mma_sync"``: bf16 at ``(32, 16)``, ``(32, 32)``, ``(80, 64)`` (the
  MLA smoke config's latent heads) and ``(80, 80)`` (stablelm-3b):
  ``mma.sync`` products, float32 accumulate;
- ``"mla_wgmma"``: bf16 at ``(576, 512)``, MLA's latent heads
  (deepseek-v2-lite: 512 latent + 64 rope columns of the key, the latent
  as the value, one KV head): a persistent CTA an SM over items of 64
  (query, head) rows of a KV head, a producer warpgroup sending 64-key K
  tiles by TMA through a two-stage ring, one ``wgmma`` consumer
  warpgroup computing S and the softmax and both adding P V into their
  share of O's columns (128 and 384); V is read from the K tiles, so
  ``v`` must be ``k[..., :512]`` (see below);
- ``"f32_cuda_cores"``: float32 at every head size of :data:`HEAD_DIMS`,
  in full float32 on the CUDA cores.

There is no fallback between them: a refused launch raises.  The wrapper
checks device, dtype, shape, alignment and contiguity, allocates the
output, launches on the current stream, raises on a non-zero
``cudaError_t`` and counts the launch in ``launch.launches``.  The plain
version is ``ref.attention``; ``ops.attention`` picks between the two by
the tensor's device.

Training (``ops.attention`` under autograd): :func:`flash_attention_fwd_lse`
runs the same kernel and also writes each row's log-sum-exp ``lse``
(float32 ``[B, H, Sq]``, natural units, ``+inf`` for a row that sees no
key; ``ref.attention_lse``), and :func:`flash_attention_bwd` launches the
backward of ``csrc/flash_attention_bwd.cu`` (``ref.attention_bwd``),
counted in ``launch.launches["flash_attention_bwd"]`` (its three kernels,
one count a call).  Its kernel, by a fixed rule from the dtype and the
head sizes (:func:`bwd_variant`; :data:`last_bwd_variant` after a call):

- ``"wgmma_tma"``: bf16 at ``(64, 64)``, ``(80, 80)`` (stablelm-3b) and
  ``(128, 128)``: the persistent ``wgmma`` kernels ``fa_bwd_dkdv_wgmma``
  and ``fa_bwd_dq_wgmma`` (TMA rings, a producer warp and two consumer
  warpgroups each; a row of 80 columns in two 64-column boxes, the
  second zero past column 79; their walk over the tiles is
  ``ref.attention_bwd_schedule``, their rings and registers
  :func:`bwd_kernel_info`);
- ``"mma_sync"``: bf16 at ``(32, 16)``, ``(32, 32)`` and ``(80, 64)`` (the
  smoke sizes): ``fa_bwd_dkdv_mma`` and ``fa_bwd_dq_mma``, ``mma.sync``
  products, a resident 64-row tile and 32-row units streamed past it;
- ``"mla_wgmma"``: bf16 at ``(576, 512)``, MLA's latent heads:
  ``fa_bwd_dkdv_mla`` (items of 64 keys, K resident, 32-row units of
  (query, head) rows streamed by TMA) and ``fa_bwd_dq_mla`` (items of 64
  rows, Q and dO resident, 32-key K tiles streamed), persistent, a
  producer warp and two ``wgmma`` consumer warpgroups each that split
  the output's columns and hand P and dS to each other; V read from the
  K tiles (their walk is ``ref.attention_bwd_schedule(...,
  variant="mla_wgmma")``);
- ``"f32_cuda_cores"``: float32 at every size of :data:`HEAD_DIMS` but
  ``(576, 512)``, CUDA-core kernels.

:data:`BWD_HEAD_DIMS` lists what each dtype takes and
:data:`BWD_BF16_RULE` which bf16 variant takes each size (the library's
``bwd_variant_of``); float32 at ``(576, 512)`` raises
``NotImplementedError`` naming its ROADMAP item (:data:`BWD_TODO`).  No
backward kernel uses atomics.

V as K's prefix: ``v`` may be the view ``k[..., :Dv]`` of a contiguous
``k`` with ``Dv < Dk`` (``ref.v_is_k_prefix``: the same ``data_ptr`` and
``k``'s strides), as MLA passes its latent values
(``models.attention._mla_blocked``); only that view is admitted without
being contiguous, and the kernels then read V from K's rows.  At bf16
``(576, 512)`` it is the only ``v`` taken: the MLA kernels serve both
products from one K tile, and a separate ``v`` raises.  The backward then
returns ``(dq, dk, None)``, dK holding dV in its first Dv columns
(``ref.attention_bwd``'s folded contract).

Limits: head sizes ``(Dk, Dv)`` in :data:`HEAD_DIMS`, ``H % Hkv == 0``,
``B`` and ``H`` up to 65535, any ``Sq, Sk >= 1`` (the kernels mask the
ragged edge as the TPU wrapper's padding does: ``q_pos = 2**30`` past
``Sq``, ``kv_pos = -1`` past ``Sk``).  The JAX package falls back to its
reference on shapes its kernel does not take; this wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .launch import check, launches, load_lib, raise_on, require_cuda, stream

HEAD_DIMS = ((32, 16), (32, 32), (64, 64), (80, 64), (80, 80), (128, 128),
             (576, 512))
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_YZ = 65535

VARIANTS = ("wgmma_tma", "mma_sync", "f32_cuda_cores", "mla_wgmma")

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"fa_forward": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                            _i, _i, _i, ctypes.c_float, _i, _i, _vp],
             "fa_forward_lse": [_vp] * 7 + [_i] * 8 + [ctypes.c_float, _i,
                                                       _i, _vp],
             "fa_variant": [_i, _i, _i]}
_BWD_ARGTYPES = {"fa_backward": [_vp] * 12 + [_i] * 8 + [ctypes.c_float,
                                                         _i, _i, _vp],
                 "fa_bwd_variant": [_i, _i, _i],
                 "fa_bwd_kernel_info": [_i, _i, _i, _vp]}
BWD_VARIANTS = ("wgmma_tma", "mma_sync", "mla_wgmma", "f32_cuda_cores")
# The bf16 backward's two kernels by variant, in the order
# fa_bwd_kernel_info numbers them.
BWD_KERNELS = {"wgmma_tma": ("fa_bwd_dkdv_wgmma", "fa_bwd_dq_wgmma"),
               "mma_sync": ("fa_bwd_dkdv_mma", "fa_bwd_dq_mma"),
               "mla_wgmma": ("fa_bwd_dkdv_mla", "fa_bwd_dq_mla")}
# The bf16 variant of each head size (the library's bwd_variant_of).
BWD_BF16_RULE = {"wgmma_tma": ((64, 64), (80, 80), (128, 128)),
                 "mma_sync": ((32, 16), (32, 32), (80, 64)),
                 "mla_wgmma": ((576, 512),)}
# The head sizes the backward takes, by dtype.
BWD_HEAD_DIMS = {torch.bfloat16: HEAD_DIMS,
                 torch.float32: tuple(d for d in HEAD_DIMS
                                      if d != (576, 512))}
# The ROADMAP item that adds the backward of the others.
BWD_TODO = {(torch.float32, (576, 512)):
            "16.4f (the float32 backward at MLA's (576, 512))"}

# The kernel the last call launched (one of VARIANTS), and the last
# backward call's (one of BWD_VARIANTS).
last_variant = None
last_bwd_variant = None


def variant(dtype, Dk: int, Dv: int) -> str:
    """The kernel ``fa_forward`` runs for this dtype and these head
    sizes, as the library's own rule gives it."""
    lib = load_lib("flash_attention", _ARGTYPES, "fa_error_string")
    v = lib.fa_variant(int(dtype == torch.bfloat16), Dk, Dv)
    if v < 0:
        raise ValueError(f"no kernel for {dtype} at (Dk={Dk}, Dv={Dv})")
    return VARIANTS[v]


def _check_inputs(q, k, v, q_pos, kv_pos, window):
    """The wrapper's checks of the forward's inputs; returns
    ``(B, Sq, Sk, H, Hkv, Dk, Dv, v_in_k)``."""
    require_cuda(q)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, S, heads, head_dim]")
    B, Sq, H, Dk = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (Dk, Dv) not in HEAD_DIMS:
        raise ValueError(f"head sizes (Dk={Dk}, Dv={Dv}) are outside the "
                         f"kernel's limits {HEAD_DIMS}")
    if not (Sq >= 1 and Sk >= 1 and Hkv >= 1 and H % Hkv == 0
            and B <= MAX_GRID_YZ and H <= MAX_GRID_YZ):
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} is "
                         f"outside the kernel's limits (H % Hkv == 0, B and "
                         f"H <= {MAX_GRID_YZ})")
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected one of {DTYPES}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    dev = q.device
    v_in_k = ref.v_is_k_prefix(k, v)
    if q.dtype == torch.bfloat16 and (Dk, Dv) == (576, 512) and not v_in_k:
        raise ValueError("at bf16 (Dk=576, Dv=512) v must be k[..., :512] "
                         "(MLA's latent values, read from the K tiles)")
    check("q", q, q.dtype, (B, Sq, H, Dk), dev)
    check("k", k, q.dtype, (B, Sk, Hkv, Dk), dev)
    check("v", v, q.dtype, (B, Sk, Hkv, Dv), dev, contiguous=not v_in_k)
    check("q_pos", q_pos, torch.int32, (B, Sq), dev)
    check("kv_pos", kv_pos, torch.int32, (B, Sk), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return B, Sq, Sk, H, Hkv, Dk, Dv, v_in_k


def bwd_variant(dtype, Dk: int, Dv: int) -> str:
    """The kernel ``flash_attention_bwd`` runs for this dtype and these
    head sizes, as the library's own rule gives it."""
    lib = load_lib("flash_attention_bwd", _BWD_ARGTYPES,
                   "fa_bwd_error_string")
    v = lib.fa_bwd_variant(int(dtype == torch.bfloat16), Dk, Dv)
    if v < 0:
        raise ValueError(f"no backward kernel for {dtype} at (Dk={Dk}, "
                         f"Dv={Dv})")
    return BWD_VARIANTS[v]


def require_backward(q, Dk: int, Dv: int) -> None:
    """Raise ``NotImplementedError`` unless the backward takes these head
    sizes in q's dtype (:data:`BWD_HEAD_DIMS`), naming the shape and the
    ROADMAP item that adds it."""
    if (Dk, Dv) not in BWD_HEAD_DIMS[q.dtype]:
        raise NotImplementedError(
            f"no backward kernel for attention at (Dk={Dk}, Dv={Dv}) in "
            f"{q.dtype} on the card (it takes {BWD_HEAD_DIMS[q.dtype]}); "
            f"ROADMAP {BWD_TODO[(q.dtype, (Dk, Dv))]}")


def flash_attention(q, k, v, *, scale, q_pos, kv_pos, causal=True,
                    window=None):
    """Attention of ``q [B,Sq,H,Dk]`` over ``k [B,Sk,Hkv,Dk]``,
    ``v [B,Sk,Hkv,Dv]`` at int32 positions ``q_pos [B,Sq]``,
    ``kv_pos [B,Sk]`` -> ``[B,Sq,H,Dv]`` in q's dtype, on the card;
    contract of ``ref.attention``."""
    B, Sq, Sk, H, Hkv, Dk, Dv, _ = _check_inputs(q, k, v, q_pos, kv_pos,
                                                 window)
    dev = q.device
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lib = load_lib("flash_attention", _ARGTYPES, "fa_error_string")
    with torch.cuda.device(dev):
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, Sq, Sk, H, Hkv, Dk, Dv,
            int(q.dtype == torch.bfloat16), float(scale), int(bool(causal)),
            -1 if window is None else int(window), stream(dev))
    raise_on(lib, err, "flash_attention")
    launches["flash_attention"] += 1
    global last_variant
    last_variant = variant(q.dtype, Dk, Dv)
    return out


def flash_attention_fwd_lse(q, k, v, *, scale, q_pos, kv_pos, causal=True,
                            window=None):
    """`flash_attention` that also returns each row's log-sum-exp: ``(out,
    lse)``, ``lse`` float32 ``[B, H, Sq]`` (contract of
    ``ref.attention_lse``); the output is bit-equal to
    `flash_attention`'s.  Counted as a ``flash_attention`` launch.  Only
    at the head sizes the backward takes in q's dtype
    (:data:`BWD_HEAD_DIMS`)."""
    B, Sq, Sk, H, Hkv, Dk, Dv, _ = _check_inputs(q, k, v, q_pos, kv_pos,
                                                 window)
    require_backward(q, Dk, Dv)
    dev = q.device
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    lib = load_lib("flash_attention", _ARGTYPES, "fa_error_string")
    with torch.cuda.device(dev):
        err = lib.fa_forward_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H,
            Hkv, Dk, Dv, int(q.dtype == torch.bfloat16), float(scale),
            int(bool(causal)), -1 if window is None else int(window),
            stream(dev))
    raise_on(lib, err, "flash_attention (with lse)")
    launches["flash_attention"] += 1
    global last_variant
    last_variant = variant(q.dtype, Dk, Dv)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, scale, q_pos, kv_pos,
                        causal=True, window=None):
    """``(dq, dk, dv)`` of attention for the cotangent ``dout`` (the
    shape and dtype of ``out``), from the forward's ``out`` and ``lse``
    (`flash_attention_fwd_lse`), on the card; contract of
    ``ref.attention_bwd``: with ``v`` as K's prefix (``ref.v_is_k_prefix``)
    ``(dq, dk, None)``, dK holding dV in its first Dv columns.  Three
    kernels (D, then dK and dV, then dQ) behind one count,
    ``launches["flash_attention_bwd"]``, picked by the rule of
    :func:`bwd_variant` (the module's docstring); each recomputes P from
    ``lse``.  No atomics, so two calls on the same inputs are
    bit-equal."""
    B, Sq, Sk, H, Hkv, Dk, Dv, fold = _check_inputs(q, k, v, q_pos, kv_pos,
                                                    window)
    require_backward(q, Dk, Dv)
    dev = q.device
    check("out", out, q.dtype, (B, Sq, H, Dv), dev)
    check("dout", dout, q.dtype, (B, Sq, H, Dv), dev)
    check("lse", lse, torch.float32, (B, H, Sq), dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = None if fold else torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    lib = load_lib("flash_attention_bwd", _BWD_ARGTYPES,
                   "fa_bwd_error_string")
    with torch.cuda.device(dev):
        err = lib.fa_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            None if fold else dv.data_ptr(), delta.data_ptr(), B, Sq, Sk, H,
            Hkv, Dk, Dv, int(q.dtype == torch.bfloat16), float(scale),
            int(bool(causal)), -1 if window is None else int(window),
            stream(dev))
    raise_on(lib, err, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    global last_bwd_variant
    last_bwd_variant = bwd_variant(q.dtype, Dk, Dv)
    return dq, dk, dv


def bwd_kernel_info(Dk: int, Dv: int | None = None) -> dict:
    """The bf16 backward's two kernels at head sizes ``(Dk, Dv)`` (``Dv``
    defaults to ``Dk``) as the library compiled them: for each of
    :data:`BWD_KERNELS` of its variant, its stages (ring or double
    buffer), dynamic shared bytes, registers a thread at launch and local
    (spill) bytes.  Needs the card (the library is loaded, no kernel
    runs)."""
    Dv = Dk if Dv is None else Dv
    lib = load_lib("flash_attention_bwd", _BWD_ARGTYPES,
                   "fa_bwd_error_string")
    out = {}
    for which, name in enumerate(BWD_KERNELS[bwd_variant(torch.bfloat16,
                                                         Dk, Dv)]):
        vals = (ctypes.c_int * 4)()
        err = lib.fa_bwd_kernel_info(which, Dk, Dv, vals)
        raise_on(lib, err, f"fa_bwd_kernel_info({name}, {Dk}, {Dv})")
        out[name] = dict(zip(("stages", "shared_bytes", "registers",
                              "local_bytes"), vals, strict=True))
    return out
