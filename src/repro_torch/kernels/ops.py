"""Dispatch of the port's hot-path kernels by the tensors' device.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``ps_view.py``, ``delta_pack.py``,
``flash_attention.py``, ``ssd_scan.py``, ``mf_sgd.py``), which launches
or raises.  There
is no backend switch and no fallback: on the card, the main path runs the
kernels or fails.

Under autograd (grad enabled and an input that requires grad),
``attention`` is a ``torch.autograd.Function`` whose forward also keeps
each row's log-sum-exp and whose backward is ``flash_attention_bwd`` on
the card (``ref.attention_lse`` / ``ref.attention_bwd`` on the CPU): in
bf16 two persistent ``wgmma`` kernels fed by TMA rings at head sizes 64
and 128, ``mma.sync`` kernels at the narrow sizes and MLA's (576, 512),
CUDA-core kernels in float32, none with atomics.  Where ``v`` is K's
prefix (MLA's latent values, ``ref.v_is_k_prefix``) the backward returns
dK with dV folded into its first columns and no gradient for ``v``, and
autograd carries the whole of it through the tensor both are views of.
``ssd`` is one whose forward is the serving call and whose backward is
``ssd_scan.ssd_bwd`` on the card (three kernels: the states entering
each chunk, their gradients by a reverse walk, the in-chunk gradients;
``ref.ssd_bwd`` on the CPU).  A float32 gradient through attention at
MLA's (576, 512) has no kernel yet and raises ``NotImplementedError``
on the card (``flash_attention.BWD_TODO``) rather than return a tensor
with no gradient.  Without a gradient the calls are the serving path's,
unchanged.
"""
from __future__ import annotations

import torch

from . import ref


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def ring_view(base, uring, uclock, cview):
    """PS view materialization; see `ref.ring_view` for the contract."""
    if _on_cuda(uring):
        from . import ps_view
        return ps_view.ring_view(base, uring, uclock, cview)
    return ref.ring_view(base, uring, uclock, cview)


def vap_suffix_norms(uring, uclock, c: int):
    """VAP suffix-aggregate inf-norms; see `ref.vap_suffix_norms`."""
    if _on_cuda(uring):
        from . import ps_view
        return ps_view.vap_suffix_norms(uring, uclock, c)
    return ref.vap_suffix_norms(uring, uclock, c)


def delta_pack(delta, thresh, scale, quant: str = "f32"):
    """Comm-substrate shipment pack; see `ref.delta_pack` for the
    contract."""
    if _on_cuda(delta):
        from . import delta_pack as dp
        return dp.delta_pack(delta, thresh, scale, quant)
    return ref.delta_pack(delta, thresh, scale, quant)


def mf_sgd_block(L, R, D, mask, gamma, lam):
    """One MF-SGD step over a dense block of ratings; see
    `ref.mf_sgd_block` for the contract.  Unlike the JAX dispatch, no
    shape falls back to the plain version on the card."""
    if _on_cuda(L):
        from . import mf_sgd
        return mf_sgd.mf_sgd_block(L, R, D, mask, gamma, lam)
    return ref.mf_sgd_block(L, R, D, mask, gamma, lam)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _attention_fwd(q, k, v, **kw):
    """``(out, lse)`` of attention, for its gradient."""
    if _on_cuda(q):
        from . import flash_attention as fa
        return fa.flash_attention_fwd_lse(q, k, v, **kw)
    return ref.attention_lse(q, k, v, **kw)


def _attention_bwd(q, k, v, out, lse, dout, **kw):
    """``(dq, dk, dv)`` of attention from its ``out`` and ``lse``; ``dv``
    is None where ``v`` is K's prefix (dK holds it)."""
    if _on_cuda(q):
        from . import flash_attention as fa
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    return ref.attention_bwd(q, k, v, out, lse, dout, **kw)


class _Attention(torch.autograd.Function):
    """Attention with its gradient: the forward keeps ``lse``, the backward
    recomputes P from it (`_attention_fwd`, `_attention_bwd`).  The
    positions get no gradient; nor does ``v`` where it is K's prefix
    (``ref.v_is_k_prefix``): dK already holds dV, and autograd adds it
    into the tensor both are views of."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, scale, causal, window):
        out, lse = _attention_fwd(q, k, v, scale=scale, q_pos=q_pos,
                                  kv_pos=kv_pos, causal=causal,
                                  window=window)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.kw = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        dq, dk, dv = _attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                    q_pos=q_pos, kv_pos=kv_pos, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, scale, q_pos, kv_pos, causal=True, window=None):
    """Blocked attention; see `ref.attention` for the contract.  Under
    autograd, `_Attention` (its gradient through ``flash_attention_bwd``
    on the card)."""
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, q_pos, kv_pos, scale, causal,
                                window)
    if _on_cuda(q):
        from . import flash_attention as fa
        return fa.flash_attention(q, k, v, scale=scale, q_pos=q_pos,
                                  kv_pos=kv_pos, causal=causal, window=window)
    return ref.attention(q, k, v, scale=scale, q_pos=q_pos, kv_pos=kv_pos,
                         causal=causal, window=window)


def _ssd_fwd(x, dt, A, B, C, chunk):
    if _on_cuda(x):
        from . import ssd_scan
        return ssd_scan.ssd(x, dt, A, B, C, chunk=chunk)
    return ref.ssd_chunked(x, dt, A, B, C, chunk)


def _ssd_bwd(x, dt, A, B, C, dy, dstate, chunk):
    """``(dx, ddt, dA, dB, dC)`` of the SSD scan for the cotangents of
    ``y`` and of the final state (None: none)."""
    if _on_cuda(x):
        from . import ssd_scan
        return ssd_scan.ssd_bwd(x, dt, A, B, C, dy, dstate, chunk)
    return ref.ssd_bwd(x, dt, A, B, C, dy, dstate, chunk)


class _SSD(torch.autograd.Function):
    """The SSD scan with its gradient: the forward is the serving call;
    the backward recomputes the chunk states from the saved inputs
    (``ssd_scan.ssd_bwd`` on the card, ``ref.ssd_bwd`` on the CPU).  The
    final state's cotangent is None when nothing used it (training: the
    mamba block drops the state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _ssd_fwd(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        return (*_ssd_bwd(x, dt, A, B, C, dy, dstate, ctx.chunk), None)


def ssd(x, dt, A, B, C, chunk=128):
    """Mamba-2 SSD chunked scan; see `ref.ssd_chunked` for the contract.
    Under autograd, `_SSD` (its gradient through ``ssd_bwd`` on the
    card)."""
    if _needs_grad(x, dt, A, B, C):
        return _SSD.apply(x, dt, A, B, C, chunk)
    return _ssd_fwd(x, dt, A, B, C, chunk)


def ssd_decode(x, dt, A, B, C, state):
    """One-token SSD step: always the plain version (a few small ops), as
    in the JAX package; see `ref.ssd_recurrent`."""
    return ref.ssd_recurrent(x, dt, A, B, C, state)
