"""The bandwidth-faithful cross-pod communication substrate, in PyTorch.

The port of ``repro/comm/substrate.py``.  With ``cfg.comm_active`` the
simulator routes cross-pod shipment through it:

- **k-clock delta aggregation** (``cfg.agg_clocks``): each producer
  accumulates its raw updates (``acc``) and ships one summed delta every
  ``agg_clocks`` clocks.  Cross-pod visibility advances only to shipment
  boundaries (:func:`shipped_end`, :func:`shipped_through`), and the
  two-tier staleness bound widens to ``s + s_xpod + agg_clocks - 1``.
- **sparse shipment** (``cfg.topk_frac``): only the ``k`` largest
  magnitudes of each aggregated row cross the wire (:func:`row_threshold`;
  ties may admit more, and :func:`selected_count` counts them).  Dropped
  mass stays in an **error-feedback residual** (``res``) that joins the
  next shipment: ``wire + residual == acc + res`` exactly in f32.
- **value quantization** (``cfg.quant``): f32, bf16 or int8 with a
  per-producer absmax scale (:func:`quant_scale`); the quantization error
  lands in the residual too.

State (:func:`init_state`), a plain dict of tensors: ``acc [P, d]``,
``res [P, d]``, the wire ring ``xring [W, P, d]`` (slot ``c % W`` holds
the shipments of clock ``c``, zeros between boundaries), and the folds of
recycled raw and wire slots per producer pod, ``base_pod`` and
``xbase_pod [G, d]``.  A reader in pod ``g`` sees ``x0 + base_pod[g] +
Σ_{g' != g} xbase_pod[g']`` (:func:`reader_base`).

What changed in the port: the clock is a Python int, so the schedule
functions return Python values and the simulator packs only on clocks that
ship (the JAX package packs every clock and discards the result between
boundaries; the state and the trace are the same).  ``k`` is computed on
the host as JAX computes it, a float32 ceil (:func:`topk_count`), and the
threshold is an exact order statistic, so it is the float that JAX's
sort picks.
"""
from __future__ import annotations

import math
import struct

import torch

from ..core.consistency import QUANT_BITS
from ..kernels import ops

# --------------------------------------------------------------- schedule


def ship_now(c: int, agg_clocks: int) -> bool:
    """Does a shipment happen at the END of clock ``c``?"""
    return (c + 1) % agg_clocks == 0


def shipped_end(c: int, agg_clocks: int) -> int:
    """Latest shipped producer clock after the end of clock ``c`` — the
    cross-pod delivery target (``c`` when ``agg_clocks == 1``)."""
    return ((c + 1) // agg_clocks) * agg_clocks - 1


def shipped_through(c: int, agg_clocks: int) -> int:
    """Latest shipped producer clock at READ time of clock ``c`` — the
    cross-pod forced-refresh target (``c - 1`` when ``agg_clocks == 1``);
    always ``>= c - agg_clocks``."""
    return (c // agg_clocks) * agg_clocks - 1


# ------------------------------------------------------------ compression


def topk_count(topk_frac: float, d: int) -> int:
    """``k = clip(ceil(topk_frac * d), 1, d)`` as the JAX package computes
    it: the product in float64, rounded to float32, then the ceil (at
    ``topk_frac = 0.07, d = 5,053,800`` that is 353,766, one less than a
    float64 ceil)."""
    prod32 = struct.unpack("f", struct.pack("f", topk_frac * d))[0]
    return min(max(math.ceil(prod32), 1), d)


def row_threshold(delta, topk_frac: float):
    """Per-row magnitude threshold [P]: the ``k``-th largest ``|delta|`` of
    each full ``[P, d]`` row, ``k = topk_count(topk_frac, d)``.

    The smallest of the ``k`` largest (``torch.topk``): an exact order
    statistic, so it is the float the JAX package's sort picks.  Of three
    exact selections timed on the H100 (``chip_smoke.py``: ``topk``,
    ``sort``, ``kthvalue``) it is the fastest at the main path's shape."""
    k = topk_count(topk_frac, delta.shape[-1])
    return torch.topk(delta.abs(), k, dim=-1, sorted=False).values.amin(-1)


def quant_scale(delta, quant: str):
    """Per-row int8 dequant scale ``max(absmax / 127, 1e-12)``; ones for
    f32/bf16.  The 127 is a tensor on the device: PyTorch's CUDA kernels
    divide by a Python scalar as a multiply by its reciprocal, which
    rounds differently from the true division of the CPU and of XLA."""
    P = delta.shape[0]
    if quant != "int8":
        return torch.ones((P,), dtype=torch.float32, device=delta.device)
    absmax = delta.abs().amax(dim=-1)
    full = torch.full_like
    return torch.maximum(absmax / full(absmax, 127.0), full(absmax, 1e-12))


def selected_count(delta, thresh):
    """Per-row selected-coordinate count [P] (float32), from full rows."""
    return (delta.abs() >= thresh[:, None]).sum(
        dim=-1, dtype=torch.int32).to(torch.float32)


def pack(delta, topk_frac: float, quant: str):
    """One shipment pack on full rows: ``(wire, residual, nnz)``."""
    return pack_block(delta, delta, topk_frac, quant)


def pack_block(delta, delta_full, topk_frac: float, quant: str):
    """One shipment pack of a column block ``delta [P, dl]`` whose full
    rows are ``delta_full [P, d]``: the threshold, the int8 scale and the
    count come from the full rows, the pack itself is elementwise on the
    block (a shard of the sharded runtime).  ``(wire, residual, nnz)``."""
    thresh = row_threshold(delta_full, topk_frac)
    scale = quant_scale(delta_full, quant)
    wire, residual = ops.delta_pack(delta, thresh, scale, quant)
    return wire, residual, selected_count(delta_full, thresh)


def wire_floats(nnz, d: int, quant: str):
    """Bits-weighted float32-equivalents on the wire for one shipment:
    ``nnz`` values at ``QUANT_BITS[quant]`` bits, plus one 32-bit index per
    value when the shipment is sparse."""
    return nnz * (QUANT_BITS[quant] / 32.0) + torch.where(nnz < d, nnz, 0.0)


def dense_ship_floats(model: str, P: int, d: int, device=None):
    """``Trace.ship_floats`` row of the dense (substrate-off) path: every
    push-model producer ships its full ``d``-float delta each clock;
    pull-based SSP ships nothing."""
    fill = 0.0 if model == "ssp" else float(d)
    return torch.full((P,), fill, dtype=torch.float32, device=device)


# ------------------------------------------------------------ state/views


def init_state(W: int, P: int, d: int, n_pods: int, device=None) -> dict:
    """Zero comm state (see the module doc for the layout)."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return dict(acc=z(P, d), res=z(P, d), xring=z(W, P, d),
                base_pod=z(n_pods, d), xbase_pod=z(n_pods, d))


def sum_rows(x):
    """``x.sum(0)`` in a fixed order: the rows of ``x`` added one after
    another, first to last, each add elementwise.

    ``torch.sum`` over a leading dimension picks its order by the number
    of columns (on the CPU a vectorized body and a scalar tail), so a
    block of columns would not sum as the same columns of the whole.  The
    simulator and the sharded runtime (whose shards own column blocks)
    both reduce producers, pods and ring slots through this, so their
    floats agree bit for bit at any column split."""
    if x.shape[0] == 1:
        return x[0].clone()
    out = x[0] + x[1]
    for i in range(2, x.shape[0]):
        out.add_(x[i])
    return out


def reader_base(x0, base_pod, xbase_pod, reader_pods):
    """Per-reader folded base ``(x0 + base_pod[own]) + Σ_{other}
    xbase_pod``: ``x0 [d]``, ``base_pod``/``xbase_pod [G, d]``,
    ``reader_pods [Pl]``.  The other-pod sum is a masked sum over ``G``
    in pod order (never a subtraction from the total), the JAX package's
    float association."""
    G = base_pod.shape[0]
    own = base_pod[reader_pods.long()]                        # [Pl, d]
    other = (torch.arange(G, device=base_pod.device)[:, None]
             != reader_pods[None, :]).to(torch.float32)        # [G, Pl]
    xother = other[0][:, None] * xbase_pod[0]
    for g in range(1, G):                                     # pod order
        xother = xother + other[g][:, None] * xbase_pod[g]
    return (x0[None, :] + own) + xother


def fold_pods(ring_slot, n_pods: int):
    """Fold one recycled ring slot ``[P, d]`` into per-producer-pod sums
    ``[G, d]`` over contiguous pod blocks (:func:`sum_rows` order)."""
    P, d = ring_slot.shape
    return sum_rows(ring_slot.reshape(n_pods, P // n_pods, d).transpose(0, 1))
